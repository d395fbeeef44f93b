"""The port's HTTP router against the JAX package's, request by request.

One table of requests goes to the JAX ``HttpRpcRouter`` over a JAX
TSDB and to the port's router over the port's TSDB (on the CPU in
float64), both holding the same seeded data (``torch_pair``). Each
request is compared by its kind:

- ``query``: the same status and the bodies equal as parsed JSON (keys
  in order, results in order, timestamps, NaN positions), the values
  within rtol 1e-9 and atol 1e-9 * max|x| of the result; the rows of
  ``showStats``/``showSummary`` hold timings of each package, so there
  every key the port emits must be one the JAX package emits;
- ``bytes``: the same status and the same body byte for byte (errors
  and every non-query body);
- ``shape``: ``/api/version``, ``/api/config`` and ``/api/stats*``
  describe each package, so the shape must be the same and every key
  or record name the port emits must appear in the JAX answer.

The table runs once at ``ENGINE_KEYS`` (the point path, where the port
runs the plain versions of K1 and K2) and once at ``GRID_ON``. Puts run
on a fresh pair per request, and their data is read back through both.
Every endpoint the port has not ported answers a structured 501.
"""

import json
import math

import numpy as np
import pytest

from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch.tsd import http_api
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from torch_pair import ENGINE_KEYS, GRID_ON, T0, port_tsdb, reference_tsdb

END = T0 + 3599
CPU = "sys.cpu.user"
NET = "sys.if.in"
# keys both TSDBs get: each package reads its own and ignores the
# other's, so /api/config can be held key by key
COMMON = {"tsd.torch.device": "cpu", "tsd.torch.dtype": "float64",
          "tsd.tpu.platform": "cpu", "tsd.query.max_device_cells": "0",
          "tsd.core.auto_create_metrics": "true"}
KEY_SETS = {"engine": ENGINE_KEYS, "grid": GRID_ON}


def seeded_metrics() -> dict:
    """Two metrics at one point a minute for an hour: ``sys.cpu.user``
    (12 series, normal(100, 15) values, a NaN and a gap) and
    ``sys.if.in`` (6 series of integral counters that wrap once)."""
    rng = np.random.default_rng(7)
    s, p = 12, 60
    tags = [{"host": f"h{i:02d}", "dc": f"dc{i % 3}", "rack": f"r{i % 4}"}
            for i in range(s)]
    ts2d = T0 + 60 * np.arange(p, dtype=np.int64)[None, :].repeat(s, 0)
    vals = rng.normal(100.0, 15.0, (s, p))
    vals[3, 17] = np.nan
    counts = np.full(s, p)
    counts[5] = 40               # h05 stops writing after 40 minutes
    n = 6
    ntags = [{"host": f"h{i:02d}", "dc": f"dc{i % 3}"} for i in range(n)]
    nts = ts2d[:n]
    nvals = np.cumsum(rng.integers(0, 1000, (n, p)), axis=1) \
        .astype(np.float64)
    nvals[2, 30:] -= nvals[2, 30] - 5      # a counter reset
    return {CPU: (tags, ts2d, vals, counts),
            NET: (ntags, nts, nvals, np.full(n, p))}


def make_pair(keys: dict, metrics: dict | None = None):
    metrics = seeded_metrics() if metrics is None else metrics
    jt = reference_tsdb(metrics, {**COMMON, **keys})
    tt = port_tsdb(jt, list(metrics), {**COMMON, **keys})
    return jt, tt


def close_pair(jt, tt) -> None:
    """Shut both TSDBs down and join both fan-out pools: the reference's
    shutdown does not wait for its ``tsd-subq`` threads, which a later
    test file on the same worker counts."""
    jt.shutdown()
    pool = getattr(jt, "_fanout_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
    tt.shutdown()


@pytest.fixture(scope="module", params=sorted(KEY_SETS))
def routers(request):
    jt, tt = make_pair(KEY_SETS[request.param])
    yield JRouter(jt), HttpRpcRouter(tt)
    close_pair(jt, tt)


def _params(params: dict) -> dict:
    return {k: [str(x) for x in (v if isinstance(v, list) else [v])]
            for k, v in params.items()}


def _body(body) -> bytes:
    if body is None:
        return b""
    return body if isinstance(body, bytes) else json.dumps(body).encode()


def send_both(jr, pr, method: str, path: str, body=None, **params):
    prm, raw = _params(params), _body(body)
    want = jr.handle(JRequest(method=method, path=path, params=prm,
                              body=raw))
    got = pr.handle(HttpRequest(method=method, path=path, params=prm,
                                body=raw))
    return got, want


# -- comparison --------------------------------------------------------

def _unwrap(body: bytes, params: dict):
    cb = params.get("jsonp")
    if cb:
        assert body.startswith(cb.encode() + b"(") and body.endswith(b")")
        body = body[len(cb) + 1:-1]
    return json.loads(body)


def _values_close(got: list, want: list) -> None:
    g = np.array([math.nan if v == "NaN" else v for v in got], float)
    w = np.array([math.nan if v == "NaN" else v for v in want], float)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * max(
        np.nanmax(np.abs(w), initial=0.0), 1.0), equal_nan=True)


def assert_query_close(got, want) -> None:
    """Query bodies as parsed JSON: results and their keys in order,
    exact tags, timestamps and NaN positions, values to the tolerance;
    for stats rows, the port's keys a subset of the JAX package's."""
    assert isinstance(got, list) and isinstance(want, list)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in g:
            if key in ("stats", "statsSummary"):
                assert set(g[key]) <= set(w[key]), \
                    set(g[key]) - set(w[key])
            elif key == "dps":
                gd, wd = g["dps"], w["dps"]
                if isinstance(wd, dict):
                    assert list(gd) == list(wd)
                    _values_close(list(gd.values()), list(wd.values()))
                else:
                    assert [t for t, _ in gd] == [t for t, _ in wd]
                    _values_close([v for _, v in gd], [v for _, v in wd])
            else:
                assert g[key] == w[key], key


# one record of /api/stats and of telnet stats
_RECORD = {"metric", "timestamp", "value", "tags"}


def assert_shape(got, want, where: str = "$") -> None:
    """The same JSON shape; every key (and record name) of the port's
    answer also in the JAX package's. A null on either side is an
    optional field left empty and matches any shape."""
    if got is None or want is None:
        return
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and \
            not isinstance(got, bool), where
        return
    assert type(got) is type(want), where
    if isinstance(want, dict):
        missing = set(got) - set(want)
        assert not missing, f"{where}: keys the JAX package lacks " \
            f"{sorted(missing)}"
        for k in got:
            assert_shape(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and got and want:
        if isinstance(want[0], dict) and set(want[0]) == _RECORD:
            names = {r["metric"] for r in want}
            extra = {r["metric"] for r in got} - names
            assert not extra, f"{where}: records the JAX package " \
                f"lacks {sorted(extra)}"
            for r in got:
                assert set(r) == set(want[0]), where
        else:
            merged = _merge(want)
            for g in got:
                assert_shape(g, merged, f"{where}[]")


def _merge(items: list):
    """One element holding every key any of ``items`` has (the JAX
    package's records differ in which stats they carry); lists merge
    into one list of all their elements."""
    items = [i for i in items if i is not None]
    if not items:
        return None
    if all(isinstance(i, list) for i in items):
        return [x for i in items for x in i]
    if not all(isinstance(i, dict) for i in items):
        return items[0]
    keys: dict = {}
    for i in items:
        for k, v in i.items():
            keys.setdefault(k, []).append(v)
    return {k: _merge(vs) for k, vs in keys.items()}


def compare(kind: str, got, want, params: dict) -> None:
    assert got.status == want.status, (got.body[:400], want.body[:400])
    if kind == "bytes":
        assert got.body == want.body
    elif kind == "query":
        if want.status != 200:
            assert got.body == want.body
        else:
            want_rows = _unwrap(want.body, params)
            assert want_rows, "the reference answered no rows"
            assert_query_close(_unwrap(got.body, params), want_rows)
    else:
        assert_shape(json.loads(got.body), json.loads(want.body))


# -- the table -----------------------------------------------------------

W = {"start": T0, "end": END}
DC = f"sum:5m-avg:{CPU}{{dc=*}}"
REQUESTS = [
    # (id, kind, method, path, body, params)
    # URI form
    ("uri-groupby", "query", "GET", "/api/query", None,
     {**W, "m": DC}),
    ("uri-rate", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:5m-avg:rate:{CPU}{{dc=*}}"}),
    ("uri-rack", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:5m-avg:rate:{CPU}{{rack=*}}"}),
    ("uri-no-downsample", "query", "GET", "/api/query", None,
     {**W, "m": f"avg:{CPU}{{host=h01|h03|h05}}"}),
    ("uri-arrays", "query", "GET", "/api/query", None,
     {**W, "m": f"max:10m-max:{CPU}", "arrays": "true"}),
    ("uri-ms", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:5m-sum:{CPU}{{dc=*}}", "ms": "true"}),
    ("uri-summary", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:15m-avg:{CPU}", "show_summary": "true"}),
    ("uri-show-query", "query", "GET", "/api/query", None,
     {**W, "m": DC, "show_query": "true"}),
    ("uri-jsonp", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:10m-avg:{CPU}", "jsonp": "cb"}),
    ("uri-dedupe", "query", "GET", "/api/query", None,
     {**W, "m": [DC, DC, f"min:5m-min:{CPU}{{dc=*}}"]}),
    ("uri-two-tagsets", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:5m-avg:{CPU}{{dc=*}}{{rack=r1}}"}),
    ("uri-none", "query", "GET", "/api/query", None,
     {**W, "m": f"none:{CPU}{{host=h03}}"}),
    ("uri-count", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:1m-count:{NET}{{host=*}}"}),
    ("uri-counter", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:rate{{counter}}:{NET}{{dc=*}}"}),
    ("uri-calendar-tz", "query", "GET", "/api/query", None,
     {**W, "m": f"avg:30m-avg:{CPU}", "tz": "America/New_York",
      "use_calendar": "true"}),
    ("uri-v1", "query", "GET", "/api/v1/query", None, {**W, "m": DC}),
    ("uri-explicit", "query", "GET", "/api/query", None,
     {**W, "m": f"sum:explicit_tags:5m-avg:{CPU}"
      "{host=*,dc=*,rack=*}"}),
    # JSON form
    ("post-filters", "query", "POST", "/api/query",
     {"start": T0, "end": END, "msResolution": True, "queries": [
         {"aggregator": "sum", "metric": CPU, "downsample": "5m-avg",
          "filters": [{"type": "wildcard", "tagk": "host",
                       "filter": "h0*", "groupBy": True}]}]}, {}),
    ("post-tsuids", "query", "POST", "/api/query",
     {"start": T0, "end": END, "showTSUIDs": True, "queries": [
         {"aggregator": "avg", "metric": CPU, "downsample": "10m-avg",
          "tags": {"dc": "dc1"}}]}, {}),
    ("post-summary-stats", "query", "POST", "/api/query",
     {"start": T0, "end": END, "showSummary": True, "showStats": True,
      "queries": [{"aggregator": "sum", "metric": CPU,
                   "downsample": "10m-sum", "tags": {"dc": "*"}}]}, {}),
    ("post-arrays-two-subs", "query", "POST", "/api/query",
     {"start": T0, "end": END, "queries": [
         {"aggregator": "max", "metric": NET, "downsample": "5m-max"},
         {"aggregator": "sum", "metric": CPU, "downsample": "5m-avg",
          "rate": True, "tags": {"rack": "*"}}]}, {"arrays": "true"}),
    ("post-show-query", "query", "POST", "/api/query",
     {"start": T0, "end": END, "showQuery": True, "queries": [
         {"aggregator": "sum", "metric": NET, "rate": True,
          "rateOptions": {"counter": True, "resetValue": 10},
          "downsample": "5m-avg", "tags": {"host": "*"}}]}, {}),
    # error probes
    ("bad-aggregator", "bytes", "GET", "/api/query", None,
     {**W, "m": f"foo:{CPU}"}),
    ("bad-downsample", "bytes", "GET", "/api/query", None,
     {**W, "m": f"sum:5m-foo:{CPU}"}),
    ("unknown-metric", "bytes", "GET", "/api/query", None,
     {**W, "m": "sum:no.such.metric"}),
    ("no-start", "bytes", "GET", "/api/query", None, {"m": DC}),
    ("end-before-start", "bytes", "GET", "/api/query", None,
     {"start": END, "end": T0, "m": DC}),
    ("no-queries", "bytes", "GET", "/api/query", None, W),
    ("bad-m", "bytes", "GET", "/api/query", None, {**W, "m": "sum"}),
    ("non-json-body", "bytes", "POST", "/api/query", b"{not json", {}),
    ("json-array-body", "bytes", "POST", "/api/query", b"[1, 2]", {}),
    ("bad-filter-type", "bytes", "POST", "/api/query",
     {"start": T0, "queries": [{"aggregator": "sum", "metric": CPU,
                                "filters": [{"type": "nope",
                                             "tagk": "host",
                                             "filter": "x"}]}]}, {}),
    ("delete-refused", "bytes", "DELETE", "/api/query", None,
     {**W, "m": DC}),
    ("put-method", "bytes", "PUT", "/api/query", None, {**W, "m": DC}),
    ("api-v2", "bytes", "GET", "/api/v2/version", None, {}),
    ("api-missing-endpoint", "bytes", "GET", "/api", None, {}),
    ("unknown-api-endpoint", "bytes", "GET", "/api/nonexistent", None,
     {}),
    ("unknown-path", "bytes", "GET", "/nonexistent", None, {}),
    ("bad-serializer", "bytes", "GET", "/api/aggregators", None,
     {"serializer": "nope"}),
    ("method-override-bad", "bytes", "GET", "/api/query", None,
     {"method_override": "bogus"}),
    ("method-override-empty", "bytes", "GET", "/api/query", None,
     {"method_override": ""}),
    ("jsonp-error", "bytes", "GET", "/api/query", None,
     {**W, "m": f"foo:{CPU}", "jsonp": "cb"}),
    # non-query bodies
    ("suggest-metrics", "bytes", "GET", "/api/suggest", None,
     {"type": "metrics", "q": "sys"}),
    ("suggest-tagv-max", "bytes", "GET", "/api/suggest", None,
     {"type": "tagv", "q": "", "max": 3}),
    ("suggest-tagk-prefix", "bytes", "GET", "/api/suggest", None,
     {"type": "tagk", "q": "r"}),
    ("suggest-bad-type", "bytes", "GET", "/api/suggest", None,
     {"type": "bogus"}),
    ("suggest-post", "bytes", "POST", "/api/suggest",
     {"type": "tagv", "q": "h0", "max": 4}, {}),
    ("suggest-post-bad-max", "bytes", "POST", "/api/suggest",
     {"type": "tagv", "max": "x"}, {}),
    ("aggregators", "bytes", "GET", "/api/aggregators", None, {}),
    ("aggregators-legacy", "bytes", "GET", "/aggregators", None, {}),
    ("aggregators-jsonp", "bytes", "GET", "/api/aggregators", None,
     {"jsonp": "cb"}),
    ("config-filters", "bytes", "GET", "/api/config/filters", None, {}),
    ("serializers", "bytes", "GET", "/api/serializers", None, {}),
    ("dropcaches", "bytes", "GET", "/api/dropcaches", None, {}),
    ("serializer-json", "bytes", "GET", "/api/aggregators", None,
     {"serializer": "json"}),
    ("favicon", "bytes", "GET", "/favicon.ico", None, {}),
    ("diediedie-no-server", "bytes", "GET", "/diediedie", None, {}),
    # bodies that describe each package
    ("version", "shape", "GET", "/api/version", None, {}),
    ("version-legacy", "shape", "GET", "/version", None, {}),
    ("config", "shape", "GET", "/api/config", None, {}),
    ("stats", "shape", "GET", "/api/stats", None, {}),
    ("stats-legacy", "shape", "GET", "/stats", None, {}),
    ("stats-query", "shape", "GET", "/api/stats/query", None, {}),
    ("stats-jvm", "shape", "GET", "/api/stats/jvm", None, {}),
    ("stats-threads", "shape", "GET", "/api/stats/threads", None, {}),
    ("stats-region-clients", "shape", "GET",
     "/api/stats/region_clients", None, {}),
]


@pytest.mark.parametrize("rid,kind,method,path,body,params", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
def test_request(routers, rid, kind, method, path, body, params):
    jr, pr = routers
    if kind == "shape":
        # a query first, so the stats lists and counters hold something
        send_both(jr, pr, "GET", "/api/query", **W, m=DC)
    got, want = send_both(jr, pr, method, path, body, **params)
    compare(kind, got, want, params)


def test_query_stats_record_the_query(routers):
    """A query's stats appear in /api/stats/query on both sides with
    the same scan counts."""
    jr, pr = routers
    m = f"sum:10m-avg:{CPU}{{host=h0*}}"
    send_both(jr, pr, "GET", "/api/query", **W, m=m)
    got, want = send_both(jr, pr, "GET", "/api/stats/query")

    def last(resp):
        done = json.loads(resp.body)["completed"]
        return next(q for q in reversed(done)
                    if q["query"]["queries"][0]["metric"] == CPU
                    and q["query"]["queries"][0]["downsample"] == "10m-avg"
                    and q["query"]["queries"][0]["filters"][0]["filter"]
                    == "h0*")

    g, w = last(got), last(want)
    assert g["executed"] and w["executed"]
    for key in ("rowsPreFilter", "rowsPostFilter", "emittedDPs",
                "columnsFromStorage", "rowsFromStorage",
                "bytesFromStorage", "uidPairsResolved"):
        assert g["stats"][key] == w["stats"][key], key
    assert g["query"] == {k: v for k, v in w["query"].items()
                          if k in g["query"]}


# -- puts --------------------------------------------------------------

def _dp(metric="put.m", ts=T0, value=1, tags=None, drop=()):
    dp = {"metric": metric, "timestamp": ts, "value": value,
          "tags": {"host": "a"} if tags is None else tags}
    for k in drop:
        dp.pop(k)
    return dp


PUTS = [
    ("single", [_dp(value=42)], {}),
    ("batch-details", [_dp(ts=T0 + 60 * i, value=i) for i in range(10)]
     + [_dp(metric="bad metric!")], {"details": "true"}),
    ("summary", [_dp(), _dp(ts=T0 + 60, value=2.5)], {"summary": "true"}),
    ("errors-no-details", [_dp(), _dp(tags={})], {}),
    ("string-values", [_dp(value="4.5"), _dp(ts=T0 + 60, value="7"),
                       _dp(ts=T0 + 120, value="1_0"),
                       _dp(ts=T0 + 180, value=" 3")], {"details": ""}),
    ("bad-values", [_dp(value=None), _dp(value=True),
                    _dp(value=[1]), _dp(value="nan")], {"details": ""}),
    ("missing-fields", [_dp(drop=("metric",)), _dp(drop=("timestamp",)),
                        _dp(drop=("value",)), _dp(drop=("tags",))],
     {"details": ""}),
    ("bad-timestamps", [_dp(ts="abc"), _dp(ts=-5), _dp(ts=0),
                        _dp(ts=2**48), _dp(ts=(T0 + 30) * 1000)],
     {"details": ""}),
    ("bad-tags", [_dp(tags={"bad key": "v"}), _dp(tags={"k": "bad v!"}),
                  _dp(tags={f"k{i}": "v" for i in range(9)})],
     {"details": ""}),
    ("many-series", [_dp(tags={"host": f"h{i}", "dc": f"d{i % 2}"},
                         ts=T0 + 60 * j, value=i * 100 + j)
                     for i in range(6) for j in range(12)], {}),
    ("single-object", _dp(value=3), {"summary": ""}),
    ("not-json", b"{nope", {}),
    ("json-scalar", b"42", {"details": ""}),
    ("empty-body", b"", {}),
]


@pytest.fixture
def fresh_routers():
    jt, tt = make_pair(ENGINE_KEYS, {})
    yield JRouter(jt), HttpRpcRouter(tt)
    close_pair(jt, tt)


@pytest.mark.parametrize("pid,body,params", PUTS,
                         ids=[p[0] for p in PUTS])
def test_put(fresh_routers, pid, body, params):
    """The same status and body for a put, then the same data read
    back through both."""
    jr, pr = fresh_routers
    got, want = send_both(jr, pr, "POST", "/api/put", body, **params)
    compare("bytes", got, want, params)
    got, want = send_both(jr, pr, "GET", "/api/query", start=T0 - 1,
                          end=T0 + 3600, m="none:put.m{host=*}",
                          ms="true")
    compare("query", got, want, {})


def test_put_get_rejected(fresh_routers):
    got, want = send_both(*fresh_routers, "GET", "/api/put")
    compare("bytes", got, want, {})


# -- rollup points (/api/rollup) ---------------------------------------

ROLLUP_ON = {"tsd.rollups.enable": "true"}


def _rdp(ts=T0, value=60, interval="1m", agg="sum", host="a", **extra):
    dp = {"metric": "roll.m", "timestamp": ts, "value": value,
          "tags": {"host": host}, "interval": interval, "aggregator": agg}
    dp.update(extra)
    return {k: v for k, v in dp.items() if v is not None}


ROLLUP_PUTS = [
    ("tier", [_rdp(agg="SUM")], {}),
    ("batch-details",
     [_rdp(ts=T0 + 60 * i, value=i * 60, agg=a, host=h)
      for i in range(10) for a in ("sum", "count") for h in ("a", "b")]
     + [_rdp(interval="9m")], {"details": "true"}),
    ("summary", [_rdp(), _rdp(ts=T0 + 60, value=2.5, agg="max")],
     {"summary": "true"}),
    ("errors-no-details", [_rdp(), _rdp(agg=None), _rdp(agg="p99")], {}),
    ("string-values", [_rdp(value="4.5"), _rdp(ts=T0 + 60, value="1_0"),
                       _rdp(ts=T0 + 120, value="nan"),
                       _rdp(ts=T0 + 180, value=" 3")], {"details": ""}),
    ("preagg", [_rdp(interval=None, agg=None, groupByAggregator="sum"),
                _rdp(groupByAggregator="max", agg="count"),
                _rdp(interval=None, agg=None, isGroupBy=True)],
     {"details": ""}),
    ("missing-fields", [{"metric": "roll.m", "timestamp": T0,
                         "interval": "1m", "aggregator": "sum"},
                        {"timestamp": T0, "value": 1, "tags": {"h": "a"},
                         "interval": "1m", "aggregator": "sum"},
                        _rdp(ts=None)], {"details": ""}),
    ("bad-timestamps", [_rdp(ts="abc"), _rdp(ts=(T0 + 30) * 1000),
                        _rdp(ts=str(T0 + 600))], {"details": ""}),
    ("bad-names", [_rdp(host="bad v!"), {**_rdp(), "metric": "bad m!"},
                   {**_rdp(), "tags": {}}], {"details": ""}),
    ("single-object", _rdp(value=3), {"summary": ""}),
    ("not-json", b"{nope", {}),
    ("empty-body", b"", {}),
]


@pytest.fixture
def rollup_routers():
    jt, tt = make_pair({**ENGINE_KEYS, **ROLLUP_ON}, {})
    yield JRouter(jt), HttpRpcRouter(tt)
    close_pair(jt, tt)


@pytest.mark.parametrize("pid,body,params", ROLLUP_PUTS,
                         ids=[p[0] for p in ROLLUP_PUTS])
def test_rollup_put(rollup_routers, pid, body, params):
    """``/api/rollup``: the same status and body as the reference's,
    then the tiers read back through both."""
    jr, pr = rollup_routers
    got, want = send_both(jr, pr, "POST", "/api/rollup", body, **params)
    compare("bytes", got, want, params)
    for m in ("sum:1m-sum:roll.m{host=*}", "sum:1m-avg:roll.m",
              "max:1h-max:roll.m{host=*}", "sum:5m-count:roll.m"):
        got, want = send_both(jr, pr, "GET", "/api/query", start=T0 - 1,
                              end=T0 + 3600, m=m, ms="true")
        assert got.status == want.status
        if want.status != 200:
            assert got.body == want.body
        else:
            assert_query_close(json.loads(got.body), json.loads(want.body))


@pytest.mark.parametrize("method", ["GET", "PUT"])
def test_rollup_put_method(rollup_routers, method):
    got, want = send_both(*rollup_routers, method, "/api/rollup",
                          [_rdp()])
    compare("bytes", got, want, {})


def test_rollup_put_with_rollups_off(fresh_routers):
    """Rollups off: each point fails with the reference's error."""
    got, want = send_both(*fresh_routers, "POST", "/api/rollup",
                          [_rdp(), _rdp(agg="count")], details="")
    compare("bytes", got, want, {})
    assert b"rollups are not enabled" in got.body


def test_rollup_put_is_one_wal_write(tmp_path):
    """A body's records land as one WAL write with one fsync."""
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{**COMMON, **ROLLUP_ON,
                       "tsd.storage.data_dir": str(tmp_path)}))
    # armed with a schedule that never fails: a counter of fsyncs
    t.faults.arm("wal.fsync")
    site = t.faults._sites["wal.fsync"]
    before = site.calls
    body = [_rdp(ts=T0 + 60 * i) for i in range(50)]
    resp = HttpRpcRouter(t).handle(HttpRequest(
        method="POST", path="/api/rollup", body=json.dumps(body).encode()))
    assert resp.status == 200
    assert site.calls - before == 1
    t.shutdown()


# -- what is not ported -------------------------------------------------

# every endpoint that answered 501 before the observability layer and
# the control plane were ported, by the id its case has always had; the
# ported ones now answer as the JAX package does
ONCE_UNPORTED = ("/api/cluster", "/api/control", "/api/health",
                 "/api/profile", "/api/stats/fleet",
                 "/api/stats/query_shapes", "/api/stats/raw",
                 "/api/stats/tenants", "/api/trace", "/logs", "/metrics",
                 "/q", "/s/x")


def _unported_paths():
    for name in http_api.UNPORTED:
        if name.startswith("/"):
            yield f"{name}/x" if name == "/s" else name
        else:
            yield f"/api/{name}"


@pytest.fixture(scope="module")
def port_router():
    jt, tt = make_pair(ENGINE_KEYS, {})
    yield JRouter(jt), HttpRpcRouter(tt)
    close_pair(jt, tt)


def test_unported_list_is_what_is_left():
    """What still refuses: graphs and static files (``cluster/``'s admin
    surface and the fleet stats came with the cluster router; on a TSD
    that is not a router they answer the JAX package's 400)."""
    assert set(_unported_paths()) == {"/q", "/s/x"}
    assert set(_unported_paths()) <= set(ONCE_UNPORTED)


@pytest.mark.parametrize("path", ONCE_UNPORTED)
def test_unported_endpoint_answers_501(port_router, path):
    """Every endpoint of the reference's surface that the port lacks
    answers a structured 501 naming the ROADMAP item, never a 404 or
    an empty 200; one the port has ported since answers the status the
    JAX package answers, never a 501."""
    jr, pr = port_router
    resp = pr.handle(HttpRequest(method="GET", path=path))
    if path not in set(_unported_paths()):
        want = jr.handle(JRequest(method="GET", path=path))
        assert resp.status == want.status != 501, resp.body
        return
    assert resp.status == 501
    err = json.loads(resp.body)["error"]
    assert err["code"] == 501
    assert "not ported yet" in err["message"]
    assert "ROADMAP Queue 1" in err["message"]


@pytest.mark.parametrize("method,path", [
    ("GET", "/api/lifecycle"), ("POST", "/api/lifecycle/sweep"),
    ("GET", "/api/lifecycle/sweep"), ("GET", "/api/v1/lifecycle")])
def test_lifecycle_endpoint_equals_reference(method, path):
    """``/api/lifecycle`` is ported: with the lifecycle off both routers
    answer the same 400, with it on the same document (the sweep
    report's clock left out)."""
    from opentsdb_tpu import TSDB as JT, Config as JC
    from opentsdb_tpu_torch import TSDB, Config
    for keys in ({}, {"tsd.lifecycle.enable": "true",
                      "tsd.lifecycle.retention": "1d"}):
        answers = []
        for router, req in (
                (JRouter(JT(JC(**{"tsd.tpu.platform": "cpu", **keys}))),
                 JRequest),
                (HttpRpcRouter(TSDB(Config(**{"tsd.torch.device": "cpu",
                                              **keys}))), HttpRequest)):
            resp = router.handle(req(method=method, path=path))
            doc = json.loads(resp.body)
            for part in (doc, doc.get("counters", {})):
                for clock in ("durationMs", "lastSweepDurationMs",
                              "lastSweepTime"):
                    part.pop(clock, None)
            answers.append((resp.status, doc))
        assert answers[1] == answers[0]


def test_mode_gating():
    """A read-only TSD does not route puts; a write-only one does not
    route queries (404, as the reference)."""
    from opentsdb_tpu_torch import TSDB, Config
    for mode, path in (("ro", "/api/put"), ("wo", "/api/query"),
                       ("wo", "/api/search")):
        t = TSDB(Config(**{"tsd.torch.device": "cpu", "tsd.mode": mode}))
        resp = HttpRpcRouter(t).handle(HttpRequest(method="POST",
                                                   path=path))
        assert resp.status == 404, (mode, path)


def test_show_stack_trace():
    """A fault inside a handler is a 500; its stack trace rides the
    body only under tsd.http.show_stack_trace."""
    from opentsdb_tpu_torch import TSDB, Config
    for show in ("false", "true"):
        t = TSDB(Config(**{"tsd.torch.device": "cpu",
                           "tsd.http.show_stack_trace": show}))

        def boom(*a):
            raise RuntimeError("device fault")

        t.new_query = boom
        resp = HttpRpcRouter(t).handle(HttpRequest(
            method="GET", path="/api/query",
            params=_params({**W, "m": "sum:x"})))
        err = json.loads(resp.body)["error"]
        assert resp.status == 500
        assert err["message"] == "RuntimeError: device fault"
        assert ("Traceback" in err.get("details", "")) == (show == "true")
