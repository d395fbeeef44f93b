"""Tsuid sub-queries and ``delete=true`` against the JAX package's.

- tsuids: sub-queries naming series by tsuid (JSON ``tsuids`` and the
  URI ``tsuids=``), on the point and grid paths, 1 to 100 tsuids, the
  per-series ``none`` aggregator, a tsuid with no series, mixed
  metrics (400), answered as the reference's engine and HTTP router
  answer them;
- delete: a ``delete=true`` query answers what it read and removes
  it, on the point path (cold and from a warm prepared batch), the
  grid path and the rollup avg path, read back through both packages;
  multi-sub deletes run serially; the front end's
  ``tsd.http.query.allow_delete`` gate;
- durability (ROADMAP Queue 3): neither package logs a delete in its
  WAL, so a restart on a ``data_dir`` before the next snapshot replays
  the deleted points back; after a flush they stay deleted. Pinned on
  both packages and across them.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from torch_pair import (T0, JQuery, TSQuery, assert_rows_close, port_tsdb,
                        reference_tsdb, rows, run_both)

S, P = 120, 60
KEYS = {"tsd.core.auto_create_metrics": "true",
        "tsd.query.cache.enable": "false"}
POINT = {"tsd.query.grid_reduce": "false"}
HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}


def _metrics() -> dict:
    rng = np.random.default_rng(31)
    tags = [{"host": f"h{i:03d}", "dc": f"dc{i % 4}"} for i in range(S)]
    ts2d = T0 + 60 * np.arange(P, dtype=np.int64)[None, :].repeat(S, 0)
    vals = rng.normal(20.0, 4.0, (S, P))
    other = rng.normal(1.0, 0.1, (4, P))
    return {"m": (tags, ts2d, vals, np.full(S, P)),
            "o": (tags[:4], ts2d[:4], other, np.full(4, P))}


def _pair(keys: dict):
    metrics = _metrics()
    jt = reference_tsdb(metrics, {**KEYS, **keys})
    return jt, port_tsdb(jt, metrics, {**KEYS, **keys})


@pytest.fixture(scope="module", params=["point", "defaults", "device"])
def pair(request):
    keys = {"point": POINT, "defaults": {},
            "device": HOST_TAIL_OFF}[request.param]
    jt, tt = _pair(keys)
    yield jt, tt
    jt.shutdown()
    tt.shutdown()


def _tsuids(t, metric: str, idx) -> list[str]:
    """The tsuid hex of series ``h<i>`` of ``metric`` in ``t``."""
    uids = t.uids
    mid = uids.metrics.get_id(metric)
    return [uids.tsuid(mid, [
        (uids.tag_names.get_id("host"), uids.tag_values.get_id(f"h{i:03d}")),
        (uids.tag_names.get_id("dc"), uids.tag_values.get_id(f"dc{i % 4}"))
    ]).hex().upper() for i in idx]


def _query(subs, start=T0, end=T0 + P * 60 - 1, **top) -> dict:
    return {"start": str(start), "end": str(end), "queries": subs, **top}


@pytest.mark.parametrize("n,agg,ds", [
    (1, "sum", None), (3, "sum", None), (100, "sum", None),
    (100, "sum", "5m-avg"), (7, "none", None), (7, "p99", "10m-max"),
    (20, "avg", "1m-sum"), (12, "dev", None)])
def test_tsuid_subquery_equals_reference(pair, n, agg, ds):
    """The tsuids name the same series in both packages; the rows carry
    the metric and the tsuids of their members, as the reference's."""
    jt, tt = pair
    ids = [(3 + 7 * k) % S for k in range(n)]
    tsuids = _tsuids(jt, "m", ids)
    assert _tsuids(tt, "m", ids) == tsuids
    sub = {"aggregator": agg, "tsuids": tsuids}
    if ds:
        sub["downsample"] = ds
    got = run_both(jt, tt, _query([sub]))
    assert {r[0] for r in got} == {"m"}
    want = jt.execute_query(JQuery.from_json(_query([sub])).validate())
    have = tt.execute_query(TSQuery.from_json(_query([sub])).validate())
    assert [r.tsuids for r in have] == [r.tsuids for r in want]
    assert sorted(t for r in have for t in r.tsuids) == sorted(tsuids)


def test_tsuid_edges_as_reference(pair):
    """A tsuid with no series is skipped; tsuids of two metrics are a
    400 with the reference's message; a tsuid sub-query beside a metric
    sub-query keeps its index."""
    jt, tt = pair
    good = _tsuids(jt, "m", [0, 1])
    absent = good[0][:-6] + "FFFFFF"
    run_both(jt, tt, _query([{"aggregator": "sum",
                              "tsuids": good + [absent]}]))
    mixed = _query([{"aggregator": "sum",
                     "tsuids": good + _tsuids(jt, "o", [0])}])
    for db, model in ((jt, JQuery), (tt, TSQuery)):
        with pytest.raises(ValueError, match="Multiple metrics"):
            db.execute_query(model.from_json(mixed).validate())
    got = run_both(jt, tt, _query([
        {"aggregator": "sum", "metric": "o"},
        {"aggregator": "max", "tsuids": good}]))
    assert [r[0] for r in got] == ["o", "m"]


@pytest.mark.parametrize("params", [
    {"tsuids": "sum:{a},{b}"}, {"tsuids": "sum:5m-avg:{a}"},
    {"tsuids": "sum:rate:{a},{b}", "m": "max:o"},
    {"tsuids": "sum:{a}", "show_tsuids": "true"}, {"tsuids": "sum:"},
    {"tsuids": "sum:{a}:x:y:z:w"}])
def test_uri_tsuids_through_both_routers(pair, params):
    jt, tt = pair
    a, b = _tsuids(jt, "m", [5, 9])
    prm = {"start": [str(T0)], "end": [str(T0 + P * 60 - 1)]}
    prm.update({k: [v.format(a=a, b=b)] for k, v in params.items()})
    want = JRouter(jt).handle(JRequest("GET", "/api/query", prm, {}, b""))
    got = HttpRpcRouter(tt).handle(HttpRequest("GET", "/api/query", prm,
                                               {}, b""))
    assert got.status == want.status
    if want.status != 200:
        assert got.body == want.body
        return
    g, w = json.loads(got.body), json.loads(want.body)
    assert [(r["metric"], r["tags"], r.get("tsuids")) for r in g] == \
        [(r["metric"], r["tags"], r.get("tsuids")) for r in w]
    for gr, wr in zip(g, w):
        assert list(gr["dps"]) == list(wr["dps"])
        np.testing.assert_allclose(list(gr["dps"].values()),
                                   list(wr["dps"].values()), rtol=1e-9)


# -- delete=true ----------------------------------------------------------------

def _read_back(jt, tt, m="sum:m{dc=*}"):
    from torch_pair import uri_query
    return run_both(jt, tt, uri_query(m, T0, T0 + P * 60 - 1))


@pytest.mark.parametrize("path,keys", [
    ("point", POINT), ("grid", {}), ("grid-device", HOST_TAIL_OFF),
    ("point-device", {**POINT, **HOST_TAIL_OFF})])
@pytest.mark.parametrize("warm", [False, True])
def test_delete_then_read_back(path, keys, warm):
    """A ``delete=true`` sub-query over dc1 and a half-hour answers the
    points it read (as the reference), and both packages then read the
    same remaining data: dc1 keeps only the other half-hour. ``warm``
    first fills the caches with the same query, so the delete runs from
    a warm prepared batch or grid."""
    jt, tt = _pair(keys)
    half = T0 + 1799
    q = _query([{"aggregator": "sum", "metric": "m",
                 "downsample": "1m-avg" if "grid" in path else None,
                 "tags": {"dc": "dc1"}}], end=half)
    q["queries"][0] = {k: v for k, v in q["queries"][0].items()
                       if v is not None}
    if warm:
        run_both(jt, tt, q)
    deleted = run_both(jt, tt, {**q, "delete": True})
    assert len(deleted[0][3]) == 30
    after = _read_back(jt, tt)
    dc1 = next(r for r in after if r[1].get("dc") == "dc1")
    assert dc1[3][0] == (T0 + 1800) * 1000
    run_both(jt, tt, _query([{"aggregator": "none", "metric": "m",
                              "tags": {"host": "h001"}}]))
    mid = tt.uids.metrics.get_id("m")
    assert tt.store.count_range(tt.store.series_ids_for_metric(mid),
                                T0 * 1000, half * 1000).sum() == \
        (S - S // 4) * 30
    jt.shutdown()
    tt.shutdown()


def test_multi_sub_delete_is_serial_and_equal():
    """Two sub-queries of one delete run one after another in both: the
    second finds the window the first deleted empty."""
    jt, tt = _pair(POINT)
    q = _query([{"aggregator": "sum", "metric": "m"},
                {"aggregator": "max", "metric": "m"}], delete=True)
    got = run_both(jt, tt, q)
    assert len(got) == 1
    assert tt.execute_query(TSQuery.from_json(
        {k: v for k, v in q.items() if k != "delete"}).validate()) == []
    jt.shutdown()
    tt.shutdown()


def test_avg_rollup_delete_reads_back_as_reference():
    """The avg path deletes both tiers' points of the window (ref:
    ``_avg_rollup_pipeline``'s delete of the sum and the aligned count
    series); the raw store keeps its points."""
    from opentsdb_tpu.rollup.job import run_rollup_job as jjob
    from opentsdb_tpu_torch.rollup.job import run_rollup_job as tjob
    keys = {**KEYS, "tsd.rollups.enable": "true"}
    dbs = [JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"})),
           TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"}))]
    for t, job in zip(dbs, (jjob, tjob)):
        for i in range(240):
            t.add_point("r.m", T0 + i * 15, float(i % 11),
                        {"host": "a" if i % 3 else "b"})
        job(t, T0 * 1000, (T0 + 3600) * 1000)
    q = {"start": T0 * 1000, "end": (T0 + 1799) * 1000,
         "queries": [{"aggregator": "sum", "metric": "r.m",
                      "downsample": "1m-avg"}]}
    out = [rows(t.execute_query(M.from_json({**q, "delete": True})
                                .validate()))
           for t, M in zip(dbs, (JQuery, TSQuery))]
    assert_rows_close(out[1], out[0])
    after = [rows(t.execute_query(M.from_json(q).validate()))
             for t, M in zip(dbs, (JQuery, TSQuery))]
    assert after[0] == after[1] == []
    raw = {**q, "queries": [{**q["queries"][0],
                             "rollupUsage": "ROLLUP_RAW"}]}
    got = [rows(t.execute_query(M.from_json(raw).validate()))
           for t, M in zip(dbs, (JQuery, TSQuery))]
    assert_rows_close(got[1], got[0])
    for t in dbs:
        t.shutdown()


@pytest.mark.parametrize("allow", ["false", "true"])
@pytest.mark.parametrize("how", ["DELETE", "POST"])
def test_http_delete_gate_as_reference(allow, how):
    """``tsd.http.query.allow_delete``: off, a DELETE or a
    ``"delete": true`` body is the reference's 400; on, both answer the
    rows and delete them."""
    jt, tt = _pair({**POINT, "tsd.http.query.allow_delete": allow})
    w = {"start": [str(T0)], "end": [str(T0 + 599)]}
    body = b""
    if how == "DELETE":
        prm = {**w, "m": ["sum:m{dc=dc2}"]}
    else:
        prm = {}
        body = json.dumps({"start": T0, "end": T0 + 599, "delete": True,
                           "queries": [{"aggregator": "sum", "metric": "m",
                                        "tags": {"dc": "dc2"}}]}).encode()
    want = JRouter(jt).handle(JRequest(how, "/api/query", prm, {}, body))
    got = HttpRpcRouter(tt).handle(HttpRequest(how, "/api/query", prm, {},
                                               body))
    assert got.status == want.status == (200 if allow == "true" else 400)
    if allow == "false":
        assert got.body == want.body
    else:
        g, wj = json.loads(got.body), json.loads(want.body)
        assert list(g[0]["dps"]) == list(wj[0]["dps"])
        after = _read_back(jt, tt, "sum:m{dc=dc2}")
        assert after[0][3][0] == (T0 + 600) * 1000
    jt.shutdown()
    tt.shutdown()


# -- durability ------------------------------------------------------------------

def _durable(kind: str, path):
    keys = {**KEYS, **POINT, "tsd.storage.data_dir": str(path)}
    if kind == "jax":
        return JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"}))
    return TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"}))


def _count(t, start, end) -> int:
    model = TSQuery if isinstance(t, TSDB) else JQuery
    out = t.execute_query(model.from_json({
        "start": start * 1000, "end": end * 1000,
        "queries": [{"aggregator": "none", "metric": "d.m"}]}).validate())
    return sum(len(r.dps) for r in out)


@pytest.mark.parametrize("writer,reader", [
    ("jax", "jax"), ("port", "port"), ("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("flushed", [False, True])
def test_delete_durability_follows_the_snapshot(tmp_path, writer, reader,
                                                flushed):
    """ROADMAP Queue 3: no WAL record stands for a delete in either
    package. Write 3 series x 20 points, delete the first 10 minutes by
    a query, then stop without a flush (the log closed, as after a
    kill): the restart replays the log and the 30 deleted points come
    back, in both packages. With a flush between the delete and the
    stop, the snapshot holds the delete and they stay gone."""
    w = _durable(writer, tmp_path)
    for h in range(3):
        for i in range(20):
            w.add_point("d.m", T0 + 60 * i, float(i), {"host": f"h{h}"})
    model = TSQuery if writer == "port" else JQuery
    w.execute_query(model.from_json({
        "start": T0 * 1000, "end": (T0 + 599) * 1000, "delete": True,
        "queries": [{"aggregator": "sum", "metric": "d.m"}]}).validate())
    assert _count(w, T0, T0 + 1199) == 30
    if flushed:
        w.flush()
    w.wal.close()
    r = _durable(reader, tmp_path)
    assert _count(r, T0, T0 + 1199) == (30 if flushed else 60)
    assert _count(r, T0 + 600, T0 + 1199) == 30
    r.wal.close()
