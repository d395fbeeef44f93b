"""The port's lookups (``opentsdb_tpu_torch/search/lookup.py``), UID
endpoints and annotated queries against the JAX package's, on the CPU.

- The 14 lookup and last-point cases of ``tests/test_search_graph.py``
  (``time_series_lookup``, ``last_data_points``), each run on both
  packages, each also asserting what that file asserts.
- ``/api/search/lookup`` (GET and POST), the search plugin's own types,
  ``/api/query/last`` (GET and POST), ``/api/uid/assign`` and
  ``/api/uid/rename``: status, body and headers equal through both
  routers.
- Annotated queries through the port's point path, with
  ``torch_pair.ENGINE_KEYS`` pinned (no cache on either side): each
  group's ``annotations`` and ``globalAnnotations`` equal the
  reference's, the values equal (``torch_pair.assert_rows_close``:
  rtol 1e-9), and ``noAnnotations`` leaves them out. With the caches
  on, a repeat after ``POST /api/annotation`` carries the new note:
  from the result cache's version and from the prepared-batch cache.

Tolerance: none for names, TSUIDs, annotations and JSON; values as
``torch_pair.assert_rows_close``.
"""

import json

import numpy as np
import pytest

from torch_meta_pair import (JAX, PORT, T0, answer, both, call, request,
                             router, tsdb, tsuid_of)
from torch_pair import (ENGINE_KEYS, assert_rows_close, irregular,
                        port_tsdb, reference_tsdb, rows)

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def seeded(side):
    t = tsdb(side)
    t.add_point("sys.cpu", T0, 1, {"host": "web01", "dc": "lax"})
    t.add_point("sys.cpu", T0 + 60, 2, {"host": "web01", "dc": "lax"})
    t.add_point("sys.cpu", T0, 3, {"host": "web02", "dc": "sjc"})
    t.add_point("sys.mem", T0, 4, {"host": "web01"})
    return t


def _lookup(side, metric, tags, **kw):
    return side.lookup.time_series_lookup(seeded(side), metric, tags, **kw)


@case
def by_metric(side):
    out = _lookup(side, "sys.cpu", [])
    assert out["totalResults"] == 2
    return out


@case
def all_metrics_star(side):
    out = _lookup(side, "*", [])
    assert out["totalResults"] == 3
    return out


@case
def tag_pair_constraint(side):
    out = _lookup(side, "*", [("host", "web01")])
    assert out["totalResults"] == 2
    return out


@case
def tagk_only(side):
    out = _lookup(side, "*", [("dc", "*")])
    assert out["totalResults"] == 2
    return out


@case
def tagv_only(side):
    out = _lookup(side, "*", [("*", "sjc")])
    assert out["results"][0]["tags"]["host"] == "web02"
    return out


@case
def limit_caps_results_not_total(side):
    out = _lookup(side, "*", [], limit=1)
    assert len(out["results"]) == 1 and out["totalResults"] == 3
    return out


@case
def unknown_names_empty(side):
    out = (_lookup(side, "no.such", []), _lookup(side, "*", [("nope", "x")]))
    assert out[0]["totalResults"] == out[1]["totalResults"] == 0
    return out


@case
def tsuid_resolvable(side):
    t = seeded(side)
    tsuid = side.lookup.time_series_lookup(t, "sys.mem", [])[
        "results"][0]["tsuid"]
    resolve = getattr(side.lookup, "sid_from_tsuid", None) or \
        side.lookup._sid_from_tsuid
    sid, metric = resolve(t, tsuid)
    assert sid is not None and metric == "sys.mem"
    return tsuid, sid, metric


def _last(side, specs, **kw):
    return side.lookup.last_data_points(seeded(side), specs, **kw)


@case
def by_metric_and_tags(side):
    out = _last(side, [{"metric": "sys.cpu{host=web01}"}])
    assert out[0]["timestamp"] == (T0 + 60) * 1000 and out[0]["value"] == "2"
    return out


@case
def by_metric_all_series(side):
    out = _last(side, [{"metric": "sys.cpu"}])
    assert len(out) == 2
    return out


@case
def by_tsuid(side):
    t = seeded(side)
    tsuid = side.lookup.time_series_lookup(t, "sys.mem", [])[
        "results"][0]["tsuid"]
    out = side.lookup.last_data_points(t, [{"tsuids": [tsuid]}])
    assert len(out) == 1 and out[0]["value"] == "4"
    return out


@case
def no_resolve(side):
    out = _last(side, [{"metric": "sys.mem"}], resolve=False)
    assert "metric" not in out[0] and "tags" not in out[0]
    return out


@case
def unknown_metric_skipped(side):
    out = _last(side, [{"metric": "no.such"}])
    assert out == []
    return out


@case
def float_value_string(side):
    t = tsdb(side)
    t.add_point("f.metric", T0, 1.5, {"host": "a"})
    out = side.lookup.last_data_points(t, [{"metric": "f.metric"}])
    assert out[0]["value"] == "1.5"
    return out


def test_every_reference_case_is_here():
    assert len(CASES) == 14


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_case_equals_reference(name):
    got, want = both(CASES[name])
    assert got == want


# -- the endpoints ------------------------------------------------------------

class EchoSearch:
    """A search plugin of either package: echoes its query."""

    def execute_query(self, query_type, query):
        return {"type": query_type, "query": query, "results": []}


def _search_rpcs(side):
    t = seeded(side)
    out = [
        call(side, t, "GET", "/api/search/lookup",
             params={"m": "sys.cpu{host=web01}"}),
        call(side, t, "GET", "/api/search/lookup",
             params={"m": "*{dc=*}", "limit": 1}),
        call(side, t, "POST", "/api/search/lookup",
             body={"metric": "sys.cpu", "tags": [{"key": "dc",
                                                  "value": "sjc"}]}),
        call(side, t, "POST", "/api/search/lookup", body={"metric": 3}),
        call(side, t, "POST", "/api/search/lookup", body={"tags": [1]}),
        call(side, t, "POST", "/api/search/tsmeta", body={"query": "x"}),
    ]
    t.search_plugin = EchoSearch()
    out.append(call(side, t, "POST", "/api/search/tsmeta",
                    body={"query": "name:sys*"}))
    tsuid = tsuid_of(t, "sys.mem", {"host": "web01"})
    out += [
        call(side, t, "GET", "/api/query/last",
             params={"timeseries": "sys.cpu{host=web02}", "resolve": ""}),
        call(side, t, "GET", "/api/query/last",
             params={"timeseries": "sys.cpu", "back_scan": 1}),
        call(side, t, "POST", "/api/query/last",
             body={"queries": [{"metric": "sys.cpu"},
                               {"tsuids": [tsuid, "0000FF000001000001"]}],
                   "resolveNames": True}),
        call(side, t, "POST", "/api/query/last", body={"queries": [1]}),
        call(side, t, "POST", "/api/query/last",
             body={"queries": [{"tsuids": "x"}]}),
        call(side, t, "POST", "/api/query/last",
             body={"queries": [], "backScan": "x"}),
    ]
    return out


def test_search_and_last_endpoints_equal_reference():
    got, want = both(_search_rpcs)
    assert got == want
    assert [a[0] for a in got] == [200, 200, 200, 400, 400, 400, 200, 200,
                                   200, 200, 400, 400, 400]


def _uid_rpcs(side):
    t = seeded(side)
    return [
        call(side, t, "GET", "/api/uid/assign",
             params={"metric": "new.a,sys.cpu", "tagk": "k1"}),
        call(side, t, "GET", "/api/uid/assign", params={"metrics": "x"}),
        call(side, t, "POST", "/api/uid/assign",
             body={"tagv": ["v1", "v2"], "metric": "new.b"}),
        call(side, t, "POST", "/api/uid/assign", body={"tagk": 5}),
        call(side, t, "POST", "/api/uid/assign", body={}),
        call(side, t, "POST", "/api/uid/assign", body={"metric": ["bad!"]}),
        call(side, t, "POST", "/api/uid/rename",
             body={"metric": "new.a", "name": "new.c"}),
        call(side, t, "GET", "/api/uid/rename",
             params={"tagk": "nope", "name": "z"}),
        call(side, t, "POST", "/api/uid/rename", body={"metric": "x"}),
        call(side, t, "GET", "/api/uid/nope"),
        call(side, t, "GET", "/api/uid/uidmeta",
             params={"uid": "000001", "type": "metric"}),
        call(side, t, "GET", "/api/uid/uidmeta",
             params={"uid": "00000Z", "type": "metric"}),
        sorted(t.uids.metrics.items()), sorted(t.uids.tag_values.items()),
    ]


def test_uid_endpoints_equal_reference():
    got, want = both(_uid_rpcs)
    assert got == want
    assert [a[0] for a in got[:-2]] == [400, 400, 200, 400, 400, 400, 200,
                                        400, 400, 404, 200, 404]


# -- annotated queries --------------------------------------------------------

QUERY = {"start": str(T0), "end": str(T0 + 3599),
         "queries": [{"aggregator": "sum", "metric": "sys.cpu.user",
                      "downsample": "5m-avg", "rate": True,
                      "filters": [{"type": "wildcard", "tagk": "dc",
                                   "filter": "*", "groupBy": True}]}]}


def _pair(keys=ENGINE_KEYS):
    metrics = {"sys.cpu.user": irregular(48, 60, seed=3)}
    jt = reference_tsdb(metrics, {**keys, "tsd.query.fanout.workers": "0"})
    tt = port_tsdb(jt, metrics, keys)
    return jt, tt


def _annotate(t, note_cls, seed: int = 3):
    """Notes on some dc0 and dc1 series, two global ones, one outside
    the range; the same for both packages (the port's TSDB holds the
    reference's UIDs)."""
    rng = np.random.default_rng(seed)
    for i in sorted(rng.choice(48, 12, replace=False).tolist()):
        tags = {"host": f"h{i:03d}", "dc": f"dc{i % 6}", "rack": f"r{i % 40}"}
        t.annotations.store(note_cls(tsuid_of(t, "sys.cpu.user", tags),
                                     T0 + 60 * int(rng.integers(0, 60)),
                                     0, f"note {i}"))
    t.annotations.store(note_cls("", T0 + 5, T0 + 50, "deploy"))
    t.annotations.store(note_cls("", T0 + 7200, 0, "later"))


def _notes_of(results, global_too=True) -> list:
    return [([a.to_json() for a in r.annotations],
             [a.to_json() for a in r.global_annotations] if global_too
             else None) for r in results]


@pytest.mark.parametrize("flags", [{}, {"globalAnnotations": True},
                                   {"noAnnotations": True},
                                   {"noAnnotations": True,
                                    "globalAnnotations": True}])
def test_annotated_query_equals_reference(flags):
    jt, tt = _pair()
    _annotate(jt, JAX.annotation.Annotation)
    _annotate(tt, PORT.annotation.Annotation)
    q = {**QUERY, **flags}
    want = jt.execute_query(JAX.TSQuery.from_json(q).validate())
    got = tt.execute_query(PORT.TSQuery.from_json(q).validate())
    assert_rows_close(rows(got), rows(want))
    assert _notes_of(got) == _notes_of(want)
    n = sum(len(r.annotations) for r in got)
    assert n == (0 if flags.get("noAnnotations") else 12)
    assert all(len(r.global_annotations) == (
        1 if flags.get("globalAnnotations") else 0) for r in got)
    # the serialized heads, through both routers
    bodies = [json.loads(r.handle(req).body) for r, req in (
        (router(PORT, tt), request(PORT, "POST", "/api/query", body=q)),
        (router(JAX, jt), request(JAX, "POST", "/api/query", body=q)))]
    strip = [[{k: v for k, v in g.items() if k != "dps"} for g in b]
             for b in bodies]
    assert strip[0] == strip[1]


def test_repeat_after_an_annotation_write_carries_it():
    """With the result cache and the device cache on: a repeat is a hit
    until ``POST /api/annotation``, whose note the next answer carries
    (the annotation version is in the result cache's version)."""
    keys = {**ENGINE_KEYS, "tsd.query.cache.enable": "true",
            "tsd.query.device_cache_mb": "64"}
    jt, tt = _pair(keys)
    tags = {"host": "h000", "dc": "dc0", "rack": "r0"}
    out = {}
    for side, t in ((PORT, tt), (JAX, jt)):
        r = router(side, t)
        seen = []
        for note in (None, {"tsuid": tsuid_of(t, "sys.cpu.user", tags),
                            "startTime": T0 + 120, "description": "new"}):
            if note is not None:
                assert answer(r.handle(request(
                    side, "POST", "/api/annotation", body=note)))[0] == 200
            for _ in range(2):
                body = json.loads(r.handle(request(
                    side, "POST", "/api/query", body=QUERY)).body)
                seen.append([g.get("annotations", []) for g in body])
        out[side.name] = seen
    assert out["port"] == out["jax"]
    assert out["port"][0] == out["port"][1] and \
        not any(out["port"][0])
    assert out["port"][2] == out["port"][3] and any(out["port"][2])
    # the port's prepared batch is not versioned by the notes (ref:
    # ``pver``): the query after the note missed the result cache and hit
    # the batch, whose results were rebuilt with the new note
    cache = tt.device_grid_cache
    assert (cache.hits, cache.misses) == (1, 1)


def test_prepared_hit_after_an_annotation_write_carries_it():
    """With the result cache off and the device cache on: a repeat after
    ``POST /api/annotation`` is a prepared-batch hit that carries the new
    note, as the reference's answer does."""
    keys = {**ENGINE_KEYS, "tsd.query.cache.enable": "false",
            "tsd.query.device_cache_mb": "64"}
    jt, tt = _pair(keys)
    tags = {"host": "h006", "dc": "dc0", "rack": "r6"}
    out = {}
    for side, t in ((PORT, tt), (JAX, jt)):
        r = router(side, t)
        seen = []
        for note in (None, {"tsuid": tsuid_of(t, "sys.cpu.user", tags),
                            "startTime": T0 + 180, "description": "hot"}):
            if note is not None:
                assert answer(r.handle(request(
                    side, "POST", "/api/annotation", body=note)))[0] == 200
            body = json.loads(r.handle(request(
                side, "POST", "/api/query", body=QUERY)).body)
            seen.append(body)
        out[side.name] = seen
    assert [[{k: v for k, v in g.items() if k != "dps"} for g in b]
            for b in out["port"]] == \
        [[{k: v for k, v in g.items() if k != "dps"} for g in b]
         for b in out["jax"]]
    before, after = out["port"]
    assert not any(g.get("annotations") for g in before)
    assert [a["description"] for g in after
            for a in g.get("annotations", [])] == ["hot"]
    cache = tt.device_grid_cache
    assert (cache.hits, cache.misses) == (1, 1)
