"""Pixel budgets (``ops/visual_downsample.py``) against the JAX
package's: the M4 and MinMaxLTTB keep masks bit for bit over edge
shapes, the naive M4 oracle, the one-row reductions, the strict 400
matrix of the query surface, whole queries through both engines and
both HTTP routers, the result cache's key, percentile rows, and the
streaming pull and push paths.

Both packages' ``visual_downsample`` are host numpy, so every mask is
held equal, not close; whole answers are held as ``torch_pair`` holds
them (rtol 1e-9, float64 on both sides).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from opentsdb_tpu.ops import visual_downsample as jvd
from opentsdb_tpu.query import model as jmodel
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch.ops import visual_downsample as vd
from opentsdb_tpu_torch.query import model as tmodel
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from torch_pair import (JQuery, TSQuery, assert_rows_close, port_tsdb,
                        reference_tsdb, rows, run_both)

BASE = 1356998400
BASE_MS = BASE * 1000


def _grid(case: str):
    """(ts, values [S, B], emit [S, B], start, end, pixels) of one edge
    shape (ref: ``tests/test_visual_downsample.py``'s oracle cases)."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "dense":
        ts = BASE_MS + np.arange(4000, dtype=np.int64) * 1000
        return (ts, rng.normal(0, 1, (5, 4000)),
                np.ones((5, 4000), bool), BASE_MS, BASE_MS + 4_000_000, 137)
    if case == "nan-gaps":
        ts = BASE_MS + np.arange(3000, dtype=np.int64) * 1000
        v = rng.normal(0, 1, (4, 3000))
        v[rng.random((4, 3000)) < 0.2] = np.nan
        v[1, 500:900] = np.nan
        return ts, v, np.ones((4, 3000), bool), BASE_MS, \
            BASE_MS + 3_000_000, 90
    if case == "sparse-emit":
        ts = BASE_MS + np.arange(2000, dtype=np.int64) * 1000
        emit = rng.random((3, 2000)) < 0.05
        return ts, rng.normal(0, 1, (3, 2000)), emit, BASE_MS, \
            BASE_MS + 2_000_000, 300
    if case == "ms-resolution":
        ts = BASE_MS + np.arange(5000, dtype=np.int64) * 7
        return ts, rng.normal(0, 1, (2, 5000)), np.ones((2, 5000), bool), \
            BASE_MS, BASE_MS + 35_000, 64
    if case == "straddle":
        ts = BASE_MS - 30_000 + np.arange(1000, dtype=np.int64) * 60_000
        return ts, rng.normal(0, 1, (3, 1000)), np.ones((3, 1000), bool), \
            BASE_MS, BASE_MS + 60_000_000, 77
    if case == "ties-inf":
        ts = BASE_MS + np.arange(800, dtype=np.int64) * 1000
        v = np.round(rng.normal(0, 1, (3, 800)))
        v[0, 10] = np.inf
        v[1, 400] = -np.inf
        return ts, v, np.ones((3, 800), bool), BASE_MS, \
            BASE_MS + 800_000, 40
    if case == "constant":
        ts = BASE_MS + np.arange(600, dtype=np.int64) * 1000
        return ts, np.full((2, 600), 3.0), np.ones((2, 600), bool), \
            BASE_MS, BASE_MS + 600_000, 20
    if case == "below-budget":
        ts = BASE_MS + np.arange(30, dtype=np.int64) * 1000
        return ts, rng.normal(0, 1, (2, 30)), np.ones((2, 30), bool), \
            BASE_MS, BASE_MS + 30_000, 100
    assert case == "trailing-empty"
    ts = BASE_MS + np.arange(500, dtype=np.int64) * 1000
    return ts, rng.normal(0, 1, (2, 500)), np.ones((2, 500), bool), \
        BASE_MS, BASE_MS + 5_000_000, 200


CASES = ["dense", "nan-gaps", "sparse-emit", "ms-resolution", "straddle",
         "ties-inf", "constant", "below-budget", "trailing-empty"]


@pytest.mark.parametrize("fn", ["m4", "minmaxlttb"])
@pytest.mark.parametrize("case", CASES)
def test_keep_mask_equals_reference(case, fn):
    ts, v, emit, start, end, px = _grid(case)
    got = vd.keep_mask(v, emit, ts, start, end, px, fn)
    want = jvd.keep_mask(v, emit, ts, start, end, px, fn)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)
    if fn == "m4":
        keep = emit if got is None else got
        for s in range(v.shape[0]):
            naive = vd.naive_m4_reference(ts, v[s], emit[s], start, end,
                                          px)
            assert naive == jvd.naive_m4_reference(ts, v[s], emit[s],
                                                   start, end, px)
            assert set(np.nonzero(keep[s])[0].tolist()) == naive
    else:
        bound = px if got is not None else v.shape[1]
        assert ((got if got is not None else emit).sum(axis=1)
                <= bound).all()


@pytest.mark.parametrize("px", [0, 1, 10, 40, 499, 501])
def test_reduce_dps_and_arrays_equal_reference(px):
    dps = [(BASE_MS + i * 1000, float((i * 7) % 23)) for i in range(500)]
    want = jvd.reduce_dps(dps, BASE_MS, BASE_MS + 500_000, px)
    assert vd.reduce_dps(dps, BASE_MS, BASE_MS + 500_000, px) == want
    ts = np.array([t for t, _ in dps], dtype=np.int64)
    vals = np.array([v for _, v in dps])
    kt, kv = vd.reduce_arrays(ts, vals, BASE_MS, BASE_MS + 500_000, px)
    assert list(zip(kt.tolist(), kv.tolist())) == want


def test_constants_equal_reference():
    assert (vd.PIXEL_FNS, vd.DEFAULT_PIXEL_FN, vd.MAX_PIXELS,
            vd.MINMAX_RATIO) == (jvd.PIXEL_FNS, jvd.DEFAULT_PIXEL_FN,
                                 jvd.MAX_PIXELS, jvd.MINMAX_RATIO)


# -- the query surface's validation ----------------------------------------

@pytest.mark.parametrize("spec", [
    "abcpx", "px", "12pxx", "-5px", "1.5px", "1500px-", "1500px-x",
    "1500px-lttbx", "70000px", "1_500px", "1500 px", "0800px", "00px",
    "1500px", "800px-m4", "640px-minmaxlttb", "0px", "65536px"])
def test_uri_pixels_as_reference(spec):
    try:
        want = jmodel.parse_uri_pixels(spec)
    except jmodel.BadRequestError as e:
        with pytest.raises(tmodel.BadRequestError) as got:
            tmodel.parse_uri_pixels(spec)
        assert str(got.value) == str(e)
    else:
        assert tmodel.parse_uri_pixels(spec) == want


@pytest.mark.parametrize("px", [-1, 70000, "abc", "1_5", "١٥", "0800",
                                1.5, True, [5], {"a": 1}, 0, "0", 12,
                                "12", 65536])
@pytest.mark.parametrize("where", ["sub", "query"])
def test_json_pixels_as_reference(px, where):
    def body():
        sub = {"metric": "m", "aggregator": "sum", "pixelFn": "M4"}
        obj = {"start": BASE_MS, "end": BASE_MS + 1000, "queries": [sub]}
        (sub if where == "sub" else obj)["pixels"] = px
        return obj
    try:
        jq = jmodel.TSQuery.from_json(body()).validate()
    except jmodel.BadRequestError as e:
        with pytest.raises(tmodel.BadRequestError) as got:
            tmodel.TSQuery.from_json(body()).validate()
        assert str(got.value) == str(e)
    else:
        tq = tmodel.TSQuery.from_json(body()).validate()
        assert tmodel.effective_pixels(tq, tq.queries[0]) == \
            jmodel.effective_pixels(jq, jq.queries[0])
        assert tq.to_json()["queries"][0] == {
            k: v for k, v in jq.to_json()["queries"][0].items()
            if k in tq.to_json()["queries"][0]}


def test_pixel_fn_and_uri_query_as_reference():
    bad = {"start": BASE_MS, "end": BASE_MS + 1000, "queries": [
        {"metric": "m", "aggregator": "sum", "pixels": 100,
         "pixelFn": "bogus"}]}
    with pytest.raises(tmodel.BadRequestError):
        tmodel.TSQuery.from_json(bad).validate()
    params = {"start": [str(BASE_MS)], "m": ["sum:m", "sum:m"],
              "downsample": ["1500px-minmaxlttb"]}
    tq, jq = tmodel.parse_uri_query(params), jmodel.parse_uri_query(params)
    assert (tq.pixels, tq.pixel_fn) == (jq.pixels, jq.pixel_fn) == \
        (1500, "minmaxlttb")
    tq.queries[1].pixels = jq.queries[1].pixels = 99
    assert len(tq.dedupe_queries().queries) == \
        len(jq.dedupe_queries().queries) == 2


# -- whole queries ------------------------------------------------------------

def _viz_metrics() -> dict:
    """The reference's ``sys.viz``: 4 series at one point per 2 s for
    two hours."""
    rng = np.random.default_rng(8)
    n, p = 4, 3600
    tags = [{"host": f"h{i}", "task": f"t{i % 2}"} for i in range(n)]
    ts2d = BASE + 2 * np.arange(p, dtype=np.int64)[None, :].repeat(n, 0)
    return {"sys.viz": (tags, ts2d, rng.normal(100, 10, (n, p)),
                        np.full(n, p))}


@pytest.fixture(scope="module")
def viz():
    metrics = _viz_metrics()
    keys = {"tsd.core.auto_create_metrics": "true"}
    jt = reference_tsdb(metrics, keys)
    tt = port_tsdb(jt, metrics, keys)
    yield jt, tt
    jt.shutdown()
    tt.shutdown()


def _q(px=None, fn=None, agg="sum", ds=None, rate=False, **top):
    sub = {"metric": "sys.viz", "aggregator": agg, "rate": rate,
           "filters": [{"type": "wildcard", "tagk": "host", "filter": "*",
                        "groupBy": True}]}
    if px is not None:
        sub["pixels"] = px
    if fn is not None:
        sub["pixelFn"] = fn
    if ds:
        sub["downsample"] = ds
    return {"start": BASE_MS, "end": (BASE + 7200) * 1000,
            "queries": [sub], **top}


QUERIES = {
    "m4-300": _q(px=300),
    "query-level-100": _q(pixels=100),
    "per-sub-wins": _q(px=300, pixels=100),
    "lttb-200": _q(px=200, fn="minmaxlttb"),
    "rate-150": _q(px=150, rate=True),
    "none-120": _q(px=120, agg="none"),
    "grid-20": _q(px=20, ds="1m-avg"),
    "p99-50": _q(px=50, agg="p99", ds="30s-max"),
    "huge-budget": _q(px=60000),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_with_pixels_equals_reference(viz, name):
    """Each budgeted query answers the reference's rows, and its points
    are a value-faithful subset of the full-resolution answer."""
    jt, tt = viz
    q = QUERIES[name]
    got = run_both(jt, tt, q)
    full = dict(q)
    full.pop("pixels", None)
    full["queries"] = [{k: v for k, v in q["queries"][0].items()
                        if k not in ("pixels", "pixelFn")}]
    whole = rows(tt.execute_query(TSQuery.from_json(full).validate()))
    for g, w in zip(got, whole):
        kept = dict(zip(g[3], g[4]))
        assert set(kept) <= set(w[3])
        ref = dict(zip(w[3], w[4]))
        assert all(ref[t] == v for t, v in kept.items())
        if name != "huge-budget":
            assert len(kept) < len(ref)


def test_cache_key_pixel_interaction(viz):
    """(ref: ``test_cache_key_pixel_interaction``) full-resolution and
    budgeted requests hold distinct result-cache entries; repeats hit;
    another budget is another entry."""
    _, tt = viz
    cache = tt.result_cache
    cache.clear()
    h0, m0 = cache.hits, cache.misses
    serve = lambda q: tt.execute_query(  # noqa: E731
        TSQuery.from_json(q).validate())
    serve(_q())
    serve(_q(px=300))
    assert (cache.misses - m0, cache.hits - h0) == (2, 0)
    full, red = serve(_q()), serve(_q(px=300))
    assert cache.hits - h0 == 2
    assert red[0].num_dps < full[0].num_dps
    serve(_q(px=100))
    assert cache.misses - m0 == 3


@pytest.mark.parametrize("downsample", ["200px", "150px-minmaxlttb",
                                        "nope", "70000px"])
def test_uri_downsample_pixels_through_both_routers(viz, downsample):
    jt, tt = viz
    params = {"start": [str(BASE)], "end": [str(BASE + 7200)],
              "m": ["sum:sys.viz{host=*}"], "downsample": [downsample]}
    want = JRouter(jt).handle(JRequest("GET", "/api/query", params, {},
                                       b""))
    got = HttpRpcRouter(tt).handle(HttpRequest("GET", "/api/query",
                                               params, {}, b""))
    assert got.status == want.status
    if want.status != 200:
        assert got.body == want.body
        return
    g, w = json.loads(got.body), json.loads(want.body)
    assert [r["tags"] for r in g] == [r["tags"] for r in w]
    for gr, wr in zip(g, w):
        assert list(gr["dps"]) == list(wr["dps"])
        np.testing.assert_allclose(list(gr["dps"].values()),
                                   list(wr["dps"].values()), rtol=1e-9)


def test_percentile_rows_reduce_after_assembly():
    """(ref: ``TestPercentilePixels``) histogram percentile rows take
    the budget after assembly, as the reference's; an over-large budget
    keeps every point."""
    from opentsdb_tpu import TSDB as JTSDB
    from opentsdb_tpu import Config as JConfig
    from opentsdb_tpu.core.histogram import SimpleHistogram as JHist
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.core.histogram import SimpleHistogram
    keys = {"tsd.core.auto_create_metrics": "true"}
    dbs = [JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"})),
           TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"}))]
    for t, hist in zip(dbs, (JHist, SimpleHistogram)):
        for i in range(600):
            h = hist([0.0, 10.0, 20.0, 30.0])
            h.counts = [10 + (i % 7), i % 5, i % 3]
            t.add_histogram_point("pp.lat", BASE + i * 10,
                                  t.histogram_manager.encode(h),
                                  {"host": "a"})
    for px in (50, 60000):
        q = {"start": BASE_MS, "end": BASE_MS + 6_000_000, "pixels": px,
             "queries": [{"metric": "pp.lat", "aggregator": "sum",
                          "percentiles": [50.0, 95.0]}]}
        want = rows(dbs[0].execute_query(JQuery.from_json(q).validate()))
        got = rows(dbs[1].execute_query(TSQuery.from_json(q).validate()))
        assert_rows_close(got, want)
        assert all((len(r[3]) == 600) == (px == 60000) for r in got)
    for t in dbs:
        t.shutdown()


def test_streaming_pull_and_push_with_pixels():
    """(ref: ``TestStreamingPixels``) a plan registered without a budget
    serves a budgeted pull, reduced at assembly, equal to the
    reference's; a budgeted standing query pushes whole reduced frames
    (a fold can move the selection)."""
    from opentsdb_tpu import TSDB as JTSDB
    from opentsdb_tpu import Config as JConfig
    from opentsdb_tpu_torch import TSDB, Config
    keys = {"tsd.core.auto_create_metrics": "true",
            "tsd.streaming.publish_min_interval_ms": "0"}
    dbs = [JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"})),
           TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"}))]
    end_ms = (BASE + 3600) * 1000
    rng = np.random.default_rng(9)
    vals = rng.normal(100, 10, (2, 3600))
    for t in dbs:
        for i in range(2):
            t.add_points("sys.live", np.arange(BASE, BASE + 3600), vals[i],
                         {"host": f"h{i}"})
        t.streaming.register({
            "id": "full", "start": BASE_MS, "end": end_ms,
            "queries": [{"metric": "sys.live", "aggregator": "sum",
                         "downsample": "10s-avg"}]}, now_ms=end_ms)
    pull = {"start": BASE_MS, "end": end_ms,
            "queries": [{"metric": "sys.live", "aggregator": "sum",
                         "downsample": "10s-avg", "pixels": 40}]}
    want = rows(dbs[0].execute_query(JQuery.from_json(pull).validate()))
    got = rows(dbs[1].execute_query(TSQuery.from_json(pull).validate()))
    assert_rows_close(got, want)
    assert dbs[1].streaming.serve_hits == 1 and len(got[0][3]) <= 160
    t = dbs[1]
    reg = t.streaming
    cq = reg.register({
        "id": "px", "start": BASE_MS, "end": end_ms,
        "queries": [{"metric": "sys.live", "aggregator": "sum",
                     "downsample": "10s-avg", "pixels": 50}]},
        now_ms=end_ms)
    sub = reg.subscribe(cq)
    snap = sub.queue.get(timeout=5)
    d = json.loads(snap.decode().split("data: ")[1])
    assert sum(len(u["dps"]) for u in d["updates"]) <= 4 * 50
    t.add_point("sys.live", BASE + 3500, 1e6, {"host": "h0"})
    reg.flush()
    w = sub.queue.get(timeout=5)
    assert b"event: windows" in w
    dw = json.loads(w.decode().split("data: ")[1])
    assert 2 <= sum(len(u["dps"]) for u in dw["updates"]) <= 4 * 50
    assert any(v is not None and v >= 5e4
               for u in dw["updates"] for v in u["dps"].values())
    reg.unsubscribe(cq, sub)
    for db in dbs:
        db.shutdown()
