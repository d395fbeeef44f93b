"""The host tail: small queries' tails on the host CPU, chosen before
any device call by size, against the JAX package's.

- placement: ``host_tail_device``, ``host_tail_for_dims`` and
  ``_rank_class_agg`` give the reference's decision (a device or None)
  on a grid of dims, aggregators and keys;
- answers: the same small queries with the tail host-placed (the
  defaults) and forced off (``-1``), on the grid, point and avg paths,
  equal to each other and to the reference's within rtol 1e-9 (both
  float64 on the CPU);
- the host-RAM prepared-batch cache: a warm hit, its invalidation by a
  write and by ``drop_caches``, and that it never fills the device
  cache;
- the continuous-query tail and the warmup place their classes by the
  same function.

On the CPU the TSDB's device is the host too, so placement shows in
``PipelineSpec.host``, in which cache a batch lands, and in which
device the engine hands the tail.
"""

from __future__ import annotations

import numpy as np
import pytest

from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query import engine as jengine
from opentsdb_tpu_torch import Config
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops.shapes import shape_bucket
from opentsdb_tpu_torch.query import engine as tengine
from torch_pair import (T0, JQuery, TSQuery, port_tsdb, reference_tsdb,
                        rows, run_both)
from opentsdb_tpu.ops.shapes import shape_bucket as jshape_bucket

HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}
# the result cache off, so repeats reach the engine's paths
BASE_KEYS = {"tsd.query.cache.enable": "false",
             "tsd.core.auto_create_metrics": "true"}

KEY_CASES = {
    "defaults": {},
    "off": {**HOST_TAIL_OFF, "tsd.query.host_tail_max_cellgroups": "-1"},
    "small": {"tsd.query.host_tail_max_cells": "5000",
              "tsd.query.host_tail_max_cellgroups": "40000",
              "tsd.query.host_tail_max_cells_linear": "20000"},
    "linear-off": {"tsd.query.host_tail_max_cells_linear": "-1"},
    "groups-off": {"tsd.query.host_tail_max_cellgroups": "-1"},
}
AGGS = ["sum", "avg", "max", "dev", "median", "p99", "ep95r3", "none",
        "not-an-aggregator"]
DIMS = [(1, 1, 1), (12, 60, 3), (100, 30, 1000), (3000, 20, 50),
        (100_000, 30, 1000), (114_688, 32, 1), (131_072, 64, 2),
        (50_000, 60, 100), (50_000, 12, 100), (100_000, 10, 100),
        (10_000, 300, 1), (1_000_000, 60, 100), (4096, 256, 2047),
        (700, 1500, 7)]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 1023, 1024, 1025,
                               114_688, 1_000_000, 3_276_800])
def test_shape_bucket_equals_reference(n):
    assert shape_bucket(n) == jshape_bucket(n)


@pytest.mark.parametrize("case", sorted(KEY_CASES))
@pytest.mark.parametrize("agg", AGGS)
def test_placement_equals_reference(case, agg):
    """Over the dims grid, with and without a group stage: the port
    gives the host CPU exactly where the reference gives its CPU
    device, and None where it gives None."""
    keys = KEY_CASES[case]
    cfg, jcfg = Config(**keys), JConfig(**keys)
    for s, b, g in DIMS:
        for emit_raw in (False, True):
            got = tengine.host_tail_for_dims(cfg, s, b, g, emit_raw, agg)
            want = jengine.host_tail_for_dims(jcfg, s, b, g, emit_raw,
                                              agg)
            assert (got is None) == (want is None), (s, b, g, emit_raw)
            assert got is None or got.type == "cpu"


@pytest.mark.parametrize("agg", AGGS + ["zimsum", "mimmin", "count",
                                        "p50", "p999", "ep50r7"])
def test_rank_class_equals_reference(agg):
    assert tengine._rank_class_agg(agg) == jengine._rank_class_agg(agg)


def test_host_tail_device_thresholds():
    """The reference's thresholds (``tests/test_host_tail.py``): under
    the default budget the host, above it None, a custom budget, -1
    off; a linear aggregator's larger cells-only budget."""
    cfg = Config()
    assert tengine.host_tail_device(cfg, 64 * 1024).type == "cpu"
    assert tengine.host_tail_device(
        cfg, tengine.HOST_TAIL_DEFAULT_CELLS + 1) is None
    small = Config(**{"tsd.query.host_tail_max_cells": "1000"})
    assert tengine.host_tail_device(small, 999) is not None
    assert tengine.host_tail_device(small, 1001) is None
    off = Config(**{"tsd.query.host_tail_max_cells": "-1"})
    assert tengine.host_tail_device(off, 1) is None
    big = 4 << 20
    assert tengine.host_tail_device(cfg, big, 1024, linear_agg=True) \
        is not None
    assert tengine.host_tail_device(cfg, big, 1024,
                                    linear_agg=False) is None
    assert (tengine.HOST_TAIL_DEFAULT_CELLS,
            tengine.HOST_TAIL_DEFAULT_CELLGROUPS,
            tengine.HOST_TAIL_DEFAULT_CELLS_LINEAR) == (
        jengine.HOST_TAIL_DEFAULT_CELLS,
        jengine.HOST_TAIL_DEFAULT_CELLGROUPS,
        jengine.HOST_TAIL_DEFAULT_CELLS_LINEAR)


def test_defaults_are_the_references():
    """The host-tail, host-cache and breaker keys default to the
    reference's values; ``tsd.query.degraded.host_fallback`` is false
    (the reference's true re-answers failures on the host)."""
    cfg, jcfg = Config(), JConfig()
    for key in ("tsd.query.host_tail_max_cells",
                "tsd.query.host_tail_max_cellgroups",
                "tsd.query.host_tail_max_cells_linear",
                "tsd.query.host_cache_mb",
                "tsd.query.breaker.failure_threshold",
                "tsd.query.breaker.reset_timeout_ms"):
        assert cfg.get_string(key) == jcfg.get_string(key), key
    assert cfg.get_string("tsd.query.degraded.host_fallback") == "false"


# -- answers --------------------------------------------------------------

S, P = 60, 60


def _metrics() -> dict:
    """``m``: 60 gauges at one a minute for an hour (a NaN hole, one
    series that stops early), tagged by host, dc (6) and rack (4)."""
    rng = np.random.default_rng(23)
    tags = [{"host": f"h{i:02d}", "dc": f"dc{i % 6}", "rack": f"r{i % 4}"}
            for i in range(S)]
    ts2d = T0 + 60 * np.arange(P, dtype=np.int64)[None, :].repeat(S, 0)
    vals = rng.normal(50.0, 8.0, (S, P))
    vals[4, 20:25] = np.nan
    counts = np.full(S, P)
    counts[7] = 41
    return {"m": (tags, ts2d, vals, counts)}


@pytest.fixture(scope="module")
def trio():
    """The reference at its defaults (host tail on), the port at its
    defaults and the port with the host tail forced off, with the same
    data; the device cache on in all three."""
    metrics = _metrics()
    jt = reference_tsdb(metrics, BASE_KEYS)
    on = port_tsdb(jt, metrics, BASE_KEYS)
    off = port_tsdb(jt, metrics, {**BASE_KEYS, **HOST_TAIL_OFF})
    yield jt, on, off
    for t in (jt, on, off):
        t.shutdown()


QUERIES = [
    "sum:5m-avg:m{dc=*}", "avg:1m-max:m{rack=*}", "sum:30s-sum:m",
    "p99:5m-avg:m{dc=*}", "median:m{rack=*}", "sum:m{dc=*}",
    "none:10m-min:m{dc=dc1}", "dev:5m-sum:rate:m{dc=*}",
    "sum:15m-first:m{rack=*}", "zimsum:5m-count:m",
]


def _json(m: str) -> dict:
    from torch_pair import uri_query
    return uri_query(m, T0, T0 + P * 60 - 1)


@pytest.mark.parametrize("m", QUERIES)
def test_small_query_host_and_device_tails_agree(trio, m, monkeypatch):
    """The same small query with the tail host-placed (defaults) and
    forced off: equal to each other and to the reference's host-placed
    answer; the defaults' tail ran with ``PipelineSpec.host`` set, the
    forced-off one without."""
    jt, on, off = trio
    seen = []
    for name in ("execute_grid", "run_prepared"):
        orig = getattr(tengine, name)

        def spy(*a, _o=orig, **k):
            seen.append(next(x for x in a
                             if isinstance(x, tpipe.PipelineSpec)).host)
            return _o(*a, **k)
        monkeypatch.setattr(tengine, name, spy)
    query = _json(m)
    got_on = run_both(jt, on, query)
    assert seen and all(seen)
    seen.clear()
    got_off = rows(off.execute_query(TSQuery.from_json(query).validate()))
    assert seen and not any(seen)
    want = rows(jt.execute_query(JQuery.from_json(query).validate()))
    from torch_pair import assert_rows_close
    assert_rows_close(got_off, want)
    assert_rows_close(got_on, got_off)


def test_avg_rollup_tail_is_host_placed():
    """The avg path's divide and tail take the host for a small grid,
    and answer as with the host tail off and as the reference (ref:
    ``test_rollup_avg_host_tail``)."""
    from opentsdb_tpu import TSDB as JTSDB
    from opentsdb_tpu.rollup.job import run_rollup_job as jjob
    from opentsdb_tpu_torch import TSDB
    from opentsdb_tpu_torch.rollup.job import run_rollup_job as tjob
    base_ms = T0 * 1000
    keys = {**BASE_KEYS, "tsd.rollups.enable": "true"}
    dbs = [JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"})),
           TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"})),
           TSDB(Config(**{**keys, **HOST_TAIL_OFF,
                          "tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64"}))]
    for t, job in zip(dbs, (jjob, tjob, tjob)):
        for i in range(120):
            t.add_point("r.m", T0 + i * 10, float(i % 7),
                        {"host": "a" if i % 3 else "b"})
        job(t, base_ms, base_ms + 1_200_000)
    q = {"start": base_ms, "end": base_ms + 1_200_000,
         "queries": [{"aggregator": "sum", "metric": "r.m",
                      "downsample": "1m-avg"}]}
    want = rows(dbs[0].execute_query(JQuery.from_json(q).validate()))
    got = [rows(t.execute_query(TSQuery.from_json(q).validate()))
           for t in dbs[1:]]
    from torch_pair import assert_rows_close
    assert_rows_close(got[0], want)
    assert_rows_close(got[1], want)
    # the host-placed avg grid never entered the device cache
    assert len(dbs[1].device_grid_cache) == 0
    assert len(dbs[2].device_grid_cache) == 1
    for t in dbs:
        t.shutdown()


# -- the host-RAM prepared-batch cache --------------------------------------

def _groupby(pts: int = 20) -> dict:
    return {"start": T0 * 1000, "end": (T0 + pts * 60) * 1000,
            "queries": [{"metric": "hosttail.m", "aggregator": "sum",
                         "filters": [{"type": "wildcard", "tagk": "host",
                                      "filter": "*", "groupBy": True}]}]}


@pytest.fixture
def groupby_pair():
    """The reference's ``_seed_groupby`` (3000 series, 50 groups, 20
    points) in both packages at their defaults."""
    rng = np.random.default_rng(9)
    n, pts, groups = 3000, 20, 50
    vals = rng.normal(50, 5, (n, pts))
    tags = [{"host": f"h{i % groups:03d}", "task": f"t{i // groups}"}
            for i in range(n)]
    ts2d = T0 + 60 * np.arange(pts, dtype=np.int64)[None, :].repeat(n, 0)
    metrics = {"hosttail.m": (tags, ts2d, vals, np.full(n, pts))}
    jt = reference_tsdb(metrics, BASE_KEYS)
    tt = port_tsdb(jt, metrics, BASE_KEYS)
    yield jt, tt, vals, groups
    jt.shutdown()
    tt.shutdown()


def test_union_groupby_served_from_host_cache(groupby_pair):
    """(ref: ``test_union_groupby_served_from_host_cache``) the first
    query misses the host pool, the repeat hits it, the device cache
    holds nothing, and the answer is the reference's and numpy's."""
    jt, tt, vals, groups = groupby_pair
    for t in (jt, tt):
        t.execute_query((JQuery if t is jt else TSQuery)
                        .from_json(_groupby()).validate())
        assert t.host_prep_cache.misses >= 1
    got = run_both(jt, tt, _groupby())
    for t in (jt, tt):
        assert t.host_prep_cache.hits >= 1
    assert tt.device_grid_cache.nbytes == 0 and \
        len(tt.device_grid_cache) == 0
    assert tt.host_prep_cache.nbytes > 0
    g0 = next(r for r in got if r[1].get("host") == "h000")
    want = vals[np.arange(len(vals)) % groups == 0].sum(axis=0)
    np.testing.assert_allclose(g0[4], want, rtol=1e-9)


def test_write_invalidates_host_cache(groupby_pair):
    """A write after the first query changes the next answer, in both
    packages alike (the host pool is versioned by the store)."""
    jt, tt, _, _ = groupby_pair
    run_both(jt, tt, _groupby())
    for t in (jt, tt):
        t.add_point("hosttail.m", T0, 1000.0,
                    {"host": "h000", "task": "t0"})
    hits = tt.host_prep_cache.hits
    got = run_both(jt, tt, _groupby())
    assert tt.host_prep_cache.hits == hits
    g0 = next(r for r in got if r[1].get("host") == "h000")
    assert g0[4][0] > 1000.0


def test_drop_caches_clears_host_cache(groupby_pair):
    jt, tt, _, _ = groupby_pair
    for t in (jt, tt):
        t.execute_query((JQuery if t is jt else TSQuery)
                        .from_json(_groupby()).validate())
    assert tt.host_prep_cache.nbytes > 0
    tt.drop_caches()
    assert tt.host_prep_cache.nbytes == 0 and len(tt.host_prep_cache) == 0
    run_both(jt, tt, _groupby())


def test_host_cache_stats_and_off_switch():
    """The host pool reports under ``query.hostcache.*`` in the stats,
    and ``tsd.query.host_cache_mb=0`` turns it off."""
    from opentsdb_tpu_torch import TSDB
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    assert t.host_prep_cache is not None
    names = {r[0] for r in t.stats.collect().records}
    assert {"tsd.query.hostcache.bytes", "tsd.query.hostcache.hits"} \
        <= names
    off = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.query.host_cache_mb": "0"}))
    assert off.host_prep_cache is None


def test_over_budget_range_never_lands_on_the_host():
    """The blocked verdict comes before placement (ref): a long range
    over ``tsd.query.max_device_cells`` streams in blocks on the
    device, whatever the host-tail budget says."""
    from opentsdb_tpu_torch.ops import blocked
    metrics = _metrics()
    jt = reference_tsdb(metrics, {**BASE_KEYS,
                                  "tsd.query.max_device_cells": "600"})
    tt = port_tsdb(jt, metrics, {**BASE_KEYS, "tsd.torch.device": "cpu",
                                 "tsd.query.max_device_cells": "600"})
    blocked.execute_blocked.runs = 0
    run_both(jt, tt, _json("sum:1m-avg:m{dc=*}"))
    assert blocked.execute_blocked.runs == 1
    jt.shutdown()
    tt.shutdown()


# -- the continuous-query tail and the warmup --------------------------------

@pytest.mark.parametrize("keys,host", [({}, True), (HOST_TAIL_OFF, False)])
def test_streaming_tail_placed_by_size(keys, host, monkeypatch):
    """A continuous query's tail is placed as the batch engine's grid
    tail of the same dims: host-placed at the defaults for this small
    view, on the TSDB's device with the host tail off. (The reference
    pins it to its host whatever the size.)"""
    from opentsdb_tpu_torch import TSDB
    from opentsdb_tpu_torch.streaming import plan as plan_mod
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.query.cache.enable": "false", **keys}))
    for i in range(4):
        t.add_points("s.m", T0 + 60 * np.arange(30), np.arange(30.) + i,
                     {"host": f"h{i}"})
    specs = []
    orig = plan_mod.execute_grid
    monkeypatch.setattr(plan_mod, "execute_grid", lambda *a, **k: (
        specs.append(a[4]), orig(*a, **k))[1])
    q = {"start": T0 * 1000, "end": (T0 + 1799) * 1000, "id": "cq",
         "queries": [{"metric": "s.m", "aggregator": "sum",
                      "downsample": "1m-sum"}]}
    t.streaming.register(q, now_ms=(T0 + 1799) * 1000)
    body = {k: v for k, v in q.items() if k != "id"}
    out = t.execute_query(TSQuery.from_json(body).validate())
    assert t.streaming.serve_hits == 1 and out
    assert specs and all(s.host is host for s in specs)
    t.shutdown()


def test_warmup_places_classes_as_the_reference():
    """Each warm class's ``PipelineSpec.host`` is the reference's
    placement of that class (its ``dev_lin``/``dev_pct``/``dev_raw``),
    at the defaults and with the host tail off."""
    from opentsdb_tpu_torch import TSDB
    from opentsdb_tpu_torch.tsd import warmup
    for keys in ({}, HOST_TAIL_OFF):
        t = TSDB(Config(**{"tsd.torch.device": "cpu", **keys}))
        jcfg = JConfig(**keys)
        for s, b, g in [(1, 60, 1), (2000, 288, 100), (1_000_000, 60, 100),
                        (200_000, 288, 1)]:
            for spec, where in warmup._agg_specs(t, s, b, g, True):
                agg = "p99" if spec.agg_name.startswith("p") else "sum"
                want = jengine.host_tail_for_dims(jcfg, s, b, g,
                                                  spec.emit_raw, agg)
                assert spec.host == (want is not None), (s, b, g, spec)
                assert where.type == "cpu"
        t.shutdown()
