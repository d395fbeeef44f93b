"""The port's query engine on a mesh (``tsd.query.mesh``) against the JAX
package's, whole queries on the CPU: twins of
``tests/test_oracle_conformance_mesh.py``.

Each pair is a JAX TSDB on its 8 virtual XLA CPU devices and a port
TSDB whose mesh is drawn from ``mesh_devices=[cpu] * 8``, holding the
same seeded irregular data (``torch_pair.irregular``; the port loaded
from the reference's export, so UIDs and series agree). Covered:

- the mesh-shape sweep (1 to 8 shards, both axes) on the point path
  (``grid_reduce=false``) and the grid path, ``sum:1m-avg:rate`` by
  ``dc``; the prepared-batch and grid-cache hits, the blocked path and
  the avg path at each mesh of ``tests/test_sharded.py`` (8, 1), (4, 2),
  (2, 4) and (1, 8); each aggregator class on one shape (the
  percentiles held to the JAX mesh's histogram estimator);
- the avg path from rollup tiers, ``none`` (per series), blocked
  streaming over the mesh, ``dev`` with mean >> std, calendar buckets;
- the caches: a warm repeat is a device-cache hit (grid and prepared
  batch) and a write invalidates it; a hit answers another group-by;
  entries carry the mesh in their key;
- placement: a mesh query never takes the host tail;
- the breaker counts a mesh failure; the warmup runs the mesh's grid
  step; two cold calls give the same bits;
- ROADMAP Queue 3 item 16: a shape past the device list raises in the
  port where the reference degrades to one device.

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|;
timestamps (the emit masks), tags and NaN positions equal.
"""

import numpy as np
import pytest
import torch

from torch_pair import (ENGINE_KEYS, GRID_ON, T0, JConfig, JQuery, JTSDB,
                        assert_rows_close, export, irregular,
                        reference_tsdb, rows, run_both, uri_query)

from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.state import load_arrays
from opentsdb_tpu_torch.parallel import sharded_pipeline as tsp
from opentsdb_tpu_torch.query import engine as tengine
from opentsdb_tpu_torch.query.model import TSQuery

CPU = torch.device("cpu")
MESH_SHAPES = ["series:1,time:1", "series:2", "series:1,time:2",
               "series:2,time:2", "series:8", "series:2,time:4"]
MESH = "series:4,time:2"
# the meshes of tests/test_sharded.py: every path runs at each
MESHES = ["series:8", "series:4,time:2", "series:2,time:4",
          "series:1,time:8"]
PATHS = {"point": ENGINE_KEYS, "grid": GRID_ON}
DC = "sum:1m-avg:rate:m{dc=*}"


def port_of(jt, keys: dict, n: int = 8, metric: str = "m"):
    """The port on the CPU in float64 over ``[cpu] * n``, loaded from
    ``jt``'s export of ``metric``."""
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **keys}),
              mesh_devices=[CPU] * n)
    load_arrays(tt, metric, *export(jt, metric))
    return tt


def pair(spec: str = MESH, keys: dict = ENGINE_KEYS, s: int = 24,
         seed: int = 3):
    metrics = {"m": irregular(s, 60, seed)}
    k = {**keys, "tsd.query.mesh": spec}
    jt = reference_tsdb(metrics, k)
    assert jt.query_mesh is not None
    return jt, port_of(jt, k)


def counts() -> tuple:
    return (tsp.run_sharded_device.runs, tsp.run_sharded_grid.runs,
            tsp.execute_blocked_sharded.runs)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mesh_spec", MESH_SHAPES)
def test_mesh_shape_sweep(mesh_spec, path):
    """A downsample + rate + group-by query over every factorization of
    1, 2, 4 and 8 devices, on the path it names."""
    jt, tt = pair(mesh_spec, PATHS[path])
    assert tt.query_mesh is not None
    before = counts()
    run_both(jt, tt, uri_query(DC))
    after = counts()
    ran = (after[0] - before[0], after[1] - before[1])
    assert ran == ((1, 0) if path == "point" else (0, 1))


@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "min", "max",
                                 "count", "zimsum", "mimmax", "p95",
                                 "median", "first", "last", "diff",
                                 "multiply"])
def test_aggregators_through_the_mesh(agg):
    jt, tt = pair()
    run_both(jt, tt, uri_query(f"{agg}:5m-avg:m{{dc=*}}"))


def test_calendar_and_union_grids_through_the_mesh():
    jt, tt = pair()
    run_both(jt, tt, uri_query("avg:15mc-max:m{dc=*}"))
    run_both(jt, tt, uri_query("sum:m{dc=*}"))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mesh_matches_reference_agg_none(path):
    """``none`` over the mesh: per-series rows."""
    jt, tt = pair(keys=PATHS[path])
    got = run_both(jt, tt, uri_query("none:1m-avg:m{host=h00*}"))
    assert len(got) > 1


@pytest.mark.parametrize("mesh_spec", MESHES)
def test_mesh_avg_rollup(mesh_spec):
    """The avg from the sum and count tiers: the divide on the host,
    then the tail over the mesh, as the reference's mesh branch."""
    def build(cls, cfg, **kw):
        t = cls(cfg(**{"tsd.core.auto_create_metrics": "true",
                       "tsd.rollups.enable": "true",
                       "tsd.query.mesh": mesh_spec, **ENGINE_KEYS,
                       **kw}), **({"mesh_devices": [CPU] * 8}
                                  if cls is TSDB else {}))
        for i in range(12):
            for j in range(40):
                ts = T0 + j * 60
                t.add_aggregate_point("m", ts, float(i + j),
                                      {"host": f"h{i % 3}"}, False, "1m",
                                      "sum")
                t.add_aggregate_point("m", ts, 2.0, {"host": f"h{i % 3}"},
                                      False, "1m", "count")
        return t

    jt = build(JTSDB, JConfig, **{"tsd.tpu.platform": "cpu"})
    tt = build(TSDB, Config, **{"tsd.torch.device": "cpu",
                                "tsd.torch.dtype": "float64"})
    before = tsp.run_sharded_device.runs
    for m in ("sum:5m-avg:m{host=*}", "sum:10m-avg:rate:m{host=*}"):
        run_both(jt, tt, uri_query(m, end=T0 + 2999))
    assert tsp.run_sharded_device.runs == before + 2


@pytest.mark.parametrize("mesh_spec,m", [
    *[(mesh, "sum:1m-avg:rate:m{dc=*}") for mesh in MESHES],
    (MESH, "avg:1m-avg:m{rack=*}"), (MESH, "p95:1m-avg:m{dc=*}")])
def test_mesh_blocked_streaming(mesh_spec, m):
    """An over-budget range on the mesh streams time blocks and keeps
    the mesh, in both packages alike (the budget scaled by the mesh
    where the reduction's memory allows)."""
    keys = {**ENGINE_KEYS, "tsd.query.max_device_cells": "64"}
    jt, tt = pair(mesh_spec, keys)
    runs, blocks = (tsp.execute_blocked_sharded.runs,
                    tsp.execute_blocked_sharded.blocks)
    run_both(jt, tt, uri_query(m))
    assert tsp.execute_blocked_sharded.runs == runs + 1
    assert tsp.execute_blocked_sharded.blocks - blocks >= 2


def test_mesh_dev_mean_much_greater_than_std():
    """``dev`` with counters near 1e7 and a std near 1: the two-pass
    centered sum does not cancel on the mesh; the port's mesh answer
    equals the JAX mesh's and its own single-device one."""
    rng = np.random.default_rng(7)
    vals = 1e7 + rng.standard_normal((16, 50))
    q = {"start": str(T0), "end": str(T0 + 3599),
         "queries": [{"metric": "m", "aggregator": "dev",
                      "downsample": "5m-avg"}]}

    def fill(t):
        for i in range(16):
            for j in range(50):
                t.add_point("m", T0 + j * 60, float(vals[i, j]),
                            {"host": f"h{i}"})
        return t

    k = {**ENGINE_KEYS, "tsd.core.auto_create_metrics": "true"}
    jt = fill(JTSDB(JConfig(**{**k, "tsd.tpu.platform": "cpu",
                               "tsd.query.mesh": MESH})))
    tt = fill(TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                             "tsd.torch.dtype": "float64",
                             "tsd.query.mesh": MESH}),
                   mesh_devices=[CPU] * 8))
    single = fill(TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                                 "tsd.torch.dtype": "float64"})))
    got = run_both(jt, tt, q)
    v = np.asarray(got[0][4])
    assert np.all(v > 0.1) and np.all(v < 10.0)
    assert_rows_close(got, rows(single.execute_query(
        TSQuery.from_json(q).validate())))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mesh_spec", MESHES)
def test_mesh_warm_repeat_uses_device_cache(mesh_spec, path):
    """The cut device batch (point path: the prepared-batch hit) or grid
    (grid path) serves a warm repeat, equal to the cold answer bit for
    bit; a write invalidates it, and both packages see the write."""
    keys = {**PATHS[path], "tsd.query.device_cache_mb": "256"}
    jt, tt = pair(mesh_spec, keys)
    q = uri_query("sum:1m-avg:m{dc=*}")
    first = run_both(jt, tt, q)
    cache = tt.device_grid_cache
    assert len(cache) == 1
    key = next(iter(cache._entries))
    assert tt.query_mesh in key
    hits = cache.hits
    before = counts()
    warm = run_both(jt, tt, q)
    assert cache.hits == hits + 1
    assert counts()[:2] == (before[0] + (path == "point"),
                            before[1] + (path == "grid"))
    assert [np.asarray(r[4]).tobytes() for r in warm] == \
        [np.asarray(r[4]).tobytes() for r in first]
    for t in (jt, tt):
        t.add_point("m", T0 + 30, 10_000.0, {"host": "h000", "dc": "dc0",
                                            "rack": "r0"})
    after = run_both(jt, tt, q)
    assert after != warm


def test_mesh_groupby_change_reuses_cached_batch():
    """Group ids are per query: the cached cut batch answers another
    group-by (the hit uploads only the new group ids)."""
    keys = {**ENGINE_KEYS, "tsd.query.device_cache_mb": "256"}
    jt, tt = pair(keys=keys)
    run_both(jt, tt, uri_query("sum:1m-avg:m"))
    hits = tt.device_grid_cache.hits
    got = run_both(jt, tt, uri_query("sum:1m-avg:m{dc=*}"))
    assert tt.device_grid_cache.hits == hits + 1
    assert len(got) == 6


def test_cache_keys_hold_the_mesh():
    """An entry made under a mesh and one made without can never serve
    each other: the mesh (or None) is part of both keys."""
    mesh = tsp  # any non-None marker object
    sids = np.arange(4)
    bts = np.arange(3) * 60_000

    class Store:
        instance_id = 7

    a = tengine.grid_cache_key(Store, sids, 0, 1, bts, 60_000, "sum")
    b = tengine.grid_cache_key(Store, sids, 0, 1, bts, 60_000, "sum", mesh)
    assert a != b and a[-1] is None and b[-1] is mesh
    keys = {**ENGINE_KEYS, "tsd.query.device_cache_mb": "256"}
    _jt, tt = pair(keys=keys)
    plain = port_of(_jt, {k: v for k, v in keys.items()})
    q = TSQuery.from_json(uri_query("p99:1m-avg:m{dc=*}")).validate()
    tt.execute_query(q)
    plain.execute_query(q)
    (kt,) = tt.device_grid_cache._entries
    (kp,) = plain.device_grid_cache._entries
    assert kt[-2] is tt.query_mesh and kt[-1] == ("pct", 6)
    assert kp[-2] is None and kp[-1] == ("rank", 6)


@pytest.mark.parametrize("m", ["sum:1m-avg:m{dc=*}",
                               "p99:1m-avg:m{dc=*}"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_mesh_query_never_takes_the_host_tail(m, path):
    """At the default host-tail budgets a query this small runs its tail
    on the host; with a mesh it runs over the mesh, and the host pool
    stays empty."""
    keys = {k: v for k, v in PATHS[path].items()
            if not k.startswith("tsd.query.host_tail")}
    keys["tsd.query.device_cache_mb"] = "256"
    jt, tt = pair(keys=keys)
    cfg = Config(**keys)
    assert tengine.host_tail_for_dims(cfg, 24, 60, 6, False,
                                      m.split(":")[0]) is not None
    before = counts()
    run_both(jt, tt, uri_query(m))
    after = counts()
    assert after[0] + after[1] == before[0] + before[1] + 1
    hpool = tt.host_prep_cache
    assert hpool is None or len(hpool) == 0


def test_two_cold_calls_give_the_same_bits():
    """float32 on the mesh, caches dropped between the calls."""
    metrics = {"m": irregular(40, 60, 5)}
    jt = reference_tsdb(metrics)
    tt = TSDB(Config(**{"tsd.torch.device": "cpu", **ENGINE_KEYS,
                        "tsd.query.mesh": MESH}), mesh_devices=[CPU] * 8)
    load_arrays(tt, "m", *export(jt, "m"))
    q = TSQuery.from_json(uri_query(DC)).validate()
    out = []
    for _ in range(2):
        tt.drop_caches()
        out.append([r.dps_arrays[1].tobytes() for r in tt.execute_query(q)])
    assert out[0] == out[1]


def test_breaker_counts_a_mesh_failure(monkeypatch):
    """Every mesh dispatch runs under ``_run_device``: a failure inside
    the sharded step is counted and raised."""
    jt, tt = pair()

    def boom(*a, **k):
        raise RuntimeError("sharded step failed")

    monkeypatch.setattr(tsp, "run_sharded_device", boom)
    q = TSQuery.from_json(uri_query(DC)).validate()
    total = tt.device_breaker.total_failures
    with pytest.raises(RuntimeError, match="sharded step failed"):
        tt.execute_query(q)
    assert tt.device_breaker.total_failures == total + 1


def test_warmup_runs_the_mesh_grid_step():
    from opentsdb_tpu_torch.tsd.warmup import run_warmup, warmup_shapes
    _jt, tt = pair(keys=GRID_ON)
    tt.config.override_config("tsd.tpu.warmup.budget_s", "0")
    before = tsp.run_sharded_grid.runs
    ran = run_warmup(tt)
    # {sum, avg} x {plain, rate} and p95/p99 per class, nothing else
    assert ran == 6 * len(warmup_shapes(tt)) > 0
    assert tsp.run_sharded_grid.runs - before == ran


def test_oversized_mesh_raises_where_the_reference_degrades():
    """ROADMAP Queue 3 item 16. ``tsd.query.mesh=series:64`` over 8
    devices: the reference logs, runs single-device and answers
    (``opentsdb_tpu/core/tsdb.py:972-984``); the port's ``TSDB()``
    raises ValueError (no fallback)."""
    cfg = {"tsd.core.auto_create_metrics": "true",
           "tsd.query.mesh": "series:64"}
    jt = JTSDB(JConfig(**{**cfg, "tsd.tpu.platform": "cpu"}))
    jt.add_point("m", T0, 1.0, {"host": "a"})
    assert jt.query_mesh is None
    res = jt.execute_query(JQuery.from_json(uri_query("sum:m"))
                           .validate())
    assert len(res) == 1 and len(res[0].dps) == 1
    with pytest.raises(ValueError, match="wants 64 devices, 8 available"):
        TSDB(Config(**{**cfg, "tsd.torch.device": "cpu"}),
             mesh_devices=[CPU] * 8)
