"""The port's rollups (``opentsdb_tpu_torch/rollup/``, the engine's tier
selection and avg path) against the JAX package's, on the CPU.

- Config: ``RollupConfig`` and ``RollupInterval`` as the reference's.
- The job's tiles: ``_rollup_tile_dense``, ``_rollup_tile`` and
  ``_coarsen`` on the same seeded inputs as the JAX functions (x64):
  counts, mins, maxes and NaN cells equal, sums within rtol 1e-12.
- The whole job: ``run_rollup_job`` by both routes (the storage route
  and ``tsd.rollups.job.device=true``) against the JAX package's on 9
  irregular series, with a split window and an lcm-capped direct tier;
  every tier series' points equal as above.
- The read side: each routing case of the reference's rollup tests on
  both packages, at the point-path keys and with the grid path on, held
  as ``torch_pair.run_both`` holds a query (rtol 1e-9).
- The result cache: a raw write keeps a tier answer's entry, the first
  point of an empty tier changes the answer.
- The keys that turn on a subsystem the port lacks are refused.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_pair import (ENGINE_KEYS, GRID_ON, JConfig, JQuery, JTSDB, T0,
                        assert_rows_close, rows)

import jax.numpy as jnp
from opentsdb_tpu.rollup import config as jconfig
from opentsdb_tpu.rollup import job as jjob
from opentsdb_tpu.rollup.store import RollupStore as JRollupStore
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.rollup import config as tconfig
from opentsdb_tpu_torch.rollup import job as tjob
from opentsdb_tpu_torch.rollup.store import RollupStore

ROOT = Path(__file__).resolve().parent.parent
ROLLUPS = {"tsd.rollups.enable": "true",
           "tsd.core.auto_create_metrics": "true"}
KEY_SETS = {"engine": ENGINE_KEYS, "grid": GRID_ON}


def jtsdb(**extra) -> JTSDB:
    return JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", **ROLLUPS,
                            **ENGINE_KEYS, **extra}))


def ptsdb(**extra) -> TSDB:
    return TSDB(Config(**{"tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64", **ROLLUPS,
                          **ENGINE_KEYS, **extra}))


def close(*tsdbs) -> None:
    for t in tsdbs:
        t.shutdown()
        pool = getattr(t, "_fanout_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)


# -- config (ref: TestRollupConfig, TestRollupInterval) ----------------------

@pytest.mark.parametrize("doc", [
    None,
    [{"interval": "5m"}],
    [{"interval": "1h", "rowSpan": "1y", "defaultInterval": True},
     {"interval": "10m", "table": "t10", "preAggregationTable": "p10"}],
    {"intervals": [{"interval": "1m"}, {"interval": "1d"}],
     "aggregationIds": {"sum": 0, "count": 1, "min": 2, "max": 3,
                        "dev": 4}}])
def test_config_json_round_trip(doc):
    """The default config and the reference's JSON forms (a bare list,
    an object with aggregation ids) give the reference's config, and
    its JSON round-trips."""
    def make(mod):
        return (mod.RollupConfig.default() if doc is None
                else mod.RollupConfig.from_json(doc))
    want, got = make(jconfig), make(tconfig)
    assert got.to_json() == want.to_json()
    assert tconfig.RollupConfig.from_json(got.to_json()).to_json() == \
        got.to_json()
    assert got.id_to_agg == want.id_to_agg
    assert [(iv.interval_ms, iv.unit) for iv in got.intervals] == \
        [(iv.interval_ms, iv.unit) for iv in want.intervals]


@pytest.mark.parametrize("ms", [1, 30_000, 60_000, 90_000, 120_000,
                                600_000, 3_600_000, 5_400_000, 7_200_000,
                                86_400_000])
def test_best_match(ms):
    for cfg in ({"intervals": [{"interval": "1m"}, {"interval": "1h"}]},
                [{"interval": "1m"}, {"interval": "9m"},
                 {"interval": "10m"}, {"interval": "2h"}]):
        want = jconfig.RollupConfig.from_json(cfg).best_match(ms)
        got = tconfig.RollupConfig.from_json(cfg).best_match(ms)
        assert (got and got.interval) == (want and want.interval)


def test_config_errors():
    with pytest.raises(ValueError):
        tconfig.RollupConfig([])
    cfg = tconfig.RollupConfig.default()
    assert cfg.get_interval("1m").table == "tsdb-rollup-1m"
    with pytest.raises(ValueError, match="no rollup tier"):
        cfg.get_interval("7m")
    with pytest.raises(ValueError):
        tconfig.RollupInterval("t", "p", "1x")


def test_config_from_file(tmp_path):
    path = tmp_path / "rollups.json"
    path.write_text(json.dumps([{"interval": "15m"}, {"interval": "1d"}]))
    t = ptsdb(**{"tsd.rollups.config": str(path)})
    assert [iv.interval for iv in t.rollup_config.intervals] == \
        ["15m", "1d"]
    assert t.rollup_store.tier("15m", "SUM") is \
        t.rollup_store.tier("15m", "sum")
    with pytest.raises(ValueError, match="unsupported rollup aggregator"):
        t.rollup_store.tier("15m", "avg")
    with pytest.raises(ValueError, match="no rollup tier"):
        t.rollup_store.tier("1m", "sum")


# -- the job's tiles ----------------------------------------------------------

def held_to(got, want) -> None:
    """[4, S, B] grids: the same NaN cells, count/min/max equal, sums
    within rtol 1e-12."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)


def _tile_values(seed: int, s: int, b: int, k: int, nan: float):
    rng = np.random.default_rng(seed)
    v = rng.normal(100.0, 15.0, (s, b * k))
    v[rng.random((s, b * k)) < nan] = np.nan
    v[0, :k] = np.nan                     # an empty cell
    return v


@pytest.mark.parametrize("seed,s,b,k,nan", [
    (0, 7, 5, 4, 0.0), (1, 13, 60, 60, 0.1), (2, 1, 3, 1, 0.3),
    (3, 40, 12, 5, 0.5)])
def test_tile_dense(seed, s, b, k, nan):
    v = _tile_values(seed, s, b, k, nan)
    want = jjob._rollup_tile_dense(jnp.asarray(v), b, k)
    held_to(tjob._rollup_tile_dense(torch.from_numpy(v), b, k), want)


def test_tile_dense_sums_in_time_order():
    """The dense tile's sums equal a left-to-right float64 sum from 0.0
    (``tss_bucket_reduce``'s order) bit for bit."""
    v = _tile_values(5, 9, 6, 60, 0.1)
    got = tjob._rollup_tile_dense(torch.from_numpy(v), 6, 60)[0].numpy()
    want = np.zeros((9, 6))
    for j in range(60):
        x = v.reshape(9, 6, 60)[:, :, j]
        want += np.where(np.isnan(x), 0.0, x)
    want[np.isnan(got)] = np.nan
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def _irregular_tile(seed: int, s: int, p: int, b: int):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, p + 1, s)
    counts[0] = p
    vals = np.full((s, p), np.nan)
    bidx = np.full((s, p), -1, dtype=np.int32)
    for i in range(s):
        n = counts[i]
        vals[i, :n] = rng.normal(50.0, 20.0, n)
        bidx[i, :n] = np.sort(rng.integers(0, b, n))
    vals[rng.random((s, p)) < 0.05] = np.nan
    return vals, bidx


@pytest.mark.parametrize("seed,s,p,b", [(0, 9, 30, 4), (1, 25, 64, 16),
                                        (2, 3, 5, 7), (3, 50, 120, 60)])
def test_tile_irregular(seed, s, p, b):
    vals, bidx = _irregular_tile(seed, s, p, b)
    want = jjob._rollup_tile(jnp.asarray(vals), jnp.asarray(bidx), b)
    held_to(tjob._rollup_tile(torch.from_numpy(vals),
                              torch.from_numpy(bidx), b), want)


@pytest.mark.parametrize("first,nf,factor", [(0, 120, 60), (17, 100, 60),
                                             (3, 5, 9), (58, 4, 60),
                                             (0, 360, 360), (5, 31, 10)])
def test_coarsen(first, nf, factor):
    """Fine buckets ``first .. first+nf-1`` (in base intervals from a
    coarse edge) onto coarse buckets of ``factor``: the port's pad and
    reshape against the JAX one-hot coarsen."""
    rng = np.random.default_rng(first + nf)
    v = rng.normal(10.0, 3.0, (4, nf * 3))
    v[rng.random(v.shape) < 0.2] = np.nan
    fine = np.array(jjob._rollup_tile_dense(jnp.asarray(v), nf, 3))
    fine_ts = first + np.arange(nf)
    coarse_idx = (fine_ts // factor - first // factor).astype(np.int32)
    nc = int(coarse_idx[-1]) + 1
    want = jjob._coarsen(jnp.asarray(fine), jnp.asarray(coarse_idx), nc)
    got = tjob._coarsen(torch.from_numpy(fine), first % factor, factor, nc)
    held_to(got, want)


# -- the whole job ---------------------------------------------------------

def tier_points(t, metric: str, tiers=("1m", "1h")) -> dict:
    """{(interval, agg, tag names): (timestamps, values)} of every tier
    series of ``metric``."""
    out = {}
    mid = t.uids.metrics.get_id(metric)
    for iv in tiers:
        for agg in ("sum", "count", "min", "max"):
            store = t.rollup_store.tier(iv, agg)
            for sid in store.series_ids_for_metric(mid):
                rec = store.series(int(sid))
                batch = store.materialize([int(sid)], 0, 2 ** 62)
                ts, vals = batch.ts_ms, batch.values
                tags = tuple(sorted(
                    (t.uids.tag_names.get_name(k),
                     t.uids.tag_values.get_name(v)) for k, v in rec.tags))
                out[(iv, agg, tags)] = (np.asarray(ts).tolist(),
                                        np.asarray(vals, dtype=np.float64))
    return out


def assert_tiers_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for key in want:
        assert got[key][0] == want[key][0], key
        g, w = got[key][1], want[key][1]
        if key[1] == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(key))


def seed_irregular(t, metric: str = "m.njob", n_series: int = 9,
                   span: int = 7200, seed: int = 11) -> int:
    """``n_series`` series of 20-300 points at random whole seconds of
    ``span`` (the reference's ``TestNativeJobPath`` data)."""
    rng = np.random.default_rng(seed)
    for i in range(n_series):
        n = int(rng.integers(20, 300))
        ts = T0 + np.sort(rng.choice(span, n, replace=False))
        t.add_points(metric, ts.astype(np.int64), rng.normal(50, 20, n),
                     {"host": f"h{i}"})
    return T0


@pytest.mark.parametrize("route", ["storage", "device"])
@pytest.mark.parametrize("backend", ["native", "memory"])
def test_job_matches_reference(route, backend):
    dev = {"tsd.rollups.job.device": str(route == "device").lower()}
    j = jtsdb(**dev)
    p = ptsdb(**dev, **{"tsd.storage.backend": backend})
    for t in (j, p):
        seed_irregular(t)
    span = ((T0 - 30) * 1000, (T0 + 7200) * 1000)
    want = jjob.run_rollup_job(j, *span)
    got = tjob.run_rollup_job(p, *span)
    assert got == want == {"1m": got["1m"], "1h": got["1h"]}
    assert_tiers_equal(tier_points(p, "m.njob"), tier_points(j, "m.njob"))
    close(j, p)


def test_job_routes_agree():
    """Storage and device routes of the port: the 1m sums bit for bit
    on regular data (both add in time order), the rest as always."""
    out = {}
    for route in ("false", "true"):
        t = ptsdb(**{"tsd.rollups.job.device": route})
        ts = T0 + np.arange(7200, dtype=np.int64)
        rng = np.random.default_rng(5)
        for i in range(6):
            t.add_points("m.reg", ts, rng.normal(100, 15, len(ts)),
                         {"host": f"h{i}"})
        written = tjob.run_rollup_job(t, T0 * 1000, (T0 + 7200) * 1000 - 1)
        assert written == {"1m": 6 * 120 * 4, "1h": 6 * 2 * 4}
        out[route] = tier_points(t, "m.reg")
        close(t)
    assert_tiers_equal(out["true"], out["false"])
    for key, (_, vals) in out["true"].items():
        if key[0] == "1m":
            np.testing.assert_array_equal(
                vals.view(np.int64), out["false"][key][1].view(np.int64))


@pytest.mark.parametrize("route", ["storage", "device"])
def test_job_split_window(monkeypatch, route):
    """An irregular window past the padded tile's cell cap splits (by
    narrower windows, then by series halves) on both packages."""
    dev = {"tsd.rollups.job.device": str(route == "device").lower()}
    for mod in (jjob, tjob):
        monkeypatch.setattr(mod, "_PADDED_TILE_MAX_CELLS", 2_000)
    j, p = jtsdb(**dev), ptsdb(**dev)
    for t in (j, p):
        seed_irregular(t, n_series=5, seed=3)
    span = (T0 * 1000, (T0 + 7200) * 1000 - 1)
    want = jjob.run_rollup_job(j, *span)
    got = tjob.run_rollup_job(p, *span)
    assert got == want
    assert_tiers_equal(tier_points(p, "m.njob"), tier_points(j, "m.njob"))
    close(j, p)


def _lcm_config():
    return [{"interval": "1m"}, {"interval": "9m"}, {"interval": "10m"},
            {"interval": "2h"}]


@pytest.mark.parametrize("route", ["storage", "device"])
def test_job_lcm_capped_and_direct_tiers(route):
    """The reference's lcm case (``test_rollup.py:140``): 1m with 9m,
    10m and 2h, whose factors' lcm reaches the window cap (360), over
    3h at one point every 30 s, on both packages."""
    dev = {"tsd.rollups.job.device": str(route == "device").lower()}
    j, p = jtsdb(**dev), ptsdb(**dev)
    j.rollup_config = jconfig.RollupConfig.from_json(_lcm_config())
    j.rollup_store = JRollupStore(j.rollup_config)
    p.rollup_config = tconfig.RollupConfig.from_json(_lcm_config())
    p.rollup_store = RollupStore(p.rollup_config, p.rollup_store._factory)
    for t in (j, p):
        for i in range(360):
            t.add_point("m", T0 + i * 30, 1.0 + (i % 7), {"host": "a"})
    span = (T0 * 1000, (T0 + 10800) * 1000 - 1)
    want = jjob.run_rollup_job(j, *span)
    got = tjob.run_rollup_job(p, *span)
    assert got == want == {"1m": 180 * 4, "9m": 20 * 4, "10m": 18 * 4,
                           "2h": 2 * 4}
    tiers = ("1m", "9m", "10m", "2h")
    assert_tiers_equal(tier_points(p, "m", tiers),
                       tier_points(j, "m", tiers))
    close(j, p)


def test_job_direct_tier(monkeypatch):
    """A tier whose factor passes the window cap takes its own pass."""
    for mod in (jjob, tjob):
        monkeypatch.setattr(mod, "_MAX_WINDOW_BUCKETS", 30)
    j, p = jtsdb(), ptsdb()
    for t in (j, p):
        seed_irregular(t, n_series=4, seed=8)
    span = (T0 * 1000, (T0 + 7200) * 1000 - 1)
    assert tjob.run_rollup_job(p, *span) == jjob.run_rollup_job(j, *span)
    assert_tiers_equal(tier_points(p, "m.njob"), tier_points(j, "m.njob"))
    close(j, p)


def test_job_series_subset_and_intervals():
    j, p = jtsdb(), ptsdb()
    for t in (j, p):
        seed_irregular(t, n_series=6, seed=2)
    span = (T0 * 1000, (T0 + 7200) * 1000 - 1)
    sids = [1, 4]
    want = jjob.run_rollup_job(j, *span, ["1m"], series_ids=sids,
                               series_chunk=1)
    seen = []
    got = tjob.run_rollup_job(p, *span, ["1m"], series_ids=sids,
                              series_chunk=1,
                              progress=lambda d, n: seen.append((d, n)))
    assert got == want and set(got) == {"1m"}
    assert seen == [(1, 2), (2, 2)]
    assert_tiers_equal(tier_points(p, "m.njob", ("1m",)),
                       tier_points(j, "m.njob", ("1m",)))
    close(j, p)


def test_job_without_rollups_raises():
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    assert t.rollup_store is None
    with pytest.raises(RuntimeError, match="rollups are not enabled"):
        tjob.run_rollup_job(t, 0, 1000)


def test_memory_store_append_grid():
    """The memory store's ``append_grid`` writes what the native one
    does."""
    from opentsdb_tpu_torch.core.store import TimeSeriesStore
    from opentsdb_tpu_torch.native.store_backend import \
        NativeTimeSeriesStore
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(5, 7))
    mask = rng.random((5, 7)) < 0.6
    bts = T0 * 1000 + 60_000 * np.arange(7)
    out = []
    for store in (TimeSeriesStore(), NativeTimeSeriesStore()):
        sids = store.get_or_create_series_bulk(1, [[(1, i)] for i in
                                                   range(5)])
        assert store.append_grid(sids[::-1], bts, grid, mask) == mask.sum()
        assert store.total_points() == mask.sum()
        batch = store.materialize(sids, 0, 2 ** 62)
        out.append((batch.series_idx.tolist(), batch.ts_ms.tolist(),
                    batch.values.tolist()))
        with pytest.raises(IndexError):
            store.append_grid([9], bts, grid[:1], mask[:1])
    assert out[0] == out[1]


# -- writes -------------------------------------------------------------------

AGG_WRITES = [
    ("tier", ("m", T0, 60.0, {"host": "a"}, False, "1m", "SUM")),
    ("tier-ms", ("m", T0 * 1000 + 5, 3, {"host": "a"}, False, "1h", "max")),
    ("preagg", ("m", T0, 5.0, {"host": "a"}, True, None, None, "sum")),
    ("preagg-tier", ("m", T0, 5.0, {"host": "a"}, True, "1m", "count",
                     "avg")),
    ("unknown-interval", ("m", T0, 1.0, {"h": "a"}, False, "9m", "sum")),
    ("missing-agg", ("m", T0, 1.0, {"h": "a"}, False, "1m", None)),
    ("bad-agg", ("m", T0, 1.0, {"h": "a"}, False, "1m", "p99")),
    ("missing-groupby", ("m", T0, 1.0, {"h": "a"}, True, None, None)),
    ("bad-metric", ("bad m!", T0, 1.0, {"h": "a"}, False, "1m", "sum")),
    ("no-tags", ("m", T0, 1.0, {}, False, "1m", "sum")),
]


@pytest.mark.parametrize("name,args", AGG_WRITES,
                         ids=[w[0] for w in AGG_WRITES])
def test_add_aggregate_point(name, args):
    """The same store, series tags and value, or the same error type and
    message, as the reference."""
    j, p = jtsdb(), ptsdb()
    outcome = []
    for t in (j, p):
        try:
            t.add_aggregate_point(*args)
            outcome.append(None)
        except Exception as e:  # noqa: BLE001 - compared below
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]
    if outcome[0] is None:
        for t_ in (j, p):
            assert t_.datapoints_added == 1
        interval, agg = args[5], args[6]
        if interval is None:
            stores = [t.rollup_store.preagg_store() for t in (j, p)]
        else:
            stores = [t.rollup_store.tier(interval, agg.lower())
                      for t in (j, p)]
        got = []
        for t, store in zip((j, p), stores):
            rec = store.series(0)
            got.append(({t.uids.tag_names.get_name(k):
                         t.uids.tag_values.get_name(v) for k, v in rec.tags},
                        store.materialize([0], 0, 2 ** 62).values.tolist(),
                        store.materialize([0], 0, 2 ** 62).ts_ms.tolist()))
        assert got[0] == got[1]
    close(j, p)


def test_add_aggregate_point_without_rollups():
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    with pytest.raises(RuntimeError, match="rollups are not enabled"):
        t.add_aggregate_point("m", T0, 1.0, {"h": "a"}, False, "1m", "sum")


def test_serve_version_and_memory_info():
    t = ptsdb()
    v0 = t.serve_version()
    t.add_aggregate_point("m", T0, 1.0, {"h": "a"}, False, "1m", "sum")
    v1 = t.serve_version()
    t.add_aggregate_point("m", T0, 2.0, {"h": "a"}, True, None, None, "sum")
    assert len({v0, v1, t.serve_version()}) == 3
    info = t.memory_info()
    assert set(info) == {"raw", "rollup:preagg", "rollup:1m:sum", "total"}
    assert info["rollup:1m:sum"]["points"] == 1
    assert info["total"]["points"] == 2 and info["total"]["series"] == 2
    close(t)


# -- the read side ---------------------------------------------------------

PTS = 40


def seed_tier(t, metric="r.m", hosts=("h0", "h1"), interval="1m"):
    """1m sum and count cells by the aggregate write path (ref:
    ``test_query_integration_rollup._seed_tier``)."""
    ts = T0 + 60 * np.arange(PTS, dtype=np.int64)
    for gi, h in enumerate(hosts):
        vals = 10.0 * (gi + 1) + np.arange(PTS, dtype=np.float64)
        for j in range(PTS):
            t.add_aggregate_point(metric, int(ts[j]), float(vals[j] * 60.0),
                                  {"host": h}, False, interval, "sum")
            t.add_aggregate_point(metric, int(ts[j]), 60.0, {"host": h},
                                  False, interval, "count")


def seed_raw_10s(t, metric="m", n=120, value=None):
    for i in range(n):
        t.add_point(metric, T0 + i * 10, float(i if value is None else value),
                    {"host": "a"})


def job(t, start_s, end_s, intervals=None):
    mod = jjob if isinstance(t, JTSDB) else tjob
    mod.run_rollup_job(t, start_s * 1000, end_s * 1000, intervals)


def drop_raw(t, metric):
    sids = t.store.series_ids_for_metric(t.uids.metrics.get_id(metric))
    t.store.delete_range(sids, 0, 2 ** 60)


def weighted(t):
    for i in range(6):
        t.add_point("w", T0 + i * 10, 12.0, {"host": "a"})
    for i in range(2):
        t.add_point("w", T0 + 60 + i * 10, 24.0, {"host": "a"})
    job(t, T0, T0 + 119)
    drop_raw(t, "w")


def many_series(t):
    rng = np.random.default_rng(4)
    ts = T0 + 30 * np.arange(240, dtype=np.int64)
    for i in range(12):
        t.add_points("g.m", ts, rng.normal(100, 15, len(ts)),
                     {"host": f"h{i}", "dc": f"dc{i % 3}"})
    job(t, T0, T0 + 7199)


def _q(metric, ds, agg="sum", end=T0 + PTS * 60, start=T0, **sub):
    return {"start": str(start), "end": str(end),
            "queries": [{"aggregator": agg, "metric": metric,
                         "downsample": ds, **sub}]}


GB_HOST = [{"type": "wildcard", "tagk": "host", "filter": "*",
            "groupBy": True}]
GB_DC = [{"type": "wildcard", "tagk": "dc", "filter": "*", "groupBy": True}]

# (case, setup of either TSDB, query, whether the answer is empty)
ROUTING = [
    ("sum-from-tier", seed_tier,
     _q("r.m", "1m-sum", tags={"host": "h0"}), False),
    ("avg-from-sum-count", seed_tier,
     _q("r.m", "1m-avg", tags={"host": "h0"}), False),
    ("avg-groupby", seed_tier, _q("r.m", "1m-avg", filters=GB_HOST), False),
    ("coarser-downsample", seed_tier,
     _q("r.m", "5m-sum", tags={"host": "h0"}), False),
    ("rollup-raw-usage",
     lambda t: (seed_tier(t), t.add_points(
         "r.m", T0 + 60 * np.arange(PTS), np.full(PTS, 7.0),
         {"host": "h0"})),
     _q("r.m", "1m-sum", rollupUsage="ROLLUP_RAW", tags={"host": "h0"}),
     False),
    ("fallback-to-raw",
     lambda t: t.add_points("rf.m", T0 + 60 * np.arange(PTS),
                            np.arange(PTS, dtype=np.float64),
                            {"host": "h0"}),
     _q("rf.m", "1m-sum", rollupUsage="ROLLUP_FALLBACK",
        tags={"host": "h0"}), False),
    ("fallback-raw-usage",
     lambda t: (seed_tier(t, metric="other.m"), t.add_points(
         "rf.m", T0 + 60 * np.arange(PTS),
         np.arange(PTS, dtype=np.float64), {"host": "h0"})),
     _q("rf.m", "1m-avg", rollupUsage="ROLLUP_FALLBACK_RAW"), False),
    ("nofallback-empty-tier",
     lambda t: (t.add_points("rn.m", T0 + 60 * np.arange(PTS),
                             np.arange(PTS, dtype=np.float64),
                             {"host": "h0"}),
                seed_tier(t, metric="other.m")),
     _q("rn.m", "1m-sum", rollupUsage="ROLLUP_NOFALLBACK"), True),
    ("job-end-to-end",
     lambda t: (t.add_points("rj.m", T0 + 30 * np.arange(2 * PTS),
                             np.arange(2 * PTS, dtype=np.float64),
                             {"host": "h0"}),
                job(t, T0, T0 + 2 * PTS * 30, ["1m"])),
     _q("rj.m", "1m-sum", tags={"host": "h0"}), False),
    ("rate-on-tier", seed_tier,
     _q("r.m", "1m-sum", rate=True, tags={"host": "h0"}), False),
    ("job-1m-tier", lambda t: (seed_raw_10s(t), job(t, T0, T0 + 1200)),
     _q("m", "1m-sum", start=T0 - 60, end=T0 + 1300), False),
    ("job-raw-usage", lambda t: (seed_raw_10s(t), job(t, T0, T0 + 1200)),
     _q("m", "1m-sum", start=T0 - 60, end=T0 + 1300,
        rollupUsage="ROLLUP_RAW"), False),
    ("unaligned-interval", lambda t: (seed_raw_10s(t), job(t, T0, T0 + 1200)),
     _q("m", "30s-sum", start=T0 - 60, end=T0 + 1300), False),
    ("job-avg", lambda t: (seed_raw_10s(t), job(t, T0, T0 + 1200)),
     _q("m", "1m-avg", start=T0 - 60, end=T0 + 1300), False),
    ("avg-after-raw-delete",
     lambda t: (seed_raw_10s(t), job(t, T0, T0 + 1200), drop_raw(t, "m")),
     _q("m", "1m-avg", start=T0 - 60, end=T0 + 1300), False),
    ("avg-weighted", weighted,
     _q("w", "2m-avg", start=T0 - 60, end=T0 + 1300), False),
    ("count-over-count-tier",
     lambda t: (t.add_points("m.cnt", np.arange(T0, T0 + 3600, 10),
                             np.ones(360), {"h": "a"}),
                job(t, T0, T0 + 3600), drop_raw(t, "m.cnt")),
     _q("m.cnt", "1h-count", end=T0 + 3599), False),
    ("tier-rate-groupby", many_series,
     _q("g.m", "5m-avg", rate=True, filters=GB_DC, end=T0 + 7199), False),
    ("tier-max-1h", many_series,
     _q("g.m", "1h-max", agg="max", filters=GB_DC, end=T0 + 7199), False),
    ("tier-min-none", many_series,
     _q("g.m", "10m-min", agg="none", end=T0 + 7199), False),
    ("tier-count-groupby", many_series,
     _q("g.m", "5m-count", filters=GB_DC, end=T0 + 7199), False),
    ("tier-avg-fill-zero", many_series,
     _q("g.m", "30m-avg-zero", filters=GB_DC, end=T0 + 7199), False),
    ("tier-avg-calendar", many_series,
     _q("g.m", "1hc-avg", filters=GB_DC, end=T0 + 7199), False),
    ("tier-sum-explicit-tags", many_series,
     {**_q("g.m", "5m-sum", end=T0 + 7199,
           filters=[{"type": "literal_or", "tagk": "dc",
                     "filter": "dc1", "groupBy": False},
                    {"type": "wildcard", "tagk": "host",
                     "filter": "*", "groupBy": False}],
           explicitTags=True)}, False),
]


def run_case(keys, setup, query, empty, extra=None):
    j = jtsdb(**keys, **(extra or {}))
    p = ptsdb(**keys, **(extra or {}))
    for t in (j, p):
        setup(t)
    want = rows(j.execute_query(JQuery.from_json(query).validate()))
    got = rows(p.execute_query(TSQuery.from_json(query).validate()))
    if empty:
        assert got == want == []
    else:
        assert_rows_close(got, want)
    close(j, p)
    return got


@pytest.mark.parametrize("keys", sorted(KEY_SETS))
@pytest.mark.parametrize("case,setup,query,empty", ROUTING,
                         ids=[c[0] for c in ROUTING])
def test_routing(keys, case, setup, query, empty):
    run_case(KEY_SETS[keys], setup, query, empty)


def test_routing_answers_from_tiers():
    """Spot values of the reference's tests: the tier answers, not
    raw."""
    got = run_case(ENGINE_KEYS, seed_tier,
                   _q("r.m", "1m-sum", tags={"host": "h0"}), False)
    np.testing.assert_allclose(got[0][4], (10.0 + np.arange(PTS)) * 60.0)
    got = run_case(ENGINE_KEYS, weighted,
                   _q("w", "2m-avg", start=T0 - 60, end=T0 + 1300), False)
    assert got[0][4] == [pytest.approx(15.0)]
    got = run_case(ENGINE_KEYS, ROUTING[16][1], ROUTING[16][2], False)
    assert got[0][4] == [360.0]


@pytest.mark.parametrize("keys", sorted(KEY_SETS))
def test_avg_over_budget_reads_raw(keys):
    """An avg whose [S, B] passes the cell budget reads raw data, where
    raw data exists (ref: engine.py:706-715): raw and tier values differ
    here, so the answer shows which store answered."""
    def setup(t):
        seed_tier(t)
        for h in ("h0", "h1"):
            t.add_points("r.m", T0 + 60 * np.arange(PTS),
                         np.full(PTS, 3.0), {"host": h})
    q = _q("r.m", "1m-avg", end=T0 + PTS * 60 - 1)
    got = run_case(KEY_SETS[keys], setup, q, False,
                   {"tsd.query.max_device_cells": str(2 * PTS)})
    assert got[0][4] == [6.0] * PTS
    got = run_case(KEY_SETS[keys], setup, q, False)
    assert got[0][4][0] == pytest.approx(30.0)


def test_count_tier_uses_sum_on_the_point_path():
    """``count`` over the count tier with the kernels' point path: the
    prepared batch reduces by sum, whatever the query names."""
    t = ptsdb()
    t.add_points("m.cnt", np.arange(T0, T0 + 3600, 10), np.ones(360),
                 {"h": "a"})
    tjob.run_rollup_job(t, T0 * 1000, (T0 + 3600) * 1000)
    drop_raw(t, "m.cnt")
    q = TSQuery.from_json(_q("m.cnt", "5m-count", end=T0 + 3599)).validate()
    got = t.execute_query(q)
    assert [v for _, v in got[0].dps] == [30.0] * 12
    close(t)


# -- the result cache --------------------------------------------------------

def test_result_cache_follows_the_selected_store():
    t = ptsdb(**{"tsd.query.cache.enable": "true"})
    seed_tier(t)
    q = _q("r.m", "1m-sum", tags={"host": "h0"})

    def run():
        return rows(t.execute_query(TSQuery.from_json(q).validate()))

    first = run()
    hits = t.result_cache.hits
    # a raw write does not touch the tier the answer came from
    t.add_point("r.m", T0, 1.0, {"host": "h0"})
    assert run() == first and t.result_cache.hits == hits + 1
    # a tier write does
    t.add_aggregate_point("r.m", T0 + 60 * PTS, 1.0, {"host": "h0"},
                          False, "1m", "sum")
    again = run()
    assert t.result_cache.hits == hits + 1 and again != first
    close(t)


def test_first_tier_point_changes_the_answer():
    t = ptsdb(**{"tsd.query.cache.enable": "true"})
    t.add_points("r.m", T0 + 60 * np.arange(PTS), np.full(PTS, 2.0),
                 {"host": "h0"})
    q = _q("r.m", "1m-sum")

    def run():
        return rows(t.execute_query(TSQuery.from_json(q).validate()))

    assert run()[0][4] == [2.0] * PTS
    t.add_aggregate_point("r.m", T0, 50.0, {"host": "h0"}, False, "1m",
                          "sum")
    assert run()[0][4] == [50.0]
    close(t)


def test_rollup_usage_is_part_of_the_cache_key():
    t = ptsdb(**{"tsd.query.cache.enable": "true"})
    seed_tier(t)
    t.add_points("r.m", T0 + 60 * np.arange(PTS), np.full(PTS, 7.0),
                 {"host": "h0"})
    q = _q("r.m", "1m-sum", tags={"host": "h0"})
    tier = rows(t.execute_query(TSQuery.from_json(q).validate()))
    q["queries"][0]["rollupUsage"] = "ROLLUP_RAW"
    raw = rows(t.execute_query(TSQuery.from_json(q).validate()))
    assert raw[0][4] == [7.0] * PTS and tier[0][4] != raw[0][4]
    sub = TSQuery.from_json(q).queries[0]
    assert sub.to_json()["rollupUsage"] == "ROLLUP_RAW"
    close(t)


# -- keys that turn on what is not ported ----------------------------------

@pytest.mark.parametrize("key,value", [
    ("tsd.lifecycle.enable", "true"),
    ("tsd.cluster.role", "shard"),
    ("tsd.cluster.role", "router"),
    ("tsd.core.meta.enable_realtime_ts", "true"),
    ("tsd.core.meta.enable_realtime_uid", "true"),
    ("tsd.core.meta.enable_tsuid_incrementing", "true"),
    ("tsd.core.meta.enable_tsuid_tracking", "true"),
    ("tsd.core.tree.enable_processing", "true")])
def test_unported_subsystem_keys_refused(key, value):
    with pytest.raises(NotImplementedError,
                       match=f"{key}={value} .*not ported yet \\(ROADMAP "
                       "Queue 1, the rest, with no device compute\\)"):
        TSDB(Config(**{"tsd.torch.device": "cpu", key: value}))
    # the default, spelled out, is no refusal
    off = "" if key == "tsd.cluster.role" else "false"
    TSDB(Config(**{"tsd.torch.device": "cpu", key: off}))


def test_rollups_enable_is_ported():
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.rollups.enable": "true"}))
    assert t.rollup_store is not None
    sub = TSQuery.from_json(_q("r.m", "1m-sum")).queries[0]
    assert sub.rollup_usage == "ROLLUP_NOFALLBACK"


# -- the command line ------------------------------------------------------

def test_cli_rollup(tmp_path):
    """``tools.cli rollup`` on a data_dir: the job's counts printed, the
    tiers in the snapshot, read back by a restart."""
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.storage.data_dir": str(tmp_path)}))
    seed_raw_10s(t)
    t.shutdown()
    out = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "rollup",
         str(T0), str(T0 + 1199), "--tsd.torch.device=cpu",
         f"--tsd.storage.data_dir={tmp_path}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["1m: 80 rollup points written",
                                       "1h: 4 rollup points written"]
    assert (tmp_path / "rollup-1m-sum" / "series.json").is_file()
    t = ptsdb(**{"tsd.storage.data_dir": str(tmp_path)})
    q = TSQuery.from_json(_q("m", "1m-sum", end=T0 + 1199)).validate()
    got = t.execute_query(q)
    assert [v for _, v in got[0].dps][:2] == [15.0, 51.0]
    close(t)
    bad = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "rollup",
         str(T0)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and "usage: tsdb rollup" in bad.stderr
