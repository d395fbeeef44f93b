"""The port's pipeline (``opentsdb_tpu_torch.ops``) against the JAX
reference on the same numpy inputs: ``execute_auto`` on complete data
(the fused kernels' plain versions) and on NaN-holed regular data (the
dense PyTorch tail), ``_rate_kernel``, ``fill_gaps``, the aggregator
reductions, the group stage and the host helpers.

Tolerance: float64 on both sides (conftest enables x64), rtol 1e-9 and
atol 1e-9 * max|x|; NaN positions and emit masks must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.core.store import PaddedBatch as JPadded
from opentsdb_tpu.ops import aggregators as jaggs
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import groupby as jgb
from opentsdb_tpu.ops import interp as jinterp
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu_torch.core.store import PaddedBatch as TPadded
from opentsdb_tpu_torch.ops import aggregators as taggs
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import groupby as tgb
from opentsdb_tpu_torch.ops import interp as tinterp
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import rate as trate

BASE_TS = 1_356_998_400_000
LINEAR_AGGS = ["sum", "zimsum", "pfsum", "avg", "count", "min", "max",
               "mimmin", "mimmax", "multiply", "squareSum", "dev",
               "first", "last", "diff"]
FILLS = ["none", "zero", "nan", "scalar"]


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


def _holed_grid(s=12, b=9, seed=0):
    """[S, B] grid with interior, leading and trailing holes, plus an
    all-NaN row and a single-value row."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(50.0, 20.0, size=(s, b))
    grid[rng.random((s, b)) < 0.3] = np.nan
    grid[0, :3] = np.nan          # leading
    grid[1, -3:] = np.nan         # trailing
    grid[2, :] = np.nan           # empty row
    grid[3, :] = np.nan
    grid[3, 4] = 7.0              # single value
    return grid


def _batch(s, b, k, g, seed=0, holes=False, counter=False):
    rng = np.random.default_rng(seed)
    p = b * k
    if counter:
        vals = np.cumsum(rng.uniform(1, 50, size=(s, p)), axis=1)
        vals[s // 2, p // 2:] -= vals[s // 2, p // 2] * 0.8
    else:
        vals = rng.normal(100.0, 15.0, size=(s, p))
    if holes:
        vals[rng.random((s, p)) < 0.25] = np.nan
        vals[0, :k] = np.nan                  # a whole leading bucket
        vals[1, -2 * k:] = np.nan             # trailing buckets
    ts_row = BASE_TS + 60_000 * np.arange(p, dtype=np.int64) // k
    ts2d = np.broadcast_to(ts_row, (s, p)).copy()
    counts = np.full(s, p, dtype=np.int64)
    sids = np.arange(s, dtype=np.int64)
    bidx = np.broadcast_to(np.repeat(np.arange(b, dtype=np.int32), k),
                           (s, p)).copy()
    bucket_ts = BASE_TS + 60_000 * np.arange(b, dtype=np.int64)
    gids = ((np.arange(s) * 5) % g).astype(np.int32)
    return (JPadded(sids, vals, ts2d, counts),
            TPadded(sids, vals, ts2d, counts), bidx, bucket_ts, gids)


def _specs(**kw):
    fp = kw.pop("fill_policy", "none")
    fv = {"zero": 0.0, "scalar": -3.5}.get(fp, float("nan"))
    return (jpipe.PipelineSpec(fill_policy=jds.FillPolicy(fp),
                               fill_value=fv, **kw),
            tpipe.PipelineSpec(fill_policy=tds.FillPolicy(fp),
                               fill_value=fv, **kw))


def _execute(s, b, k, g, ro=None, seed=0, holes=False, counter=False,
             **kw):
    jpad, tpad, bidx, bts, gids = _batch(s, b, k, g, seed=seed,
                                         holes=holes, counter=counter)
    jspec, tspec = _specs(num_series=s, num_buckets=b, num_groups=g, **kw)
    want, want_emit = jpipe.execute_auto(
        jpad, bidx, bts, gids, jspec,
        jrate.RateOptions(**ro) if ro else None)
    got, got_emit = tpipe.execute_auto(
        tpad, bidx, bts, gids, tspec,
        trate.RateOptions(**ro) if ro else None, dtype=torch.float64,
        device="cpu")
    _assert_close(got.numpy(), want)
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("agg", LINEAR_AGGS)
def test_execute_auto_holes(agg, fill):
    """NaN-holed regular data: the dense PyTorch tail (interpolation,
    fill policy, emission) against the reference's XLA dense path."""
    _execute(14, 6, 3, 4, seed=1, holes=True, ds_function="avg",
             agg_name=agg, fill_policy=fill)


@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg", ["sum", "zimsum", "pfsum", "avg",
                                 "count", "squareSum"])
def test_execute_auto_complete(agg, rate):
    """Complete data: the fused path (plain versions on CPU) against
    the reference's Pallas path."""
    _execute(20, 6, 4, 3, seed=2, ds_function="sum", agg_name=agg,
             rate=rate)


@pytest.mark.parametrize("agg", ["min", "dev", "first", "last"])
def test_execute_auto_complete_dense_aggs(agg):
    """Complete data with aggregators the kernels decline: both sides
    take their dense path."""
    _execute(20, 6, 4, 3, seed=3, ds_function="max", agg_name=agg,
             rate=True)


@pytest.mark.parametrize("ro,holes", [
    (dict(), True),
    (dict(counter=True, counter_max=2**32), False),
    (dict(counter=True, counter_max=2**32, reset_value=3.0), True),
    (dict(counter=True, counter_max=2**32, reset_value=3.0), False),
    (dict(counter=True, counter_max=2**32, drop_resets=True), False),
    (dict(counter=True, counter_max=2**32, drop_resets=True), True),
])
def test_execute_auto_rate_options(ro, holes):
    _execute(16, 7, 3, 3, ro=ro, seed=4, holes=holes, counter=True,
             ds_function="last", agg_name="sum", rate=True,
             rate_counter=ro.get("counter", False),
             rate_drop_resets=ro.get("drop_resets", False))


def test_execute_auto_emit_raw():
    """Aggregator 'none': per-series rows, no group stage."""
    s = 9
    _execute(s, 5, 2, s, seed=5, holes=True, ds_function="sum",
             agg_name="none", emit_raw=True, rate=True)


def test_execute_auto_irregular_not_ported():
    """A batch whose first row lost its last point, which raised
    NotImplementedError before the padded layout's port, against the
    reference's padded path."""
    jpad, tpad, bidx, bts, gids = _batch(6, 3, 2, 2)
    counts = tpad.counts.copy()
    counts[0] -= 1
    vals = tpad.values2d.copy()
    vals[0, -1] = np.nan
    bidx = bidx.copy()
    bidx[0, -1] = -1
    jspec, tspec = _specs(num_series=6, num_buckets=3, num_groups=2,
                          ds_function="sum", agg_name="sum")
    want, want_emit = jpipe.execute_auto(
        jpad._replace(counts=counts, values2d=vals), bidx, bts, gids,
        jspec)
    got, got_emit = tpipe.execute_auto(
        tpad._replace(counts=counts, values2d=vals), bidx, bts, gids,
        tspec, None, dtype=torch.float64, device="cpu")
    _assert_close(got.numpy(), want)
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)


@pytest.mark.parametrize("counter,drop,reset", [
    (False, False, 0.0), (True, False, 0.0), (True, False, 4.0),
    (True, True, 0.0), (True, True, 4.0)])
def test_rate_kernel(counter, drop, reset):
    grid = np.cumsum(np.abs(_holed_grid(seed=6)), axis=1)
    grid[5, 6] = 1.0              # a rollover
    rel_ts = tpipe.device_bucket_ts(
        BASE_TS + 60_000 * np.arange(grid.shape[1], dtype=np.int64))
    rel_ts[4:] += 30_000          # uneven spacing
    want = jrate._rate_kernel(jnp.asarray(grid), jnp.asarray(rel_ts),
                              counter, jnp.asarray(2.0**32),
                              jnp.asarray(reset), drop)
    got = trate._rate_kernel(torch.as_tensor(grid),
                             torch.as_tensor(rel_ts), counter, 2.0**32,
                             reset, drop)
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", [m.value for m in taggs.Interpolation])
def test_fill_gaps(mode):
    grid = _holed_grid(seed=7)
    rel_ts = np.cumsum(np.r_[0, np.arange(1, grid.shape[1])]) * 1000
    want = jinterp.fill_gaps(jnp.asarray(grid), jnp.asarray(rel_ts), mode)
    got = tinterp.fill_gaps(torch.as_tensor(grid),
                            torch.as_tensor(rel_ts), mode)
    _assert_close(got.numpy(), np.asarray(want))


def test_carry_prev_next():
    grid = _holed_grid(seed=8)
    mask = ~np.isnan(grid)
    gz = np.where(mask, grid, 0.0)
    for jfn, tfn in ((jinterp.carry_prev, tinterp.carry_prev),
                     (jinterp.carry_next, tinterp.carry_next)):
        jv, jhas = jfn((jnp.asarray(gz),), jnp.asarray(mask))
        tv, thas = tfn((torch.as_tensor(gz),), torch.as_tensor(mask))
        np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
        np.testing.assert_array_equal(tv.numpy()[np.asarray(jhas)],
                                      np.asarray(jv)[np.asarray(jhas)])


REDUCTIONS = ["agg_sum", "agg_min", "agg_max", "agg_avg", "agg_count",
              "agg_multiply", "agg_squaresum", "agg_dev", "agg_first",
              "agg_last", "agg_diff"]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", REDUCTIONS)
def test_aggregator_reductions(name, axis):
    x = _holed_grid(seed=9)
    want = getattr(jaggs, name)(jnp.asarray(x), axis=axis)
    got = getattr(taggs, name)(torch.as_tensor(x), axis=axis)
    _assert_close(got.numpy(), np.asarray(want))


def test_aggregator_registry():
    assert taggs.names() == jaggs.names()
    for name in jaggs.names():
        j, t = jaggs.get(name), taggs.get(name)
        assert (t.name, t.interpolation.value, t.percentile,
                t.estimation) == (j.name, j.interpolation.value,
                                  j.percentile, j.estimation)
    # the rank aggregators reduce too (they raised before their port)
    x = _holed_grid(seed=12)
    for name in ("median", "p99", "ep95r3", "ep95r7"):
        _assert_close(taggs.get(name)(torch.as_tensor(x)).numpy(),
                      np.asarray(jaggs.get(name)(jnp.asarray(x))))


@pytest.mark.parametrize("agg", LINEAR_AGGS)
def test_group_aggregate(agg):
    grid = _holed_grid(s=15, seed=10)
    gids = (np.arange(15) * 4) % 5
    ts = np.arange(grid.shape[1], dtype=np.int64) * 60_000
    want = jgb.group_aggregate(jnp.asarray(grid), jnp.asarray(ts),
                               jnp.asarray(gids, dtype=jnp.int32), 5,
                               jaggs.get(agg))
    got = tgb.group_aggregate(torch.as_tensor(grid), torch.as_tensor(ts),
                              torch.as_tensor(gids, dtype=torch.long), 5,
                              taggs.get(agg))
    _assert_close(got.numpy(), np.asarray(want))


def test_group_rank_not_ported():
    """The median group stage, which raised NotImplementedError before
    its port, against the reference (one group over the whole grid)."""
    grid = _holed_grid(seed=11)
    ts = np.arange(grid.shape[1], dtype=np.int64) * 60_000
    want = jgb.group_aggregate(jnp.asarray(grid), jnp.asarray(ts),
                               jnp.zeros(grid.shape[0], dtype=jnp.int32),
                               1, jaggs.get("median"))
    got = tgb.group_aggregate(torch.as_tensor(grid), torch.as_tensor(ts),
                              torch.zeros(grid.shape[0], dtype=torch.long),
                              1, taggs.get("median"))
    _assert_close(got.numpy(), np.asarray(want))


def test_host_helpers():
    _, tpad, bidx, bts, _ = _batch(5, 4, 3, 2)
    for fn in ("detect_regular_padded",):
        assert getattr(tpipe, fn)(tpad.counts, bidx, 4) == \
            getattr(jpipe, fn)(tpad.counts, bidx, 4) == 3
    bad = bidx.copy()
    bad[2, 0] = 1
    assert tpipe.detect_regular_padded(tpad.counts, bad, 4) is None
    assert jpipe.detect_regular_padded(tpad.counts, bad, 4) is None
    np.testing.assert_array_equal(tpipe.device_bucket_ts(bts),
                                  jpipe.device_bucket_ts(bts))
    for spec in ("5m-avg", "1m-max-zero", "10s-sum-scalar#2.5",
                 "0all-count", "1h-mult-nan"):
        j = jds.DownsamplingSpecification.parse(spec)
        t = tds.DownsamplingSpecification.parse(spec)
        assert (t.interval_ms, t.function, t.fill_policy.value,
                t.run_all) == (j.interval_ms, j.function,
                               j.fill_policy.value, j.run_all)
    ts = BASE_TS + np.arange(0, 3_600_000, 7_000, dtype=np.int64)
    spec = tds.DownsamplingSpecification.parse("5m-avg")
    for a, b in zip(tds.assign_buckets(ts, spec, BASE_TS + 1000,
                                       BASE_TS + 3_599_000),
                    jds.assign_buckets(ts, jds.DownsamplingSpecification
                                       .parse("5m-avg"), BASE_TS + 1000,
                                       BASE_TS + 3_599_000)):
        np.testing.assert_array_equal(a, b)
    # calendar buckets, which raised NotImplementedError before their
    # port
    for a, b in zip(tds.assign_buckets(ts, tds.DownsamplingSpecification
                                       .parse("1dc-avg"), BASE_TS,
                                       BASE_TS + 3_599_000),
                    jds.assign_buckets(ts, jds.DownsamplingSpecification
                                       .parse("1dc-avg"), BASE_TS,
                                       BASE_TS + 3_599_000)):
        np.testing.assert_array_equal(a, b)
