"""The port's time-blocked execution (``opentsdb_tpu_torch/ops/blocked.py``)
against the JAX package's (``opentsdb_tpu/ops/blocked.py``) and against
the port's own unblocked pipeline, on the CPU.

- ``execute_blocked`` on the seeded sparse batches of
  ``tests/test_blocked.py`` (every aggregator of its list plus count,
  min and max; rate with and without a counter; the ZERO, SCALAR and
  NaN fill policies; LERP across several empty blocks; blocks of one
  bucket; a series empty over a whole middle block; a batch out of
  (series, time) order), held against the JAX package's
  ``execute_blocked`` and against the port's unblocked ``execute``
  (float64 and float32); ``pick_block_buckets``; each block's points
  split off in the batch's order (``_block_slices``).
- The engine's verdict: two TSDBs (one per package) with a small
  ``tsd.query.max_device_cells`` answer rate, LERP, a fill policy,
  calendar buckets and a union grid alike; the port runs them blocked
  and caches no prepared batch; an over-budget ``emit_raw`` query runs
  whole in both packages.

Tolerance against the JAX package: float64 on both sides (conftest
enables x64), rtol 1e-9 and atol 1e-9 * max|x| (the reference's own
``tests/test_blocked.py`` holds its blocked path at rtol 1e-9); the
reference casts the carries' times to the grid's float, the port keeps
them int64, which the tolerance covers. NaN positions and emit masks
must be equal. Against the port's unblocked path: equal bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_pair import (ENGINE_KEYS, T0, irregular, port_tsdb,
                        reference_tsdb, run_both, uri_query)

from opentsdb_tpu.ops import blocked as jblocked  # noqa: E402
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu.query import engine as jengine
from opentsdb_tpu_torch.ops import blocked as tblocked
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import rate as trate

BASE_TS = 1_356_998_400_000


def sparse_batch(s=6, b=24, seed=0, density=0.5):
    """``tests/test_blocked.py::sparse_batch``: irregular data with real
    holes, so that the carries must cross block edges."""
    rng = np.random.default_rng(seed)
    values, sidx, bidx = [], [], []
    for i in range(s):
        present = rng.random(b) < density
        present[rng.integers(0, b)] = True  # at least one point
        for j in np.nonzero(present)[0]:
            values.append(rng.normal(100.0, 20.0))
            sidx.append(i)
            bidx.append(j)
    bts = np.arange(b, dtype=np.int64) * 60_000 + BASE_TS
    return (np.asarray(values), np.asarray(sidx, np.int32),
            np.asarray(bidx, np.int32), bts)


def _specs(**kw):
    fill = kw.pop("fill_policy", "none")
    return (tpipe.PipelineSpec(fill_policy=tds.FillPolicy(fill), **kw),
            jpipe.PipelineSpec(fill_policy=jds.FillPolicy(fill), **kw))


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _compare(block_buckets=5, seed=0, density=0.5, counter=None,
             batch=None, **spec_kw):
    """The port's blocked run against the JAX package's (float64) and
    against the port's unblocked ``execute`` (float64 and float32, bit
    for bit). Returns the port's float64 (result, emit)."""
    tspec, jspec = _specs(**spec_kw)
    values, sidx, bidx, bts = batch or sparse_batch(
        s=tspec.num_series, b=tspec.num_buckets, seed=seed,
        density=density)
    gids = (np.arange(tspec.num_series) % tspec.num_groups) \
        .astype(np.int32)
    tro = trate.RateOptions(counter=bool(counter))
    jro = jrate.RateOptions(counter=bool(counter))
    runs = tblocked.execute_blocked.runs
    got, got_emit = tblocked.execute_blocked(
        values, sidx, bidx, bts, gids, tspec, tro, dtype=torch.float64,
        device="cpu", block_buckets=block_buckets)
    assert tblocked.execute_blocked.runs == runs + 1
    want, want_emit = jblocked.execute_blocked(
        values, sidx, bidx, bts, gids, jspec, jro,
        block_buckets=block_buckets)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, np.asarray(want_emit))
    for dtype in (torch.float64, torch.float32):
        whole, whole_emit = tpipe.execute(values, sidx, bidx, bts, gids,
                                          tspec, tro, dtype=dtype,
                                          device="cpu")
        part, part_emit = tblocked.execute_blocked(
            values, sidx, bidx, bts, gids, tspec, tro, dtype=dtype,
            device="cpu", block_buckets=block_buckets)
        _same_bits(part, whole.numpy())
        np.testing.assert_array_equal(part_emit, whole_emit.numpy())
    return got, got_emit


@pytest.mark.parametrize("agg", ["sum", "avg", "zimsum", "pfsum",
                                 "mimmin", "mimmax", "dev", "p95",
                                 "median", "count", "min", "max"])
def test_blocked_matches_over_aggs(agg):
    _compare(num_series=6, num_buckets=24, num_groups=2,
             ds_function="avg", agg_name=agg, seed=3)


@pytest.mark.parametrize("counter", [False, True])
def test_blocked_rate_carries(counter):
    _compare(num_series=5, num_buckets=21, num_groups=2,
             ds_function="sum", agg_name="sum", rate=True,
             rate_counter=counter, counter=counter, block_buckets=4,
             seed=7)


@pytest.mark.parametrize("fill,value", [("zero", 0.0), ("scalar", 42.0),
                                        ("nan", float("nan"))])
def test_blocked_fill_policies(fill, value):
    _compare(num_series=4, num_buckets=18, num_groups=2,
             ds_function="avg", agg_name="sum", fill_policy=fill,
             fill_value=value, block_buckets=7, seed=11)


def test_blocked_very_sparse_cross_block_lerp():
    """Single points many blocks apart: LERP bridges several empty
    blocks in both directions."""
    _compare(num_series=3, num_buckets=30, num_groups=1,
             ds_function="sum", agg_name="sum", block_buckets=3, seed=5,
             density=0.08)


def test_block_size_one():
    _compare(num_series=4, num_buckets=10, num_groups=2,
             ds_function="avg", agg_name="avg", rate=True,
             block_buckets=1, seed=9)


def test_series_empty_over_a_middle_block():
    """Series 0 holds points in the first and the last block only: its
    next carry for the first block and its prev carry for the last come
    from blocks two away (``_merge_carry``'s far carry), through a rate
    and a LERP."""
    values, sidx, bidx, bts = sparse_batch(s=4, b=15, seed=2, density=0.6)
    hole = (sidx == 0) & (bidx >= 5) & (bidx < 10)
    batch = (values[~hole], sidx[~hole], bidx[~hole], bts)
    assert ((batch[1] == 0) & (batch[2] < 5)).any()
    assert ((batch[1] == 0) & (batch[2] >= 10)).any()
    got, emit = _compare(num_series=4, num_buckets=15, num_groups=4,
                         ds_function="avg", agg_name="sum", rate=True,
                         block_buckets=5, batch=batch)
    # its group holds it alone: the middle block is all interpolated
    assert not emit[0, 5:10].any() and np.isfinite(got[0, 5:10]).all()


@pytest.mark.parametrize("block_buckets", [3, 24])
def test_blocked_out_of_order_batch(block_buckets):
    """A batch not in (series, time) order is put in it by one stable
    sort before the blocks are split off, as the unblocked path sorts
    it."""
    values, sidx, bidx, bts = sparse_batch(s=5, b=24, seed=13,
                                           density=0.7)
    perm = np.random.default_rng(13).permutation(len(values))
    _compare(num_series=5, num_buckets=24, num_groups=2,
             ds_function="avg", agg_name="avg", rate=True,
             block_buckets=block_buckets,
             batch=(values[perm], sidx[perm], bidx[perm], bts))


@pytest.mark.parametrize("block_buckets", [1, 5, 24])
def test_block_slices_keep_series_time_order(block_buckets):
    """Each block's points are the batch's points of its buckets, in the
    batch's (series, time) order, the values cast to the run's type."""
    values, sidx, bidx, _ = sparse_batch(s=7, b=24, seed=17)
    got = tblocked._block_slices(values, sidx, bidx, 24, block_buckets,
                                 np.float32)
    assert len(got) == -(-24 // block_buckets)
    for i, (v, si, bi) in enumerate(got):
        at = bidx // block_buckets == i
        assert v.dtype == np.float32
        assert si.dtype == bi.dtype == np.int32
        np.testing.assert_array_equal(v, values[at].astype(np.float32))
        np.testing.assert_array_equal(si, sidx[at])
        np.testing.assert_array_equal(bi, bidx[at])


def test_pick_block_buckets():
    assert tblocked.pick_block_buckets(1_000_000, 10_000, 1 << 26) == 67
    assert tblocked.pick_block_buckets(10, 100) == 100  # fits entirely
    assert tblocked.pick_block_buckets(1 << 30, 100) == 1  # floor at 1
    for args in ((1_000_000, 10_000, 1 << 26), (10, 100), (1 << 30, 100)):
        assert tblocked.pick_block_buckets(*args) == \
            jblocked.pick_block_buckets(*args)


def test_blocked_refuses_emit_raw():
    tspec, _ = _specs(num_series=3, num_buckets=6, num_groups=3,
                      ds_function="sum", agg_name="none", emit_raw=True)
    values, sidx, bidx, bts = sparse_batch(s=3, b=6)
    with pytest.raises(ValueError, match="emit_raw"):
        tblocked.execute_blocked(values, sidx, bidx, bts,
                                 np.arange(3, dtype=np.int32), tspec,
                                 dtype=torch.float64, device="cpu")


def test_the_engine_imports_the_one_budget():
    from opentsdb_tpu_torch.query import engine as tengine
    assert tengine.DEFAULT_CELL_BUDGET is tblocked.DEFAULT_CELL_BUDGET
    assert tblocked.DEFAULT_CELL_BUDGET == jblocked.DEFAULT_CELL_BUDGET


# -- the engine's verdict ----------------------------------------------------

S, P = 24, 180             # 24 series x 3 hours of minute points
BUDGET = 24 * 20           # 20 buckets of 24 series a block
# the blocked queries: (URI sub-query, extra TSQuery keys)
BLOCKED = {
    "rate": ("sum:1m-avg:rate:m{dc=*}", {}),
    "lerp": ("avg:2m-max:m{rack=*}", {}),
    "fill": ("sum:3m-avg-zero:m{dc=*}", {}),
    "calendar": ("max:5mc-avg:m{dc=*}", {"timezone": "Asia/Kolkata"}),
    "union": ("sum:m{dc=*}", {}),
}


@pytest.fixture(scope="module")
def pair():
    data = {"m": irregular(S, P, seed=4)}
    keys = {**ENGINE_KEYS, "tsd.query.max_device_cells": str(BUDGET)}
    jt = reference_tsdb(data, keys)
    # the port with its prepared-batch cache on, which the blocked
    # branch must leave empty
    tt = port_tsdb(jt, data, {**keys, "tsd.query.device_cache_mb": "64"})
    return jt, tt


def _jax_blocked_runs(monkeypatch):
    calls = []
    real = jengine.execute_blocked

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(jengine, "execute_blocked", counted)
    return calls


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_engine_streams_an_over_budget_query(pair, monkeypatch, name):
    jt, tt = pair
    m, extra = BLOCKED[name]
    query = uri_query(m, end=T0 + P * 60 - 1, **extra)
    jcalls = _jax_blocked_runs(monkeypatch)
    runs = tblocked.execute_blocked.runs
    blocks = tblocked.execute_blocked.blocks
    rows = run_both(jt, tt, query)
    assert len(rows) > 1
    assert len(jcalls) == 1
    assert tblocked.execute_blocked.runs == runs + 1
    assert tblocked.execute_blocked.blocks > blocks + 1
    assert len(tt.device_grid_cache) == 0


def test_engine_blocked_equals_unblocked_bit_for_bit(pair, monkeypatch):
    """The same queries with the budget raised past them take the
    unblocked point path and give the same bits. The blocked path
    flattens a padded batch, so the unblocked run is held to the flat
    layout too: the padded layout's band reduction adds a bucket's
    points in another order (within the JAX tolerance, not bit for
    bit)."""
    from opentsdb_tpu_torch.query.model import TSQuery
    _, tt = pair
    monkeypatch.setattr(tpipe, "_PADDED_EINSUM_MAX_CELLS", 0)
    for m, extra in BLOCKED.values():
        query = TSQuery.from_json(uri_query(m, end=T0 + P * 60 - 1,
                                            **extra)).validate()
        part = tt.execute_query(query)
        tt.config.override_config("tsd.query.max_device_cells", str(1 << 26))
        try:
            runs = tblocked.execute_blocked.runs
            whole = tt.execute_query(query)
            assert tblocked.execute_blocked.runs == runs
        finally:
            tt.config.override_config("tsd.query.max_device_cells",
                                      str(BUDGET))
            tt.drop_caches()
        assert len(part) == len(whole) > 1
        for a, b in zip(part, whole):
            assert a.tags == b.tags
            np.testing.assert_array_equal(a.dps_arrays[0], b.dps_arrays[0])
            _same_bits(a.dps_arrays[1], b.dps_arrays[1])


def test_engine_runs_emit_raw_whole(pair, monkeypatch):
    """An over-budget ``none`` aggregation runs whole in both packages,
    as the reference's verdict says."""
    jt, tt = pair
    jcalls = _jax_blocked_runs(monkeypatch)
    runs = tblocked.execute_blocked.runs
    rows = run_both(jt, tt, uri_query("none:1m-avg:m{dc=dc1}",
                                      end=T0 + P * 60 - 1))
    assert len(rows) == S // 6
    assert not jcalls and tblocked.execute_blocked.runs == runs
