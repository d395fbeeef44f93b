"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips when no card is present and runs
on the card with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerance: per cell ``|kernel - plain| <= 1e-5 * sum|terms| + 1e-6``
(float32 sums in another order); emit masks and NaN positions equal.
The plain answer adds the float32 terms' group sums in float64
(``plain_reduce(exact=True)``), so only the kernel's rounding counts.
Both kernels are deterministic: each adds in the order that
``test_torch_span_order`` sets out, bit for bit, and 20 launches agree
bitwise; so do two calls of the grid tail, whose group sums follow a
fixed order. A two-sub query fans out and launches each kernel once,
and a query over demoted history reads the lifecycle's stitched view
through each kernel.
The histogram merge and ranks (float64, no kernel) equal the CPU's bit
for bit, and a percentile query keeps its counts on the card.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
from opentsdb_tpu_torch.ops.rate import RateOptions
from test_torch_span_order import onehot_run_sums, span_tree_sums

pytestmark = pytest.mark.cuda
# the host tail off: every engine tail on the card
HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(card, ds_fn, agg, rate, counter, allow_span, s=1500, b=7, k=3,
          g=9, misalign=False, sort=None, spread=False, want_order=None):
    """``misalign`` puts the value rows at a 4-byte offset from a 16-byte
    boundary (a contiguous view one float into its buffer). The group
    ids are random, or ``(7 i) % g`` with ``spread`` (every group the
    same size), and sorted when ``sort`` (default: ``allow_span``);
    ``want_order`` asserts whether the span batch carries a
    permutation. Returns the batch and its answer."""
    rng = np.random.default_rng(3)
    p = b * k
    vals = (np.cumsum(rng.uniform(1, 50, (s, p)), axis=1) if counter
            else rng.normal(100.0, 15.0, (s, p)))
    gids = rng.integers(0, g, s).astype(np.int32)
    if spread:
        gids = ((np.arange(s) * 7) % g).astype(np.int32)
    if allow_span if sort is None else sort:
        gids.sort()
    ts = np.arange(b, dtype=np.int64) * 60_000
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function=ds_fn, agg_name=agg, rate=rate,
                        rate_counter=counter)
    x = torch.as_tensor(vals, dtype=torch.float32, device=card)
    if misalign:
        buf = torch.empty(s * p + 1, dtype=torch.float32, device=card)
        x = buf[1:].view(s, p).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    cm, rv = (2.0**32, 5.0) if counter else (float(2**64 - 1), 0.0)
    batch = fused.prepare(x, ts, gids, spec, allow_span=allow_span)
    assert (batch.spans is not None) == allow_span
    if want_order is not None:
        assert (batch.order is not None) == want_order
    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    ro = RateOptions(counter=counter, counter_max=cm, reset_value=rv)
    got_res, got_emit = fused.run(batch, spec, k, ro)
    after = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    assert after[0 if allow_span else 1] == \
        before[0 if allow_span else 1] + 1
    acc = fused.plain_reduce(batch, spec, k, cm, rv, exact=True)
    terms = fused.plain_reduce(batch, spec, k, cm, rv, exact=True,
                               magnitude=True)
    want_res, want_emit = fused._finalize(acc, batch.sizes, spec)
    torch.cuda.synchronize()
    assert torch.equal(got_emit, want_emit)
    assert torch.equal(torch.isnan(got_res), torch.isnan(want_res))
    scale = terms / torch.where(batch.sizes[:, None] > 0,
                                batch.sizes[:, None], 1.0) \
        if agg == "avg" else terms
    err = (got_res - want_res).abs().nan_to_num(0.0)
    assert bool((err <= 1e-5 * scale + 1e-6).all())
    return batch, got_res


@pytest.mark.parametrize("allow_span", [True, False])
@pytest.mark.parametrize("ds_fn", sorted(fused._DS_FNS))
def test_kernel_matches_plain_over_ds_fns(card, ds_fn, allow_span):
    _case(card, ds_fn, "sum", True, False, allow_span)


@pytest.mark.parametrize("allow_span", [True, False])
@pytest.mark.parametrize("agg", sorted(fused._AGG_FNS))
def test_kernel_matches_plain_over_aggs(card, agg, allow_span):
    _case(card, "avg", agg, False, False, allow_span)


@pytest.mark.parametrize("allow_span", [True, False])
def test_kernel_counter_rate(card, allow_span):
    _case(card, "last", "sum", True, True, allow_span)


def test_onehot_group_chunks(card):
    """4000 groups of under one row each on average: most warp tiles
    hold many runs, and many groups are empty."""
    _case(card, "sum", "sum", True, False, False, s=3000, b=13, k=2,
          g=4000)


def _onehot_tile() -> int:
    from opentsdb_tpu_torch.ops import _cuda_build
    return _cuda_build.library().fused_onehot_tile()


@pytest.mark.parametrize("d", [None, -1, 1])
def test_onehot_ragged_tiles(card, d):
    """S = 1 (below one tile) and a block tile of the kernel less or
    plus one row: rows past S add nothing."""
    s = 1 if d is None else _onehot_tile() + d
    _case(card, "avg", "sum", True, False, False, s=s, b=12, k=5, g=7)


@pytest.mark.parametrize("b,k,misalign", [(7, 3, False), (9, 7, False),
                                          (12, 5, True)])
def test_onehot_unaligned_rows(card, b, k, misalign):
    """P % 4 != 0, or a base that is not 16-byte aligned: the ring takes
    4-byte async copies instead of 16-byte ones."""
    _case(card, "sum", "sum", True, False, False, s=3001, b=b, k=k,
          g=1500, misalign=misalign)


def test_onehot_ring_wraps(card):
    """Each warp takes several 32-row tiles of four column chunks (P =
    64: 20, 20, 20 and a ragged 4), far more steps than its ring has
    stages: every warp's ring wraps several times."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    s = 4 * sms * _onehot_tile() + 77
    _case(card, "avg", "sum", True, False, False, s=s, b=16, k=4, g=2000)


@pytest.mark.parametrize("g", [1, fused._MAX_GROUPS])
def test_onehot_group_extremes(card, g):
    """One group, and the most groups the one-hot layout takes."""
    _case(card, "avg", "squareSum", True, False, False, s=5000, b=12, k=5,
          g=g)


@pytest.mark.parametrize("b,g", [(13_000, 3), (26_000, 2)])
def test_onehot_long_rows(card, b, g):
    """Rows of many buckets: past 25,856 buckets 1/dt does not fit
    beside the rings and stays in global memory; the combine takes the
    buckets in passes of 256."""
    _case(card, "sum", "sum", True, True, False, s=100, b=b, k=1, g=g)


# -- the span kernel reading rows through the group order -----------------

@pytest.mark.parametrize("s", [1, 31, 33, 127, 129])
def test_span_unsorted_ragged_tiles(card, s):
    """Unsorted ids in the span layout: the kernel reads each row through
    the permutation. S below a warp tile, a warp tile (32) and a span
    tile (128) less or plus one row: rows past S add nothing. (One row
    is always sorted, so S = 1 carries no permutation.)"""
    _case(card, "avg", "sum", True, False, True, s=s, b=12, k=5, g=3,
          sort=False, want_order=s > 1)


@pytest.mark.parametrize("b,k,misalign", [(7, 3, False), (7, 9, False),
                                          (12, 5, True)])
def test_span_unsorted_unaligned_rows(card, b, k, misalign):
    """P % 4 != 0 (P = 21, 63), or a base that is not 16-byte aligned:
    the permuted rows take 4-byte async copies instead of 16-byte
    ones."""
    _case(card, "sum", "sum", True, False, True, s=3001, b=b, k=k, g=5,
          misalign=misalign, sort=False, want_order=True)


def test_span_ring_wraps(card):
    """Each warp takes several 32-row warp tiles of four column chunks
    (P = 64), far more steps than its ring has stages."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    s = 4 * sms * _onehot_tile() + 77
    _case(card, "avg", "sum", True, False, True, s=s, b=16, k=4, g=6,
          sort=False, want_order=True)


def test_span_one_group(card):
    """One group: every id is 0, already sorted, no permutation."""
    _case(card, "avg", "squareSum", True, False, True, s=5000, b=12, k=5,
          g=1, sort=False, want_order=False)


def test_span_most_groups(card):
    """The most groups the span layout takes (1024), unsorted, 20 rows
    each: a 128-row span tile covers up to 8 groups and a warp tile up
    to 3, so the combine reads many slots per group."""
    g = fused._SPAN_GROUP_MAX
    _case(card, "avg", "sum", True, False, True, s=20 * g, b=12, k=5, g=g,
          spread=True, sort=False, want_order=True)


def test_span_sorted_ids_take_no_order(card):
    """Ids that are already sorted: the kernel reads rows in place."""
    _case(card, "avg", "sum", True, False, True, s=3001, b=12, k=5, g=9,
          sort=True, want_order=False)


def test_span_deterministic(card):
    """No atomics in the span kernel or its combine: two launches on one
    batch give the same bits."""
    batch, first = _case(card, "avg", "sum", True, False, True, s=70_001,
                         b=12, k=5, g=37, spread=True, sort=False,
                         want_order=True)
    spec = PipelineSpec(num_series=70_001, num_buckets=12, num_groups=37,
                        ds_function="avg", agg_name="sum", rate=True)
    again, _ = fused.run(batch, spec, 5)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(first), torch.isnan(again))
    assert torch.equal(first.nan_to_num(0.0), again.nan_to_num(0.0))


@pytest.mark.parametrize("ds_fn,rate", [("sum", False), ("avg", True)])
def test_span_tree_order(card, ds_fn, rate):
    """The span kernel adds in the order that ``span_tree_sums`` sets
    out (unsorted ids, groups across warp tiles, a ragged last tile):
    its group sums equal that order's float32 sums of the plain
    transform bit for bit."""
    s, b, k, g = 70_001, 12, 5, 37
    rng = np.random.default_rng(11)
    vals = rng.normal(100.0, 15.0, (s, b * k))
    gids = rng.integers(0, g, s).astype(np.int32)
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function=ds_fn, agg_name="sum", rate=rate)
    ts = np.arange(b, dtype=np.int64) * 60_000
    batch = fused.prepare(torch.as_tensor(vals, dtype=torch.float32,
                                          device=card), ts, gids, spec)
    assert batch.spans is not None and batch.order is not None
    cm, rv = float(2**64 - 1), 0.0
    acc = fused.span_reduce(batch.values, batch.order, batch.gids,
                            batch.spans, batch.group_start, batch.inv_dt,
                            spec, k, cm, rv)
    t = fused._in_group_order(
        fused._transform_plain(batch.values.cpu(), batch.inv_dt.cpu(),
                               spec, k, cm, rv), batch.order.cpu())
    want = span_tree_sums(t.numpy(), batch.gids.cpu().numpy(), g)
    np.testing.assert_array_equal(acc.cpu().numpy(), want)


@pytest.mark.parametrize("ds_fn,rate", [("sum", False), ("avg", True)])
def test_onehot_tree_order(card, ds_fn, rate):
    """The one-hot kernel adds in the order that ``onehot_run_sums``
    sets out (2000 unsorted groups, several runs to a warp tile, groups
    across warp tiles, a ragged last tile): its group sums equal that
    order's float32 sums of the plain transform bit for bit."""
    s, b, k, g = 70_001, 12, 5, 2000
    rng = np.random.default_rng(13)
    vals = rng.normal(100.0, 15.0, (s, b * k))
    gids = rng.integers(0, g, s).astype(np.int32)
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function=ds_fn, agg_name="sum", rate=rate)
    ts = np.arange(b, dtype=np.int64) * 60_000
    batch = fused.prepare(torch.as_tensor(vals, dtype=torch.float32,
                                          device=card), ts, gids, spec)
    assert batch.spans is None and batch.order is not None
    cm, rv = float(2**64 - 1), 0.0
    acc = fused.onehot_reduce(batch.values, batch.order, batch.gids,
                              batch.group_start, batch.inv_dt, spec, k,
                              cm, rv)
    t = fused._in_group_order(
        fused._transform_plain(batch.values.cpu(), batch.inv_dt.cpu(),
                               spec, k, cm, rv), batch.order.cpu())
    want = onehot_run_sums(t.numpy(), batch.gids.cpu().numpy(), g)
    np.testing.assert_array_equal(acc.cpu().numpy(), want)


@pytest.mark.parametrize("grouping", ["rack", "dc"])
def test_onehot_deterministic(card, grouping):
    """20 launches of the one-hot kernel on one batch give the same
    bits: 2000 unsorted groups (config 3's ``rack``: i % 2000), and the
    ``dc`` grouping (i % 100, thousands of rows of one group in a block)
    forced onto the one-hot layout."""
    s, b, k = 400_000, 12, 5
    g = 2000 if grouping == "rack" else 100
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.normal(100.0, 15.0, (s, b * k)),
                           dtype=torch.float32, device=card)
    gids = (np.arange(s) % g).astype(np.int32)
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function="avg", agg_name="sum", rate=True)
    ts = np.arange(b, dtype=np.int64) * 300_000
    batch = fused.prepare(vals, ts, gids, spec, allow_span=False)
    assert batch.spans is None
    cm, rv = float(2**64 - 1), 0.0
    runs = [fused.onehot_reduce(batch.values, batch.order, batch.gids,
                                batch.group_start, batch.inv_dt, spec, k,
                                cm, rv) for _ in range(20)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r.view(torch.int32), runs[0].view(torch.int32))


def _card_tsdb(card, **keys):
    """A TSDB on the card holding 3000 series x 60 points at one a
    minute (seed 0), tagged dc (i % 100) and rack (i % 1500). The
    result cache is off unless ``keys`` turn it on, so that a repeat
    reaches the engine's paths, and the host tail is off: at its
    default budgets these small queries' tails would run on the host,
    and these tests hold the card's paths."""
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{"tsd.torch.device": str(card),
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.query.cache.enable": "false",
                       **HOST_TAIL_OFF, **keys}))
    rng = np.random.default_rng(0)
    s, p = 3000, 60
    ts = np.broadcast_to(1356998400 + 60 * np.arange(p), (s, p))
    t.add_series_points("m", [{"host": f"h{i}", "dc": f"dc{i % 100}",
                               "rack": f"r{i % 1500}"} for i in range(s)],
                        ts, rng.normal(100.0, 15.0, (s, p)))
    return t


def _card_query(m):
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    return TSQuery(start="1356998400", end=str(1356998400 + 3599),
                   queries=[parse_uri_subquery(m)]).validate()


@pytest.mark.parametrize("m", ["sum:5m-avg:m{dc=*}",
                               "sum:10m-max-zero:m{rack=*}",
                               "avg:1m-sum:m{dc=*}"])
def test_grid_path_on_card(card, m):
    """At the defaults the grid path answers on the card as the port
    does on the CPU in float64 (positive values: 1e-5 relative), with no
    kernel launched, and a repeat is a cache hit."""
    from opentsdb_tpu_torch import TSDB, Config
    t = _card_tsdb(card)
    cpu = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.torch.dtype": "float64"}))
    cpu.store, cpu.uids = t.store, t.uids
    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    got = t.execute_query(_card_query(m))
    warm = t.execute_query(_card_query(m))
    want = cpu.execute_query(_card_query(m))
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == before
    assert t.device_grid_cache.hits == 1
    assert len(got) == len(want) > 0
    for a, w, b in zip(got, want, warm):
        np.testing.assert_array_equal(a.dps_arrays[0], w.dps_arrays[0])
        np.testing.assert_allclose(a.dps_arrays[1], w.dps_arrays[1],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b.dps_arrays[1], w.dps_arrays[1],
                                   rtol=1e-5, atol=1e-6)


def test_prepared_hit_launches_the_kernel(card):
    """grid_reduce=false with the cache on: a warm hit runs the span
    kernel again on the cached batch, and its answer is the cold one
    bit for bit (the span kernel is deterministic)."""
    t = _card_tsdb(card, **{"tsd.query.grid_reduce": "false"})
    q = _card_query("sum:5m-avg:rate:m{dc=*}")
    cold = t.execute_query(q)
    n = fused.span_reduce.launches
    warm = t.execute_query(q)
    assert fused.span_reduce.launches == n + 1
    assert t.device_grid_cache.hits == 1
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a.dps_arrays[1], b.dps_arrays[1])


@pytest.mark.parametrize("m,kernel", [
    ("sum:1m-sum:m{dc=*}", "span_reduce"),
    ("sum:1m-sum:m{rack=*}", "onehot_reduce")])
def test_stitched_history_launches_the_kernel(card, m, kernel):
    """After a lifecycle demotion into the 1m tiers, a query over the
    demoted hour reads the stitched view (tier cells, one a bucket) on
    the point path: K1 by ``dc``, K2 by ``rack``, one launch each, and
    the answer is the CPU's in float64 over the same stores (1e-5
    relative, as the other card tests)."""
    from opentsdb_tpu_torch import TSDB, Config
    keys = {"tsd.query.grid_reduce": "false",
            "tsd.query.device_cache_mb": "0",
            "tsd.rollups.enable": "true", "tsd.lifecycle.enable": "true",
            "tsd.lifecycle.demote_after": "30m",
            "tsd.lifecycle.demote_tiers": "1m"}
    t = _card_tsdb(card, **keys)
    rep = t.lifecycle.sweep(now_ms=(1356998400 + 3600) * 1000)
    assert rep["demoted"] > 0
    cpu = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.torch.dtype": "float64", **keys}))
    cpu.store, cpu.uids, cpu.rollup_store = (t.store, t.uids,
                                             t.rollup_store)
    cpu.lifecycle._boundaries = dict(t.lifecycle._boundaries)
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    q = TSQuery(start="1356998400", end=str(1356998400 + 1799),
                queries=[parse_uri_subquery(m)]).validate()
    n = getattr(fused, kernel).launches
    got = t.execute_query(q)
    assert getattr(fused, kernel).launches == n + 1
    want = cpu.execute_query(q)
    assert len(got) == len(want) > 0
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.dps_arrays[0], w.dps_arrays[0])
        np.testing.assert_allclose(a.dps_arrays[1], w.dps_arrays[1],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g", [100, 2000])
def test_grid_tail_repeats_bit_for_bit(card, g):
    """The grid tail at config 3's shape ([1M, 12] float32, group ids
    i % G) gives the same bits on two calls: its group sums follow a
    fixed order, with no atomics."""
    from opentsdb_tpu_torch.ops import pipeline
    rng = np.random.default_rng(0)
    s, b = 1_000_000, 12
    grid = torch.as_tensor(rng.normal(100.0, 15.0, (s, b)),
                           dtype=torch.float32, device=card)
    has = torch.ones((s, b), dtype=torch.bool, device=card)
    bts = np.int64(1356998400_000) + 300_000 * np.arange(b)
    gids = np.arange(s) % g
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function="avg", agg_name="sum", rate=True)
    first, emit = pipeline.execute_grid(grid, has, bts, gids, spec)
    again, emit2 = pipeline.execute_grid(grid, has, bts, gids, spec)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    assert torch.equal(emit, emit2)


def test_fanout_launches_each_kernel_once(card):
    """A two-sub TSQuery at grid_reduce=false with both caches off fans
    out: K1 ({dc=*}, 100 groups) and K2 ({rack=*}, 1500 groups) launch
    exactly once each, from two threads, and each sub answers as it
    does alone, bit for bit."""
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    t = _card_tsdb(card, **{"tsd.query.grid_reduce": "false",
                            "tsd.query.device_cache_mb": "0"})
    try:
        ms = ["sum:5m-avg:rate:m{dc=*}", "sum:5m-avg:rate:m{rack=*}"]
        alone = [t.execute_query(_card_query(m)) for m in ms]
        before = (fused.span_reduce.launches,
                  fused.onehot_reduce.launches)
        both = t.execute_query(TSQuery(
            start="1356998400", end=str(1356998400 + 3599),
            queries=[parse_uri_subquery(m) for m in ms]).validate())
        assert (fused.span_reduce.launches - before[0],
                fused.onehot_reduce.launches - before[1]) == (1, 1)
        assert [r.sub_query_index for r in both] == \
            [0] * len(alone[0]) + [1] * len(alone[1])
        for r, a in zip(both, alone[0] + alone[1]):
            assert r.tags == a.tags
            np.testing.assert_array_equal(r.dps_arrays[0],
                                          a.dps_arrays[0])
            np.testing.assert_array_equal(r.dps_arrays[1],
                                          a.dps_arrays[1])
    finally:
        t.shutdown()


def _irregular_card_tsdb(card):
    """A TSDB on the card holding 3000 series of jittered points (0-9 s)
    with 2% dropped (seed 0), tagged as ``_card_tsdb``'s, at the
    default keys but the result cache and the host tail (off, so that
    the tails run on the card); and a CPU float64 TSDB reading the same
    store and UIDs."""
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{"tsd.torch.device": str(card),
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.query.cache.enable": "false",
                       **HOST_TAIL_OFF}))
    rng = np.random.default_rng(0)
    s, p = 3000, 60
    ts = 1356998400 + 60 * np.arange(p) + rng.integers(0, 10, (s, p))
    vals = rng.normal(100.0, 15.0, (s, p))
    keep = rng.random((s, p)) >= 0.02
    order = np.argsort(~keep, axis=1, kind="stable")
    counts = keep.sum(axis=1)
    t.add_series_points("m", [{"host": f"h{i}", "dc": f"dc{i % 100}",
                               "rack": f"r{i % 1500}"} for i in range(s)],
                        np.take_along_axis(ts, order, axis=1),
                        np.take_along_axis(vals, order, axis=1), counts)
    cpu = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.torch.dtype": "float64",
                         "tsd.query.cache.enable": "false"}))
    cpu.store, cpu.uids = t.store, t.uids
    return t, cpu


@pytest.mark.parametrize("m,tz,kind", [
    ("sum:5m-last:rate:m{dc=*}", None, "padded"),
    ("avg:10m-squareSum:m{rack=*}", None, "padded"),
    ("p99:5m-median:m{rack=*}", None, "flat"),
    ("ep95r7:5m-p90:m{dc=*}", None, "flat"),
    ("avg:15mc-max:m{dc=*}", "America/New_York", "padded"),
    ("sum:m{dc=*}", None, "padded")])
def test_irregular_paths_on_card(card, m, tz, kind, monkeypatch):
    """The padded, flat (rank) and calendar paths on the card answer as
    the port on the CPU in float64 (positive values: 1e-5 relative to
    the largest value of the row), launch neither fused kernel, and two
    calls with the cache dropped give the same bits, as does a warm
    prepared-batch hit."""
    from opentsdb_tpu_torch.query import engine as engine_mod
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    t, cpu = _irregular_card_tsdb(card)
    kinds = []
    orig = engine_mod.run_prepared
    monkeypatch.setattr(engine_mod, "run_prepared", lambda prep, *a, **k:
                        kinds.append(prep.kind) or orig(prep, *a, **k))

    def q():
        return TSQuery(start="1356998400", end=str(1356998400 + 3599),
                       timezone=tz,
                       queries=[parse_uri_subquery(m)]).validate()

    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    got = t.execute_query(q())
    warm = t.execute_query(q())
    t.drop_caches()
    again = t.execute_query(q())
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == before
    assert kinds[0] == kind and t.device_grid_cache is not None
    want = cpu.execute_query(q())
    assert len(got) == len(want) > 0
    for a, w, b, c in zip(got, want, warm, again):
        assert a.tags == w.tags
        np.testing.assert_array_equal(a.dps_arrays[0], w.dps_arrays[0])
        scale = np.abs(w.dps_arrays[1]).max()
        np.testing.assert_allclose(a.dps_arrays[1], w.dps_arrays[1],
                                   rtol=1e-5, atol=1e-5 * scale)
        for other in (b, c):
            np.testing.assert_array_equal(
                a.dps_arrays[1].view(np.int64),
                other.dps_arrays[1].view(np.int64))


@pytest.mark.parametrize("agg,rate", [("sum", True), ("avg", False),
                                      ("p95", False), ("dev", True),
                                      ("mimmax", False)])
def test_blocked_equals_unblocked_on_card(card, agg, rate):
    """Time blocks on the card give the unblocked flat path's bits:
    carries keep int64 times and each block's group sums follow the
    same fixed order."""
    from opentsdb_tpu_torch.ops import blocked
    from opentsdb_tpu_torch.ops.pipeline import execute
    rng = np.random.default_rng(5)
    s, b, g = 3000, 40, 37
    sidx, bidx = np.nonzero(rng.random((s, b)) < 0.6)
    reps = rng.integers(1, 4, len(sidx))        # 1-3 points a cell
    sidx = np.repeat(sidx, reps).astype(np.int32)
    bidx = np.repeat(bidx, reps).astype(np.int32)
    vals = rng.normal(100.0, 15.0, len(sidx))
    bts = np.arange(b, dtype=np.int64) * 60_000
    gids = rng.integers(0, g, s).astype(np.int32)
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function="avg", agg_name=agg, rate=rate)
    whole, whole_emit = execute(vals, sidx, bidx, bts, gids, spec,
                                RateOptions(), dtype=torch.float32,
                                device=card)
    runs = blocked.execute_blocked.runs
    part, part_emit = blocked.execute_blocked(
        vals, sidx, bidx, bts, gids, spec, RateOptions(),
        dtype=torch.float32, device=card, block_buckets=7)
    assert blocked.execute_blocked.runs == runs + 1
    np.testing.assert_array_equal(part.view(np.int32),
                                  whole.cpu().numpy().view(np.int32))
    np.testing.assert_array_equal(part_emit, whole_emit.cpu().numpy())


@pytest.mark.parametrize("n,nb,nseg", [(101, 64, 10), (20_000, 64, 3)])
def test_histogram_merge_on_card_equals_cpu(card, n, nb, nseg):
    """The histogram merge and ranks on the card equal the CPU's bit for
    bit, on every call (float64 integer sums, exact in any order), with
    merged counts past 2^24 in the second case."""
    from opentsdb_tpu_torch.ops import histogram_kernels as hk
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 5000, (n, nb)).astype(np.float64)
    seg = rng.integers(0, nseg, n)
    bounds = np.logspace(0, 4, nb + 1)
    qs = [50.0, 99.0, 99.9]
    want = hk.histogram_percentile_pipeline(counts, seg, nseg, bounds, qs,
                                            device="cpu")
    for _ in range(3):
        got = hk.histogram_percentile_pipeline(counts, seg, nseg, bounds,
                                               qs, device=card)
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
    merged = hk.merge_histograms(torch.from_numpy(counts).to(card),
                                 torch.from_numpy(seg).to(card), nseg)
    assert merged.is_cuda and merged.dtype == torch.float64


def test_histogram_query_on_card(card):
    """A percentile sub-query on a TSDB on the card: the counts stay on
    the card as float64, neither kernel launches, and the answer equals
    the same query on the CPU bit for bit, cold and warm."""
    import struct
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.query.model import TSQuery
    rng = np.random.default_rng(6)
    bounds = np.logspace(0, 3, 9)
    pts = []
    for i in range(300):
        for j in range(3):
            blob = (b"\x01" + struct.pack(">H", 9)
                    + struct.pack(">9d", *bounds)
                    + struct.pack(">8Q", *rng.integers(0, 50, 8).tolist())
                    + struct.pack(">QQ", 0, 0))
            pts.append(("lat", 1356998400 + 60 * j, blob,
                        {"host": f"h{i}", "dc": f"dc{i % 7}"}))
    q = {"start": "1356998400", "end": "1356998699", "queries": [{
        "aggregator": "sum", "metric": "lat", "percentiles": [50, 99.9],
        "downsample": "1m-sum",
        "filters": [{"type": "wildcard", "tagk": "dc", "filter": "*",
                     "groupBy": True}]}]}
    answers = {}
    for dev in ("cpu", "cuda"):
        t = TSDB(Config(**{"tsd.torch.device": dev,
                           "tsd.core.auto_create_metrics": "true",
                           "tsd.query.cache.enable": "false"}))
        t.add_histogram_batch(pts)
        fused.span_reduce.launches = fused.onehot_reduce.launches = 0
        runs = [[(r.metric, r.tags, r.dps_arrays[0].tolist(),
                  r.dps_arrays[1].view(np.int64).tolist())
                 for r in t.execute_query(TSQuery.from_json(q).validate())]
                for _ in range(2)]
        assert runs[0] == runs[1] and runs[0]
        assert fused.span_reduce.launches == fused.onehot_reduce.launches \
            == 0
        if dev == "cuda":
            (entry,) = [e for k, e in t.device_grid_cache._entries.items()
                        if k[0] == "hist"]
            assert entry[1][0].is_cuda and entry[1][0].dtype == \
                torch.float64
        answers[dev] = runs[0]
        t.shutdown()
    assert answers["cuda"] == answers["cpu"]


@pytest.mark.parametrize("m,grid_reduce", [("sum:5m-avg:rate:m{dc=*}", "true"),
                                           ("sum:5m-avg:rate:m{dc=*}", "false"),
                                           ("p99:5m-max:m{dc=*}", "true")])
def test_host_tail_keeps_small_tails_off_the_card(card, m, grid_reduce,
                                                  monkeypatch):
    """At the default budgets a small query's tail runs on the host CPU
    of a card TSDB: its grid or batch is a CPU tensor, no kernel
    launches, nothing enters the device cache, and the answer equals the
    same query with the host tail off, on the card (1e-5 relative)."""
    from opentsdb_tpu_torch.query import engine as engine_mod
    seen = []
    for name in ("execute_grid", "run_prepared"):
        orig = getattr(engine_mod, name)

        def spy(x, *a, _o=orig, **k):
            t = x if isinstance(x, torch.Tensor) else x.arrays[0]
            seen.append(t.device.type)
            return _o(x, *a, **k)
        monkeypatch.setattr(engine_mod, name, spy)
    keys = {"tsd.query.grid_reduce": grid_reduce}
    on = _card_tsdb(card, **keys)
    off = _card_tsdb(card, **keys)
    for k in HOST_TAIL_OFF:     # _card_tsdb pins them: back to defaults
        on.config.override_config(k, "0")
    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    got = on.execute_query(_card_query(m))
    assert seen == ["cpu"] and len(on.device_grid_cache) == 0
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == before
    seen.clear()
    want = off.execute_query(_card_query(m))
    assert seen == ["cuda"]
    assert len(got) == len(want) > 0
    for a, w in zip(got, want):
        assert a.tags == w.tags
        np.testing.assert_array_equal(a.dps_arrays[0], w.dps_arrays[0])
        np.testing.assert_allclose(a.dps_arrays[1], w.dps_arrays[1],
                                   rtol=1e-5, atol=1e-6)
    on.shutdown()
    off.shutdown()
