"""The port's fused pipeline (``opentsdb_tpu_torch.ops.fused``, its
kernels' plain versions on the CPU) against the reference's Pallas
kernels (``opentsdb_tpu.ops.pallas_fused``, interpret mode) on the same
numpy inputs. Mirrors tests/test_pallas_fused.py case for case.

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|
(the two sides add the same terms in different orders); NaN positions
and emit masks must be equal. The float32 case passes the dtype on
both sides and uses rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pallas_fused
from opentsdb_tpu.ops.pipeline import PipelineSpec as JSpec
from opentsdb_tpu.ops.rate import RateOptions as JRate
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import fused, pipeline
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec as TSpec
from opentsdb_tpu_torch.ops.rate import RateOptions as TRate

DS_FNS = sorted(pallas_fused._DS_FNS)
AGGS = sorted(pallas_fused._AGG_FNS)
BASE_TS = 1_356_998_400_000


def _specs(**kw):
    fp = kw.pop("fill_policy", "none")
    return (JSpec(fill_policy=jds.FillPolicy(fp), **kw),
            TSpec(fill_policy=tds.FillPolicy(fp), **kw))


def _rates(ro: dict | None):
    return (JRate(**ro), TRate(**ro)) if ro else (None, None)


def _data(s, b, k, g, seed=0, counter=False, sorted_gids=False):
    rng = np.random.default_rng(seed)
    p = b * k
    if counter:
        vals = np.cumsum(rng.uniform(1, 50, size=(s, p)), axis=1)
        vals[s // 3, p // 2:] -= vals[s // 3, p // 2] * 0.9  # rollover
        vals[2 * s // 3, p // 3:] -= vals[2 * s // 3, p // 3] * 0.7
    else:
        vals = rng.normal(100.0, 15.0, size=(s, p))
    ts = np.arange(b, dtype=np.int64) * 60_000 + BASE_TS
    gids = ((np.arange(s) * 7) % g).astype(np.int32)  # unsorted
    if sorted_gids:
        gids = np.sort(gids)
    return vals, ts, gids


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


def _both(vals, ts, gids, k, ro=None, dtype=np.float64,
          allow_span=True, **spec_kw):
    """(port result, port emit, reference result, reference emit)."""
    jspec, tspec = _specs(**spec_kw)
    jro, tro = _rates(ro)
    want, want_emit = pallas_fused.fused_dense_pipeline(
        vals, ts, gids, jspec, k, dtype=dtype, rate_options=jro)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    got, got_emit = fused.fused_dense_pipeline(
        torch.as_tensor(vals, dtype=tdtype), ts, gids, tspec, k,
        rate_options=tro, allow_span=allow_span)
    return got.numpy(), got_emit.numpy(), want, want_emit


@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("ds_fn", DS_FNS)
def test_fused_matches_pallas(ds_fn, agg, rate):
    vals, ts, gids = _data(10, 6, 4, 3, seed=7)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, 4, num_series=10, num_buckets=6, num_groups=3,
        ds_function=ds_fn, agg_name=agg, rate=rate)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


@pytest.mark.parametrize("allow_span", [True, False])
@pytest.mark.parametrize("reset", [0.0, 5.0])
def test_counter_rate_matches_pallas(reset, allow_span):
    """Counter rollover + reset_value (RateSpan.java:150-170) through
    both layouts."""
    s, b, k, g = 33, 7, 3, 3
    vals, ts, gids = _data(s, b, k, g, seed=21, counter=True)
    ro = dict(counter=True, counter_max=2**32, reset_value=reset)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, k, ro=ro, allow_span=allow_span, num_series=s,
        num_buckets=b, num_groups=g, ds_function="last", agg_name="sum",
        rate=True, rate_counter=True)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


@pytest.mark.parametrize("s,b,k,g", [(13, 5, 3, 4), (300, 5, 3, 7),
                                     (129, 4, 2, 2)])
def test_odd_sizes(s, b, k, g):
    """Series counts that don't divide the CUDA tile (TILE_S=128)."""
    vals, ts, gids = _data(s, b, k, g, seed=11)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, k, num_series=s, num_buckets=b, num_groups=g,
        ds_function="avg", agg_name="avg", rate=True)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


@pytest.mark.parametrize("fill", ["none", "zero", "nan", "scalar"])
def test_fill_policies(fill):
    """The finalizer's emit mask: fill NONE follows presence (the
    rate-dropped first bucket never emits), others emit every bucket."""
    vals, ts, gids = _data(20, 6, 2, 3, seed=5)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, 2, num_series=20, num_buckets=6, num_groups=3,
        ds_function="sum", agg_name="zimsum", rate=True,
        fill_policy=fill)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


def test_float32_matches_pallas():
    vals, ts, gids = _data(40, 6, 4, 3, seed=9)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, 4, dtype=np.float32, num_series=40,
        num_buckets=6, num_groups=3, ds_function="avg", agg_name="avg",
        rate=True)
    assert got.dtype == np.float32
    _assert_close(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got_emit, want_emit)


def _prep(s, g, **kw):
    vals, ts, gids = _data(s, 6, 4, g, seed=0)
    _, tspec = _specs(num_series=s, num_buckets=6, num_groups=g, **kw)
    return torch.as_tensor(vals), ts, gids, tspec


@pytest.mark.parametrize("s,g,allow,want_span", [
    (40, 4, True, True),       # few groups: span layout
    (40, 20, True, False),     # > SPAN_MAX groups in one tile: one-hot
    (2100, 1050, True, False),  # > 1024 groups: one-hot
    (40, 4, False, False),     # allow_span=False forces one-hot
])
def test_layout_selection(s, g, allow, want_span):
    vals, ts, gids, spec = _prep(s, g, ds_function="avg", agg_name="sum")
    batch = fused.prepare(vals, ts, gids, spec, allow_span=allow)
    assert (batch.spans is not None) == want_span
    if want_span:
        # every tile's slots hold exactly its distinct groups, in order
        gs = batch.gids.numpy()
        for t in range(batch.spans.shape[0]):
            u = np.unique(gs[t * fused.TILE_S:(t + 1) * fused.TILE_S])
            row = batch.spans[t].numpy()
            np.testing.assert_array_equal(row[:len(u)], u)
            assert (row[len(u):] == g).all()
        assert (np.diff(gs) >= 0).all()
        np.testing.assert_array_equal(
            batch.group_start.numpy(),
            np.concatenate([[0], np.cumsum(np.bincount(gids,
                                                       minlength=g))]))


def test_many_groups_onehot_matches_pallas():
    """G > 1024 takes the one-hot kernel in both packages."""
    s, g = 2100, 1050
    vals, ts, gids = _data(s, 3, 2, g, seed=3)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, 2, num_series=s, num_buckets=3, num_groups=g,
        ds_function="sum", agg_name="avg", rate=True)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


@pytest.mark.parametrize("ds_fn", DS_FNS)
@pytest.mark.parametrize("agg", ["sum", "avg", "squareSum"])
def test_span_matches_onehot(ds_fn, agg):
    """Both layouts agree on identical (group-sortable) data, rate on."""
    vals, ts, gids = _data(37, 6, 4, 5, seed=13)
    outs = {}
    for allow in (True, False):
        got, emit, want, want_emit = _both(
            vals, ts, gids, 4, allow_span=allow, num_series=37,
            num_buckets=6, num_groups=5, ds_function=ds_fn,
            agg_name=agg, rate=True)
        _assert_close(got, want)
        np.testing.assert_array_equal(emit, want_emit)
        outs[allow] = got
    _assert_close(outs[True], outs[False])


def test_span_multi_tile_spans():
    """300 series over 3 tiles with group runs crossing tile
    boundaries, against plain numpy group sums of the downsample."""
    s, g, b, k = 300, 3, 6, 4
    vals, ts, gids = _data(s, b, k, g, seed=17)
    _, spec = _specs(num_series=s, num_buckets=b, num_groups=g,
                     ds_function="sum", agg_name="sum")
    batch = fused.prepare(torch.as_tensor(vals), ts, gids, spec)
    assert batch.spans is not None and batch.spans.shape[0] == 3
    res, _ = fused.run(batch, spec, k)
    ds = vals.reshape(s, b, k).sum(axis=2)
    want = np.stack([ds[gids == gid].sum(axis=0) for gid in range(g)])
    np.testing.assert_allclose(res.numpy(), want, rtol=1e-9)


def test_sort_order_cache_reused(monkeypatch):
    """The group-sort permutation is memoized on the group-id digest,
    so a repeated query skips the host argsort."""
    monkeypatch.setattr(fused, "_ORDER_CACHE", {})
    monkeypatch.setattr(fused, "_order_cache_bytes", 0)
    vals, ts, gids, spec = _prep(40, 4, ds_function="avg",
                                 agg_name="sum")
    first = fused.prepare(vals, ts, gids, spec)
    assert len(fused._ORDER_CACHE) == 1
    calls = []
    orig = np.argsort
    monkeypatch.setattr(np, "argsort",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    again = fused.prepare(vals, ts, gids, spec)
    assert not calls, "repeat prepare re-ran the argsort"
    assert torch.equal(first.gids, again.gids)


def test_declines_unsupported():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    _, p99 = _specs(num_series=10, num_buckets=6, num_groups=3,
                    ds_function="sum", agg_name="p99")
    assert not fused.supported(p99, torch.float32, cpu)
    _, drop = _specs(num_series=10, num_buckets=6, num_groups=3,
                     ds_function="sum", agg_name="sum", rate=True,
                     rate_counter=True, rate_drop_resets=True)
    assert not fused.supported(drop, torch.float32, cpu)
    _, ctr = _specs(num_series=10, num_buckets=6, num_groups=3,
                    ds_function="sum", agg_name="sum", rate=True,
                    rate_counter=True)
    assert fused.supported(ctr, torch.float32, cpu)
    assert fused.supported(ctr, torch.float64, cpu)
    # the CUDA kernels are float32-only, as the TPU declines f64
    assert fused.supported(ctr, torch.float32, cuda)
    assert not fused.supported(ctr, torch.float64, cuda)
    _, raw = _specs(num_series=10, num_buckets=6, num_groups=10,
                    ds_function="sum", agg_name="none", emit_raw=True)
    assert not fused.supported(raw, torch.float32, cpu)
    _, big = _specs(num_series=10, num_buckets=6, num_groups=5000,
                    ds_function="sum", agg_name="sum")
    assert not fused.supported(big, torch.float32, cpu)
    # the same verdicts as the reference on every ds x agg pair
    for ds_fn in DS_FNS + ["median", "dev"]:
        for agg in AGGS + ["p99", "min", "dev"]:
            jspec, tspec = _specs(num_series=10, num_buckets=6,
                                  num_groups=3, ds_function=ds_fn,
                                  agg_name=agg)
            assert fused.supported(tspec, torch.float32, cpu) == \
                pallas_fused.supported(jspec, np.float32)


def test_declines_nan_data(monkeypatch):
    """Holes force interpolation: the fused path must not run, and the
    dense path still matches the reference's XLA path."""
    from opentsdb_tpu.ops.pipeline import execute
    s, b, k, g = 10, 6, 4, 3
    vals, ts, gids = _data(s, b, k, g, seed=3)
    vals[1, 5] = np.nan
    jspec, tspec = _specs(num_series=s, num_buckets=b, num_groups=g,
                          ds_function="sum", agg_name="sum")
    called = []
    monkeypatch.setattr(fused, "fused_dense_pipeline",
                        lambda *a, **kw: called.append(1))
    got, got_emit = pipeline._run_dense_or_fused(
        torch.as_tensor(vals), ts, gids, tspec, k, TRate())
    assert not called
    si = np.repeat(np.arange(s, dtype=np.int32), b * k)
    bi = np.tile(np.repeat(np.arange(b, dtype=np.int32), k), s)
    want, want_emit = execute(vals.reshape(-1), si, bi, ts, gids, jspec,
                              use_pallas=False)
    _assert_close(got.numpy(), want)
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers run the plain version and
    launch nothing."""
    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    vals, ts, gids, spec = _prep(40, 4, ds_function="avg", agg_name="sum")
    for allow in (True, False):
        fused.run(fused.prepare(vals, ts, gids, spec, allow_span=allow),
                  spec, 4)
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == before


@pytest.mark.parametrize("s,b,k,g", [
    (1, 12, 5, 7),        # one series, less than a warp tile
    (767, 12, 5, 7),      # a ragged last block tile of the kernel
    (769, 12, 5, 7),
    (301, 7, 3, 1500),    # P = 21: P % 4 != 0, at G > 1024
    (301, 9, 7, 1500),    # P = 63
    (200, 16, 4, 9),      # P = 64: column chunks of 20, 20, 20 and 4
    (300, 12, 5, 1),      # one group
    (300, 12, 5, 4096),   # the most groups the one-hot layout takes
    (2000, 12, 5, 2000),  # config 3's B, k and G
    (8, 1500, 1, 3),      # a long row: many column chunks per tile
])
def test_onehot_edges_match_pallas(s, b, k, g):
    """The one-hot layout at the shapes where its CUDA kernel has edges
    (tile and chunk remainders, unaligned rows, group extremes) agrees
    with the reference; the card tests hold the kernel to this plain
    version at the same shapes."""
    vals, ts, gids = _data(s, b, k, g, seed=13)
    got, got_emit, want, want_emit = _both(
        vals, ts, gids, k, allow_span=False, num_series=s,
        num_buckets=b, num_groups=g, ds_function="avg", agg_name="sum",
        rate=True)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_emit, want_emit)


@pytest.mark.parametrize("sorted_gids,allow", [(False, True), (True, True),
                                               (False, False)])
def test_prepare_keeps_row_order(sorted_gids, allow):
    """prepare never gathers the value matrix: values stay in the
    caller's row order; a span or one-hot batch over unsorted ids
    carries the stable group-sort permutation as int32 (both kernels
    read their rows through it), a batch of sorted ids none."""
    s, g = 300, 3
    vals, ts, gids = _data(s, 6, 4, g, seed=19, sorted_gids=sorted_gids)
    _, spec = _specs(num_series=s, num_buckets=6, num_groups=g,
                     ds_function="avg", agg_name="sum")
    x = torch.as_tensor(vals)
    batch = fused.prepare(x, ts, gids, spec, allow_span=allow)
    assert batch.values is x
    assert (batch.spans is not None) == allow
    if not sorted_gids:
        assert batch.order.dtype == torch.int32
        np.testing.assert_array_equal(batch.order.numpy(),
                                      np.argsort(gids, kind="stable"))
        np.testing.assert_array_equal(batch.gids.numpy(),
                                      gids[batch.order.numpy()])
    else:
        assert batch.order is None
        np.testing.assert_array_equal(batch.gids.numpy(), gids)


@pytest.mark.parametrize("ds_fn,agg", [("avg", "sum"), ("max", "avg"),
                                       ("last", "squareSum")])
def test_plain_reduce_span_matches_pallas(ds_fn, agg):
    """plain_reduce on a multi-tile span batch with a permutation (300
    unsorted series, 3 groups) pairs each row with its group: its
    finalized answer equals the reference's."""
    s, b, k, g = 300, 6, 4, 3
    vals, ts, gids = _data(s, b, k, g, seed=23)
    jspec, tspec = _specs(num_series=s, num_buckets=b, num_groups=g,
                          ds_function=ds_fn, agg_name=agg, rate=True)
    want, want_emit = pallas_fused.fused_dense_pipeline(
        vals, ts, gids, jspec, k, dtype=np.float64)
    batch = fused.prepare(torch.as_tensor(vals), ts, gids, tspec)
    assert batch.spans is not None and batch.spans.shape[0] == 3
    assert batch.order is not None
    acc = fused.plain_reduce(batch, tspec, k, float(2**64 - 1), 0.0)
    got, got_emit = fused._finalize(acc, batch.sizes, tspec)
    _assert_close(got.numpy(), want)
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)


def test_plain_reduce_adds_groups_in_float64():
    """The kernels' reference on the card (``exact``) adds each group's
    float32 terms in float64 and rounds once, so over one group of
    30,000 series it is the correctly rounded sum, whatever order a
    float32 running sum would take."""
    s, b, k = 30_000, 2, 1
    rng = np.random.default_rng(29)
    vals = rng.normal(100.0, 15.0, (s, b)).astype(np.float32)
    ts = np.arange(b, dtype=np.int64) * 60_000 + BASE_TS
    gids = np.zeros(s, np.int32)
    _, spec = _specs(num_series=s, num_buckets=b, num_groups=1,
                     ds_function="sum", agg_name="sum")
    batch = fused.prepare(torch.as_tensor(vals), ts, gids, spec)
    got = fused.plain_reduce(batch, spec, k, float(2**64 - 1), 0.0,
                             exact=True)
    assert got.dtype == torch.float32
    exact = vals.astype(np.float64).sum(axis=0)
    np.testing.assert_array_equal(got.numpy()[0],
                                  exact.astype(np.float32))
