"""The port's rank aggregators and segment primitives against the JAX
package on the same seeded inputs: ``ops/segment.py`` (the segmented
sums, extrema, products, first/last, ``segment_sort_ranks`` and
``select_rank``), the median and percentile reductions
(``agg_median``, ``percentile_along_axis`` with the legacy, R_3 and R_7
estimations), the rank downsample functions (``_bucketize_rank``), the
rank group stage (``_group_rank``), and whole rank queries through
both ``TSDB.execute_query``.

The reference's two-key ``lax.sort`` keeps -0.0 and +0.0 in their
input order and puts NaN of either sign last; the port's stable sorts
must pick the same zero, so signed-zero cases compare the sign bit as
well as the value.

Tolerance: float64 on both sides (conftest enables x64), rtol 1e-9 and
atol 1e-9 * max|x|; NaN positions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import aggregators as jaggs
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import groupby as jgb
from opentsdb_tpu.ops import segment as jseg
from opentsdb_tpu_torch.ops import aggregators as taggs
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import groupby as tgb
from opentsdb_tpu_torch.ops import segment as tseg
from torch_pair import (ENGINE_KEYS, GRID_ON, irregular, port_tsdb,
                        reference_tsdb, run_both, uri_query)

RANK_AGGS = ["median", "p50", "p75", "p99", "p999", "ep95r3", "ep95r7",
             "ep50r3", "ep999r7"]


def _assert_close(got, want, rtol=1e-9, sign=False):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)
    if sign:
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _flat(seed=0, n=400, nseg=37, zeros=False):
    """(values, sorted segment ids, nseg): NaN values, empty segments
    and, with ``zeros``, many signed zeros and ties."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    ids[ids == 5] = 6                       # segment 5 empty
    vals = rng.normal(0.0, 2.0, n)
    vals[rng.random(n) < 0.1] = np.nan
    if zeros:
        vals[rng.random(n) < 0.4] = 0.0
        vals[rng.random(n) < 0.3] = -0.0
        vals[rng.random(n) < 0.2] = 1.5
    return vals, ids, nseg


@pytest.mark.parametrize("name", ["seg_sum", "seg_count", "seg_min",
                                  "seg_max", "seg_prod", "seg_sumsq"])
def test_segment_reductions(name):
    vals, ids, nseg = _flat(1)
    x = np.where(np.isnan(vals), 1.0, vals)
    want = getattr(jseg, name)(jnp.asarray(x), jnp.asarray(ids), nseg)
    got = getattr(tseg, name)(torch.as_tensor(x), torch.as_tensor(ids),
                              nseg)
    w = np.asarray(want)
    present = np.bincount(ids, minlength=nseg) > 0
    # an empty segment: the reference holds the dtype's extreme, the
    # port +-inf; both are masked by a zero count downstream
    _assert_close(got.numpy()[present], w[present])


def test_segment_unsorted_ids_and_out_of_range():
    """Unsorted ids are put in order first; ids outside the segments
    drop out, as in the reference's scatter."""
    rng = np.random.default_rng(2)
    ids = rng.integers(-2, 12, 300).astype(np.int32)
    x = rng.normal(size=300)
    want = jseg.seg_sum(jnp.asarray(x), jnp.asarray(ids), 10,
                        sorted_ids=False)
    got = tseg.seg_sum(torch.as_tensor(x), torch.as_tensor(ids), 10,
                       sorted_ids=False)
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_seg_first_last(masked):
    vals, ids, nseg = _flat(3)
    valid = ~np.isnan(vals) if masked else None
    jf, jl = jseg.seg_first_last(jnp.asarray(vals), jnp.asarray(ids), nseg,
                                 None if valid is None
                                 else jnp.asarray(valid))
    tf, tl = tseg.seg_first_last(torch.as_tensor(vals),
                                 torch.as_tensor(ids), nseg,
                                 None if valid is None
                                 else torch.as_tensor(valid))
    _assert_close(tf.numpy(), np.asarray(jf))
    _assert_close(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("zeros", [False, True])
def test_segment_sort_ranks(zeros):
    vals, ids, nseg = _flat(4, zeros=zeros)
    jv, ji, js, jc = jseg.segment_sort_ranks(jnp.asarray(vals),
                                             jnp.asarray(ids), nseg)
    tv, ti, ts_, tc = tseg.segment_sort_ranks(torch.as_tensor(vals),
                                              torch.as_tensor(ids), nseg)
    _assert_close(tv.numpy(), np.asarray(jv), sign=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_select_rank():
    vals, ids, nseg = _flat(5)
    jv, _, js, jc = jseg.segment_sort_ranks(jnp.asarray(vals),
                                            jnp.asarray(ids), nseg)
    rng = np.random.default_rng(6)
    h = rng.uniform(0.5, 14.0, nseg)
    want = jseg.select_rank(jv, js, jc, jnp.asarray(h))
    got = tseg.select_rank(torch.as_tensor(np.array(jv)),
                           torch.as_tensor(np.array(js)),
                           torch.as_tensor(np.array(jc)),
                           torch.as_tensor(h))
    _assert_close(got.numpy(), np.asarray(want))


def _grid(seed, zeros=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 20.0, (23, 9))
    x[rng.random(x.shape) < 0.25] = np.nan
    x[2, :] = np.nan
    x[3, :] = np.nan
    x[3, 4] = 7.0
    if zeros:
        x[rng.random(x.shape) < 0.3] = 0.0
        x[rng.random(x.shape) < 0.3] = -0.0
    return x


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", RANK_AGGS)
def test_rank_reductions(name, axis, zeros):
    x = _grid(7, zeros)
    want = jaggs.get(name)(jnp.asarray(x), axis=axis)
    got = taggs.get(name)(torch.as_tensor(x), axis=axis)
    _assert_close(got.numpy(), np.asarray(want), sign=zeros)


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("fn", ["median", "p99", "ep95r3", "ep95r7",
                                "p50", "ep50r7"])
def test_bucketize_rank(fn, zeros):
    """The rank downsample functions over a flat batch sorted by
    (series, time)."""
    rng = np.random.default_rng(8)
    s, b = 15, 6
    counts = rng.integers(0, 40, s)
    series_idx = np.repeat(np.arange(s, dtype=np.int32), counts)
    bidx = np.concatenate([np.sort(rng.integers(0, b, n))
                           for n in counts]).astype(np.int32)
    vals = rng.normal(10.0, 3.0, len(bidx))
    vals[rng.random(len(vals)) < 0.1] = np.nan
    if zeros:
        vals[rng.random(len(vals)) < 0.3] = 0.0
        vals[rng.random(len(vals)) < 0.3] = -0.0
    jg, jc = jds.bucketize(jnp.asarray(vals), jnp.asarray(series_idx),
                           jnp.asarray(bidx), s, b, fn)
    tg, tc = tds.bucketize(torch.as_tensor(vals),
                           torch.as_tensor(series_idx),
                           torch.as_tensor(bidx), s, b, fn)
    _assert_close(tg.numpy(), np.asarray(jg), sign=zeros)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _groups(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "skewed":
        s, g = 301, 7
        gids = np.where(rng.random(s) < 0.8, 0, rng.integers(1, g, s))
        gids[gids == 4] = 5                 # group 4 empty
    elif name == "spread":
        s, g = 400, 120
        gids = rng.integers(0, g, s)
    else:  # "one"
        s, g = 60, 1
        gids = np.zeros(s, dtype=np.int64)
    x = rng.normal(5.0, 2.0, (s, 8))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[rng.random(x.shape) < 0.1] = 0.0
    x[rng.random(x.shape) < 0.1] = -0.0
    x[gids == gids.max(), 0] = np.nan
    return x, gids.astype(np.int64), g


@pytest.mark.parametrize("case", ["skewed", "spread", "one"])
@pytest.mark.parametrize("agg", RANK_AGGS)
def test_group_rank(case, agg, monkeypatch):
    """The rank group stage against the reference's, twice, bit-equal,
    with no atomic scatter."""
    def atomic(*a, **k):
        raise AssertionError("an order-free scatter ran")

    for name in ("index_add_", "scatter_add_", "scatter_reduce_"):
        monkeypatch.setattr(torch.Tensor, name, atomic)
    x, gids, g = _groups(case)
    want = jgb._group_reduce(jnp.asarray(x), jnp.asarray(gids), g, agg)
    xt, gt = torch.as_tensor(x), torch.as_tensor(gids)
    first = tgb._group_reduce(xt, gt, g, agg)
    again = tgb._group_reduce(xt, gt, g, agg)
    _assert_close(first.numpy(), np.asarray(want), sign=True)
    assert torch.equal(first.view(torch.int64), again.view(torch.int64))


@pytest.mark.parametrize("agg", ["median", "p99", "ep95r3"])
def test_group_aggregate_interpolates_before_ranking(agg):
    """LERP-filled holes take part in the rank, as in the reference."""
    x, gids, g = _groups("spread")
    ts = np.arange(x.shape[1], dtype=np.int64) * 60_000
    want = jgb.group_aggregate(jnp.asarray(x), jnp.asarray(ts),
                               jnp.asarray(gids, dtype=jnp.int32), g,
                               jaggs.get(agg))
    got = tgb.group_aggregate(torch.as_tensor(x), torch.as_tensor(ts),
                              torch.as_tensor(gids), g, taggs.get(agg))
    _assert_close(got.numpy(), np.asarray(want))


# -- whole queries ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    metrics = {"r": irregular(120, 60, seed=21, nan=0.01)}
    jt = reference_tsdb(metrics)
    return jt, port_tsdb(jt, metrics)


QUERIES = [
    "p99:5m-median:r{rack=*}",
    "median:5m-avg:r{dc=*}",
    "ep95r3:10m-p90:r{dc=*}",
    "ep95r7:5m-ep75r7:rate:r{dc=*}",
    "p50:1m-max:r",
    "p999:15m-ep50r3:r{dc=dc2}",
    "median:r{dc=dc0|dc1}",
    "p75:5m-p99-zero:r{dc=*}",
]


@pytest.mark.parametrize("grid", ["off", "on"])
@pytest.mark.parametrize("m", QUERIES)
def test_rank_query_matches_reference(pair, m, grid):
    jt, tt = pair
    keys = GRID_ON if grid == "on" else ENGINE_KEYS
    for key, value in keys.items():
        jt.config.override_config(key, value)
        tt.config.override_config(key, value)
    run_both(jt, tt, uri_query(m))
