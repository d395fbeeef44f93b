"""The span and one-hot kernels' orders of additions, and why their
reference on the card adds in float64 (CPU; the port only, no JAX).

``span_tree_sums`` adds float32 terms in the order of
``csrc/fused_pipeline.cu``'s span kernel: a 5-step shuffle tree over
each 32-row warp tile of the sorted order (rows of other groups add
0), then ``span_combine_kernel``'s per-group pass (tile lane ``l`` adds
every ``lanes``-th warp tile from 0 in order, then a halving tree over
the lanes). ``onehot_run_sums`` does the same for the one-hot kernel:
a segmented suffix scan of shuffles over each run of one group in a
warp tile, then ``onehot_combine_kernel``'s per-group pass.
``tests/test_torch_cuda.py`` holds each kernel to its order bit for bit
on the card.

The data below are the draws of ``chip_smoke.py``'s sweep (seed 7) up
to its 200,003-row size with 7 unsorted groups of about 28,600 series
(B = 16, k = 4). At (group 2, bucket 4), with ``avg`` downsampling and
no rate, the span kernel gave 2851193.75 on an H100, and the float32
``index_add_`` on the card (atomics, in no fixed order) 2851162.0:
1.1e-5 of the sum of the terms, past the tolerance of 1e-5. The tests
show that the kernel's tree order gives that value, that the float64
group sums (``plain_reduce(exact=True)``) side with it, and that a
float32 running sum spends most of the tolerance by itself.
"""

import functools

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec

TOL_REL, TOL_ABS = 1e-5, 1e-6
CM, RV = float(2**64 - 1), 0.0
S, B, K, G = 200_003, 16, 4, 7
WARP_TILE = 32     # rows per warp tile of the span kernel
COMBINE = 1024     # threads per span_combine_kernel block
OH_COMBINE = 256   # threads per onehot_combine_kernel block


def _lane_tree(parts: np.ndarray, b: int, threads: int) -> np.ndarray:
    """A combine kernel's sum of one group's warp-tile partials [T, B]:
    tile lane ``l`` adds every ``lanes``-th partial from 0 in order,
    then a halving tree over the lanes."""
    nb = min(b, threads)
    lanes = 1
    while lanes * 2 * nb <= threads:
        lanes *= 2
    m = -(-len(parts) // lanes)
    pad = np.zeros((m * lanes, b), np.float32)
    pad[:len(parts)] = parts
    acc = np.zeros((lanes, b), np.float32)
    for row in pad.reshape(m, lanes, b):
        acc = acc + row
    h = lanes
    while h > 1:
        h //= 2
        acc = acc[:h] + acc[h:2 * h]
    return acc[0]


def onehot_run_sums(t: np.ndarray, gids: np.ndarray,
                    g: int) -> np.ndarray:
    """acc [G, B] float32: the group sums of ``t`` [S, B] float32 (rows
    in group order, ``gids`` sorted) in the one-hot kernel's order. In
    each warp tile, lane L of a run ending at lane E adds, for off = 1,
    2, 4, 8, 16, the value of lane L + off while L + off <= E; the
    run's first lane keeps the run's sum."""
    s, b = t.shape
    nt = -(-s // WARP_TILE)
    x = np.zeros((nt * WARP_TILE, b), np.float32)
    x[:s] = t
    x = x.reshape(nt, WARP_TILE, b)
    gp = np.full(nt * WARP_TILE, -1, np.int64)
    gp[:s] = gids
    gp = gp.reshape(nt, WARP_TILE)
    lane = np.arange(WARP_TILE)
    run_end = np.empty_like(gp)
    run_end[:, -1] = WARP_TILE - 1
    for j in range(WARP_TILE - 2, -1, -1):
        run_end[:, j] = np.where(gp[:, j] == gp[:, j + 1],
                                 run_end[:, j + 1], j)
    off = 1
    while off < WARP_TILE:
        y = np.zeros_like(x)
        y[:, :WARP_TILE - off] = x[:, off:]
        take = (lane[None, :] + off <= run_end)[:, :, None]
        x = np.where(take, x + y, x)
        off *= 2
    starts = np.searchsorted(gids, np.arange(g + 1))
    out = np.zeros((g, b), np.float32)
    for gi in range(g):
        lo, hi = starts[gi], starts[gi + 1]
        if hi == lo:
            continue
        t0, t1 = lo // WARP_TILE, (hi - 1) // WARP_TILE
        parts = x[t0:t1 + 1, 0].copy()
        parts[0] = x[t0, lo - t0 * WARP_TILE]
        out[gi] = _lane_tree(parts, b, OH_COMBINE)
    return out


def span_tree_sums(t: np.ndarray, gids: np.ndarray, g: int) -> np.ndarray:
    """acc [G, B] float32: the group sums of ``t`` [S, B] float32 (rows
    in group order, ``gids`` sorted) in the span kernel's order."""
    s, b = t.shape
    nt = -(-s // WARP_TILE)
    tp = np.zeros((nt * WARP_TILE, b), np.float32)
    tp[:s] = t
    gp = np.full(nt * WARP_TILE, -1, np.int64)
    gp[:s] = gids
    starts = np.searchsorted(gids, np.arange(g + 1))
    out = np.zeros((g, b), np.float32)
    for gi in range(g):
        lo, hi = starts[gi], starts[gi + 1]
        if hi == lo:
            continue
        rows = slice(lo // WARP_TILE * WARP_TILE,
                     ((hi - 1) // WARP_TILE + 1) * WARP_TILE)
        x = np.where((gp[rows] == gi)[:, None], tp[rows], np.float32(0))
        x = x.reshape(-1, WARP_TILE, b)
        w = WARP_TILE
        while w > 1:  # __shfl_down_sync by 16, 8, 4, 2, 1
            w //= 2
            x = x[:, :w] + x[:, w:2 * w]
        out[gi] = _lane_tree(x[:, 0], b, COMBINE)
    return out


@functools.lru_cache(maxsize=1)
def _sweep_data():
    """(base, counter, gids) of the sweep's 200,003-row span size."""
    rng = np.random.default_rng(7)
    for s, b, k, g in ((1000, 5, 3, 7), (4097, 12, 5, 37), (129, 12, 5, 3),
                       (3001, 7, 9, 5), (S, B, K, G)):
        p = b * k
        base = rng.normal(100.0, 15.0, (s, p))
        counter = np.cumsum(rng.uniform(1, 50, (s, p)), axis=1)
        counter[s // 3, p // 2:] -= counter[s // 3, p // 2] * 0.9
        gids = rng.integers(0, g, s).astype(np.int32)
    return base, counter, gids


def _sums(ds_fn: str, rate: bool):
    """(kernel-order sums, float64 reference, float32 plain, terms)."""
    base, counter, gids = _sweep_data()
    spec = PipelineSpec(num_series=S, num_buckets=B, num_groups=G,
                        ds_function=ds_fn, agg_name="sum", rate=rate)
    ts = np.arange(B, dtype=np.int64) * 60_000 + 1_356_998_400_000
    x = torch.as_tensor(counter if rate else base, dtype=torch.float32)
    batch = fused.prepare(x, ts, gids, spec)
    assert batch.spans is not None and batch.order is not None
    t = fused._in_group_order(
        fused._transform_plain(batch.values, batch.inv_dt, spec, K, CM, RV),
        batch.order)
    tree = span_tree_sums(t.numpy(), batch.gids.numpy(), G)
    exact = fused.plain_reduce(batch, spec, K, CM, RV, exact=True).numpy()
    f32 = fused.plain_reduce(batch, spec, K, CM, RV).numpy()
    terms = fused.plain_reduce(batch, spec, K, CM, RV, exact=True,
                               magnitude=True).numpy()
    return tree, exact, f32, terms


def test_tree_order_gives_the_card_value():
    """The span kernel's order reproduces its H100 value at (2, 4), and
    so does the float64 reference; the card's float32 ``index_add_``
    value is past the tolerance."""
    tree, exact, _, terms = _sums("avg", False)
    assert tree[2, 4] == np.float32(2851193.75)
    assert exact[2, 4] == tree[2, 4]
    tol = TOL_REL * terms[2, 4] + TOL_ABS
    assert abs(np.float32(2851162.0) - tree[2, 4]) > tol


@pytest.mark.parametrize("ds_fn,rate", [("avg", False), ("sum", False),
                                        ("max", False), ("first", False),
                                        ("avg", True)])
def test_exact_reference_sides_with_tree_order(ds_fn, rate):
    """Float64 group sums rounded once stay within a tenth of the
    tolerance of the kernel's float32 tree over every cell."""
    tree, exact, _, terms = _sums(ds_fn, rate)
    assert bool((np.abs(tree - exact) <= 0.1 * TOL_REL * terms).all())


def test_float32_running_sum_spends_the_tolerance():
    """The float32 plain version (a running sum, as the wrappers run it
    for CPU tensors) is already more than half the tolerance from the
    kernel's tree by itself, so another float32 order (the card's
    atomics) can cross it."""
    tree, _, f32, terms = _sums("avg", False)
    assert float((np.abs(f32 - tree) / terms).max()) > 0.5 * TOL_REL


def test_span_wrapper_cpu_is_the_plain_version():
    """For CPU tensors ``span_reduce`` runs ``plain_reduce`` as it is
    (float32 sums), the function ``chip_smoke.py`` times as plain."""
    base, _, gids = _sweep_data()
    n = 3001
    spec = PipelineSpec(num_series=n, num_buckets=B, num_groups=G,
                        ds_function="avg", agg_name="sum", rate=True)
    ts = np.arange(B, dtype=np.int64) * 60_000 + 1_356_998_400_000
    batch = fused.prepare(torch.as_tensor(base[:n], dtype=torch.float32),
                          ts, gids[:n], spec)
    assert batch.order is not None
    got = fused.span_reduce(batch.values, batch.order, batch.gids,
                            batch.spans, batch.group_start, batch.inv_dt,
                            spec, K, CM, RV)
    assert torch.equal(got, fused.plain_reduce(batch, spec, K, CM, RV))


@pytest.mark.parametrize("g", [7, 2000])
def test_onehot_run_order_sides_with_exact(g):
    """The one-hot kernel's order (runs of one group in a warp tile,
    then a fixed tree over the tiles) stays within a tenth of the
    tolerance of the float64 group sums, at 7 large groups and at 2000
    groups of about 100 rows, several to a warp tile."""
    base, _, _ = _sweep_data()
    rng = np.random.default_rng(31)
    gids = rng.integers(0, g, S).astype(np.int32)
    spec = PipelineSpec(num_series=S, num_buckets=B, num_groups=g,
                        ds_function="avg", agg_name="sum")
    ts = np.arange(B, dtype=np.int64) * 60_000 + 1_356_998_400_000
    batch = fused.prepare(torch.as_tensor(base, dtype=torch.float32), ts,
                          gids, spec, allow_span=False)
    assert batch.spans is None and batch.order is not None
    t = fused._in_group_order(
        fused._transform_plain(batch.values, batch.inv_dt, spec, K, CM, RV),
        batch.order)
    runs = onehot_run_sums(t.numpy(), batch.gids.numpy(), g)
    exact = fused.plain_reduce(batch, spec, K, CM, RV, exact=True).numpy()
    terms = fused.plain_reduce(batch, spec, K, CM, RV, exact=True,
                               magnitude=True).numpy()
    assert bool((np.abs(runs - exact) <= 0.1 * TOL_REL * terms).all())
