"""Time-blocked execution of long ranges (port of
``opentsdb_tpu/ops/blocked.py``, with the boundary helpers of
``opentsdb_tpu/parallel/sharded_pipeline.py``).

A query whose ``[S, B]`` grid exceeds the device cell budget
(``tsd.query.max_device_cells``, :data:`DEFAULT_CELL_BUDGET`) runs in
time blocks of ``block_buckets`` buckets, so the device holds
``O(S x block)`` cells whatever the range's length. The whole point
batch stays on the host; each block's slice is uploaded on its own, and
the ``[G, B]`` result and emit mask are assembled on the host.

Rate and merge interpolation look across block edges. Carries are
``[S]`` vectors (value, int64 time relative to the query's first
bucket, present), so a block computes the same bits as the whole range:

- pass 1 (forward): per block, bucketize -> fill policy -> rate with
  the running prev-carry, keeping only each block's first present cell
  after the rate; it runs only when the aggregator interpolates with a
  next cell (LERP, MIN, MAX under fill NONE);
- a backward scan of those firsts gives each block its next-present
  carry;
- pass 2 (forward): recompute each block, fill its holes with the
  (prev, next) carries (:func:`_fill_with_boundaries`), group-reduce in
  the fixed order of a :class:`~.groupby.GroupPlan` and copy the
  ``[G, Bb]`` slab to the host.

The points must be in (series, time) order, as the store materializes
them; each block's points are taken out with a mask, which keeps that
order inside the block.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import groupby as gb_mod
from opentsdb_tpu_torch.ops.interp import fill_gaps
from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec,
                                             apply_fill_policy,
                                             device_bucket_ts)
from opentsdb_tpu_torch.ops.rate import RateOptions, _rate_kernel

# default device-cell budget per block (~256 MB of float32)
DEFAULT_CELL_BUDGET = 1 << 26

_COUNT_LOCK = threading.Lock()


# -- the boundary helpers ----------------------------------------------------

def _block_boundaries(grid, bucket_ts):
    """Per series, the last and the first present cell of this block:
    ((last_v, last_t, present), (first_v, first_t, present)), ``[S]``
    each, times int64 from ``bucket_ts``."""
    nb = grid.shape[-1]
    mask = ~torch.isnan(grid)
    col = torch.arange(nb, device=grid.device)
    last = torch.where(mask, col, -1).amax(dim=-1)
    first = torch.where(mask, col, nb).amin(dim=-1)
    lp, fp = last.clamp(min=0), first.clamp(max=nb - 1)
    return ((grid.gather(-1, lp[:, None])[:, 0], bucket_ts[lp], last >= 0),
            (grid.gather(-1, fp[:, None])[:, 0], bucket_ts[fp], first < nb))


def _fill_with_boundaries(grid, bucket_ts, mode: str, prev_carry,
                          next_carry):
    """Merge-time interpolation of one block with its cross-block
    carries: :func:`~.interp.fill_gaps` over the block, a hole with no
    present cell of its own on one side taking that side's carry."""
    return fill_gaps(grid, bucket_ts, mode, (prev_carry, next_carry))


def _rate_with_boundary(grid, bucket_ts, spec: PipelineSpec,
                        ro: RateOptions, carry):
    """The rate of one block, the first present cell of each series
    taking ``carry`` (the last present pre-rate cell of an earlier
    block) as its predecessor."""
    return _rate_kernel(grid, bucket_ts, spec.rate_counter,
                        float(ro.counter_max), float(ro.reset_value),
                        spec.rate_drop_resets, carry)


# -- the passes --------------------------------------------------------------

def _prep_block(values, series_idx, bucket_idx, num_buckets: int,
                spec: PipelineSpec):
    """bucketize + downsample fill policy (pipeline steps 1-2)."""
    grid, cnt = ds_mod.bucketize(values, series_idx, bucket_idx,
                                 spec.num_series, num_buckets,
                                 spec.ds_function)
    return apply_fill_policy(grid, cnt > 0, spec)


def _pass1_step(values, series_idx, bucket_idx, bucket_ts,
                ro: RateOptions, rate_carry, spec: PipelineSpec):
    """One block up to its rate: (the last present pre-rate cell of
    each series, or None without a rate; the rated grid; has_data)."""
    grid, has_data = _prep_block(values, series_idx, bucket_idx,
                                 bucket_ts.shape[0], spec)
    pre_last = None
    if spec.rate:
        pre_last = _block_boundaries(grid, bucket_ts)[0]
        grid = _rate_with_boundary(grid, bucket_ts, spec, ro, rate_carry)
        has_data = has_data & ~torch.isnan(grid)
    return pre_last, grid, has_data


def _pass2_step(grid, has_data, bucket_ts, plan: gb_mod.GroupPlan,
                prev_carry, next_carry, spec: PipelineSpec):
    """Fill with carries + group reduce one block -> ([G, Bb], emit),
    as :func:`~.pipeline._finish_pipeline` does over the whole range."""
    agg = aggs_mod.get(spec.agg_name)
    if spec.fill_policy == ds_mod.FillPolicy.NONE and not spec.complete:
        filled = _fill_with_boundaries(grid, bucket_ts,
                                       agg.interpolation.value,
                                       prev_carry, next_carry)
    else:
        # NAN/NULL fills emit explicit NaN points: the merge skips
        # them without interpolating
        filled = grid
    result = gb_mod._group_reduce(filled, plan.group_ids, spec.num_groups,
                                  agg.name, plan)
    if spec.fill_policy == ds_mod.FillPolicy.NONE \
            and not (spec.complete and not spec.rate):
        emit = plan.max(has_data.to(grid.dtype)) > 0
    else:
        emit = torch.ones((spec.num_groups, grid.shape[-1]),
                          dtype=torch.bool, device=grid.device)
    return result, emit


def _merge_carry(nearer, farther):
    """Combine boundary candidates: keep the nearer block's when
    present, else the farther carry."""
    (v0, t0, p0), (v1, t1, p1) = nearer, farther
    return (torch.where(p0, v0, v1), torch.where(p0, t0, t1), p0 | p1)


def _empty_carry(num_series: int, dtype: torch.dtype, device):
    return (torch.zeros(num_series, dtype=dtype, device=device),
            torch.zeros(num_series, dtype=torch.int64, device=device),
            torch.zeros(num_series, dtype=torch.bool, device=device))


def pick_block_buckets(num_series: int, num_buckets: int,
                       cell_budget: int = DEFAULT_CELL_BUDGET) -> int:
    """Largest block size keeping S x Bb under the device budget."""
    if num_series <= 0:
        return num_buckets
    return max(1, min(num_buckets, cell_budget // max(num_series, 1)))


def _block_slices(values: np.ndarray, series_idx: np.ndarray,
                  bucket_idx: np.ndarray, num_buckets: int, bb: int,
                  np_dtype) -> list:
    """Each block's (values, series_idx, bucket_idx) in (series, time)
    order, the values cast to ``np_dtype``."""
    step = np.diff(series_idx)
    if ((step < 0) | ((step == 0) & (np.diff(bucket_idx) < 0))).any():
        # not in (series, time) order: one stable sort puts it there
        first = np.argsort(series_idx.astype(np.int64) * num_buckets
                           + bucket_idx, kind="stable")
        values, series_idx, bucket_idx = (
            values[first], series_idx[first], bucket_idx[first])
        del first
    del step
    n_blocks = -(-num_buckets // bb)
    # a mask per block keeps the batch's order inside it: one pass over
    # the points each, no permutation
    key = bucket_idx // bb
    key = key.astype(np.uint8 if n_blocks <= 1 << 8 else np.int64)
    out = []
    for i in range(n_blocks):
        mask = key == i
        out.append((np.asarray(values[mask], dtype=np_dtype),
                    series_idx[mask].astype(np.int32, copy=False),
                    bucket_idx[mask].astype(np.int32, copy=False)))
    return out


def execute_blocked(batch_values: np.ndarray, series_idx: np.ndarray,
                    bucket_idx: np.ndarray, bucket_ts: np.ndarray,
                    group_ids: np.ndarray, spec: PipelineSpec,
                    rate_options: RateOptions | None = None, *,
                    dtype: torch.dtype, device,
                    block_buckets: int | None = None,
                    stages: dict | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming equivalent of :func:`~.pipeline.execute` over a flat
    point batch for ``emit_raw=False``: the same bits, with device
    memory bounded by ``num_series x block_buckets`` cells. Returns the
    ``[G, B]`` result and emit mask as host arrays. ``stages``, when
    given, receives the seconds of the host split into blocks, pass 1
    and pass 2 (its host copies included)."""
    if spec.emit_raw:
        raise ValueError("blocked execution aggregates; emit_raw "
                         "queries run whole")
    ro = rate_options or RateOptions()
    s, b, g = spec.num_series, spec.num_buckets, spec.num_groups
    bb = block_buckets or pick_block_buckets(s, b)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    t = time.perf_counter()
    series_idx = np.asarray(series_idx)
    bucket_idx = np.asarray(bucket_idx)
    slices = _block_slices(np.asarray(batch_values), series_idx,
                           bucket_idx, b, bb, np_dtype)
    blocks = [(b0, min(b0 + bb, b), i)
              for i, b0 in enumerate(range(0, b, bb))]
    bts = torch.as_tensor(device_bucket_ts(bucket_ts)).to(device)
    split_s = time.perf_counter() - t

    def run_block(blk, rate_carry):
        b0, b1, i = blk
        sv, ssi, sbi = slices[i]
        up = (torch.from_numpy(sv).to(device),
              torch.from_numpy(ssi).to(device),
              torch.from_numpy(sbi).to(device) - b0)
        return _pass1_step(*up, bts[b0:b1], ro, rate_carry, spec)

    agg = aggs_mod.get(spec.agg_name)
    needs_next = spec.fill_policy == ds_mod.FillPolicy.NONE \
        and not spec.complete \
        and agg.interpolation.value in ("lerp", "max", "min")
    empty = _empty_carry(s, dtype, device)

    # pass 1: forward sweep keeping each block's first present cell
    # (on the host: their count grows with the range)
    t = time.perf_counter()
    firsts = []
    rate_carry = empty
    for blk in (blocks if needs_next else ()):
        pre_last, grid, _ = run_block(blk, rate_carry)
        firsts.append(tuple(x.cpu() for x in
                            _block_boundaries(grid, bts[blk[0]:blk[1]])[1]))
        del grid
        if spec.rate:
            rate_carry = _merge_carry(pre_last, rate_carry)
    # backward scan: the next-present carry of each block
    next_carries = [None] * len(blocks)
    nc = _empty_carry(s, dtype, "cpu")
    for i in range(len(blocks) - 1, -1, -1):
        next_carries[i] = nc
        if needs_next:
            nc = _merge_carry(firsts[i], nc)
    del firsts
    pass1_s = time.perf_counter() - t

    # pass 2: forward sweep computing the [G, Bb] slabs
    t = time.perf_counter()
    plan = gb_mod.GroupPlan(
        torch.as_tensor(np.asarray(group_ids, dtype=np.int32)).to(device),
        g)
    out = np.empty((g, b), dtype=np_dtype)
    emit_out = np.empty((g, b), dtype=bool)
    rate_carry = prev_carry = empty
    for blk, nxt in zip(blocks, next_carries):
        b0, b1 = blk[0], blk[1]
        pre_last, grid, has_data = run_block(blk, rate_carry)
        result, emit = _pass2_step(
            grid, has_data, bts[b0:b1], plan, prev_carry,
            tuple(x.to(device) for x in nxt), spec)
        out[:, b0:b1] = result.cpu().numpy()
        emit_out[:, b0:b1] = emit.cpu().numpy()
        if spec.rate:
            rate_carry = _merge_carry(pre_last, rate_carry)
        prev_carry = _merge_carry(_block_boundaries(grid, bts[b0:b1])[0],
                                  prev_carry)
        del grid, has_data, result, emit
    pass2_s = time.perf_counter() - t
    with _COUNT_LOCK:
        execute_blocked.runs += 1
        execute_blocked.blocks += len(blocks)
    if stages is not None:
        stages.update(split=split_s, pass1=pass1_s, pass2=pass2_s)
    return out, emit_out


# blocked executions and the blocks they ran, since the last reset
execute_blocked.runs = 0
execute_blocked.blocks = 0
