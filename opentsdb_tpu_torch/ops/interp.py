"""Merge-time interpolation as vectorized gap filling.

(ref: ``src/core/AggregationIterator.java:27-119``)

On the ``[series, bucket]`` grid the reference's per-span interpolation
becomes a masked fill along the time axis: every NaN hole *between* a
series' first and last values is substituted per the aggregator's
interpolation mode; outside that range the series contributes nothing
(stays NaN).

The reference package finds the nearest present cell with a
``lax.associative_scan``; PyTorch has no such scan, so here it is a
``cummax`` over the last-valid column index plus a ``gather``, which
yields the same values.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops.aggregators import Interpolation


def _gather_at(arrays, idx):
    safe = idx.clamp(min=0, max=idx.shape[-1] - 1)
    return tuple(torch.gather(a, -1, safe) for a in arrays)


def carry_prev(arrays, mask):
    """For each cell along the last axis: the values of ``arrays`` at
    the nearest PRESENT cell at-or-before it, plus that presence flag."""
    b = mask.shape[-1]
    col = torch.arange(b, device=mask.device).expand_as(mask)
    idx = torch.where(mask, col, -1).cummax(dim=-1).values
    return _gather_at(arrays, idx) + (idx >= 0,)


def carry_next(arrays, mask):
    """Reverse twin of :func:`carry_prev`: nearest present cell
    at-or-after."""
    b = mask.shape[-1]
    col = torch.arange(b, device=mask.device).expand_as(mask)
    idx = torch.where(mask, col, b).flip(-1).cummin(dim=-1).values \
        .flip(-1)
    return _gather_at(arrays, idx) + (idx < b,)


def shift_prev(arrays, fill_values):
    """Shift each [S, B] array one column right (making an inclusive
    prev-carry exclusive: 'strictly before'), filling column 0."""
    return tuple(
        torch.cat([torch.full_like(a[:, :1], fv), a[:, :-1]], dim=-1)
        for a, fv in zip(arrays, fill_values))


def fill_gaps(grid, bucket_ts, mode: str):
    """Fill NaN holes of ``grid[S,B]`` per interpolation ``mode``.

    - ``lerp``: linear interpolation against ``bucket_ts`` between each
      series' first and last valid cells; NaN outside.
    - ``zim``: 0 for every hole (ZeroIfMissing).
    - ``max`` / ``min``: +inf / -inf for holes *between* first and last
      valid (type extremes, used by mimmin/mimmax); NaN outside.
    - ``prev``: repeat previous valid value (pfsum); NaN before the
      first valid cell.
    """
    nan = float("nan")
    mask = ~torch.isnan(grid)
    if mode == Interpolation.ZIM.value:
        return torch.where(mask, grid, 0.0)

    gz = torch.where(mask, grid, 0.0)
    if mode == Interpolation.PREV.value:
        prev_val, has_prev = carry_prev((gz,), mask)
        return torch.where(mask, grid,
                           torch.where(has_prev, prev_val, nan))

    ts_row = bucket_ts[None, :].expand_as(grid)
    v0, t0, has0 = carry_prev((gz, ts_row), mask)
    v1, t1, has1 = carry_next((gz, ts_row), mask)
    in_range = has0 & has1
    if mode in (Interpolation.MAX.value, Interpolation.MIN.value):
        extreme = torch.inf if mode == Interpolation.MAX.value \
            else -torch.inf
        return torch.where(mask, grid,
                           torch.where(in_range, extreme, nan))

    if mode != Interpolation.LERP.value:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    # integer ts differences before the float cast: exact
    t = bucket_ts[None, :]
    num = (t - t0).to(grid.dtype)
    den = (t1 - t0).to(grid.dtype)
    lerped = v0 + (v1 - v0) * num / torch.where(den > 0, den, 1.0)
    return torch.where(mask, grid, torch.where(in_range, lerped, nan))
