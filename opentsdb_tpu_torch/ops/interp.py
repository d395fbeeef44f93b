"""Merge-time interpolation as vectorized gap filling.

(ref: ``src/core/AggregationIterator.java:27-119``)

On the ``[series, bucket]`` grid the reference's per-span interpolation
becomes a masked fill along the time axis: every NaN hole *between* a
series' first and last values is substituted per the aggregator's
interpolation mode; outside that range the series contributes nothing
(stays NaN).

The reference package finds the nearest present cell with a
``lax.associative_scan``; here it is a running max (min) of the
last- (next-) valid column index plus a ``gather``, which yields the
same values. The running max is log2(B) elementwise passes: torch's
``cummax``/``cummin`` along the innermost axis also compute indices and
took 10 ms each on a ``[1M, 12]`` int64 grid on an H100, 90% of the
grid tail.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops.aggregators import Interpolation


def _gather_at(arrays, idx):
    safe = idx.clamp(min=0, max=idx.shape[-1] - 1)
    return tuple(torch.gather(a, -1, safe) for a in arrays)


def _running(idx, forward: bool):
    """Inclusive running max along the last axis (``forward``), or the
    running min from the end, by doubling; ``idx`` is overwritten."""
    b = idx.shape[-1]
    k = 1
    while k < b:
        if forward:
            idx[..., k:] = torch.maximum(idx[..., k:], idx[..., :-k])
        else:
            idx[..., :-k] = torch.minimum(idx[..., :-k], idx[..., k:])
        k *= 2
    return idx


def carry_prev(arrays, mask):
    """For each cell along the last axis: the values of ``arrays`` at
    the nearest PRESENT cell at-or-before it, plus that presence flag."""
    b = mask.shape[-1]
    col = torch.arange(b, device=mask.device).expand_as(mask)
    idx = _running(torch.where(mask, col, -1), forward=True)
    return _gather_at(arrays, idx) + (idx >= 0,)


def carry_next(arrays, mask):
    """Reverse twin of :func:`carry_prev`: nearest present cell
    at-or-after."""
    b = mask.shape[-1]
    col = torch.arange(b, device=mask.device).expand_as(mask)
    idx = _running(torch.where(mask, col, b), forward=False)
    return _gather_at(arrays, idx) + (idx < b,)


def shift_prev(arrays, fill_values):
    """Shift each [S, B] array one column right (making an inclusive
    prev-carry exclusive: 'strictly before'), filling column 0."""
    return tuple(
        torch.cat([torch.full_like(a[:, :1], fv), a[:, :-1]], dim=-1)
        for a, fv in zip(arrays, fill_values))


def under_carry(local, carry):
    """Per cell of ``local`` (``[S, B]`` arrays, their presence last):
    the local values where present, else the series' ``carry`` (``[S]``
    vectors, their presence last): the nearest present cell outside
    this block of buckets (:mod:`.blocked`)."""
    *vals, has = local
    *cvals, cp = carry
    return tuple(torch.where(has, v, c[:, None])
                 for v, c in zip(vals, cvals)) + (has | cp[:, None],)


def fill_gaps(grid, bucket_ts, mode: str, carries=None):
    """Fill NaN holes of ``grid[S,B]`` per interpolation ``mode``.

    - ``lerp``: linear interpolation against ``bucket_ts`` between each
      series' first and last valid cells; NaN outside.
    - ``zim``: 0 for every hole (ZeroIfMissing).
    - ``max`` / ``min``: +inf / -inf for holes *between* first and last
      valid (type extremes, used by mimmin/mimmax); NaN outside.
    - ``prev``: repeat previous valid value (pfsum); NaN before the
      first valid cell.

    ``carries`` = (prev, next), each ``(values [S], int64 times [S],
    present [S])``: the nearest present cell of each series before and
    after ``grid``'s buckets, when ``grid`` is one time block of a
    longer range; a hole with no present cell of its own on that side
    takes the carry.
    """
    nan = float("nan")
    mask = ~torch.isnan(grid)
    if mode == Interpolation.ZIM.value:
        return torch.where(mask, grid, 0.0)

    gz = torch.where(mask, grid, 0.0)
    if mode == Interpolation.PREV.value:
        prev_val, has_prev = carry_prev((gz,), mask)
        if carries is not None:
            pv, _, pp = carries[0]
            prev_val, has_prev = under_carry((prev_val, has_prev),
                                             (pv, pp))
        return torch.where(mask, grid,
                           torch.where(has_prev, prev_val, nan))

    ts_row = bucket_ts[None, :].expand_as(grid)
    v0, t0, has0 = carry_prev((gz, ts_row), mask)
    v1, t1, has1 = carry_next((gz, ts_row), mask)
    if carries is not None:
        v0, t0, has0 = under_carry((v0, t0, has0), carries[0])
        v1, t1, has1 = under_carry((v1, t1, has1), carries[1])
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
