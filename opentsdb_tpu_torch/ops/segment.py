"""Segmented reductions over flat point batches.

Port of ``opentsdb_tpu/ops/segment.py``. A flat batch of points
``(values[N], seg_ids[N])`` is reduced into ``num_segments`` slots; the
segment ids are ``series_idx * num_buckets + bucket_idx``, so one call
downsamples every series of a query at once.

Points arrive sorted by (series, time) from the store, so the ids are
non-decreasing: each segment is one contiguous slice, found by a
``searchsorted`` of the segment boundaries, and reduced by
``torch.segment_reduce`` over those offsets. Both walk each segment in a
fixed order, so a call gives the same bits every time on the card as on
the CPU (``index_add_`` and ``scatter_reduce_`` add with atomics in no
fixed order on CUDA and are not used). Ids outside ``[0,
num_segments)`` are dropped, as the reference's scatter drops them.
Unsorted ids (``sorted_ids=False``) are put in order first by a stable
sort, which keeps the points of a segment in their batch order.
"""

from __future__ import annotations

import torch


def _sorted(values: torch.Tensor, seg_ids: torch.Tensor,
            sorted_ids: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if sorted_ids:
        return values, seg_ids
    seg_ids, order = torch.sort(seg_ids, stable=True)
    return values[order], seg_ids


def segment_offsets(seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """[num_segments + 1] int64: segment j is ``[off[j], off[j+1])`` of
    the (sorted) ids; ids below 0 lie before ``off[0]``, ids of
    ``num_segments`` or more after ``off[-1]``."""
    bounds = torch.arange(num_segments + 1, device=seg_ids.device,
                          dtype=seg_ids.dtype)
    return torch.searchsorted(seg_ids, bounds)


def reduce_at(values: torch.Tensor, offsets: torch.Tensor,
              reduce: str) -> torch.Tensor:
    """``reduce`` ("sum", "prod", "min", "max") of each segment
    ``values[offsets[j]:offsets[j+1]]``; an empty segment holds the
    reduction's identity (0, 1, +inf, -inf).

    The values go in as one column: on CUDA, ``segment_reduce`` of 1-D
    data runs a segmented reduce of one thread block per segment, while
    a column takes one thread per segment, walking it in order, which
    is far faster over the millions of short segments of a point batch
    (PERF.md §6)."""
    return torch.segment_reduce(values[:, None], reduce, offsets=offsets,
                                axis=0)[:, 0]


def first_last_at(values: torch.Tensor, valid: torch.Tensor | None,
                  offsets: torch.Tensor):
    """(first, last) value of each segment of ``values`` at ``offsets``,
    skipping the points that ``valid`` masks out. An empty segment holds
    ``values[0]`` (0 when there are no points), as in the reference;
    callers mask it. Positions are reduced as float64, exact below
    2**53 points."""
    n = values.shape[0]
    if n == 0:
        z = values.new_zeros((offsets.shape[0] - 1,))
        return z, z
    pos = torch.arange(n, device=values.device, dtype=torch.float64)
    if valid is None:
        first_cand = last_cand = pos
    else:
        first_cand = torch.where(valid, pos, torch.inf)
        last_cand = torch.where(valid, pos, -torch.inf)
    first_pos = reduce_at(first_cand, offsets, "min")
    last_pos = reduce_at(last_cand, offsets, "max")
    has_any = torch.isfinite(first_pos) & torch.isfinite(last_pos)
    safe_first = torch.where(has_any, first_pos, 0.0).long()
    safe_last = torch.where(has_any, last_pos, 0.0).long()
    return values[safe_first], values[safe_last]


def _reduce(values, seg_ids, num_segments, reduce: str, sorted_ids: bool):
    values, seg_ids = _sorted(values, seg_ids, sorted_ids)
    return reduce_at(values, segment_offsets(seg_ids, num_segments),
                     reduce)


def seg_sum(values, seg_ids, num_segments, sorted_ids=True):
    return _reduce(values, seg_ids, num_segments, "sum", sorted_ids)


def seg_count(values, seg_ids, num_segments, sorted_ids=True):
    return _reduce(torch.ones_like(values), seg_ids, num_segments, "sum",
                   sorted_ids)


def seg_min(values, seg_ids, num_segments, sorted_ids=True):
    """An empty segment holds +inf (the reference: the dtype's max)."""
    return _reduce(values, seg_ids, num_segments, "min", sorted_ids)


def seg_max(values, seg_ids, num_segments, sorted_ids=True):
    """An empty segment holds -inf (the reference: the dtype's min)."""
    return _reduce(values, seg_ids, num_segments, "max", sorted_ids)


def seg_prod(values, seg_ids, num_segments, sorted_ids=True):
    return _reduce(values, seg_ids, num_segments, "prod", sorted_ids)


def seg_sumsq(values, seg_ids, num_segments, sorted_ids=True):
    return _reduce(values * values, seg_ids, num_segments, "sum",
                   sorted_ids)


def seg_first_last(values, seg_ids, num_segments, valid=None,
                   sorted_ids=True):
    """(first, last) value per segment, relying on the time order of
    the points within a segment (:func:`first_last_at`). ``valid``
    masks out NaN points (they are skipped, not selected)."""
    if not sorted_ids:
        seg_ids, order = torch.sort(seg_ids, stable=True)
        values = values[order]
        valid = None if valid is None else valid[order]
    return first_last_at(values, valid,
                         segment_offsets(seg_ids, num_segments))


def segment_sort_ranks(values, seg_ids, num_segments):
    """Sort ``values`` within segments: (sorted_values, sorted_seg_ids,
    segment_starts, segment_valid_counts).

    The reference's one two-key ``lax.sort`` becomes two stable sorts:
    by value, then by segment id. ``torch.sort`` puts NaN after every
    number, as ``lax.sort`` does, so NaN points sort to the end of their
    segment and are left out of the valid counts; equal values (-0.0
    and +0.0 among them) keep their batch order in both, as they do in
    ``lax.sort``. Starts and counts come from the sorted ids' offsets
    and a fixed-order segment sum."""
    by_value = torch.sort(values, stable=True).indices
    sorted_ids, by_id = torch.sort(seg_ids[by_value], stable=True)
    sorted_vals = values[by_value[by_id]]
    off = segment_offsets(sorted_ids, num_segments)
    counts = reduce_at((~torch.isnan(sorted_vals)).to(torch.float64), off,
                       "sum").long()
    return sorted_vals, sorted_ids, off[:-1], counts


def select_rank(sorted_vals, starts, counts, h):
    """Per-segment order statistics at (1-based, fractional) ranks
    ``h[num_segments]`` with linear interpolation between neighbours:
    the core of every percentile estimation. A segment of count 0
    gives NaN."""
    n = sorted_vals.shape[0]
    last = max(n - 1, 0)
    h_floor = torch.floor(h)
    frac = h - h_floor
    top = (counts - 1).clamp(min=0)
    lo_idx = (h_floor.long() - 1).clamp(min=0)
    hi_idx = torch.minimum(lo_idx + 1, top)
    lo_idx = torch.minimum(lo_idx, top)
    if n == 0:
        return torch.full(h.shape, torch.nan, dtype=sorted_vals.dtype,
                          device=sorted_vals.device)
    lo = sorted_vals[(starts + lo_idx).clamp(0, last)]
    hi = sorted_vals[(starts + hi_idx).clamp(0, last)]
    out = lo + frac * (hi - lo)
    return torch.where(counts > 0, out, torch.nan)
