"""Batched fold and window-combine functions of the continuous queries
(ref: ``opentsdb_tpu/ops/stream_fold.py``).

One shared partial array (sum/count/min/max per (series, bucket) cell,
:mod:`opentsdb_tpu_torch.streaming.plan`) is maintained by ONE vectorized
scatter fold per ingest batch and then serves every continuous query
attached to it — the multi-query plan-sharing core: fold cost is per
*partial array*, not per standing query, so N same-metric dashboards
cost one fold.

The window combines layer on the same decomposition rule the rollup
tiers use (``rollup/job.py``: sums of sums, counts of counts, mins of
mins, maxs of maxs; ``avg`` derives as sum/count at read time):

- :func:`combine_stride` — a view whose downsample interval is a
  multiple of the shared base interval derives its buckets by
  combining ``stride`` contiguous base buckets (downsample-divisible
  plan sharing).
- :func:`combine_sliding` — sliding windows: each output bucket
  aggregates the ``k`` trailing buckets ending at it (window size =
  k x interval, slide = interval). Windowed sums use an explicit
  window view (not cumsum differences) so summation order matches a
  direct per-window fold bit for bit.
- :func:`combine_hopping` — hopping windows (slide > interval): the
  trailing-``k`` combine of :func:`combine_sliding` subsampled to
  the slide-aligned output columns, so a hopping bucket is bit-equal
  to the sliding bucket at the same edge.
- :func:`session_grid` — session-gap windows: consecutive non-empty
  buckets whose edge distance is <= ``gap_ms`` merge into one
  session; the session aggregate lands on the session's FIRST bucket
  edge, other buckets are empty. The combine runs as ONE flat
  reduceat over every (row, bucket) cell (:func:`session_grid_flat`)
  so per-tag session partials — where rows explode to user
  cardinality — close sessions in one pass, not S python loops.

All of them are host numpy, as in the reference: they run off the
ingest path on the shared fold workers (or in a dashboard-sized serve
tail). Only the pipeline tail a pull runs over their grid goes to the
query device (:meth:`~opentsdb_tpu_torch.streaming.plan.PlanView.serve`).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

STATS = ("sum", "count", "min", "max")


def scatter_fold(sums: np.ndarray, cnts: np.ndarray, mins: np.ndarray,
                 maxs: np.ndarray, slots: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray) -> None:
    """Fold one batch of points into the shared partial ring IN
    PLACE: one unbuffered scatter per stat channel. ``slots`` are
    member row indices, ``cols`` ring columns, ``vals`` the values —
    all filtered to live buckets by the caller."""
    np.add.at(sums, (slots, cols), vals)
    np.add.at(cnts, (slots, cols), 1.0)
    np.minimum.at(mins, (slots, cols), vals)
    np.maximum.at(maxs, (slots, cols), vals)


def combine_stride(sums: np.ndarray, cnts: np.ndarray,
                   mins: np.ndarray, maxs: np.ndarray, stride: int):
    """[S, B*stride] base-bucket channels -> [S, B] view-bucket
    channels by combining each run of ``stride`` contiguous base
    buckets (sum/sum/min/max — exact for the decomposable stats)."""
    if stride <= 1:
        return sums, cnts, mins, maxs
    s, n = sums.shape
    b = n // stride

    def rs(a):
        return a.reshape(s, b, stride)

    return (rs(sums).sum(axis=2), rs(cnts).sum(axis=2),
            rs(mins).min(axis=2), rs(maxs).max(axis=2))


def combine_sliding(sums: np.ndarray, cnts: np.ndarray,
                    mins: np.ndarray, maxs: np.ndarray, k: int):
    """Trailing-window combine: output bucket ``j`` aggregates input
    buckets ``max(0, j-k+1) .. j`` (leading outputs see a clipped
    window). Identity channels pad with 0 / +-inf so a clipped window
    equals a direct fold over its available buckets."""
    if k <= 1:
        return sums, cnts, mins, maxs
    s = sums.shape[0]

    def trail(a, fill, reduce):
        pad = np.concatenate(
            [np.full((s, k - 1), fill, dtype=a.dtype), a], axis=1)
        return reduce(sliding_window_view(pad, k, axis=1), -1)

    return (trail(sums, 0.0, np.sum), trail(cnts, 0.0, np.sum),
            trail(mins, np.inf, np.min), trail(maxs, -np.inf, np.max))


def combine_hopping(sums: np.ndarray, cnts: np.ndarray,
                    mins: np.ndarray, maxs: np.ndarray, k: int,
                    sel: np.ndarray):
    """Hopping-window combine: output bucket ``sel[j]`` aggregates
    the ``k`` trailing input buckets ending at it — the trailing
    combine of :func:`combine_sliding` subsampled to the
    slide-aligned columns ``sel``, so a hopping bucket is bit-equal
    to the sliding bucket at the same edge (slide == interval is
    exactly sliding; the caller enforces slide > interval)."""
    s, c, mn, mx = combine_sliding(sums, cnts, mins, maxs, k)
    return s[:, sel], c[:, sel], mn[:, sel], mx[:, sel]


def session_grid_flat(sums: np.ndarray, cnts: np.ndarray,
                      mins: np.ndarray, maxs: np.ndarray,
                      edges: np.ndarray, gap_ms: int):
    """Session-gap combine over EVERY row in one flat pass: the
    non-empty (row, bucket) cells enumerate in row-major order, a
    session break falls on every row change and every within-row
    edge gap > ``gap_ms``, and one ``reduceat`` per stat channel
    folds each segment onto its first bucket. Element order within a
    segment matches the per-row walk exactly, so results are
    bit-identical to reducing each row independently — but a
    million-session partial closes in one kernel call."""
    out_s = np.zeros_like(sums)
    out_c = np.zeros_like(cnts)
    out_min = np.full_like(mins, np.inf)
    out_max = np.full_like(maxs, -np.inf)
    rows, cols = np.nonzero(cnts > 0)
    if not len(rows):
        return out_s, out_c, out_min, out_max
    e = edges[cols]
    brk = np.empty(len(rows), dtype=bool)
    brk[0] = True
    # a new session starts on a new row or where the edge gap
    # exceeds gap_ms (the cross-row diff is masked by the row break)
    brk[1:] = (rows[1:] != rows[:-1]) | ((e[1:] - e[:-1]) > gap_ms)
    starts = np.nonzero(brk)[0]
    r0, c0 = rows[starts], cols[starts]
    out_s[r0, c0] = np.add.reduceat(sums[rows, cols], starts)
    out_c[r0, c0] = np.add.reduceat(cnts[rows, cols], starts)
    out_min[r0, c0] = np.minimum.reduceat(mins[rows, cols], starts)
    out_max[r0, c0] = np.maximum.reduceat(maxs[rows, cols], starts)
    return out_s, out_c, out_min, out_max


def session_grid(sums: np.ndarray, cnts: np.ndarray, mins: np.ndarray,
                 maxs: np.ndarray, edges: np.ndarray, gap_ms: int):
    """Session-gap combine: per series, runs of non-empty buckets
    whose consecutive edge distance is <= ``gap_ms`` merge into one
    session whose aggregate lands on the run's FIRST bucket; every
    other bucket comes back empty. Sessions are delimited within the
    supplied range (a session truncated by the range edge aggregates
    its visible part). Thin alias of :func:`session_grid_flat` —
    kept as the view-combine entry point."""
    return session_grid_flat(sums, cnts, mins, maxs, edges, gap_ms)
