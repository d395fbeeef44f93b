"""Pixel-aware serve-path downsampling: M4 and MinMaxLTTB (ref:
``opentsdb_tpu/ops/visual_downsample.py``, ported whole: host numpy in
both packages).

A dashboard chart is ``W`` pixels wide; shipping more than ~4 points
per pixel column per series is wire and serialization waste, since
the browser draws them onto the same column (tsdownsample; M4: Jugel
et al., VLDB 2014). These functions reduce the engine's final
per-group output, after downsample/fill/rate/interpolate/aggregate, to
the points a ``W``-px line rendering needs.

Both operators are point selections: they compute a boolean keep mask
over the engine's ``[S, B]`` result and emit grids, and the serve path
applies ``emit &= keep`` before result assembly. No value or timestamp
changes, which is what makes M4 error-free for line rendering: every
pixel column's min, max, first and last real point survives.

- **M4**: per (series row, pixel column), keep the first and last
  emitted points and the (earliest) min and max among non-NaN emitted
  points; at most 4 points per occupied pixel. NaN points (fill-policy
  holes emitted as gaps) keep their first/last per pixel so gap
  boundaries survive.
- **MinMaxLTTB**: a MinMax preselection into ``ratio * n_out`` bins
  feeds Largest-Triangle-Three-Buckets, emitting at most ``n_out``
  points per series (global first and last always kept). Not
  error-free, so M4 is the default.

Everything is column-segment reductions (``np.minimum.reduceat`` over
the pixel partition of the bucket axis) on host grids of a few
thousand columns by a few hundred groups.
"""

from __future__ import annotations

import numpy as np

# supported pixel-reduction operators (query surface: `pixelFn` /
# `downsample=<N>px-<fn>`)
PIXEL_FNS = ("m4", "minmaxlttb")
DEFAULT_PIXEL_FN = "m4"
# strict-validation cap: wider than any real display, small enough
# that a typo'd pixel count cannot allocate absurd bin tables
MAX_PIXELS = 65536
# MinMaxLTTB preselection ratio (tsdownsample's default)
MINMAX_RATIO = 4


def assign_pixels(bucket_ts: np.ndarray, start_ms: int, end_ms: int,
                  pixels: int) -> np.ndarray:
    """Map output timestamps to pixel columns: ``pixels`` equal time
    bins over the query window ``[start_ms, end_ms]`` (the chart's
    x-axis). Returns int64[B], ascending because ``bucket_ts`` is.
    Timestamps outside the window (the aligned-down first bucket)
    clip into the edge columns."""
    span = max(int(end_ms) - int(start_ms), 1)
    idx = (bucket_ts.astype(np.int64) - int(start_ms)) * pixels // span
    return np.clip(idx, 0, pixels - 1)


def _pixel_starts(pixel_idx: np.ndarray, pixels: int, b: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """reduceat segment starts for the pixel partition + the mask of
    pixels that own at least one bucket column. reduceat of an EMPTY
    segment returns the next segment's first element — every consumer
    must invalidate unoccupied pixels.

    The table is TRIMMED to the last pixel owning data (it may be
    shorter than ``pixels``): pixels past the last data column — a
    query window ending after the data does — would get a segment
    start == ``b``, which reduceat rejects, and clipping such a start
    instead would steal the final column from the last real pixel's
    segment (the next start is that segment's END). Trimmed-away
    pixels are empty by construction, identical to being invalidated.
    Consumers size their per-pixel tables off ``len(starts)``, never
    the requested pixel count."""
    # one scalar probe per call (the last data-owning pixel)
    n_eff = min(pixels, int(pixel_idx[-1]) + 1)
    starts = np.searchsorted(pixel_idx, np.arange(n_eff))
    occupied = np.diff(starts, append=b) > 0
    return starts, occupied


def _minmax_cols(values2d: np.ndarray, emit2d: np.ndarray,
                 idx: np.ndarray, starts: np.ndarray,
                 occupied: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment earliest columns achieving the min and the max over
    emitted non-NaN values (±inf are legal extremes; tie -> earliest
    column, matching a first-wins scan). Sentinel ``b`` = no
    candidate. Shared by M4 and the MinMaxLTTB preselection — same
    semantics over different bin tables."""
    b = values2d.shape[1]
    col = np.arange(b, dtype=np.int64)[None, :]
    sent = b
    valued = emit2d & ~np.isnan(values2d)
    pmin = np.minimum.reduceat(
        np.where(valued, values2d, np.inf), starts, axis=1)
    pmax = np.maximum.reduceat(
        np.where(valued, values2d, -np.inf), starts, axis=1)
    is_min = valued & (values2d == pmin[:, idx])
    is_max = valued & (values2d == pmax[:, idx])
    min_col = np.minimum.reduceat(
        np.where(is_min, col, sent), starts, axis=1)
    max_col = np.minimum.reduceat(
        np.where(is_max, col, sent), starts, axis=1)
    min_col[:, ~occupied] = sent
    max_col[:, ~occupied] = sent
    return min_col, max_col


def _scatter_keep(keep: np.ndarray, cols: np.ndarray,
                  sentinel: int) -> None:
    """Set keep[row, cols[row, p]] for every valid (non-sentinel)
    selection in one scatter."""
    rows, _ = np.nonzero(cols != sentinel)
    keep[rows, cols[cols != sentinel]] = True


def m4_keep_mask(values2d: np.ndarray, emit2d: np.ndarray,
                 pixel_idx: np.ndarray, pixels: int) -> np.ndarray:
    """M4 selection mask over ``[S, B]`` grids.

    Per (row, pixel): the first and last emitted columns, and the
    earliest columns achieving the min and the max over emitted
    non-NaN values. Exactness contract (oracle-tested): for every row
    and pixel, the kept set CONTAINS that pixel's first/last emitted
    point and its min/max, and nothing outside the pixel's emitted
    points.
    """
    s, b = values2d.shape
    keep = np.zeros((s, b), dtype=bool)
    if s == 0 or b == 0 or pixels <= 0:
        return keep
    starts, occupied = _pixel_starts(pixel_idx, pixels, b)
    col = np.arange(b, dtype=np.int64)[None, :]
    sent = b  # "no candidate" sentinel, > any real column

    # first/last emitted column per pixel (NaN points included: gap
    # boundaries are part of the drawn line)
    first_col = np.minimum.reduceat(
        np.where(emit2d, col, sent), starts, axis=1)
    last_col = np.maximum.reduceat(
        np.where(emit2d, col, -1), starts, axis=1)
    min_col, max_col = _minmax_cols(values2d, emit2d, pixel_idx,
                                    starts, occupied)

    # pixels owning zero bucket columns carry reduceat garbage (the
    # next pixel's first element): invalidate before scattering
    first_col[:, ~occupied] = sent
    last_col[:, ~occupied] = -1

    _scatter_keep(keep, first_col, sent)
    _scatter_keep(keep, min_col, sent)
    _scatter_keep(keep, max_col, sent)
    _scatter_keep(keep, last_col, -1)
    return keep


def minmaxlttb_keep_mask(values2d: np.ndarray, emit2d: np.ndarray,
                         bucket_ts: np.ndarray, start_ms: int,
                         end_ms: int, pixels: int,
                         ratio: int = MINMAX_RATIO) -> np.ndarray:
    """MinMaxLTTB selection mask: MinMax preselection into
    ``ratio * pixels`` bins, then LTTB over the candidates down to
    <= ``pixels`` points per row (global first/last always kept).

    The LTTB stage walks the ``pixels - 2`` interior time bins once,
    vectorized across rows (each step is a [S, bin-width] argmax of
    triangle areas against the previously selected point and the next
    bin's candidate centroid — the classic formulation, tsdownsample
    §3). NaN points are never LTTB candidates; rows whose bin has no
    candidate select nothing there.
    """
    s, b = values2d.shape
    keep = np.zeros((s, b), dtype=bool)
    if s == 0 or b == 0 or pixels <= 0:
        return keep
    if b <= pixels:
        # already under budget: LTTB of n <= n_out is the identity
        return emit2d.copy()

    # --- global first/last emitted point per row: LTTB anchors
    first_g = np.where(emit2d.any(axis=1),
                       np.argmax(emit2d, axis=1), -1)
    last_g = np.where(emit2d.any(axis=1),
                      b - 1 - np.argmax(emit2d[:, ::-1], axis=1), -1)
    rows_ok = first_g >= 0
    keep[rows_ok, first_g[rows_ok]] = True
    keep[rows_ok, last_g[rows_ok]] = True
    if pixels <= 2:
        # a 1-2 point budget leaves no interior bins: the anchors ARE
        # the answer (emitting everything here would hand a 2px
        # sparkline the full-resolution response)
        return keep

    # --- stage 1: MinMax preselection (the m4 min/max machinery over
    # a finer bin table)
    pre_bins = min(max(ratio, 1) * pixels, b)
    pre_idx = assign_pixels(bucket_ts, start_ms, end_ms, pre_bins)
    starts, occupied = _pixel_starts(pre_idx, pre_bins, b)
    sent = b  # _minmax_cols' "no candidate" sentinel
    min_col, max_col = _minmax_cols(values2d, emit2d, pre_idx,
                                    starts, occupied)
    cand = np.zeros((s, b), dtype=bool)
    _scatter_keep(cand, min_col, sent)
    _scatter_keep(cand, max_col, sent)

    # --- stage 2: LTTB over the candidates, `pixels - 2` interior
    # bins between the window edges
    n_bins = pixels - 2
    bin_idx = assign_pixels(bucket_ts, start_ms, end_ms, n_bins)
    bstarts, boccupied = _pixel_starts(bin_idx, n_bins, b)
    bends = np.append(bstarts[1:], b)
    # x in float seconds relative to the window (well-conditioned for
    # the area arithmetic)
    x = (bucket_ts.astype(np.float64) - float(start_ms)) / 1e3
    # the anchors must not double as bin selections
    cand[rows_ok, first_g[rows_ok]] = False
    cand[rows_ok, last_g[rows_ok]] = False
    y = np.where(cand, values2d, np.nan)
    # per-bin candidate counts + centroids (the "next bucket average");
    # reduceat over bool saturates, so count over int
    ccount = np.add.reduceat(cand.astype(np.int64), bstarts, axis=1)
    cnt = np.maximum(ccount, 1)
    cx = np.add.reduceat(np.where(cand, x[None, :], 0.0),
                         bstarts, axis=1) / cnt
    cy = np.add.reduceat(np.where(cand, y, 0.0), bstarts, axis=1) / cnt
    has_cand = ccount > 0
    has_cand[:, ~boccupied] = False

    prev_x = np.where(rows_ok, x[np.maximum(first_g, 0)], 0.0)
    prev_y = np.where(rows_ok,
                      values2d[np.arange(s), np.maximum(first_g, 0)],
                      0.0)
    prev_y = np.where(np.isnan(prev_y), 0.0, prev_y)
    last_x = x[np.maximum(last_g, 0)]
    last_y = values2d[np.arange(s), np.maximum(last_g, 0)]
    last_y = np.where(np.isnan(last_y), 0.0, last_y)
    arange_s = np.arange(s)
    n_eff = len(bstarts)  # trailing data-less bins are trimmed away
    for k in range(n_eff):
        # the LTTB bin walk: bounded by the requested pixels, never by
        # the point count (the min/max preselection above is vectorized)
        lo, hi = int(bstarts[k]), int(bends[k])
        if hi <= lo:
            continue
        rows = np.nonzero(has_cand[:, k])[0]
        if not len(rows):
            continue
        # next anchor: the following bin's centroid, else the last point
        nk = k + 1
        if nk < n_eff:
            nx = np.where(has_cand[rows, nk], cx[rows, nk],
                          last_x[rows])
            ny = np.where(has_cand[rows, nk], cy[rows, nk],
                          last_y[rows])
        else:
            nx, ny = last_x[rows], last_y[rows]
        xs = x[lo:hi][None, :]
        ys = y[rows, lo:hi]
        area = np.abs(
            (prev_x[rows, None] - nx[:, None]) * (ys - prev_y[rows, None])
            - (prev_x[rows, None] - xs) * (ny[:, None] - prev_y[rows, None]))
        area = np.where(np.isnan(ys), -1.0, area)
        pick = np.argmax(area, axis=1)
        sel = lo + pick
        keep[rows, sel] = True
        prev_x[rows] = x[sel]
        prev_y[rows] = values2d[rows, sel]
    return keep


def keep_mask(values2d: np.ndarray, emit2d: np.ndarray,
              bucket_ts: np.ndarray, start_ms: int, end_ms: int,
              pixels: int, fn: str = DEFAULT_PIXEL_FN
              ) -> np.ndarray | None:
    """The serve-path entry point: a keep mask for ``emit &= keep``,
    or None when the reduction is a guaranteed no-op (every point
    already fits the pixel budget for M4's 4-slots-per-pixel bound)."""
    if pixels <= 0:
        return None
    b = values2d.shape[1]
    if fn == "m4":
        if b <= pixels:
            # <= 1 bucket column per pixel: M4 keeps everything
            return None
        pixel_idx = assign_pixels(bucket_ts, start_ms, end_ms, pixels)
        return m4_keep_mask(values2d, emit2d, pixel_idx, pixels)
    if fn == "minmaxlttb":
        return minmaxlttb_keep_mask(values2d, emit2d, bucket_ts,
                                    start_ms, end_ms, pixels)
    raise ValueError(f"unknown pixel downsample fn {fn!r}")


def reduce_dps(dps: list, start_ms: int, end_ms: int, pixels: int,
               fn: str = DEFAULT_PIXEL_FN) -> list:
    """Pixel-reduce an already-assembled ``[(ts_ms, value), ...]`` row
    (percentile rows are emitted post-assembly, outside the ``[S, B]``
    grids the serve path reduces) by running the same kernels over a
    one-row grid. Returns the kept dps, original list when the budget
    keeps everything."""
    if pixels <= 0 or len(dps) <= 1:
        return dps
    ts = np.asarray([int(t) for t, _ in dps], dtype=np.int64)
    vals = np.asarray([float(v) for _, v in dps], dtype=np.float64)
    keep = keep_mask(vals[None, :], np.ones((1, len(dps)), dtype=bool),
                     ts, start_ms, end_ms, pixels, fn)
    if keep is None:
        return dps
    row = keep[0]
    return [dp for i, dp in enumerate(dps) if row[i]]


def reduce_arrays(ts_ms: np.ndarray, vals: np.ndarray, start_ms: int,
                  end_ms: int, pixels: int, fn: str = DEFAULT_PIXEL_FN
                  ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`reduce_dps` over an assembled row's columns (``ts_ms``,
    ``vals``), the form the port's results carry."""
    if pixels <= 0 or len(ts_ms) <= 1:
        return ts_ms, vals
    keep = keep_mask(np.asarray(vals, dtype=np.float64)[None, :],
                     np.ones((1, len(ts_ms)), dtype=bool),
                     np.asarray(ts_ms, dtype=np.int64), start_ms, end_ms,
                     pixels, fn)
    if keep is None:
        return ts_ms, vals
    return ts_ms[keep[0]], vals[keep[0]]


def naive_m4_reference(ts_ms: np.ndarray, vals: np.ndarray,
                       emit: np.ndarray, start_ms: int, end_ms: int,
                       pixels: int) -> set[int]:
    """Reference M4 for the oracle battery: a direct per-pixel scan of
    ONE series, returning the set of kept column indices. Deliberately
    written as the obvious O(B) loop — the vectorized kernel must
    reproduce it exactly."""
    span = max(int(end_ms) - int(start_ms), 1)
    by_pixel: dict[int, list[int]] = {}
    # deliberately scalar: the oracle the tests hold the vectorized
    # masks to; never called on the serve path
    for i in range(len(ts_ms)):
        if not emit[i]:
            continue
        p = (int(ts_ms[i]) - int(start_ms)) * pixels // span
        p = min(max(p, 0), pixels - 1)
        by_pixel.setdefault(p, []).append(i)
    kept: set[int] = set()
    for cols in by_pixel.values():
        kept.add(cols[0])
        kept.add(cols[-1])
        valued = [i for i in cols if not np.isnan(vals[i])]
        if valued:
            vmin = min(vals[i] for i in valued)
            vmax = max(vals[i] for i in valued)
            kept.add(next(i for i in valued if vals[i] == vmin))
            kept.add(next(i for i in valued if vals[i] == vmax))
    return kept
