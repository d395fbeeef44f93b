"""Columnar fold of raw point columns into per-cell quantile sketches
(ref: ``opentsdb_tpu/ops/sketch_fold.py``).

One vectorized pass turns flat ``(cell, value)`` columns into sparse
per-(cell, sign, bucket-index) counts (a ``np.unique`` over an
``[N, 3]`` key matrix plus per-cell reductions), and each cell's slice
becomes a canonical :class:`~opentsdb_tpu_torch.sketch.ddsketch.DDSketch`.
The percentile sub-query over a scalar metric
(:mod:`opentsdb_tpu_torch.sketch.query`) folds the window's points
with it.

Host numpy, as in the reference: the fold runs beside the query's
store read, not in the device pipeline.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.sketch.ddsketch import (DDSketch, MIN_INDEXABLE,
                                          _merge_store)

# key-matrix "kind" column: ascending value order within a cell
_KIND_NEG, _KIND_ZERO, _KIND_POS = 0, 1, 2


def fold_cells(ts_ms: np.ndarray, values: np.ndarray, cell_ms: int,
               alpha: float, max_buckets: int | None = None,
               faults=None) -> dict[int, DDSketch]:
    """Fold flat point columns into one sketch per time cell.

    ``cell_ts = ts - ts % cell_ms`` (the tier bucket rule). NaNs are
    skipped. Returns ``{cell_ts: DDSketch}`` — each sketch is in
    canonical form, so folding a cell's points here is bit-equal to
    ``DDSketch.add_values`` over the same points. ``faults`` is the
    owning TSDB's injector (site ``sketch.fold``), None in kernels
    detached from a TSDB.
    """
    if faults is not None:
        faults.check("sketch.fold")
    ts = np.asarray(ts_ms, dtype=np.int64)
    v = np.asarray(values, dtype=np.float64)
    keep = np.isfinite(v)
    if not keep.all():
        ts, v = ts[keep], v[keep]
    if not len(v):
        return {}
    cells = ts - ts % cell_ms

    proto = DDSketch(alpha)
    kind = np.full(len(v), _KIND_ZERO, dtype=np.int64)
    key = np.zeros(len(v), dtype=np.int64)
    pos = v > MIN_INDEXABLE
    neg = v < -MIN_INDEXABLE
    if pos.any():
        kind[pos] = _KIND_POS
        key[pos] = proto._keys(v[pos])
    if neg.any():
        kind[neg] = _KIND_NEG
        # negative store sorts ascending by index; ascending VALUE is
        # descending index, so flip the sort key to keep one lexsort
        key[neg] = -proto._keys(-v[neg])

    mat = np.stack([cells, kind, key], axis=1)
    rows, inv, counts = np.unique(mat, axis=0, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(cells, kind="stable")
    out: dict[int, DDSketch] = {}
    cell_col = rows[:, 0]
    starts = np.nonzero(np.concatenate(
        [[True], cell_col[1:] != cell_col[:-1]]))[0]
    bounds = np.append(starts, len(cell_col))
    # per-cell exact extrema from the value columns
    v_sorted_cells = cells[order]
    v_sorted = v[order]
    c_starts = np.nonzero(np.concatenate(
        [[True], v_sorted_cells[1:] != v_sorted_cells[:-1]]))[0]
    cell_min = np.minimum.reduceat(v_sorted, c_starts)
    cell_max = np.maximum.reduceat(v_sorted, c_starts)
    cell_ids = v_sorted_cells[c_starts]
    extrema = {int(c): (float(lo), float(hi)) for c, lo, hi
               in zip(cell_ids, cell_min, cell_max)}

    # one iteration per distinct cell, never per point: the per-point
    # fold above is one np.unique pass
    for si in range(len(starts)):
        lo, hi = bounds[si], bounds[si + 1]
        cell = int(cell_col[lo])
        sk = DDSketch(alpha)
        r = rows[lo:hi]
        c = counts[lo:hi].astype(np.float64)
        negm = r[:, 1] == _KIND_NEG
        zm = r[:, 1] == _KIND_ZERO
        posm = r[:, 1] == _KIND_POS
        if negm.any():
            # un-flip the sort key; re-sort ascending by true index
            nidx = (-r[negm, 2]).astype(np.int32)
            o = np.argsort(nidx)
            sk.neg_idx, sk.neg_cnt = nidx[o], c[negm][o]
        if zm.any():
            sk.zero_count = float(c[zm].sum())
        if posm.any():
            sk.pos_idx = r[posm, 2].astype(np.int32)
            sk.pos_cnt = c[posm]
        sk.count = float(c.sum())
        sk.min, sk.max = extrema[cell]
        if max_buckets:
            sk.collapse(max_buckets)
        out[cell] = sk
    return out


def fold_series_cells(series_idx: np.ndarray, ts_ms: np.ndarray,
                      values: np.ndarray, cell_ms: int, alpha: float,
                      max_buckets: int | None = None, faults=None
                      ) -> dict[tuple[int, int], DDSketch]:
    """Per-(series, cell) fold of a flat materialized batch: offsets
    each series into a disjoint cell namespace so ONE ``fold_cells``
    pass covers every series, then splits the keys back out."""
    ts = np.asarray(ts_ms, dtype=np.int64)
    sidx = np.asarray(series_idx, dtype=np.int64)
    if not len(ts):
        return {}
    # cells are bucket-aligned and non-negative in practice; offset by
    # series into disjoint ranges wide enough for the batch's span
    base = int(ts.min()) - int(ts.min()) % cell_ms
    span = (int(ts.max()) - base) // cell_ms + 1
    keyed = (ts - ts % cell_ms - base) // cell_ms + sidx * span
    folded = fold_cells(keyed, values, 1, alpha, max_buckets,
                        faults=faults)
    return {(int(k // span), base + int(k % span) * cell_ms): sk
            for k, sk in folded.items()}


def merge_sorted_counts(idx_a, cnt_a, idx_b, cnt_b):
    """Re-export of the canonical store merge for kernel callers."""
    return _merge_store(idx_a, cnt_a, idx_b, cnt_b)
