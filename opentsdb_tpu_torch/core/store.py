"""Host column store: the port's storage engine.

Keeps the reference store's semantics (``opentsdb_tpu/core/store.py``):
per-series points sorted on read, duplicate timestamps resolved
last-write-wins, a per-metric columnar tag index, inclusive
``[start_ms, end_ms]`` range reads, and the two layouts the query
engine uploads to the device: the row-padded :class:`PaddedBatch` and
the flat :class:`PointBatch` (for batches whose row lengths are too
skewed to pad).

The layout differs. The reference keeps one growable buffer per series
and walks them in Python on every read, which costs seconds per call at
a million series. Here all points of the store live in three flat
columns in CSR form (``offsets[S+1]``, ``ts[N]``, ``vals[N]``), sorted by
(series, timestamp). Writes land in a pending list of columnar chunks;
the first read after a write folds them in. A chunk that arrives
already sorted into an empty store is adopted as is (one O(N) check);
anything else is merged with a stable ``lexsort`` whose stability keeps
write order among duplicates, so the last write of a (series, ts) pair
wins. Range reads bisect every selected row at once.

``bucket_reduce`` is the storage-side downsample of the grid path: it
reduces a window to ``[S, B]`` bucket statistics without gathering the
points (ref: the native store's ``tss_bucket_reduce``).
"""

from __future__ import annotations

import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np


def pad_mask(counts: np.ndarray, pmax: int) -> np.ndarray:
    """Boolean [S, Pmax] mask of PAD cells (col >= row count)."""
    return np.arange(pmax)[None, :] >= counts[:, None]


class PointBatch(NamedTuple):
    """Flat materialized points of a set of series, in (series, time)
    order. ``series_idx[i]`` indexes ``series_ids`` (dense 0..S-1), not
    the global series id, so the device sees a compact series axis."""
    series_ids: np.ndarray    # int64 [S] global series ids
    series_idx: np.ndarray    # int32 [N] dense position of each point
    ts_ms: np.ndarray         # int64 [N]
    values: np.ndarray        # float64 [N]

    @property
    def num_series(self) -> int:
        return len(self.series_ids)

    @property
    def num_points(self) -> int:
        return len(self.ts_ms)


class PaddedBatch(NamedTuple):
    """Row-padded materialized points: series i's points occupy columns
    ``0..counts[i]-1`` of row i, time-ascending; the rest is NaN
    padding (values) and 0 (timestamps)."""
    series_ids: np.ndarray    # int64 [S] global series ids
    values2d: np.ndarray      # float64 [S, Pmax], NaN-padded
    ts2d: np.ndarray          # int64 [S, Pmax], 0-padded
    counts: np.ndarray        # int64 [S] points per row

    @property
    def num_points(self) -> int:
        return int(self.counts.sum())


class MetricIndex:
    """Per-metric columnar tag index: (series_id, tagk_id, tagv_id)
    triples, so a tag filter evaluates as numpy set operations over
    every series of the metric at once."""

    def __init__(self, metric_id: int):
        self.metric_id = metric_id
        # sub-queries read the index from several threads at once: the
        # fold of pending parts must happen once
        self._lock = threading.Lock()
        self._sid_parts: list[np.ndarray] = []
        self._triple_parts: list[np.ndarray] = []
        self._sid_arr = np.empty(0, dtype=np.int64)
        self._tags_arr = np.empty((0, 3), dtype=np.int64)

    def add_bulk(self, series_ids: np.ndarray,
                 triples: np.ndarray) -> None:
        with self._lock:
            self._sid_parts.append(np.asarray(series_ids,
                                              dtype=np.int64))
            self._triple_parts.append(
                np.asarray(triples, dtype=np.int64).reshape(-1, 3))

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(sids[int64 S], tag_triples[int64 T x 3]) snapshot; the same
        array objects until the next write."""
        with self._lock:
            if self._sid_parts:
                self._sid_arr = np.concatenate([self._sid_arr]
                                               + self._sid_parts)
                self._tags_arr = np.concatenate([self._tags_arr]
                                                + self._triple_parts)
                self._sid_parts, self._triple_parts = [], []
            return self._sid_arr, self._tags_arr


def _row_search(ts: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                value, right: bool) -> np.ndarray:
    """Vectorized per-row ``searchsorted``: for each row, the first
    index in ``[lo, hi)`` whose timestamp is ``>= value`` (``> value``
    when ``right``); ``value`` is one timestamp or one per row. One
    bisection step per iteration for all rows."""
    lo = lo.copy()
    hi = hi.copy()
    last = max(len(ts) - 1, 0)
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) // 2
        v = ts[np.minimum(mid, last)]
        go = ((v <= value) if right else (v < value)) & active
        lo = np.where(go, mid + 1, lo)
        hi = np.where(active & ~go, mid, hi)


def _range_bounds(offsets: np.ndarray, ts: np.ndarray, sids: np.ndarray,
                  start_ms: int, end_ms: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per row of ``sids``: the index of its first point in the
    inclusive ``[start_ms, end_ms]`` and the index past its last."""
    row_lo, row_hi = offsets[sids], offsets[sids + 1]
    lo = _row_search(ts, row_lo, row_hi, start_ms, right=False)
    return lo, _row_search(ts, lo, row_hi, end_ms, right=True)


def _row_bounds(ts: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                edges: np.ndarray) -> np.ndarray:
    """``[S, K]``: for row i and edge j, the first index in
    ``[lo[i], hi[i])`` whose timestamp is ``>= edges[j]`` (``hi[i]``
    when none). The first guess places each row's points evenly between
    its first and last timestamp, which is exact for a fixed cadence
    (the product and quotient of integers below 2**53 round exactly);
    the cells where it misses are bisected."""
    n = hi - lo
    last = len(ts) - 1
    first_t = ts[np.minimum(lo, last)]
    # rows of fewer than two points get guess lo, which is checked
    span = ts[np.clip(hi - 1, 0, last)] - first_t
    span = np.where(span > 0, span, 1).astype(np.float64)
    x = (edges[None, :] - first_t[:, None]).astype(np.float64)
    x *= (n - 1)[:, None]
    x /= span[:, None]
    np.ceil(x, out=x)
    np.clip(x, 0, n[:, None], out=x)
    guess = x.astype(np.int64)
    guess += lo[:, None]
    # right when ts[guess - 1] < edge <= ts[guess] inside the row
    # (guess - 1 may be -1: that read is masked by guess == lo)
    lo2 = np.broadcast_to(lo[:, None], guess.shape)
    hi2 = np.broadcast_to(hi[:, None], guess.shape)
    ok = ts[guess - 1] < edges
    ok |= guess == lo2
    up = ts[np.minimum(guess, last)] >= edges
    up |= guess == hi2
    ok &= up
    if not ok.all():
        miss = np.nonzero(~ok)
        guess[miss] = _row_search(ts, lo2[miss], hi2[miss],
                                  np.broadcast_to(edges, guess.shape)
                                  [miss], right=False)
    return guess


def _reduce_rows(ts: np.ndarray, vals: np.ndarray, lo: np.ndarray,
                 hi: np.ndarray, edges: np.ndarray, may_hold_nan: bool,
                 sums: np.ndarray, cnts: np.ndarray,
                 mins: np.ndarray | None, maxs: np.ndarray | None
                 ) -> None:
    """bucket_reduce of one chunk of rows into the given rows of its
    outputs, which hold the empty-cell values on entry."""
    s, nb = len(lo), len(edges) - 1
    some = hi > lo
    if not some.any():
        return
    # bucket j of row i is bounds[i, j] .. bounds[i, j + 1]; an edge at
    # or before every point of the range is lo, one after all is hi
    before = edges <= ts[lo[some]].min()
    after = edges > ts[hi[some] - 1].max()
    bounds = np.empty((s, nb + 1), dtype=np.int64)
    bounds[:, before] = lo[:, None]
    bounds[:, after] = hi[:, None]
    inner = np.flatnonzero(~before & ~after)
    if len(inner):
        bounds[:, inner] = _row_bounds(ts, lo, hi, edges[inner])
    # the points any bucket of these rows holds lie in vals[first:end];
    # one more point keeps every bucket's end inside v (but at the end
    # of the column)
    first, end = int(bounds[:, 0].min()), int(bounds[:, -1].max())
    if end <= first:
        return
    v = vals[first:min(end + 1, len(vals))]
    bounds -= first
    if may_hold_nan:
        nan = np.isnan(v)
        valid = np.zeros(len(v) + 1, dtype=np.int64)
        np.cumsum(~nan, out=valid[1:])
        cnt = np.diff(valid[bounds], axis=1)
    else:
        nan = None
        cnt = np.diff(bounds, axis=1)
    filled = cnt > 0
    cnts[:] = cnt
    # reduceat reduces v[idx[m]:idx[m + 1]] for each m: over the
    # flattened bounds that is every bucket, plus one segment from a
    # row's last edge to the next row's first, which is dropped; empty
    # buckets are masked. Indices must lie inside v, so a bucket that
    # ends at the end of the column is reduced on its own.
    idx = np.minimum(bounds.reshape(-1), len(v) - 1)
    at_end = np.nonzero(filled & (bounds[:, 1:] == len(v)))
    for out, ufunc, neutral in ((sums, np.add, 0.0),
                                (mins, np.minimum, np.inf),
                                (maxs, np.maximum, -np.inf)):
        if out is None:
            continue
        w = v if nan is None else np.where(nan, neutral, v)
        red = ufunc.reduceat(w, idx).reshape(s, nb + 1)[:, :-1]
        for i, j in zip(*at_end):
            red[i, j] = ufunc.reduce(w[bounds[i, j]:])
        np.copyto(out, red, where=filled)


# (row, bucket) cells of one bucket_reduce work item, and the threads
# that take them
_REDUCE_CELLS = 1 << 20
_REDUCE_THREADS = min(8, os.cpu_count() or 1)
_INSTANCE_IDS = itertools.count(1)


class SeriesIdentity(NamedTuple):
    """A series' metric UID and its (tagk, tagv) UID pairs, sorted."""
    metric_id: int
    tags: tuple


class TimeSeriesStore:
    """In-memory storage engine: all series of all metrics.

    One lock guards series creation, pending writes and the fold into
    the CSR columns. Published column arrays are replaced, never
    mutated in place, so a reader's snapshot stays valid. It keeps no
    per-point integer flag: the writes' ``is_int`` is accepted and
    dropped."""

    backend = "memory"

    def __init__(self):
        self._lock = threading.Lock()
        self._key_to_sid: dict[tuple, int] = {}
        # sid -> (metric id, sorted tag pairs)
        self._keys: list[tuple] = []
        self._num_series = 0
        self._metric_index: dict[int, MetricIndex] = {}
        self._pending: list[tuple[np.ndarray, np.ndarray,
                                  np.ndarray]] = []
        self._offsets = np.zeros(1, dtype=np.int64)
        self._ts = np.empty(0, dtype=np.int64)
        self._vals = np.empty(0, dtype=np.float64)
        # set once a NaN value is written; bucket_reduce then skips
        # NaNs point by point
        self._may_hold_nan = False
        self.points_written = 0
        # beside points_written it versions the store for read-side
        # caches; a delete bumps it
        self.mutation_epoch = 0
        # identity for cache keys: id() could alias a freed store
        self.instance_id = next(_INSTANCE_IDS)

    @property
    def version(self) -> tuple[int, int]:
        """Changes with every write: a cache entry of another version
        is stale."""
        return self.points_written, self.mutation_epoch

    def collect_stats(self, collector) -> None:
        collector.record("storage.series.count", self._num_series)
        collector.record("storage.points.written", self.points_written)

    # -- write path -------------------------------------------------------

    def get_or_create_series(self, metric_id: int,
                             tags: Sequence[tuple[int, int]]) -> int:
        return int(self.get_or_create_series_bulk(metric_id, [tags])[0])

    def get_or_create_series_bulk(
            self, metric_id: int,
            tags_list: Sequence[Sequence[tuple[int, int]]]) -> np.ndarray:
        """Vectorized get_or_create_series for N series of one metric:
        one lock take and one index update for the whole batch
        (ref: ``TimeSeriesStore.get_or_create_series_bulk``)."""
        keys = [(metric_id, tuple(sorted(t))) for t in tags_list]
        out = np.empty(len(keys), dtype=np.int64)
        with self._lock:
            new_sids: list[int] = []
            new_rows: list[tuple[int, int, int]] = []
            for i, key in enumerate(keys):
                sid = self._key_to_sid.get(key)
                if sid is None:
                    sid = self._num_series
                    self._num_series += 1
                    self._key_to_sid[key] = sid
                    self._keys.append(key)
                    new_sids.append(sid)
                    new_rows.extend((sid, k, v) for k, v in key[1])
                out[i] = sid
            if new_sids:
                idx = self._metric_index.get(metric_id)
                if idx is None:
                    idx = self._metric_index[metric_id] = \
                        MetricIndex(metric_id)
                idx.add_bulk(np.asarray(new_sids, dtype=np.int64),
                             np.asarray(new_rows, dtype=np.int64))
        return out

    def append(self, series_id: int, ts_ms: int, value: float,
               is_int: bool = False) -> None:
        self.append_lines([series_id], [ts_ms], [value])

    def append_many(self, series_id: int, ts_ms: np.ndarray,
                    values: np.ndarray, is_int=False) -> None:
        """Append many points of one series."""
        ts = np.asarray(ts_ms, dtype=np.int64)
        self.append_lines(np.full(len(ts), series_id, dtype=np.int64),
                          ts, values)

    def append_grid(self, series_ids, bucket_ts, grid, mask) -> int:
        """Bulk write of one ``[S, B]`` grid: the cells of row i that
        ``mask`` selects land on ``series_ids[i]`` at ``bucket_ts`` (ref:
        ``TimeSeriesStore.append_grid``; the rollup job's output
        path), in one scatter-append."""
        sids = np.asarray(series_ids, dtype=np.int64)
        mask = np.asarray(mask, dtype=bool)
        grid = np.asarray(grid, dtype=np.float64)
        if grid.shape != (len(sids), len(bucket_ts)) or \
                mask.shape != grid.shape:
            raise ValueError("grid and mask must be [len(series_ids), "
                             "len(bucket_ts)]")
        if len(sids) and (int(sids.min()) < 0
                          or int(sids.max()) >= self._num_series):
            raise IndexError("invalid series id in append_grid")
        return self.append_lines(
            np.broadcast_to(sids[:, None], grid.shape)[mask],
            np.broadcast_to(np.asarray(bucket_ts, dtype=np.int64),
                            grid.shape)[mask], grid[mask])

    def append_lines(self, sids, ts_ms, values, is_int=None) -> int:
        """Columnar scatter-append: element i lands on series
        ``sids[i]`` (ref: ``TimeSeriesStore.append_lines``; negative
        sids skip)."""
        sid_arr = np.asarray(sids, dtype=np.int64).reshape(-1)
        ts_arr = np.asarray(ts_ms, dtype=np.int64).reshape(-1)
        val_arr = np.asarray(values, dtype=np.float64).reshape(-1)
        if not len(sid_arr) == len(ts_arr) == len(val_arr):
            raise ValueError("sids/timestamps/values lengths differ")
        keep = sid_arr >= 0
        if not keep.all():
            sid_arr, ts_arr, val_arr = (sid_arr[keep], ts_arr[keep],
                                        val_arr[keep])
        if not len(sid_arr):
            return 0
        has_nan = bool(np.isnan(val_arr).any())
        with self._lock:
            if int(sid_arr.max()) >= self._num_series:
                raise IndexError("invalid series id in append")
            self._pending.append((sid_arr, ts_arr, val_arr))
            self._may_hold_nan |= has_nan
            self.points_written += len(sid_arr)
        return len(sid_arr)

    def _fold_locked(self) -> None:
        """Fold pending chunks into the sorted CSR columns."""
        n_series = self._num_series
        if not self._pending and len(self._offsets) == n_series + 1:
            return
        old_counts = np.diff(self._offsets)
        parts = self._pending
        self._pending = []
        if len(self._ts) == 0 and len(parts) == 1:
            sid, ts, vals = parts[0]
        else:
            old_sid = np.repeat(np.arange(len(old_counts),
                                          dtype=np.int64), old_counts)
            sid = np.concatenate([old_sid] + [p[0] for p in parts])
            ts = np.concatenate([self._ts] + [p[1] for p in parts])
            vals = np.concatenate([self._vals] + [p[2] for p in parts])
        if len(sid) > 1:
            dsid = np.diff(sid)
            in_order = ((dsid > 0) | ((dsid == 0) & (np.diff(ts) > 0))
                        ).all()
            if not in_order:
                # stable: equal (sid, ts) keep write order, so the
                # last element of each run is the last write
                order = np.lexsort((ts, sid))
                sid, ts, vals = sid[order], ts[order], vals[order]
                last = np.ones(len(sid), dtype=bool)
                last[:-1] = (sid[1:] != sid[:-1]) | (ts[1:] != ts[:-1])
                if not last.all():
                    sid, ts, vals = sid[last], ts[last], vals[last]
        counts = np.bincount(sid, minlength=n_series)
        offsets = np.zeros(n_series + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        self._offsets, self._ts, self._vals = offsets, ts, vals

    def delete_range(self, series_ids, start_ms: int, end_ms: int) -> int:
        """Remove the points in the inclusive ``[start_ms, end_ms]`` of
        each series (ref: ``TimeSeriesStore.delete_range``); returns how
        many went. The columns are replaced, not changed in place, so a
        reader's snapshot stays valid."""
        sids = np.unique(np.asarray(series_ids, dtype=np.int64))
        with self._lock:
            if len(sids) and (int(sids[0]) < 0
                              or int(sids[-1]) >= self._num_series):
                raise IndexError("invalid series id in delete_range")
            self._fold_locked()
            offsets, ts, vals = self._offsets, self._ts, self._vals
            lo, hi = _range_bounds(offsets, ts, sids, start_ms, end_ms)
            gone = hi - lo
            total = int(gone.sum())
            if total == 0:
                return 0
            keep = np.ones(len(ts), dtype=bool)
            first = np.repeat(lo - (np.cumsum(gone) - gone), gone)
            keep[first + np.arange(total)] = False
            counts = np.diff(offsets)
            counts[sids] -= gone
            new_offsets = np.zeros_like(offsets)
            np.cumsum(counts, out=new_offsets[1:])
            self._offsets, self._ts, self._vals = \
                new_offsets, ts[keep], vals[keep]
            self.mutation_epoch += 1
            return total

    def _columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._lock:
            self._fold_locked()
            return self._offsets, self._ts, self._vals

    # -- read path --------------------------------------------------------

    def metric_ids(self) -> list[int]:
        """Every metric with a series, in the order of its first one."""
        with self._lock:
            return list(self._metric_index)

    def metric_index(self, metric_id: int) -> MetricIndex | None:
        return self._metric_index.get(metric_id)

    def series(self, series_id: int) -> SeriesIdentity:
        """The identity of one series (ref: ``TimeSeriesStore.series``'s
        ``metric_id`` and ``tags``); IndexError for an unknown id."""
        if series_id < 0:
            raise IndexError(f"no series {series_id}")
        return SeriesIdentity(*self._keys[series_id])

    def total_points(self) -> int:
        offsets, _, _ = self._columns()
        return int(offsets[-1])

    def series_ids_for_metric(self, metric_id: int) -> np.ndarray:
        idx = self._metric_index.get(metric_id)
        if idx is None:
            return np.empty(0, dtype=np.int64)
        sids, _ = idx.arrays()
        return sids

    def _row_ranges(self, series_ids, start_ms: int, end_ms: int):
        """Per selected row: (first index in range, end index), plus
        the columns they index, for the inclusive [start, end]."""
        offsets, ts, vals = self._columns()
        lo, hi = _range_bounds(offsets, ts,
                               np.asarray(series_ids, dtype=np.int64),
                               start_ms, end_ms)
        return lo, hi, ts, vals

    def count_range(self, series_ids: Sequence[int], start_ms: int,
                    end_ms: int) -> np.ndarray:
        """Points per series in [start_ms, end_ms] without copying them."""
        lo, hi, _, _ = self._row_ranges(series_ids, start_ms, end_ms)
        return hi - lo

    def materialize(self, series_ids: Sequence[int], start_ms: int,
                    end_ms: int) -> PointBatch:
        """Gather every point of ``series_ids`` in [start_ms, end_ms]
        into a flat batch (ref: ``TimeSeriesStore.materialize``): each
        row's slice of the columns, one after another."""
        sids = np.asarray(series_ids, dtype=np.int64)
        lo, hi, ts, vals = self._row_ranges(sids, start_ms, end_ms)
        counts = hi - lo
        series_idx = np.repeat(np.arange(len(sids), dtype=np.int32),
                               counts)
        # point j of row i sits at lo[i] + j
        first = np.cumsum(counts) - counts
        idx = np.arange(int(counts.sum()), dtype=np.int64)
        idx += np.repeat(lo - first, counts)
        return PointBatch(sids, series_idx, ts[idx], vals[idx])

    def materialize_padded(self, series_ids: Sequence[int],
                           start_ms: int, end_ms: int) -> PaddedBatch:
        """Gather every point of ``series_ids`` in [start_ms, end_ms]
        into the row-padded layout (ref:
        ``TimeSeriesStore.materialize_padded``)."""
        sids = np.asarray(series_ids, dtype=np.int64)
        lo, hi, ts, vals = self._row_ranges(sids, start_ms, end_ms)
        counts = hi - lo
        pmax = max(1, int(counts.max())) if len(counts) else 1
        idx = lo[:, None] + np.arange(pmax, dtype=np.int64)[None, :]
        if len(counts) and (counts == pmax).all():
            # regular cadence: one gather, no padding
            return PaddedBatch(sids, vals[idx], ts[idx], counts)
        values2d = np.full((len(sids), pmax), np.nan)
        ts2d = np.zeros((len(sids), pmax), dtype=np.int64)
        present = ~pad_mask(counts, pmax)
        values2d[present] = vals[idx[present]]
        ts2d[present] = ts[idx[present]]
        return PaddedBatch(sids, values2d, ts2d, counts)

    def bucket_reduce(self, series_ids, start_ms: int, end_ms: int,
                      t0: int, interval_ms: int, nbuckets: int,
                      want_minmax: bool = False):
        """Storage-side fixed-interval downsample (ref:
        ``TimeSeriesStore.bucket_reduce`` and the native
        ``tss_bucket_reduce``): ``[S, B]`` float64 sums and counts, and
        min and max on request (else None), of every point in the
        inclusive ``[start_ms, end_ms]``, bucket ``b = (ts - t0) //
        interval_ms``. Points with ``b < 0`` or ``b >= nbuckets`` are
        dropped and stored NaNs skipped; an empty cell holds sum 0,
        count 0, min +inf and max -inf.

        Rows are sorted, so each bucket's points are one slice of the
        columns: one search per (row, bucket edge) finds them, and a
        segmented ``reduceat`` adds them where they lie, without
        gathering a point. Chunks of rows go to a few threads."""
        if interval_ms <= 0 or nbuckets <= 0:
            raise ValueError("interval_ms and nbuckets must be positive")
        sids = np.asarray(series_ids, dtype=np.int64)
        order = None
        if len(sids) > 1 and (np.diff(sids) < 0).any():
            # rows in column order keep each chunk's slice of the columns,
            # and the segments reduceat drops, short
            order = np.argsort(sids, kind="stable")
            sids = sids[order]
        offsets, ts, vals = self._columns()
        # read after the snapshot: a NaN in it set the flag first
        may_hold_nan = self._may_hold_nan
        edges = t0 + interval_ms * np.arange(nbuckets + 1, dtype=np.int64)
        s = len(sids)
        sums = np.zeros((s, nbuckets))
        cnts = np.zeros((s, nbuckets))
        mins = np.full((s, nbuckets), np.inf) if want_minmax else None
        maxs = np.full((s, nbuckets), -np.inf) if want_minmax else None
        chunk = max(1, _REDUCE_CELLS // (nbuckets + 1))
        rows = [slice(i, i + chunk) for i in range(0, s, chunk)]

        def work(r: slice) -> None:
            lo, hi = _range_bounds(offsets, ts, sids[r], start_ms, end_ms)
            _reduce_rows(ts, vals, lo, hi, edges, may_hold_nan,
                         sums[r], cnts[r],
                         None if mins is None else mins[r],
                         None if maxs is None else maxs[r])

        if len(rows) > 1:
            # numpy releases the interpreter lock in these loops
            with ThreadPoolExecutor(min(len(rows), _REDUCE_THREADS)) as ex:
                for f in [ex.submit(work, r) for r in rows]:
                    f.result()
        elif rows:
            work(rows[0])
        out = (sums, cnts, mins, maxs)
        if order is None:
            return out
        unsorted = []
        for a in out:
            if a is not None:
                a, sorted_a = np.empty_like(a), a
                a[order] = sorted_a
            unsorted.append(a)
        return tuple(unsorted)
