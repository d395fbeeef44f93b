"""Host column store: the port's storage engine.

Keeps the reference store's semantics (``opentsdb_tpu/core/store.py``):
per-series points sorted on read, duplicate timestamps resolved
last-write-wins, a per-metric columnar tag index, inclusive
``[start_ms, end_ms]`` range reads, and the row-padded
:class:`PaddedBatch` the query engine uploads to the device.

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
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Sequence

import numpy as np


def pad_mask(counts: np.ndarray, pmax: int) -> np.ndarray:
    """Boolean [S, Pmax] mask of PAD cells (col >= row count)."""
    return np.arange(pmax)[None, :] >= counts[:, None]


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
        self._sid_parts: list[np.ndarray] = []
        self._triple_parts: list[np.ndarray] = []
        self._sid_arr = np.empty(0, dtype=np.int64)
        self._tags_arr = np.empty((0, 3), dtype=np.int64)

    def add_bulk(self, series_ids: np.ndarray,
                 triples: np.ndarray) -> None:
        self._sid_parts.append(np.asarray(series_ids, dtype=np.int64))
        self._triple_parts.append(
            np.asarray(triples, dtype=np.int64).reshape(-1, 3))

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(sids[int64 S], tag_triples[int64 T x 3]) snapshot."""
        if self._sid_parts:
            self._sid_arr = np.concatenate([self._sid_arr]
                                           + self._sid_parts)
            self._tags_arr = np.concatenate([self._tags_arr]
                                            + self._triple_parts)
            self._sid_parts, self._triple_parts = [], []
        return self._sid_arr, self._tags_arr


def _row_search(ts: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                value: int, right: bool) -> np.ndarray:
    """Vectorized per-row ``searchsorted``: for each row, the first
    index in ``[lo, hi)`` whose timestamp is ``>= value`` (``> value``
    when ``right``). One bisection step per iteration for all rows."""
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


class TimeSeriesStore:
    """In-memory storage engine: all series of all metrics.

    One lock guards series creation, pending writes and the fold into
    the CSR columns. Published column arrays are replaced, never
    mutated in place, so a reader's snapshot stays valid."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key_to_sid: dict[tuple, int] = {}
        self._num_series = 0
        self._metric_index: dict[int, MetricIndex] = {}
        self._pending: list[tuple[np.ndarray, np.ndarray,
                                  np.ndarray]] = []
        self._offsets = np.zeros(1, dtype=np.int64)
        self._ts = np.empty(0, dtype=np.int64)
        self._vals = np.empty(0, dtype=np.float64)
        self.points_written = 0

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

    def append_many(self, series_id: int, ts_ms: np.ndarray,
                    values: np.ndarray) -> None:
        """Append many points of one series."""
        ts = np.asarray(ts_ms, dtype=np.int64)
        self.append_lines(np.full(len(ts), series_id, dtype=np.int64),
                          ts, values)

    def append_lines(self, sids, ts_ms, values) -> int:
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
        with self._lock:
            if int(sid_arr.max()) >= self._num_series:
                raise IndexError("invalid series id in append")
            self._pending.append((sid_arr, ts_arr, val_arr))
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

    def _columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._lock:
            self._fold_locked()
            return self._offsets, self._ts, self._vals

    # -- read path --------------------------------------------------------

    def metric_index(self, metric_id: int) -> MetricIndex | None:
        return self._metric_index.get(metric_id)

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
        sids = np.asarray(series_ids, dtype=np.int64)
        row_lo, row_hi = offsets[sids], offsets[sids + 1]
        lo = _row_search(ts, row_lo, row_hi, start_ms, right=False)
        hi = _row_search(ts, lo, row_hi, end_ms, right=True)
        return lo, hi, ts, vals

    def count_range(self, series_ids: Sequence[int], start_ms: int,
                    end_ms: int) -> np.ndarray:
        """Points per series in [start_ms, end_ms] without copying them."""
        lo, hi, _, _ = self._row_ranges(series_ids, start_ms, end_ms)
        return hi - lo

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
