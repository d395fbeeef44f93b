"""The native store backend (``tsd.storage.backend=native``, the
default; ref: ``native/store_backend.py``).

:class:`NativeTimeSeriesStore` keeps every point in the C++ arena of
``csrc/tsdbstore.cc``: one buffer per series, appended to in write
order and sorted lazily, per series, on the first read after an
out-of-order write (last write wins among equal timestamps). Series
identity and the per-metric tag index stay in Python, as in the memory
store (:class:`~opentsdb_tpu_torch.core.store.TimeSeriesStore`), whose
interface it has. The range passes (count, fill, bucket reduce) run on
a C++ thread pool; every foreign call releases the interpreter lock.

The module also carries the library's two functions that are not
storage: the bulk import-line parse (:func:`parse_import_buffer`,
feeding ``TSDB.import_buffer``) and the JSON dps formatter
(:func:`format_dps`, used by the serializer). All of it needs the
library: there is no pure-Python twin, and :func:`make_store` never
swaps in the memory store when the build fails.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from opentsdb_tpu_torch.core.store import (_INSTANCE_IDS, FIRST_TS_NONE,
                                           MetricIndex, PaddedBatch,
                                           PointBatch, SeriesIdentity,
                                           TimeSeriesStore)
from opentsdb_tpu_torch.native._build import NativeBuildError, library

__all__ = ["IMPORT_ERRORS", "NativeBuildError", "NativeTimeSeriesStore",
           "ParsedImport", "format_dps", "format_dps_is_fast",
           "make_store", "parse_import_buffer"]

BACKENDS = ("native", "memory")
# worker threads of the range passes and the import parse
_THREADS = min(16, os.cpu_count() or 4)


def _ptr(arr: np.ndarray | None):
    return None if arr is None else arr.ctypes.data_as(ctypes.c_void_p)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64).reshape(-1)


class NativeTimeSeriesStore:
    """C++-backed store with the memory store's interface (ref:
    ``NativeTimeSeriesStore``)."""

    backend = "native"
    # the scan fault site, as on the memory store
    fault_injector = None
    fault_site = "store"

    def __init__(self):
        self._lib = library()
        self._h = ctypes.c_void_p(self._lib.tss_create())
        # one lock for series creation and the tag index
        self._lock = threading.Lock()
        self._key_to_sid: dict[tuple, int] = {}
        # (metric id, sorted tag UID pairs) of each series, by id
        self._keys: list[tuple] = []
        self._num_series = 0
        self._metric_index: dict[int, MetricIndex] = {}
        # bumped by every destructive operation (delete, repair, patch):
        # with points_written it versions the store for read-side caches
        self.mutation_epoch = 0
        # identity for cache keys, from the memory store's counter so
        # the two backends never share one
        self.instance_id = next(_INSTANCE_IDS)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.tss_destroy(h)

    @property
    def points_written(self) -> int:
        return int(self._lib.tss_points_written(self._h))

    @property
    def version(self) -> tuple[int, int]:
        """Changes with every write: a cache entry of another version
        is stale."""
        return self.points_written, self.mutation_epoch

    def num_series(self) -> int:
        return self._num_series

    def collect_stats(self, collector) -> None:
        collector.record("storage.series.count", self._num_series)
        collector.record("storage.points.written", self.points_written)
        collector.record("storage.backend", 1, backend="native")
        mi = self.memory_info()
        collector.record("storage.resident_bytes", mi["resident_bytes"])
        collector.record("storage.live_bytes", mi["live_bytes"])
        collector.record("storage.dead_bytes", mi["dead_bytes"])

    # -- write path -------------------------------------------------------

    def get_or_create_series(self, metric_id: int,
                             tags: Sequence[tuple[int, int]]) -> int:
        return int(self.get_or_create_series_bulk(metric_id, [tags])[0])

    def get_or_create_series_bulk(
            self, metric_id: int,
            tags_list: Sequence[Sequence[tuple[int, int]]]) -> np.ndarray:
        """Series ids of N tag sets of one metric, new ones allocated
        contiguously by one ``tss_add_series_n`` call; one lock take and
        one index update for the batch. Ids are assigned in first-seen
        order, as the memory store assigns them."""
        keys = [(metric_id, tuple(sorted(t))) for t in tags_list]
        out = np.empty(len(keys), dtype=np.int64)
        with self._lock:
            get = self._key_to_sid.get
            new_keys: dict[tuple, int] = {}
            for i, key in enumerate(keys):
                sid = get(key)
                if sid is None:
                    sid = new_keys.get(key)
                    if sid is None:
                        sid = new_keys[key] = self._num_series \
                            + len(new_keys)
                out[i] = sid
            if new_keys:
                first = self._lib.tss_add_series_n(self._h, len(new_keys))
                if first != self._num_series:
                    raise RuntimeError(
                        f"native series directory at {first}, expected "
                        f"{self._num_series}")
                self._key_to_sid.update(new_keys)
                self._keys.extend(new_keys)
                self._num_series += len(new_keys)
                idx = self._metric_index.get(metric_id)
                if idx is None:
                    idx = self._metric_index[metric_id] = \
                        MetricIndex(metric_id)
                idx.add_bulk(
                    np.fromiter(new_keys.values(), dtype=np.int64,
                                count=len(new_keys)),
                    np.asarray([(sid, k, v)
                                for key, sid in new_keys.items()
                                for k, v in key[1]],
                               dtype=np.int64).reshape(-1, 3))
        return out

    def append(self, series_id: int, ts_ms: int, value: float,
               is_int: bool = False) -> None:
        if self._lib.tss_append(self._h, series_id, ts_ms, value,
                                int(bool(is_int))) != 0:
            raise IndexError(f"no such series {series_id}")

    def append_many(self, series_id: int, ts_ms, values,
                    is_int=False) -> None:
        """Append many points of one series; ``is_int`` is one flag or
        one per point."""
        ts = _i64(ts_ms)
        vals = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        if len(ts) != len(vals):
            raise ValueError("timestamps/values lengths differ")
        ints = self._flags(is_int, len(ts))
        if self._lib.tss_append_many(self._h, series_id, len(ts), _ptr(ts),
                                     _ptr(vals), _ptr(ints)) != 0:
            raise IndexError(f"no such series {series_id}")

    @staticmethod
    def _flags(is_int, n: int) -> np.ndarray:
        """uint8 [n] integer flags from one flag (None: 0) or n."""
        if np.ndim(is_int) == 0:
            return np.full(n, int(bool(is_int)), dtype=np.uint8)
        ints = np.ascontiguousarray(is_int, dtype=np.uint8).reshape(-1)
        if len(ints) != n:
            raise ValueError("is_int length differs")
        return ints

    def append_lines(self, sids, ts_ms, values, is_int=None) -> int:
        """Scatter-append: element i lands on series ``sids[i]``
        (negative sids skip) in one native call. Every id is checked
        before anything is written. Returns the points written."""
        sid_arr, ts_arr = _i64(sids), _i64(ts_ms)
        val_arr = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        if not len(sid_arr) == len(ts_arr) == len(val_arr):
            raise ValueError("sids/timestamps/values lengths differ")
        ints = self._flags(is_int, len(sid_arr))
        if len(sid_arr) and int(sid_arr.max()) >= self._num_series:
            raise IndexError("invalid series id in append")
        n = self._lib.tss_append_lines(self._h, _ptr(sid_arr), len(sid_arr),
                                       _ptr(ts_arr), _ptr(val_arr),
                                       _ptr(ints))
        if n < 0:
            raise IndexError("invalid series id in append")
        return int(n)

    def append_grid(self, series_ids, bucket_ts, grid, mask) -> int:
        """Bulk write of one ``[S, B]`` grid: the cells of row i that
        ``mask`` selects land on ``series_ids[i]`` at ``bucket_ts``
        (the rollup job's output path)."""
        sids, bts = _i64(series_ids), _i64(bucket_ts)
        g = np.ascontiguousarray(grid, dtype=np.float64)
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        if g.shape != (len(sids), len(bts)) or m.shape != g.shape:
            raise ValueError("grid and mask must be [len(series_ids), "
                             "len(bucket_ts)]")
        n = self._lib.tss_append_grid(self._h, _ptr(sids), len(sids),
                                      _ptr(bts), len(bts), _ptr(g),
                                      _ptr(m), _THREADS)
        if n < 0:
            raise IndexError("invalid series id in append_grid")
        return int(n)

    # -- destructive operations (delete, fsck) ------------------------------

    def delete_range(self, series_ids, start_ms: int, end_ms: int) -> int:
        """Remove the points in the inclusive ``[start_ms, end_ms]`` of
        each series; returns how many went. Every id is checked before
        anything is deleted."""
        sids = _i64(series_ids)
        if len(sids) and (int(sids.min()) < 0
                          or int(sids.max()) >= self._num_series):
            raise IndexError("invalid series id in delete_range")
        deleted = 0
        for sid in sids.tolist():
            deleted += int(self._lib.tss_delete_range(self._h, sid,
                                                      start_ms, end_ms))
        if deleted:
            self.mutation_epoch += 1
        return deleted

    def repair_series(self, series_id: int, min_ts: int, max_ts: int,
                      drop_nonfinite: bool = True) -> int:
        """fsck's in-place repair: drop points outside ``[min_ts,
        max_ts]`` and, with ``drop_nonfinite``, NaN and infinite values.
        Returns the points removed."""
        n = self._lib.tss_repair_series(self._h, series_id, min_ts, max_ts,
                                        int(drop_nonfinite))
        if n < 0:
            raise IndexError(f"no such series {series_id}")
        if n:
            self.mutation_epoch += 1
        return int(n)

    def patch_value(self, series_id: int, ts_ms: int, value: float,
                    is_int: bool = False) -> None:
        """fsck's in-place repair: overwrite the value at an exact
        timestamp (KeyError when the series has no point there)."""
        rc = self._lib.tss_patch_value(self._h, series_id, ts_ms,
                                       float(value), int(bool(is_int)))
        if rc == -1:
            raise IndexError(f"no such series {series_id}")
        if rc == -2:
            raise KeyError(f"series {series_id} has no point at {ts_ms}")
        self.mutation_epoch += 1

    def fsck_columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
        """What fsck checks (the memory store's ``fsck_columns``): each
        series' canonical points, sorted and deduped as the store keeps
        them, so no series is unsorted and every timestamp is
        distinct."""
        counts, ts, vals, _ = self.read_all()
        return (counts, ts, vals, np.zeros(len(counts), dtype=bool),
                counts.copy())

    # -- read path --------------------------------------------------------

    def metric_ids(self) -> list[int]:
        """Every metric with a series, in the order of its first one."""
        with self._lock:
            return list(self._metric_index)

    def metric_index(self, metric_id: int) -> MetricIndex | None:
        return self._metric_index.get(metric_id)

    def series(self, series_id: int) -> SeriesIdentity:
        """The identity of one series (the memory store's ``series``);
        IndexError for an unknown id."""
        if not 0 <= series_id < self._num_series:
            raise IndexError(f"no series {series_id}")
        return SeriesIdentity(*self._keys[series_id])

    def series_ids_for_metric(self, metric_id: int) -> np.ndarray:
        idx = self._metric_index.get(metric_id)
        if idx is None:
            return np.empty(0, dtype=np.int64)
        sids, _ = idx.arrays()
        return sids

    def series_points(self, series_id: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All points of one series, sorted: (ts int64, values float64,
        is_int bool)."""
        n = int(self._lib.tss_series_length(self._h, series_id))
        if n < 0:
            raise IndexError(f"no such series {series_id}")
        ts = np.empty(n, dtype=np.int64)
        vals = np.empty(n, dtype=np.float64)
        ints = np.empty(n, dtype=np.uint8)
        # a concurrent write can change the length: trim to the copy
        got = max(int(self._lib.tss_read_series(
            self._h, series_id, n, _ptr(ts), _ptr(vals), _ptr(ints))), 0)
        return ts[:got], vals[:got], ints[:got].astype(bool)

    def series_identities(self) -> list[tuple[int, tuple]]:
        """(metric id, sorted (tagk, tagv) UID pairs) of every series,
        by series id."""
        with self._lock:
            return list(self._keys)

    def read_all(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """Every series' points, sorted, back to back in series order:
        (counts int64 [S], ts int64, values float64, is_int uint8). One
        foreign call for the lengths, one per series for its points, and
        no array per series (the snapshot's read)."""
        lib, h = self._lib, self._h
        counts = self.series_lengths()
        total = int(counts.sum())
        ts = np.empty(total, dtype=np.int64)
        vals = np.empty(total, dtype=np.float64)
        ints = np.empty(total, dtype=np.uint8)
        bt, bv, bi = ts.ctypes.data, vals.ctypes.data, ints.ctypes.data
        slots = counts.copy()
        off = 0
        for sid, c in enumerate(slots.tolist()):
            # a concurrent delete can shorten a series after its length
            # was read: keep what was copied
            counts[sid] = max(int(lib.tss_read_series(
                h, sid, c, bt + 8 * off, bv + 8 * off, bi + off)), 0)
            off += c
        if int(counts.sum()) < total:
            rel = np.arange(total) - np.repeat(np.cumsum(slots) - slots,
                                               slots)
            keep = rel < np.repeat(counts, slots)
            ts, vals, ints = ts[keep], vals[keep], ints[keep]
        return counts, ts, vals, ints

    def first_timestamps(self, series_ids) -> np.ndarray:
        """Each series' oldest timestamp (int64; ``FIRST_TS_NONE`` for a
        series with no point): one read of one point per series."""
        sids = _i64(series_ids)
        out = np.full(len(sids), FIRST_TS_NONE, dtype=np.int64)
        ts, val, flag = (np.empty(1, dtype=np.int64),
                         np.empty(1, dtype=np.float64),
                         np.empty(1, dtype=np.uint8))
        for i, sid in enumerate(sids.tolist()):
            got = self._lib.tss_read_series(self._h, sid, 1, _ptr(ts),
                                            _ptr(val), _ptr(flag))
            if got < 0:
                raise IndexError(f"no such series {sid}")
            if got:
                out[i] = ts[0]
        return out

    def count_range(self, series_ids: Sequence[int], start_ms: int,
                    end_ms: int) -> np.ndarray:
        """Points per series in the inclusive ``[start_ms, end_ms]``."""
        sids = _i64(series_ids)
        counts = np.empty(len(sids), dtype=np.int64)
        if self._lib.tss_count_range(self._h, _ptr(sids), len(sids),
                                     start_ms, end_ms, _ptr(counts),
                                     _THREADS) != 0:
            raise IndexError("invalid series id in count_range")
        return counts

    def _fill(self, sids, start_ms, end_ms, offsets, counts, ts_out,
              vals_out, sidx_out) -> None:
        # rows that lost points between count and fill (a concurrent
        # delete) end in NaN placeholders at start_ms, which the query
        # path skips
        self._lib.tss_fill_range(self._h, _ptr(sids), len(sids), start_ms,
                                 end_ms, _ptr(offsets), _ptr(counts),
                                 _ptr(ts_out), _ptr(vals_out),
                                 _ptr(sidx_out), _THREADS)

    def materialize(self, series_ids: Sequence[int], start_ms: int,
                    end_ms: int) -> PointBatch:
        """Every point of ``series_ids`` in ``[start_ms, end_ms]``, row
        after row: one count pass, then one fill pass."""
        if self.fault_injector is not None:
            self.fault_injector.check(self.fault_site)
        sids = _i64(series_ids)
        counts = self.count_range(sids, start_ms, end_ms)
        offsets = np.cumsum(counts) - counts
        total = int(counts.sum())
        ts = np.empty(total, dtype=np.int64)
        vals = np.empty(total, dtype=np.float64)
        sidx = np.empty(total, dtype=np.int32)
        if total:
            self._fill(sids, start_ms, end_ms, offsets, counts, ts, vals,
                       sidx)
        return PointBatch(sids, sidx, ts, vals)

    def materialize_padded(self, series_ids: Sequence[int], start_ms: int,
                           end_ms: int) -> PaddedBatch:
        """The row-padded layout: the fill pass writes row i at offset
        ``i * Pmax`` of NaN-filled values and zero timestamps."""
        if self.fault_injector is not None:
            self.fault_injector.check(self.fault_site)
        sids = _i64(series_ids)
        counts = self.count_range(sids, start_ms, end_ms)
        pmax = max(1, int(counts.max())) if len(sids) else 1
        values2d = np.full((len(sids), pmax), np.nan)
        ts2d = np.zeros((len(sids), pmax), dtype=np.int64)
        if counts.any():
            sidx = np.empty(len(sids) * pmax, dtype=np.int32)
            self._fill(sids, start_ms, end_ms,
                       np.arange(len(sids), dtype=np.int64) * pmax, counts,
                       ts2d, values2d, sidx)
        return PaddedBatch(sids, values2d, ts2d, counts)

    def bucket_reduce(self, series_ids, start_ms: int, end_ms: int,
                      t0: int, interval_ms: int, nbuckets: int,
                      want_minmax: bool = False):
        """Storage-side fixed-interval downsample (``tss_bucket_reduce``):
        ``[S, B]`` float64 sums and counts, and min and max on request
        (else None), of the points in ``[start_ms, end_ms]``, bucket ``b
        = (ts - t0) // interval_ms``; points with ``b < 0`` or ``b >=
        nbuckets`` are dropped and NaNs skipped; an empty cell holds sum
        0, count 0, min +inf and max -inf. Each bucket is added in time
        order."""
        if self.fault_injector is not None:
            self.fault_injector.check(self.fault_site)
        if interval_ms <= 0 or nbuckets <= 0:
            raise ValueError("interval_ms and nbuckets must be positive")
        sids = _i64(series_ids)
        s = len(sids)
        sums = np.empty((s, nbuckets))
        cnts = np.empty((s, nbuckets))
        mins = np.empty((s, nbuckets)) if want_minmax else None
        maxs = np.empty((s, nbuckets)) if want_minmax else None
        if self._lib.tss_bucket_reduce(
                self._h, _ptr(sids), s, start_ms, end_ms, t0, interval_ms,
                nbuckets, _ptr(sums), _ptr(cnts), _ptr(mins), _ptr(maxs),
                _THREADS) != 0:
            raise IndexError("invalid series id in bucket_reduce")
        return sums, cnts, mins, maxs

    def series_lengths(self) -> np.ndarray:
        """Points of every series, by series id, in one foreign call:
        a call per series re-takes the GIL once for each, which stalls
        a stats scrape for seconds on a busy process."""
        i64 = np.iinfo(np.int64)
        return self.count_range(np.arange(self._num_series, dtype=np.int64),
                                int(i64.min), int(i64.max))

    def total_points(self) -> int:
        return int(self.series_lengths().sum())

    def memory_info(self) -> dict:
        """Footprint for stats: the arena keeps no capacity per series,
        so resident bytes are estimated as live ones, 17 bytes a point
        (int64 timestamp, float64 value, integer flag); cached on the
        store's version."""
        key = (self.version, self._num_series)
        cached = getattr(self, "_memory_info_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        points = self.total_points()
        info = {"series": self._num_series, "points": points,
                "resident_bytes": points * 17, "live_bytes": points * 17,
                "dead_bytes": 0, "estimated": True}
        self._memory_info_cache = (key, info)
        return info


# -- the bulk import-line parse ----------------------------------------------

IMPORT_ERRORS = {
    1: "too few fields (metric ts value tag=value...)",
    2: "invalid timestamp",
    3: "invalid value",
    4: "malformed tag (need tagk=tagv) or too many tags",
    5: "invalid character in metric or tag",
}


class ParsedImport:
    """Columnar result of one import-buffer parse: per line its raw
    timestamp (seconds or ms as written), value, integer flag, group id
    (its distinct metric and sorted tags; -1 for errors and blanks) and
    error code (0 ok, -1 blank or comment, else a key of
    ``IMPORT_ERRORS``); per group the bytes of its first line, so names
    and UIDs resolve once per series."""

    __slots__ = ("ts", "values", "is_int", "group_ids", "errors",
                 "rep_lines", "num_groups", "num_lines")

    def __init__(self, ts, values, is_int, group_ids, errors, rep_lines,
                 num_groups, num_lines):
        self.ts = ts                  # int64 [L]
        self.values = values          # float64 [L]
        self.is_int = is_int          # uint8 [L]
        self.group_ids = group_ids    # int64 [L]
        self.errors = errors          # int32 [L]
        self.rep_lines = rep_lines    # list[bytes], one per group
        self.num_groups = num_groups
        self.num_lines = num_lines


def parse_import_buffer(buf: bytes,
                        threads: int | None = None) -> ParsedImport:
    """Parse ``metric ts value tagk=tagv ...`` lines in one native pass,
    threaded over newline-aligned chunks (``tss_parse_import``)."""
    if not buf:
        e = np.empty(0, dtype=np.int64)
        return ParsedImport(e, np.empty(0), np.empty(0, np.uint8), e.copy(),
                            np.empty(0, np.int32), [], 0, 0)
    lib = library()
    nl = lib.tss_count_lines(buf, len(buf))
    ts = np.empty(nl, dtype=np.int64)
    vals = np.empty(nl, dtype=np.float64)
    ints = np.empty(nl, dtype=np.uint8)
    gids = np.empty(nl, dtype=np.int64)
    errs = np.empty(nl, dtype=np.int32)
    rep_off = np.empty(nl, dtype=np.int64)
    rep_len = np.empty(nl, dtype=np.int64)
    nlines = ctypes.c_int64(0)
    ng = lib.tss_parse_import(
        buf, len(buf), _ptr(ts), _ptr(vals), _ptr(ints), _ptr(gids),
        _ptr(errs), _ptr(rep_off), _ptr(rep_len), nl,
        ctypes.addressof(nlines), threads or _THREADS)
    if ng < 0:
        raise RuntimeError("import parse: more groups than lines")
    n = nlines.value
    reps = [bytes(buf[o:o + ln])
            for o, ln in zip(rep_off[:ng].tolist(), rep_len[:ng].tolist())]
    return ParsedImport(ts[:n], vals[:n], ints[:n], gids[:n], errs[:n],
                        reps, int(ng), n)


# -- the dps formatter -------------------------------------------------------

def format_dps_is_fast() -> bool:
    """True when the library formats doubles through ``std::to_chars``
    (libstdc++ 11 or later). Otherwise it walks ``%g`` precisions, which
    is slower than the serializer's columnar formatter."""
    return bool(library().tss_fmt_fast())


def format_dps(ts_ms: np.ndarray, vals: np.ndarray, seconds: bool,
               as_arrays: bool) -> bytes:
    """One series' dps as JSON entries joined by commas, without the
    envelope: ``"ts":v`` or ``[ts,v]``, ts in seconds when asked, NaN
    and the infinities quoted, integral values below 2**53 as integers,
    other values in their shortest round-trip form."""
    ts_arr = _i64(ts_ms)
    val_arr = np.ascontiguousarray(vals, dtype=np.float64).reshape(-1)
    cap = len(ts_arr) * 64 + 64
    buf = ctypes.create_string_buffer(cap)
    n = library().tss_format_dps(_ptr(ts_arr), _ptr(val_arr), len(ts_arr),
                                 int(seconds), int(as_arrays), buf, cap)
    if n < 0:
        raise RuntimeError("format_dps: output buffer too small")
    return buf.raw[:n]


def make_store(config):
    """The store ``tsd.storage.backend`` names: ``native`` (the
    default) or ``memory``. A native store whose library does not build
    or load raises :class:`NativeBuildError` with the compiler's
    output; nothing falls back to the memory store."""
    backend = config.get_string("tsd.storage.backend")
    if backend == "native":
        return NativeTimeSeriesStore()
    if backend == "memory":
        return TimeSeriesStore()
    raise ValueError(f"unknown tsd.storage.backend {backend!r}; "
                     f"expected one of {', '.join(BACKENDS)}")
