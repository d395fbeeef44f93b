"""Cold-tier columnar store: mmap-backed disk spill of demoted history
(ref: ``opentsdb_tpu/coldstore/store.py``).

The lifecycle bounds RAM by demoting aged raw points into rollup tiers,
but the tiers still live in process memory. This module is the disk
backend the sweeper spills cold tier history into: per-metric segment
files (:mod:`.format`) holding the four per-stat tier columns
(sum/count/min/max) over an int32-packed timestamp column, plus a json
manifest tracking every segment and each metric's **spill boundary**
(ms, exclusive: tier cells before it live on disk, not in RAM). The
files and the manifest are the reference's, so either package opens
the other's directory.

Reads go through :class:`ColdStatView`, a ``TimeSeriesStore``-shaped
object (``bucket_reduce`` / ``materialize`` / ``materialize_padded`` /
``count_range`` / ``delete_range``, with ``instance_id`` and
``version`` for the read-side caches) over the mmapped columns,
consumed by the three-way
:class:`~opentsdb_tpu_torch.lifecycle.stitch.StitchedStore` (cold
segments < spill boundary < in-RAM tier < demotion boundary < raw
tail). Series identity inside a segment is stored as sorted tag NAME
pairs and resolved back to the raw store's sids at read time, so
segments survive UID renumbering and restarts.

Crash order, as the reference's: the segment file is fsynced and
renamed into place first, the manifest (segment list + moved spill
boundary) commits second in ONE atomic write, and only then is the
spilled range deleted from the in-RAM tier stores. A crash at any
point leaves either (a) an orphan segment file invisible to reads or
(b) RAM duplicates of spilled cells that the stitched read CLIPS at
the spill boundary; never a double-serve, never a lost range, and the
next sweep's reconciliation purge removes them.

Segment writes run under the ``coldstore.write`` fault site (a failed
spill leaves the RAM copies authoritative), reads under
``coldstore.read`` with their own circuit breaker. A failed or
breaker-blocked cold read makes the stitched read raise
:class:`~opentsdb_tpu_torch.utils.faults.DegradedError`, a structured
503; the reference serves the tier and raw zones alone there (partial
history, ROADMAP Queue 3 item 21). The notes bump the cold
``mutation_epoch`` either way.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import zlib
from typing import Any, Sequence

import numpy as np

from opentsdb_tpu_torch.coldstore import format as fmt
from opentsdb_tpu_torch.core.store import (_INSTANCE_IDS, PaddedBatch,
                                           PointBatch, padded_from_batch)

LOG = logging.getLogger("coldstore")

MANIFEST = "manifest.json"
SEGMENT_SUFFIX = ".cold"
QUARANTINE_SUFFIX = ".quarantine"


def _metric_slug(metric: str) -> str:
    """Filesystem-safe, collision-safe metric tag for segment names."""
    safe = re.sub(r"[^A-Za-z0-9_.\-]", "_", metric)[:80]
    return f"{safe}-{zlib.crc32(metric.encode()) & 0xFFFFFFFF:08x}"


class _SegmentHandle:
    """Manifest entry + lazily-opened mmap + cached identity maps."""

    __slots__ = ("entry", "_seg", "_ids", "_lock")

    def __init__(self, entry: dict):
        self.entry = entry
        self._seg: fmt.Segment | None = None
        # per-series sorted (tagk_id, tagv_id) tuple (or None when a
        # tag name no longer resolves), aligned with segment.series
        self._ids: list | None = None
        self._lock = threading.Lock()

    def open(self, directory: str) -> fmt.Segment:
        seg = self._seg
        if seg is None:
            with self._lock:
                seg = self._seg
                if seg is None:
                    seg = fmt.Segment(
                        os.path.join(directory, self.entry["file"]))
                    self._seg = seg
        return seg

    def id_map(self, directory: str, uids) -> dict:
        """{sorted tag-id tuple: (off, cnt)} for this segment. UID
        tables are append-only, so one resolution is cached forever."""
        seg = self.open(directory)
        with self._lock:
            if self._ids is None:
                out = {}
                for tags, off, cnt in seg.series:
                    try:
                        key = tuple(sorted(
                            (uids.tag_names.get_id(k),
                             uids.tag_values.get_id(v))
                            for k, v in tags))
                    except LookupError:
                        continue  # unresolvable identity: fsck's find
                    out[key] = (off, cnt)
                self._ids = out
            return self._ids


class ColdStatView:
    """Read surface over one (metric, tier interval, stat): the cold
    third of the stitched store. Takes RAW-store series ids and maps
    them to segment rows by (metric, tags) identity, exactly like the
    stitched store maps raw sids to tier sids.

    Raises on any segment problem (missing file, bad checksum, armed
    ``coldstore.read`` fault); the stitched store's cold guard counts it
    and answers 503."""

    fault_site = "coldstore.read"

    def __init__(self, cold: "ColdStore", metric: str, interval: str,
                 stat: str, raw_store):
        self.instance_id = next(_INSTANCE_IDS)
        self.cold = cold
        self.metric = metric
        self.interval = interval
        self.stat = stat
        self.raw = raw_store

    @property
    def handles(self) -> list[_SegmentHandle]:
        # resolved per call (cached on the ColdStore, cleared by every
        # manifest mutation) so a long-lived stitched view never holds
        # handles onto rewritten or quarantined segment files
        return self.cold._handles(self.metric, self.interval)

    # version surface consumed by StitchedStore / result-cache keys
    @property
    def points_written(self) -> int:
        return self.cold.points_spilled

    @property
    def mutation_epoch(self) -> int:
        return self.cold.mutation_epoch

    @property
    def version(self) -> tuple[int, int]:
        """Changes with every spill and every cold mutation."""
        return self.points_written, self.mutation_epoch

    def total_points(self) -> int:
        return sum(h.entry["rows"] for h in self.handles)

    def _check(self) -> None:
        faults = self.cold.faults
        if faults is not None:
            faults.check(self.fault_site)

    def _rows_for(self, handle: _SegmentHandle, sids: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(positions in ``sids``, off, cnt) of the requested raw series
        present in this segment."""
        id_map = handle.id_map(self.cold.directory, self.cold.uids)
        out = []
        for i, sid in enumerate(sids.tolist()):
            hit = id_map.get(self.raw.series(sid).tags)
            if hit is not None:
                out.append((i, hit[0], hit[1]))
        arr = np.asarray(out, dtype=np.int64).reshape(-1, 3)
        return arr[:, 0], arr[:, 1], arr[:, 2]

    def _overlapping(self, start_ms: int, end_ms: int
                     ) -> list[_SegmentHandle]:
        return [h for h in self.handles
                if h.entry["start_ms"] <= end_ms
                and h.entry["end_ms"] >= start_ms]

    def _ranges(self, handle: _SegmentHandle, sids: np.ndarray,
                start_ms: int, end_ms: int):
        """(segment, positions in ``sids``, first row, row count) of each
        requested series' rows within [start_ms, end_ms]."""
        seg = handle.open(self.cold.directory)
        pos, off, cnt = self._rows_for(handle, sids)
        lo, hi = fmt.row_bounds_many(seg, off, cnt, start_ms, end_ms)
        return seg, pos, lo, hi - lo

    # -- StorageBackend read surface ------------------------------------

    def count_range(self, series_ids, start_ms: int,
                    end_ms: int) -> np.ndarray:
        self._check()
        sids = np.asarray(series_ids, dtype=np.int64)
        out = np.zeros(len(sids), dtype=np.int64)
        for h in self._overlapping(start_ms, end_ms):
            _seg, pos, _lo, n = self._ranges(h, sids, start_ms, end_ms)
            np.add.at(out, pos, n)
        return out

    def materialize(self, series_ids, start_ms: int,
                    end_ms: int) -> PointBatch:
        """Flat batch of the stat column. Segments of one metric are
        time-disjoint and visited oldest-first, so after the stable
        sort on the series index each series' points are
        time-ascending (the PointBatch contract)."""
        self._check()
        sids = np.asarray(series_ids, dtype=np.int64)
        idx_parts: list[np.ndarray] = []
        ts_parts: list[np.ndarray] = []
        val_parts: list[np.ndarray] = []
        for h in sorted(self._overlapping(start_ms, end_ms),
                        key=lambda h: h.entry["start_ms"]):
            seg, pos, lo, n = self._ranges(h, sids, start_ms, end_ms)
            total = int(n.sum())
            if not total:
                continue
            rows = np.repeat(lo - (np.cumsum(n) - n), n) \
                + np.arange(total)
            idx_parts.append(np.repeat(pos, n).astype(np.int32))
            scale = seg.header.get("scale", 1)
            ts = np.asarray(seg.ts)[rows]
            ts_parts.append(ts.astype(np.int64) if scale == 0 else
                            int(seg.header["base_ms"])
                            + ts.astype(np.int64) * scale)
            val_parts.append(np.asarray(seg.cols[self.stat])[rows])
        if not ts_parts:
            return PointBatch(sids, np.empty(0, dtype=np.int32),
                              np.empty(0, dtype=np.int64),
                              np.empty(0, dtype=np.float64))
        series_idx = np.concatenate(idx_parts)
        ts_ms = np.concatenate(ts_parts)
        values = np.concatenate(val_parts)
        order = np.argsort(series_idx, kind="stable")
        return PointBatch(sids, series_idx[order], ts_ms[order],
                          values[order])

    def bucket_reduce(self, series_ids, start_ms: int, end_ms: int,
                      t0: int, interval_ms: int, nbuckets: int,
                      want_minmax: bool = False):
        """Same fused shape as ``TimeSeriesStore.bucket_reduce``: [S,B]
        sum/count (+min/max) grids over the stat column."""
        batch = self.materialize(series_ids, start_ms, end_ms)
        s = len(batch.series_ids)
        b = (batch.ts_ms - t0) // interval_ms
        ok = (b >= 0) & (b < nbuckets) & ~np.isnan(batch.values)
        seg = batch.series_idx[ok].astype(np.int64) * nbuckets + b[ok]
        vals = batch.values[ok]
        n = s * nbuckets
        sums = np.bincount(seg, weights=vals, minlength=n).reshape(
            s, nbuckets)
        cnts = np.bincount(seg, minlength=n).astype(np.float64) \
            .reshape(s, nbuckets)
        mins = maxs = None
        if want_minmax:
            mins = np.full(n, np.inf)
            np.minimum.at(mins, seg, vals)
            maxs = np.full(n, -np.inf)
            np.maximum.at(maxs, seg, vals)
            mins = mins.reshape(s, nbuckets)
            maxs = maxs.reshape(s, nbuckets)
        return sums, cnts, mins, maxs

    def materialize_padded(self, series_ids, start_ms: int,
                           end_ms: int) -> PaddedBatch:
        return padded_from_batch(
            self.materialize(series_ids, start_ms, end_ms))

    def delete_range(self, series_ids, start_ms: int,
                     end_ms: int) -> int:
        """delete=true over cold history: segment rewrite. A cold row
        holds ALL four stat columns of one tier cell, so deleting it
        removes the point from every stat — the point is gone, which
        is what delete means. Raises on failure (a delete must never
        silently not happen)."""
        sids = np.asarray(series_ids, dtype=np.int64)
        identities = set()
        for sid in sids:
            identities.add(self.raw.series(int(sid)).tags)
        return self.cold.delete_rows(self.metric, self.interval,
                                     identities, start_ms, end_ms)


class ColdStore:
    """Segment + manifest owner for one cold directory (see module
    docstring). Owned by the :class:`~opentsdb_tpu_torch.lifecycle.
    manager.LifecycleManager`; all mutation goes through the sweep or
    the fsck helpers (``quarantine``, ``clamp_boundary``)."""

    def __init__(self, directory: str, faults=None, uids=None,
                 read_breaker=None):
        self.directory = directory
        self.faults = faults
        self.uids = uids
        self.read_breaker = read_breaker
        self._lock = threading.Lock()
        # metric -> {"spill_boundary_ms": int, "segments": [entry]}
        self._metrics: dict[str, dict] = {}
        # (metric, interval) -> [_SegmentHandle] (sorted by start_ms)
        self._handle_cache: dict[tuple[str, str],
                                 list[_SegmentHandle]] = {}
        self.mutation_epoch = 0
        self.points_spilled = 0
        self.segments_written = 0
        self.bytes_spilled = 0
        self.spill_errors = 0
        self.read_errors = 0
        self.degraded_serves = 0
        self.segments_quarantined = 0
        self.segments_dropped = 0       # retention
        self.segments_compacted = 0     # merge-compaction
        self.points_deleted = 0         # delete=true rewrites
        self.last_error = ""
        self._load_manifest()

    # ------------------------------------------------------------------
    # manifest
    # ------------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _load_manifest(self) -> None:
        import json
        path = self.manifest_path
        if not os.path.isfile(path):
            return
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as exc:
            # a corrupt manifest degrades to "no cold data": tier/raw
            # serving continues, fsck reports the segments as orphans
            LOG.warning("could not load cold manifest %s: %s", path,
                        exc)
            self.last_error = f"manifest: {exc}"
            return
        self._metrics = doc.get("metrics") or {}
        self.points_spilled = sum(
            e["rows"] for m in self._metrics.values()
            for e in m.get("segments", ()))

    def _save_manifest_locked(self) -> None:
        import json
        from opentsdb_tpu_torch.core.persist import atomic_write
        os.makedirs(self.directory, exist_ok=True)
        atomic_write(self.manifest_path, json.dumps(
            {"version": 1, "metrics": self._metrics},
            sort_keys=True).encode())

    # ------------------------------------------------------------------
    # read-side lookups
    # ------------------------------------------------------------------

    def spill_boundary(self, metric: str) -> int:
        with self._lock:
            rec = self._metrics.get(metric)
            return int(rec["spill_boundary_ms"]) if rec else 0

    def spill_boundaries(self) -> dict[str, int]:
        """Locked snapshot for the admin surface (a sweep may insert
        a metric mid-request)."""
        with self._lock:
            return {m: int(rec["spill_boundary_ms"])
                    for m, rec in self._metrics.items()}

    def has_segments(self, metric: str, interval: str) -> bool:
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return False
            return any(e["interval"] == interval
                       for e in rec.get("segments", ()))

    def _handles(self, metric: str, interval: str
                 ) -> list[_SegmentHandle]:
        key = (metric, interval)
        with self._lock:
            cached = self._handle_cache.get(key)
            if cached is None:
                rec = self._metrics.get(metric) or {}
                cached = sorted(
                    (_SegmentHandle(e) for e in rec.get("segments", ())
                     if e["interval"] == interval),
                    key=lambda h: h.entry["start_ms"])
                self._handle_cache[key] = cached
            return cached

    def stat_view(self, metric: str, interval: str, stat: str,
                  raw_store) -> ColdStatView:
        return ColdStatView(self, metric, interval, stat, raw_store)

    def sketch_rows(self, metric: str, interval: str | None,
                    start_ms: int, end_ms: int
                    ) -> list[tuple[tuple, int, bytes]]:
        """The fifth column's cold read: ``(tags_names, cell_ts,
        blob)`` rows of every format-2 segment overlapping
        [start_ms, end_ms]. ``interval=None`` reads every interval
        that has sketch-bearing segments (the query path doesn't know
        which tier carried the cells at fold time). Runs under
        ``coldstore.read``, like the stat views: the caller answers a
        raise with 503)."""
        if self.faults is not None:
            self.faults.check("coldstore.read")
        if interval is None:
            with self._lock:
                rec = self._metrics.get(metric)
                intervals = sorted({e["interval"]
                                    for e in rec["segments"]
                                    if e.get("sketch")}) if rec else []
            out: list[tuple[tuple, int, bytes]] = []
            for iv in intervals:
                out.extend(self._sketch_rows_one(metric, iv, start_ms,
                                                 end_ms))
            return out
        return self._sketch_rows_one(metric, interval, start_ms,
                                     end_ms)

    def _sketch_rows_one(self, metric: str, interval: str,
                         start_ms: int, end_ms: int
                         ) -> list[tuple[tuple, int, bytes]]:
        out: list[tuple[tuple, int, bytes]] = []
        for h in self._handles(metric, interval):
            if h.entry["start_ms"] > end_ms or \
                    h.entry["end_ms"] < start_ms:
                continue
            seg = h.open(self.directory)
            if not seg.has_sketches:
                continue
            lo_v, hi_v = fmt.row_bounds_many(
                seg, [off for _, off, _ in seg.series],
                [cnt for _, _, cnt in seg.series], start_ms, end_ms)
            for (tags, _, _), lo, hi in zip(seg.series, lo_v.tolist(),
                                            hi_v.tolist()):
                if hi <= lo:
                    continue
                ts = seg.ts64(lo, hi)
                for j in range(hi - lo):
                    blob = seg.sketch_blob(lo + j)
                    if blob is not None:
                        out.append((tags, int(ts[j]), blob))
        return out

    def has_sketch_segments(self, metric: str, interval: str) -> bool:
        """Whether any committed segment of this (metric, tier)
        carries the sketch column (manifest-entry check, no file
        open)."""
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return False
            return any(e["interval"] == interval and e.get("sketch")
                       for e in rec["segments"])

    # ------------------------------------------------------------------
    # spill (called by the lifecycle sweep, under coldstore.write)
    # ------------------------------------------------------------------

    def write_segment(self, metric: str, interval: str,
                      series_entries: Sequence[dict],
                      ts_ms: np.ndarray,
                      cols: dict[str, np.ndarray],
                      sketch: tuple[np.ndarray, bytes] | None = None
                      ) -> dict:
        """Write one durable segment file (NOT yet visible: the caller
        commits it to the manifest via :meth:`commit_spill` once every
        tier's segment of the sweep is on disk). ``sketch`` is the
        optional fifth column — ``(offsets int64[rows+1], blob)`` of
        per-row serialized quantile sketches; its presence makes the
        file a format-2 segment."""
        if self.faults is not None:
            self.faults.check("coldstore.write")
        ts_col, base, scale = fmt.pack_timestamps(ts_ms)
        start = int(ts_ms.min()) if len(ts_ms) else 0
        end = int(ts_ms.max()) if len(ts_ms) else 0
        name = (f"{_metric_slug(metric)}-{interval}-{start}-{end}"
                f"{SEGMENT_SUFFIX}")
        header = {
            "metric": metric, "interval": interval,
            "base_ms": base, "scale": scale,
            "start_ms": start, "end_ms": end,
            "stats": list(fmt.STATS),
            "series": list(series_entries),
        }
        return fmt.write_segment(self.directory, name, header, ts_col,
                                 cols, sketch=sketch)

    def commit_spill(self, metric: str, boundary_ms: int,
                     entries: Sequence[dict]) -> None:
        """Publish freshly-written segments + the moved spill boundary
        in one atomic manifest write. After this returns, stitched
        reads clip the in-RAM tier at the new boundary — the caller
        may then safely purge the spilled range from RAM."""
        with self._lock:
            rec = self._metrics.setdefault(
                metric, {"spill_boundary_ms": 0, "segments": []})
            existing = {e["file"] for e in rec["segments"]}
            for e in entries:
                if e["file"] in existing:   # re-spill after a crash:
                    rec["segments"] = [     # newest write wins
                        x for x in rec["segments"]
                        if x["file"] != e["file"]]
                rec["segments"].append(dict(e))
                self.segments_written += 1
                self.points_spilled += int(e["rows"])
                self.bytes_spilled += int(e["bytes"])
            rec["spill_boundary_ms"] = max(
                int(rec["spill_boundary_ms"]), int(boundary_ms))
            self._handle_cache.clear()
            self._save_manifest_locked()
            self.mutation_epoch += 1

    # ------------------------------------------------------------------
    # destructive ops (delete=true, retention, fsck quarantine)
    # ------------------------------------------------------------------

    def delete_rows(self, metric: str, interval: str,
                    identities: set, start_ms: int,
                    end_ms: int) -> int:
        """Remove the given series' rows within [start_ms, end_ms] by
        rewriting every overlapping segment (cold deletes are rare
        admin ops; a rewrite keeps the format append-only)."""
        deleted = 0
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return 0
            keep_entries = []
            obsolete: list[str] = []
            changed = False
            for entry in rec["segments"]:
                if entry["interval"] != interval or \
                        entry["start_ms"] > end_ms or \
                        entry["end_ms"] < start_ms:
                    keep_entries.append(entry)
                    continue
                seg = fmt.Segment(os.path.join(self.directory,
                                               entry["file"]))
                removed, new_entry = self._rewrite_segment(
                    seg, entry, identities, start_ms, end_ms)
                deleted += removed
                if removed == 0:
                    keep_entries.append(entry)
                    continue
                if new_entry is not None:
                    keep_entries.append(new_entry)
                obsolete.append(entry["file"])
                changed = True
            if changed:
                rec["segments"] = keep_entries
                self._handle_cache.clear()
                self.points_deleted += deleted
                self.mutation_epoch += 1
                self._save_manifest_locked()
                # unlink the replaced files only AFTER the manifest
                # commit: a crash before this point leaves both files
                # on disk with the manifest still authoritative (the
                # old rows readable, the .rw file an fsck-visible
                # orphan) — never a referenced-but-missing segment
                for name in obsolete:
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:  # pragma: no cover
                        pass
        return deleted

    def _rewrite_segment(self, seg: fmt.Segment, entry: dict,
                         identities: set | None, start_ms: int,
                         end_ms: int) -> tuple[int, dict | None]:
        """(rows removed, replacement manifest entry or None when the
        whole segment emptied). ``identities`` of None means EVERY
        series (retention trim); a set restricts to those tag-id
        identities (delete=true). Writes the replacement file but does
        NOT touch the old one — the caller unlinks it after the
        manifest commit. Caller holds the lock."""
        uids = self.uids
        n = int(entry["rows"])
        keep = np.ones(n, dtype=bool)
        runs = []
        for tags, off, cnt in seg.series:
            if identities is not None:
                try:
                    key = tuple(sorted((uids.tag_names.get_id(k),
                                        uids.tag_values.get_id(v))
                                       for k, v in tags))
                except LookupError:
                    continue
                if key not in identities:
                    continue
            runs.append((off, cnt))
        if runs:
            offs, cnts = zip(*runs)
            lo_v, hi_v = fmt.row_bounds_many(seg, offs, cnts, start_ms,
                                             end_ms)
            for lo, hi in zip(lo_v.tolist(), hi_v.tolist()):
                keep[lo:hi] = False
        removed = int(n - keep.sum())
        if removed == 0:
            return 0, entry
        if removed == n:
            return removed, None
        ts64 = seg.ts64(0, n)[keep]
        cols = {stat: np.asarray(seg.cols[stat])[keep]
                for stat in seg.header["stats"]}
        series_entries = []
        pos = np.cumsum(keep) - keep  # new row index of each old row
        for tags, off, cnt in seg.series:
            cnt_new = int(keep[off:off + cnt].sum())
            if cnt_new:
                series_entries.append({
                    "tags": [list(p) for p in tags],
                    "off": int(pos[off]), "cnt": cnt_new})
        # the sketch column survives rewrites: kept rows keep their
        # blobs (re-packed contiguously), dropped rows drop theirs
        sketch = None
        if seg.has_sketches:
            offs = np.asarray(seg.sk_off)
            lens = (offs[1:] - offs[:-1])[keep]
            new_off = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=new_off[1:])
            blob_parts = []
            for row in np.nonzero(keep)[0].tolist():
                lo2, hi2 = int(offs[row]), int(offs[row + 1])
                if hi2 > lo2:
                    blob_parts.append(bytes(seg.sk_blob[lo2:hi2]))
            sketch = (new_off, b"".join(blob_parts))
        ts_col, base, scale = fmt.pack_timestamps(ts64)
        header = {
            "metric": entry.get("metric", seg.header["metric"]),
            "interval": entry["interval"],
            "base_ms": base, "scale": scale,
            "start_ms": int(ts64.min()), "end_ms": int(ts64.max()),
            "stats": list(seg.header["stats"]),
            "series": series_entries,
        }
        # the replacement keeps the SEGMENT_SUFFIX (fsck's orphan scan
        # matches on it) and carries a monotonic nonce so repeated
        # rewrites never collide or accrete suffixes
        base = entry["file"]
        if base.endswith(SEGMENT_SUFFIX):
            base = base[:-len(SEGMENT_SUFFIX)]
        base = re.sub(r"-rw\d+$", "", base)
        name = (f"{base}-rw{self.points_deleted + removed}"
                f"{SEGMENT_SUFFIX}")
        new_entry = fmt.write_segment(self.directory, name, header,
                                      ts_col, cols, sketch=sketch)
        return removed, new_entry

    def compact_segments(self, metric: str, threshold: int) -> int:
        """Merge-compact every (metric, tier) group that accumulated
        MORE than ``threshold`` per-sweep segments into one segment
        per tier. Same crash ordering as the delete rewrite: each
        merged replacement is durable on disk BEFORE the single
        manifest commit that swaps the entries, and the obsolete files
        unlink only AFTER it — a crash at any point leaves fsck-visible
        orphans, never a referenced-but-missing segment. Returns the
        number of segments merged away."""
        if threshold <= 0:
            return 0
        if self.faults is not None:
            self.faults.check("coldstore.write")
        removed = 0
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return 0
            by_tier: dict[str, list[dict]] = {}
            for entry in rec["segments"]:
                by_tier.setdefault(entry["interval"], []).append(entry)
            keep_entries = [e for e in rec["segments"]
                            if len(by_tier[e["interval"]]) <= threshold]
            obsolete: list[str] = []
            changed = False
            for interval, entries in sorted(by_tier.items()):
                if len(entries) <= threshold:
                    continue
                entries = sorted(entries,
                                 key=lambda e: e["start_ms"])
                new_entry = self._merge_segments_locked(
                    metric, interval, entries)
                if new_entry is None:   # unreadable input: leave as-is
                    keep_entries.extend(entries)
                    continue
                keep_entries.append(new_entry)
                obsolete.extend(e["file"] for e in entries)
                removed += len(entries) - 1
                changed = True
            if changed:
                rec["segments"] = keep_entries
                self._handle_cache.clear()
                self.segments_compacted += removed
                self.mutation_epoch += 1
                self._save_manifest_locked()
                # unlink the merged inputs only AFTER the manifest
                # commit (the delete-rewrite ordering, see above)
                for name in obsolete:
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:  # pragma: no cover
                        pass
        return removed

    def _merge_segments_locked(self, metric: str, interval: str,
                               entries: list[dict]) -> dict | None:
        """Write ONE durable segment holding every row of ``entries``
        (time-disjoint, passed sorted by start_ms), series-major like
        any spilled segment: per identity, the per-segment runs
        concatenate in segment order, so each series' rows stay
        time-ascending. Returns the replacement manifest entry, or
        None when an input segment cannot be read (checksum, missing
        file — the group is left untouched for fsck to report).
        Caller holds the lock."""
        try:
            segs = [fmt.Segment(os.path.join(self.directory,
                                             e["file"]))
                    for e in entries]
        except (fmt.SegmentError, OSError) as exc:
            self.last_error = f"compact: {exc}"
            return None
        stats = list(segs[0].header["stats"])
        if any(list(s.header["stats"]) != stats for s in segs[1:]):
            return None
        # per-identity row runs, first-seen order (deterministic:
        # segment order is start_ms order, series order is on-disk)
        order: list[tuple] = []
        runs: dict[tuple, list[tuple[int, int, int]]] = {}
        for si, seg in enumerate(segs):
            for tags, off, cnt in seg.series:
                if tags not in runs:
                    order.append(tags)
                    runs[tags] = []
                runs[tags].append((si, off, cnt))
        has_sk = any(s.has_sketches for s in segs)
        ts_parts: list[np.ndarray] = []
        col_parts: dict[str, list[np.ndarray]] = \
            {st: [] for st in stats}
        sk_lens: list[np.ndarray] = []
        sk_blobs: list[bytes] = []
        series_entries = []
        off_out = 0
        for tags in order:
            cnt_total = 0
            for si, off, cnt in runs[tags]:
                seg = segs[si]
                ts_parts.append(seg.ts64(off, off + cnt))
                for st in stats:
                    col_parts[st].append(
                        np.asarray(seg.cols[st])[off:off + cnt])
                if has_sk:
                    if seg.has_sketches:
                        offs = np.asarray(seg.sk_off)
                        sk_lens.append(offs[off + 1:off + cnt + 1]
                                       - offs[off:off + cnt])
                        lo, hi = int(offs[off]), int(offs[off + cnt])
                        if hi > lo:
                            sk_blobs.append(bytes(seg.sk_blob[lo:hi]))
                    else:
                        # format-1 input rows merge into a format-2
                        # output as empty (offset-equal) sketch slots
                        sk_lens.append(np.zeros(cnt, dtype=np.int64))
                cnt_total += cnt
            series_entries.append({"tags": [list(p) for p in tags],
                                   "off": off_out, "cnt": cnt_total})
            off_out += cnt_total
        ts64 = np.concatenate(ts_parts) if ts_parts else \
            np.zeros(0, dtype=np.int64)
        cols = {st: np.concatenate(col_parts[st]) if col_parts[st]
                else np.zeros(0, dtype=np.float64) for st in stats}
        sketch = None
        if has_sk:
            lens = np.concatenate(sk_lens) if sk_lens else \
                np.zeros(0, dtype=np.int64)
            new_off = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=new_off[1:])
            sketch = (new_off, b"".join(sk_blobs))
        ts_col, base_ms, scale = fmt.pack_timestamps(ts64)
        header = {
            "metric": metric, "interval": interval,
            "base_ms": base_ms, "scale": scale,
            "start_ms": int(ts64.min()) if len(ts64) else 0,
            "end_ms": int(ts64.max()) if len(ts64) else 0,
            "stats": stats, "series": series_entries,
        }
        # keeps SEGMENT_SUFFIX (fsck's orphan scan matches on it) and
        # a monotonic nonce so repeated compactions never collide
        name = (f"{_metric_slug(metric)}-{interval}"
                f"-{header['start_ms']}-{header['end_ms']}"
                f"-mc{self.segments_compacted + len(entries)}"
                f"{SEGMENT_SUFFIX}")
        return fmt.write_segment(self.directory, name, header, ts_col,
                                 cols, sketch=sketch)

    @staticmethod
    def _entry_interval_ms(entry: dict, interval_ms_of) -> int:
        """One segment's cell-window span in ms: the shared expiry
        rule for the drop and trim paths (unknown/absent tier maps
        conservatively to 0)."""
        if interval_ms_of is None:
            return 0
        try:
            return max(int(interval_ms_of(entry["interval"])), 0)
        except Exception:  # noqa: BLE001 - unknown tier
            return 0

    def drop_segments_before(self, metric: str, cutoff_ms: int,
                             interval_ms_of=None) -> int:
        """Retention for the cold tier, segment-granular: drop every
        segment whose WHOLE range expired — including the last cell's
        aggregation window ``[end_ms, end_ms + interval)``, the same
        cell rule the partial trim and the RAM-tier purge use (a cell
        stamped just before the cutoff still aggregates unexpired
        history). Returns rows dropped."""
        dropped = 0
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return 0
            keep = []
            for entry in rec["segments"]:
                iv_ms = self._entry_interval_ms(entry, interval_ms_of)
                if entry["end_ms"] + iv_ms < cutoff_ms:
                    dropped += int(entry["rows"])
                    self.segments_dropped += 1
                    path = os.path.join(self.directory, entry["file"])
                    try:
                        os.unlink(path)
                    except OSError:
                        pass  # already gone; manifest is authoritative
                else:
                    keep.append(entry)
            if dropped:
                rec["segments"] = keep
                self._handle_cache.clear()
                self.mutation_epoch += 1
                self._save_manifest_locked()
        return dropped

    # a straddling segment is only rewritten once its expired prefix
    # is worth the copy: the rewrite is O(segment) regardless of how
    # little expired, so trimming every sweep would re-copy a huge
    # long-lived segment per cycle for a sliver. 25% bounds the
    # amortized write amplification at ~4x while whole-expired
    # segments keep dropping for free via drop_segments_before.
    TRIM_MIN_EXPIRED_FRACTION = 0.25

    def trim_segments_before(self, metric: str, cutoff_ms: int,
                             interval_ms_of=None) -> int:
        """Partial-segment retention trim: rewrite still-live segments
        whose RANGE straddles the cutoff, dropping the expired prefix
        through the delete-rewrite path (same crash ordering:
        replacement written + manifest committed BEFORE the old file
        unlinks). :meth:`drop_segments_before` handles whole-expired
        segments cheaply (unlink, no rewrite) — this covers the long
        tail a single huge segment would otherwise pin on disk until
        its newest cell expired.

        A cold cell stamped T aggregates ``[T, T+interval)``: like the
        RAM-tier purge rule, only cells whose WHOLE window expired are
        trimmed (``T + interval <= cutoff``), so unexpired aggregated
        history is never lost with its cell. ``interval_ms_of``
        maps a tier interval string ("1m") to its ms span; absent
        (or unknown interval), the trim conservatively assumes 0.
        Segments whose expired prefix is under
        :data:`TRIM_MIN_EXPIRED_FRACTION` of their range are left for
        a later sweep (write-amplification gate). Returns rows
        removed."""
        trimmed = 0
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return 0
            keep_entries: list[dict] = []
            obsolete: list[str] = []
            changed = False
            for entry in rec["segments"]:
                iv_ms = self._entry_interval_ms(entry, interval_ms_of)
                # inclusive delete end: mirrors the RAM tier's
                # ``cutoff - 1 - iv`` purge bound
                cut_end = cutoff_ms - 1 - iv_ms
                if cut_end < 1 or entry["start_ms"] > cut_end:
                    keep_entries.append(entry)
                    continue
                span = max(entry["end_ms"] - entry["start_ms"], 1)
                frac = (cut_end - entry["start_ms"]) / span
                if frac < self.TRIM_MIN_EXPIRED_FRACTION:
                    keep_entries.append(entry)
                    continue
                seg = fmt.Segment(os.path.join(self.directory,
                                               entry["file"]))
                removed, new_entry = self._rewrite_segment(
                    seg, entry, None, 1, cut_end)
                trimmed += removed
                if removed == 0:
                    keep_entries.append(entry)
                    continue
                if new_entry is not None:
                    keep_entries.append(new_entry)
                else:
                    self.segments_dropped += 1
                obsolete.append(entry["file"])
                changed = True
            if changed:
                rec["segments"] = keep_entries
                self._handle_cache.clear()
                self.points_deleted += trimmed
                self.mutation_epoch += 1
                self._save_manifest_locked()
                # unlink replaced files only AFTER the manifest commit
                # (delete_rows crash ordering: an orphan is
                # fsck-visible, a referenced-but-missing segment is
                # data loss)
                for name in obsolete:
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:  # pragma: no cover
                        pass
        return trimmed

    def quarantine(self, metric: str, file: str) -> bool:
        """fsck --fix: move a corrupt segment out of the manifest (and
        aside on disk) so reads of the rest stop failing on it."""
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec:
                return False
            hit = [e for e in rec["segments"] if e["file"] == file]
            if not hit:
                return False
            rec["segments"] = [e for e in rec["segments"]
                               if e["file"] != file]
            path = os.path.join(self.directory, file)
            try:
                if os.path.exists(path):
                    os.replace(path, path + QUARANTINE_SUFFIX)
            except OSError as exc:  # pragma: no cover - disk trouble
                LOG.warning("could not quarantine %s: %s", path, exc)
            self.segments_quarantined += 1
            self._handle_cache.clear()
            self.mutation_epoch += 1
            self._save_manifest_locked()
            return True

    def clamp_boundary(self, metric: str, boundary_ms: int) -> bool:
        """fsck --fix for a spill boundary past the demotion boundary
        (would double-serve [demote, spill) from both cold and raw)."""
        with self._lock:
            rec = self._metrics.get(metric)
            if not rec or rec["spill_boundary_ms"] <= boundary_ms:
                return False
            rec["spill_boundary_ms"] = int(boundary_ms)
            self.mutation_epoch += 1
            self._save_manifest_locked()
            return True

    # ------------------------------------------------------------------
    # read-failure bookkeeping (called by the stitched store's guard)
    # ------------------------------------------------------------------

    def note_read_error(self, exc: Exception) -> None:
        self.read_errors += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        # the epoch bump makes any result computed during this failure
        # stale for every later cache lookup (entries store the
        # pre-read version)
        self.mutation_epoch += 1
        if self.read_errors <= 5 or self.read_errors % 1000 == 0:
            LOG.warning("cold read failed (%s); the query answers 503",
                        self.last_error)

    def note_degraded_serve(self) -> None:
        self.degraded_serves += 1
        self.mutation_epoch += 1

    # ------------------------------------------------------------------
    # fsck surface
    # ------------------------------------------------------------------

    def fsck_scan(self, demote_boundaries: dict[str, int]
                  ) -> list[dict]:
        """Integrity findings: [{metric, file|None, problem,
        fixable}]. ``demote_boundaries`` maps metric name -> lifecycle
        demotion boundary (from ``lifecycle.json``)."""
        findings: list[dict] = []
        with self._lock:
            metrics = {m: dict(rec, segments=list(rec["segments"]))
                       for m, rec in self._metrics.items()}
        listed: set[str] = set()
        for metric, rec in metrics.items():
            spill_b = int(rec["spill_boundary_ms"])
            demote_b = demote_boundaries.get(metric)
            if spill_b and demote_b is None:
                # lifecycle.json lost or the metric UID unresolvable:
                # clamping to 0 here would cascade into quarantining
                # every (healthy) segment — report only, the operator
                # restores lifecycle.json (serving already clamps the
                # stitch, so nothing double-serves meanwhile)
                findings.append({
                    "metric": metric, "file": None, "fix": "report",
                    "problem": (
                        "spill boundary set but the metric has no "
                        "demotion boundary (lifecycle.json missing "
                        "or stale?) — cold history is unreachable "
                        "until it is restored")})
            elif demote_b is not None and spill_b > int(demote_b):
                findings.append({
                    "metric": metric, "file": None, "fix": "clamp",
                    "problem": (
                        f"spill boundary {spill_b} is past the "
                        f"demotion boundary {demote_b} — the range "
                        "between them would be double-served"),
                    "boundary": int(demote_b)})
            for entry in rec["segments"]:
                listed.add(entry["file"])
                path = os.path.join(self.directory, entry["file"])
                problem = None
                if not os.path.isfile(path):
                    problem = "segment file missing"
                else:
                    try:
                        fmt.Segment(path)
                        if not fmt.verify_data_crc(path):
                            problem = "data checksum mismatch"
                    except fmt.SegmentError as exc:
                        problem = str(exc)
                if problem is None and entry["end_ms"] >= spill_b:
                    problem = (f"segment range ends at "
                               f"{entry['end_ms']} >= spill boundary "
                               f"{spill_b}")
                if problem is not None:
                    findings.append({"metric": metric,
                                     "file": entry["file"],
                                     "fix": "quarantine",
                                     "problem": problem})
        try:
            on_disk = os.listdir(self.directory)
        except OSError:
            on_disk = []
        for name in on_disk:
            if name.endswith(SEGMENT_SUFFIX) and name not in listed:
                findings.append({
                    "metric": "", "file": name, "fix": "orphan",
                    "problem": "segment file not in manifest "
                               "(interrupted spill)"})
        return findings

    def remove_orphan(self, file: str) -> None:
        path = os.path.join(self.directory, file)
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
        except OSError:  # pragma: no cover - disk trouble
            pass

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def cold_bytes(self) -> int:
        with self._lock:
            return sum(int(e["bytes"])
                       for rec in self._metrics.values()
                       for e in rec.get("segments", ()))

    def memory_info(self) -> dict:
        with self._lock:
            segs = [e for rec in self._metrics.values()
                    for e in rec.get("segments", ())]
            return {
                "series": 0,  # identity lives in the raw store
                "points": sum(int(e["rows"]) for e in segs),
                "segments": len(segs),
                "disk_bytes": sum(int(e["bytes"]) for e in segs),
                "resident_bytes": 0,  # mmap: pages are reclaimable
                "live_bytes": 0, "dead_bytes": 0,
            }

    def counters(self) -> dict[str, Any]:
        return {
            "segmentsWritten": self.segments_written,
            "segmentsQuarantined": self.segments_quarantined,
            "segmentsDropped": self.segments_dropped,
            "segmentsCompacted": self.segments_compacted,
            "pointsSpilled": self.points_spilled,
            "pointsDeleted": self.points_deleted,
            "bytesSpilled": self.bytes_spilled,
            "coldBytes": self.cold_bytes(),
            "spillErrors": self.spill_errors,
            "readErrors": self.read_errors,
            "degradedServes": self.degraded_serves,
            "lastError": self.last_error,
        }

    def health_info(self) -> dict[str, Any]:
        doc = {"enabled": True, "dir": self.directory,
               **self.counters()}
        if self.read_breaker is not None:
            doc["breaker"] = self.read_breaker.health_info()
        return doc

    def collect_stats(self, collector) -> None:
        collector.record("coldstore.segments.written",
                         self.segments_written)
        collector.record("coldstore.segments.quarantined",
                         self.segments_quarantined)
        collector.record("coldstore.segments.compacted",
                         self.segments_compacted)
        collector.record("coldstore.points.spilled",
                         self.points_spilled)
        collector.record("coldstore.bytes", self.cold_bytes())
        collector.record("coldstore.spill_errors", self.spill_errors)
        collector.record("coldstore.read_errors", self.read_errors)
        collector.record("coldstore.degraded_serves",
                         self.degraded_serves)
