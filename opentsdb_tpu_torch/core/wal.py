"""Write-ahead log: acknowledged writes survive a crash (ref:
``opentsdb_tpu/core/wal.py``; the reference's own reference delegates
this to HBase's WAL, with batch imports opting out per request,
``PutRequest.setDurable(false)``).

The on-disk format is the reference's, so either package replays the
other's log:

- append-only segments ``<data_dir>/wal/wal-<first seq>-<pid>.log``,
  each starting with :data:`MAGIC`, holding records framed
  ``[type u8 | len u32 | seq u64 | crc32 u32 | payload]``. A torn tail
  (a crash mid-write) fails its CRC; replay stops there and cuts the
  torn bytes off the file, so exactly the intact prefix survives.
- point records are columnar binary: ``T_POINTS`` one series' points,
  ``T_LINES`` points scattered over many series; ``T_SERIES`` maps a
  store series id to its metric and tag names once per log, and
  ``T_UID`` records an explicit UID assignment. Replay resolves names
  again and remaps series ids, so it does not depend on the numbering
  of the run that wrote the log.
- **group commit**: one commit leader fsyncs at a time and every other
  waiter acknowledges by sequence number, returning without touching
  the disk when a round already covered its records. With
  ``group_window_ms > 0`` the leader first holds a bounded commit
  window for concurrent writers, cut short by the record and byte caps
  or as soon as the log goes quiet. ``fsync`` is ``always``,
  ``interval`` (a background thread) or ``never``.
- **request-scoped batching** (:meth:`WriteAheadLog.batch`): records
  appended inside the scope buffer per thread and land as one framed
  write under one lock take at scope exit, and the ``sync()`` calls
  inside collapse into one group-committed fsync: one put body, telnet
  burst or import buffer costs one write and one fsync.
- a disk that keeps failing after the retry ladder puts the log in
  degraded mode: writes are still accepted and acknowledged, the flag
  shows in :meth:`WriteAheadLog.health_info` and the stats, and a
  probe retries every ``resync_ms``.
- :meth:`WriteAheadLog.truncate` after a snapshot deletes the segments
  it covers; the snapshot's ``wal_applied_seq`` makes replay skip what
  it holds. Replaying a scalar record twice is harmless: the store
  keeps the last write of a timestamp and series resolution is
  idempotent.

``T_HIST`` holds one histogram point (its metric, tag names and
timestamp as JSON, then the codec blob); replay writes it again through
``TSDB.add_histogram_point``. A histogram point adds to its arena, so
it must not be replayed over a snapshot that holds it: the writer logs
it under the TSDB's histogram lock (:meth:`WriteAheadLog.flush_batch`
lands a batch scope's records there), and a snapshot reads the
sequence and the arenas under the same lock. The scalar stores are the
data store and, with rollups on, the rollup stores (kinds ``preagg`` and
``tier:<interval>:<agg>``); a rollup record replayed with rollups off
raises, naming ``tsd.rollups.enable``, where the reference drops it.
``T_ANNOT`` holds an annotation's JSON document (with its ``tsuid``)
and ``T_ANNOT_DEL`` a delete (``tsuid``, ``start``); replay stores or
deletes them without logging again. Single writer: one TSDB owns a
data_dir at a time.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import struct
import threading
import time
import zlib

import numpy as np

from opentsdb_tpu_torch.meta.annotation import Annotation
from opentsdb_tpu_torch.obs.trace import trace_begin, trace_end
from opentsdb_tpu_torch.utils.faults import call_with_retries

log = logging.getLogger("wal")

_HDR = struct.Struct("<BIQI")  # type, payload_len, seq, crc32
MAGIC = b"OTSDBWAL1\n"

T_SERIES = 1      # json {"k": kind, "sid": int, "m": name, "t": [[k,v]..]}
T_POINTS = 2      # bin: kind | sid i64 | n i32 | ts i64[n] f64[n] u8[n]
T_LINES = 3       # bin: kind | n i32 | sids i64[n] ts i64[n] f64[n] u8[n]
T_UID = 4         # json {"kind", "name"}
T_ANNOT = 5       # json annotation doc (+"tsuid")
T_ANNOT_DEL = 6   # json {"tsuid", "start"}
T_HIST = 7        # json {"m", "t", "ts"} \n blob bytes

_KIND = struct.Struct("<B")     # kind string length prefix
_SID_N = struct.Struct("<qi")   # sid, count
_N = struct.Struct("<i")        # count


def _pack_kind(kind: str) -> bytes:
    kb = kind.encode()
    return _KIND.pack(len(kb)) + kb


def _unpack_kind(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = _KIND.unpack_from(buf, off)
    off += _KIND.size
    return buf[off:off + n].decode(), off + n


def _pack_cols(ts, vals, flags) -> bytes:
    return (np.ascontiguousarray(ts, dtype=np.int64).tobytes()
            + np.ascontiguousarray(vals, dtype=np.float64).tobytes()
            + np.ascontiguousarray(flags, dtype=np.uint8).tobytes())


def _unpack_cols(buf: bytes, off: int, n: int):
    ts = np.frombuffer(buf, np.int64, n, off)
    off += 8 * n
    vals = np.frombuffer(buf, np.float64, n, off)
    off += 8 * n
    flags = np.frombuffer(buf, np.uint8, n, off)
    return ts, vals, flags


def _aligned(*arrays):
    """The arrays, each copied only where the record's framing left it
    unaligned for its type (the native store reads them as C arrays)."""
    return tuple(np.require(a, requirements=("C", "A")) for a in arrays)


class _WalBatch:
    """One request's records, buffered per thread (see
    :meth:`WriteAheadLog.batch`)."""

    __slots__ = ("records", "nbytes", "sync_wanted", "known")

    def __init__(self):
        self.records: list[tuple[int, bytes]] = []
        self.nbytes = 0
        self.sync_wanted = False
        self.known: set[tuple[str, int]] = set()


class WriteAheadLog:
    def __init__(self, wal_dir: str, fsync_mode: str = "always",
                 segment_bytes: int = 64 << 20,
                 interval_ms: int = 200, faults=None, retry=None,
                 resync_ms: int = 1000, group_window_ms: int = 0,
                 group_max_records: int = 4096,
                 group_max_bytes: int = 4 << 20):
        if fsync_mode not in ("always", "interval", "never"):
            raise ValueError(f"bad wal fsync mode {fsync_mode!r}")
        self.dir = wal_dir
        self.fsync_mode = fsync_mode
        self.segment_bytes = segment_bytes
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = threading.Lock()       # append framing and seq
        self._fh = None
        self._seq = 0
        self._written = 0   # bytes appended to the current segment
        self._synced_seq = 0
        # (kind, sid) pairs whose T_SERIES record is in the log
        self._known: set[tuple[str, int]] = set()
        self._closed = False
        self._interval_thread = None
        # close() sets it and joins the interval fsync thread
        self._interval_stop = threading.Event()
        # group commit: one leader fsyncs at a time, everyone else
        # acknowledges by sequence (_synced_seq >= their last record)
        self._commit_cond = threading.Condition()
        self._commit_leader = False
        self.group_window_s = max(group_window_ms, 0) / 1000.0
        self.group_max_records = max(int(group_max_records), 1)
        self.group_max_bytes = max(int(group_max_bytes), 1)
        self._bytes_appended = 0  # framed bytes ever appended
        self._bytes_synced = 0    # ... covered by a successful fsync
        self.group_syncs = 0        # physical fsync rounds
        self.records_synced = 0     # records those rounds covered
        self.piggybacked_syncs = 0  # sync() calls another round covered
        self.window_expiries = 0    # commit window closed by its timeout
        self.size_triggers = 0      # ... by the records/bytes caps
        self.idle_breaks = 0        # ... by a quiet log (lone writer)
        self._tls = threading.local()
        # degraded mode: appends are still accepted (the flag says the
        # log may not be durable) and a probe retries every resync_ms
        self._faults = faults          # FaultInjector or None
        self._retry = retry            # RetryPolicy or None (no retry)
        self._resync_s = max(resync_ms, 0) / 1000.0
        self.degraded = False
        self._degraded_until = 0.0
        # append health is tracked apart from fsync health: an fsync
        # outage must not shed appends (the next good fsync covers
        # them), a write outage must not pay the ladder per record
        self._append_failing = False
        # a segment closed at rotation without a good fsync: its
        # records stay non-durable until a snapshot covers them
        self.durability_hole = False
        self.sync_failures = 0    # fsync ladder exhaustions
        self.sync_retries = 0     # single retried fsyncs
        self.append_failures = 0  # write ladder exhaustions
        self.append_dropped = 0   # records shed while the log was down
        self.last_sync_error = ""
        if fsync_mode == "interval":
            self._interval_s = interval_ms / 1000.0
            t = threading.Thread(target=self._interval_loop,
                                 name="wal-fsync", daemon=True)
            self._interval_thread = t
            t.start()

    # -- segments ---------------------------------------------------------

    def _segments(self) -> list[str]:
        names = [n for n in os.listdir(self.dir)
                 if n.startswith("wal-") and n.endswith(".log")]
        # wal-<first seq, 20 digits>-<pid>.log sorts by first seq
        return [os.path.join(self.dir, n) for n in sorted(names)]

    def _open_segment(self) -> None:
        name = f"wal-{self._seq + 1:020d}-{os.getpid()}.log"
        self._fh = open(os.path.join(self.dir, name), "ab", buffering=0)
        if self._fh.tell() == 0:
            self._fh.write(MAGIC)
        self._written = self._fh.tell()

    # -- append side ------------------------------------------------------

    def _roll_segment_locked(self) -> bool:
        """Open or rotate the active segment when needed (the caller
        holds ``_lock``). False when the write path is down (the caller
        sheds its records)."""
        if self._fh is not None and self._written < self.segment_bytes:
            return True
        if self._fh is not None:
            # a sync() after this append fsyncs only the new segment:
            # the old one's tail must reach the disk now, or stand as a
            # durability hole until a snapshot covers it
            if not self._fsync_or_degrade(self._fh, "rotation fsync"):
                self.durability_hole = True
            try:
                self._fh.close()
            except OSError as exc:
                log.warning("wal segment close failed (%s); abandoning "
                            "handle", exc)
            self._fh = None
        try:
            self._open_segment()
        except OSError as exc:
            self.append_failures += 1
            self._append_failing = True
            self._note_degraded(exc, "segment open")
            return False
        return True

    def _write_framed_locked(self, blob: bytes) -> bool:
        """Write framed records to the active segment under the retry
        ladder (the caller holds ``_lock``); False: shed."""

        def write_rec():
            if self._faults is not None:
                self._faults.check("wal.append")
            self._fh.write(blob)

        try:
            call_with_retries(write_rec, self._retry, retryable=(OSError,))
        except OSError as exc:
            # the store write happened and is acknowledged; the record
            # is lost from the log, and the flag says so
            self.append_failures += 1
            self._append_failing = True
            self._note_degraded(exc, "append")
            return False
        self._written += len(blob)
        self._bytes_appended += len(blob)
        if self._append_failing:
            self._append_failing = False
            log.info("wal append recovered; records are logged again")
            if self.fsync_mode == "never":
                # no fsync path clears the flag in this mode
                self.degraded = False
        return True

    def _append(self, rtype: int, payload: bytes) -> int:
        """Frame and write one record. Returns its sequence number, -1
        when it was shed (the write path is degraded), or 0 inside a
        :meth:`batch` scope, where it is buffered until scope exit."""
        b = getattr(self._tls, "batch", None)
        if b is not None:
            b.records.append((rtype, payload))
            b.nbytes += _HDR.size + len(payload)
            return 0
        return self._append_batch([(rtype, payload)])

    def _append_batch(self, records: list[tuple[int, bytes]]) -> int:
        """Frame and write many records under one lock take and one
        ``write()``. Returns the last record's sequence number, or -1
        when the whole batch was shed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("WAL is closed")
            if self._append_failing and \
                    time.monotonic() < self._degraded_until:
                # the write path is down: shed, rather than pay the
                # retry ladder on every append
                self.append_dropped += len(records)
                return -1
            if not self._roll_segment_locked():
                return -1
            frames = []
            for rtype, payload in records:
                self._seq += 1
                frames.append(_HDR.pack(rtype, len(payload), self._seq,
                                        zlib.crc32(payload)) + payload)
            if not self._write_framed_locked(b"".join(frames)):
                return -1
            return self._seq

    # -- request-scoped batching -------------------------------------------

    @contextlib.contextmanager
    def batch(self):
        """Every record appended inside the scope is buffered per
        thread and lands as one framed write at scope exit; ``sync()``
        calls inside become at most one group-committed fsync there.
        The scope commits on an exception too: points the caller has
        written to the store stay on the durability path. Nested
        scopes join the outermost one."""
        if getattr(self._tls, "batch", None) is not None:
            yield self
            return
        b = self._tls.batch = _WalBatch()
        try:
            yield self
        finally:
            self._tls.batch = None
            self._commit_batch(b)

    def _commit_batch(self, b: _WalBatch) -> None:
        last = self._land(b)
        if b.sync_wanted and last != -1:
            self.sync(upto=last)

    def _land(self, b: _WalBatch) -> int | None:
        """Write a batch's buffered records and empty its buffer. The
        last record's sequence number, -1 when they were shed, None
        when there were none."""
        if not b.records:
            return None
        records, known = b.records, b.known
        b.records, b.nbytes, b.known = [], 0, set()
        try:
            last = self._append_batch(records)
        except RuntimeError:
            # closed mid-request (a shutdown race): the store writes
            # happened, so shed the records loudly instead of raising
            # from the scope's exit
            log.warning("wal closed mid-batch; %d record(s) shed",
                        len(records))
            self.append_dropped += len(records)
            return -1
        if last >= 0 and known:
            self._known.update(known)
        return last

    def flush_batch(self) -> None:
        """Write the records this thread's :meth:`batch` scope holds so
        far, so they take their sequence numbers now; the scope's fsync
        still waits for its exit. Nothing outside a scope."""
        b = getattr(self._tls, "batch", None)
        if b is not None:
            self._land(b)

    def _append_json(self, rtype: int, doc: dict) -> int:
        return self._append(rtype, json.dumps(doc).encode())

    def ensure_series(self, kind: str, sid: int, metric: str,
                      tags: dict[str, str]) -> None:
        """Log the (kind, sid) -> names mapping once per log, so point
        records can name bare series ids."""
        key = (kind, sid)
        if key in self._known:
            return
        doc = {"k": kind, "sid": sid, "m": metric,
               "t": sorted(tags.items())}
        b = getattr(self._tls, "batch", None)
        if b is not None:
            # known only once the batch's write lands (_commit_batch)
            if key not in b.known:
                b.known.add(key)
                self._append_json(T_SERIES, doc)
            return
        if self._append_json(T_SERIES, doc) >= 0:
            # a shed record stays unknown, so the mapping is logged
            # again before the series' next point
            self._known.add(key)

    def seed_known(self, kind: str, num_series: int) -> None:
        """Mark the series a loaded snapshot covers (its load order
        reproduces their numbering)."""
        self._known.update((kind, s) for s in range(num_series))

    def log_points(self, kind: str, sid: int, ts_ms, vals, flags) -> None:
        self._append(T_POINTS, _pack_kind(kind) + _SID_N.pack(sid, len(ts_ms))
                     + _pack_cols(ts_ms, vals, flags))

    def log_point(self, kind: str, sid: int, ts_ms: int, value: float,
                  is_int: bool) -> None:
        self._append(T_POINTS, _pack_kind(kind) + _SID_N.pack(sid, 1)
                     + struct.pack("<qdB", ts_ms, value, is_int))

    def log_lines(self, kind: str, sids, ts_ms, vals, flags) -> None:
        self._append(T_LINES, _pack_kind(kind) + _N.pack(len(sids))
                     + np.ascontiguousarray(sids, np.int64).tobytes()
                     + _pack_cols(ts_ms, vals, flags))

    def log_uid(self, kind: str, name: str) -> None:
        self._append_json(T_UID, {"kind": kind, "name": name})

    def log_annotation(self, doc: dict) -> None:
        self._append_json(T_ANNOT, doc)

    def log_annotation_delete(self, tsuid: str, start: int) -> None:
        self._append_json(T_ANNOT_DEL, {"tsuid": tsuid, "start": start})

    def log_histogram(self, metric: str, tags: dict[str, str],
                      ts: int, blob: bytes) -> None:
        """One histogram point: ``ts`` as the writer gave it (seconds or
        ms), the codec blob as it came."""
        head = json.dumps({"m": metric, "t": sorted(tags.items()),
                           "ts": ts}).encode()
        self._append(T_HIST, head + b"\n" + blob)

    def sync(self, upto: int | None = None) -> None:
        """Block until the caller's records are on disk (group commit;
        ``upto`` bounds the wait to that sequence number). Inside a
        :meth:`batch` scope this defers to one fsync at scope exit."""
        if self.fsync_mode != "always":
            return
        b = getattr(self._tls, "batch", None)
        if b is not None:
            b.sync_wanted = True
            return
        self._sync(upto)

    def _note_degraded(self, exc: Exception, context: str) -> None:
        """Enter (or extend) degraded mode after the retry ladder ran
        out; probes retry every ``resync_ms``."""
        self.last_sync_error = f"{context}: {type(exc).__name__}: {exc}"
        if not self.degraded:
            log.error("wal %s failing persistently (%s); running DEGRADED: "
                      "acknowledged writes may not be durable until the "
                      "disk recovers", context, exc)
        self.degraded = True
        self._degraded_until = time.monotonic() + self._resync_s

    def _fsync_or_degrade(self, fh, context: str) -> bool:
        """fsync under the retry ladder; running out degrades instead of
        raising. True when the data is known durable."""

        def do_fsync():
            if self._faults is not None:
                self._faults.check("wal.fsync")
            os.fsync(fh.fileno())

        def on_retry(attempt, exc):
            self.sync_retries += 1
            log.warning("wal fsync failed (attempt %d: %s); retrying",
                        attempt, exc)

        try:
            call_with_retries(do_fsync, self._retry, retryable=(OSError,),
                              on_retry=on_retry)
        except ValueError:
            # the segment was closed mid-sync by truncate, which fsyncs
            # before it closes: the target is durable
            return True
        except OSError as exc:
            self.sync_failures += 1
            self._note_degraded(exc, context)
            return False
        return True

    def _sync(self, upto: int | None = None) -> None:
        with self._lock:
            target = self._seq if upto is None else min(upto, self._seq)
        if self._synced_seq >= target:
            return
        # the group-commit wait a request pays, leader or piggyback: a
        # ``wal.commit_wait`` span (one thread-local read untraced)
        h = trace_begin("wal.commit_wait")
        try:
            self._sync_inner(target)
        finally:
            trace_end(h)

    def _sync_inner(self, target: int) -> None:
        if self.degraded and time.monotonic() < self._degraded_until:
            # shed durability work until the next probe
            return
        # one commit round at a time; the others wait and acknowledge
        # by sequence. The leader always gives up leadership and
        # notifies, and waiters re-check the degraded window on every
        # wake, so a failed round strands no one.
        with self._commit_cond:
            while True:
                if self._synced_seq >= target:
                    self.piggybacked_syncs += 1
                    return
                if self._closed:
                    return
                if self.degraded and \
                        time.monotonic() < self._degraded_until:
                    return
                if not self._commit_leader:
                    self._commit_leader = True
                    break
                self._commit_cond.wait(0.05)
        try:
            self._commit_once()
        finally:
            with self._commit_cond:
                self._commit_leader = False
                self._commit_cond.notify_all()

    def _commit_window_wait(self) -> None:
        """The leader's bounded commit window, cut short by the caps
        and by a quiet log (no append during a poll slice): waiters'
        records are already appended, so once the log stops growing
        more waiting is only latency. A lone writer pays at most about
        one poll slice."""
        deadline = time.monotonic() + self.group_window_s
        slice_s = min(self.group_window_s, 0.001)
        while True:
            with self._lock:
                pending = self._seq - self._synced_seq
                pending_bytes = self._bytes_appended - self._bytes_synced
            if pending >= self.group_max_records or \
                    pending_bytes >= self.group_max_bytes:
                self.size_triggers += 1
                return
            now = time.monotonic()
            if now >= deadline:
                self.window_expiries += 1
                return
            time.sleep(min(deadline - now, slice_s))
            with self._lock:
                grew = self._seq - self._synced_seq > pending
            if not grew:
                self.idle_breaks += 1
                return

    def _commit_once(self) -> None:
        """One physical commit round (the caller leads): the window if
        any, then one fsync covering every record appended until the
        capture point."""
        if self.group_window_s > 0.0 and self.fsync_mode == "always" \
                and not self._closed:
            self._commit_window_wait()
        with self._lock:
            target = self._seq
            covered_bytes = self._bytes_appended
            fh = self._fh
        if fh is None or self._synced_seq >= target:
            # no segment: a truncate fsynced and closed it, so all
            # earlier records are durable, unless a rotation closed one
            # without a good fsync (the hole stands until a snapshot)
            if not self.durability_hole:
                self._synced_seq = max(self._synced_seq, target)
                self._bytes_synced = max(self._bytes_synced,
                                         covered_bytes)
            return
        if not self._fsync_or_degrade(fh, "fsync"):
            return   # the next good probe covers the records
        self.group_syncs += 1
        self.records_synced += target - self._synced_seq
        self._synced_seq = target
        self._bytes_synced = max(self._bytes_synced, covered_bytes)
        if self.degraded:
            log.info("wal fsync recovered after %d failure(s); durability "
                     "restored", self.sync_failures)
            self.degraded = False

    def _interval_loop(self) -> None:
        while not self._interval_stop.wait(self._interval_s):
            try:
                self._sync()
            except (OSError, ValueError):  # pragma: no cover
                if self._closed:
                    return
                log.exception("wal interval fsync failed")

    # -- state --------------------------------------------------------------

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def sync_lag(self) -> int:
        """Records appended but not yet fsynced (0 when healthy in
        ``always`` mode)."""
        with self._lock:
            return max(self._seq - self._synced_seq, 0)

    def records_per_sync(self) -> float:
        """Mean records per physical fsync round (1.0: no batching)."""
        if not self.group_syncs:
            return 0.0
        return self.records_synced / self.group_syncs

    def health_info(self) -> dict:
        return {
            "fsync_mode": self.fsync_mode,
            "last_seq": self.last_seq(),
            "synced_seq": self._synced_seq,
            "sync_lag": self.sync_lag(),
            "degraded": self.degraded,
            "durability_hole": self.durability_hole,
            "sync_failures": self.sync_failures,
            "sync_retries": self.sync_retries,
            "append_failures": self.append_failures,
            "append_dropped": self.append_dropped,
            "last_sync_error": self.last_sync_error,
            "group_window_ms": round(self.group_window_s * 1000.0, 3),
            "group_syncs": self.group_syncs,
            "records_synced": self.records_synced,
            "records_per_sync": round(self.records_per_sync(), 2),
            "piggybacked_syncs": self.piggybacked_syncs,
            "window_expiries": self.window_expiries,
            "size_triggers": self.size_triggers,
            "idle_breaks": self.idle_breaks,
        }

    def collect_stats(self, collector) -> None:
        collector.record("wal.sync_lag", self.sync_lag())
        collector.record("wal.sync_failures", self.sync_failures)
        collector.record("wal.sync_retries", self.sync_retries)
        collector.record("wal.append_failures", self.append_failures)
        collector.record("wal.append_dropped", self.append_dropped)
        collector.record("wal.degraded", int(self.degraded))
        collector.record("wal.group_syncs", self.group_syncs)
        collector.record("wal.records_per_sync",
                         round(self.records_per_sync(), 2))
        collector.record("wal.piggybacked_syncs", self.piggybacked_syncs)
        collector.record("wal.window_expiries", self.window_expiries)
        collector.record("wal.size_triggers", self.size_triggers)
        collector.record("wal.idle_breaks", self.idle_breaks)

    def truncate(self, upto_seq: int) -> int:
        """Delete the segments a snapshot with ``wal_applied_seq =
        upto_seq`` covers, and rotate the active one so the next
        truncate can delete it. Returns the segments deleted."""
        deleted = 0
        with self._lock:
            if self._fh is not None:
                # records past upto_seq may live in this segment: fsync
                # before closing. On a broken disk it stays open, so
                # later probes can still fsync its tail.
                if self._fsync_or_degrade(self._fh, "truncate fsync"):
                    self._fh.close()
                    self._fh = None  # reopened on the next append
                    self._synced_seq = self._seq
                    self._bytes_synced = self._bytes_appended
                    # the snapshot covers every earlier record
                    self.durability_hole = False
            active = self._fh.name if self._fh is not None else None
            for path in self._segments():
                if path == active:
                    continue
                last = _segment_last_seq(path)
                if last is not None and last <= upto_seq:
                    os.unlink(path)
                    deleted += 1
        return deleted

    def close(self) -> None:
        self._closed = True
        # stop and join the interval thread first, outside every lock
        # (its _sync takes them)
        self._interval_stop.set()
        t, self._interval_thread = self._interval_thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)
        with self._commit_cond:
            self._commit_cond.notify_all()
        with self._lock:
            if self._fh is not None:
                try:
                    os.fsync(self._fh.fileno())
                except OSError:  # pragma: no cover
                    pass
                self._fh.close()
                self._fh = None

    # -- replay side ------------------------------------------------------

    def replay(self, tsdb, applied_seq: int) -> int:
        """Apply the records with seq > ``applied_seq``; returns the
        points recovered. Resumes the sequence past every record seen,
        so new appends never reuse a number. A record the port cannot
        apply raises: nothing is skipped."""
        recovered = 0
        sid_maps: dict[str, dict[int, int]] = {}
        series_run: list[bytes] = []
        max_seq = applied_seq
        segments = self._segments()
        for i, path in enumerate(segments):
            tail: dict = {}
            for rtype, seq, payload in _read_segment(path, tail=tail):
                max_seq = max(max_seq, seq)
                if seq <= applied_seq:
                    continue
                if rtype == T_SERIES:
                    # a run of series records decodes and resolves in
                    # bulk
                    series_run.append(payload)
                    continue
                if series_run:
                    self._apply_series(tsdb, series_run, sid_maps)
                    series_run = []
                recovered += self._apply(tsdb, rtype, seq, payload,
                                         sid_maps)
            if i == len(segments) - 1:
                self._truncate_torn_tail(path, tail)
        if series_run:
            self._apply_series(tsdb, series_run, sid_maps)
        with self._lock:
            self._seq = max(self._seq, max_seq)
            self._synced_seq = self._seq
        return recovered

    @staticmethod
    def _truncate_torn_tail(path: str, tail: dict) -> None:
        """Cut a crash's partial last record off the last segment, so
        the file ends at its last intact record and later replays do
        not meet it again. Never raises."""
        if not tail.get("torn"):
            return
        good_end = tail.get("good_end", 0)
        if good_end < len(MAGIC):
            # bad or partial magic: nothing to keep; the segment is left
            # for inspection (replay skips it)
            return
        try:
            size = os.path.getsize(path)
            if good_end < size:
                os.truncate(path, good_end)
                log.warning("wal: truncated torn tail of %s (%d -> %d "
                            "bytes)", path, size, good_end)
        except OSError:  # pragma: no cover - best-effort repair
            log.exception("wal: could not truncate torn tail of %s", path)

    @staticmethod
    def _store_for(tsdb, kind: str):
        """The store of a record's kind (ref: ``_store_for``): ``data``,
        ``preagg`` or ``tier:<interval>:<agg>``. A rollup record with
        rollups off, or of a tier the config no longer holds, raises
        (the reference logs the error and drops the record)."""
        if kind == "data":
            return tsdb.store
        if kind == "preagg" or kind.startswith("tier:"):
            rollups = tsdb.rollup_store
            if rollups is None:
                raise ValueError(
                    f"the WAL holds a record of the rollup store {kind!r}, "
                    "but rollups are off: set tsd.rollups.enable=true to "
                    "replay it")
            if kind == "preagg":
                return rollups.preagg_store()
            _, interval, agg = kind.split(":", 2)
            return rollups.tier(interval, agg)
        raise ValueError(f"unknown wal store kind {kind!r}")

    def _apply_series(self, tsdb, payloads: list[bytes],
                      sid_maps: dict) -> None:
        """Resolve a run of T_SERIES records: one JSON decode for the
        run, then for each run of one kind and one metric one bulk UID
        resolution and one bulk series creation, in log order, so UIDs
        and series ids are assigned as record-by-record replay would
        assign them."""
        docs = json.loads(b"[" + b",".join(payloads) + b"]")
        for (kind, metric), run in itertools.groupby(
                docs, key=lambda d: (d["k"], d["m"])):
            run = list(run)
            store = self._store_for(tsdb, kind)
            metric_id, tag_ids = tsdb._resolve_uids(
                metric, [dict(d["t"]) for d in run], create=True)
            reals = store.get_or_create_series_bulk(metric_id,
                                                    tag_ids).tolist()
            wal_sids = [d["sid"] for d in run]
            sid_maps.setdefault(kind, {}).update(zip(wal_sids, reals))
            # a drifted sid stays unknown: a later series that reuses
            # it must log its own T_SERIES record
            self._known.update((kind, r) for w, r in zip(wal_sids, reals)
                               if w == r)

    def _apply(self, tsdb, rtype: int, seq: int, payload: bytes,
               sid_maps: dict) -> int:
        if rtype == T_POINTS:
            kind, off = _unpack_kind(payload, 0)
            wal_sid, n = _SID_N.unpack_from(payload, off)
            ts_arr, vals, flags = _aligned(
                *_unpack_cols(payload, off + _SID_N.size, n))
            store = self._store_for(tsdb, kind)
            # a sid with no T_SERIES record predates this log: the
            # snapshot's load recreated it under the same number
            sid = sid_maps.get(kind, {}).get(wal_sid, wal_sid)
            store.append_many(sid, ts_arr, vals, flags)
            return n
        if rtype == T_LINES:
            kind, off = _unpack_kind(payload, 0)
            (n,) = _N.unpack_from(payload, off)
            off += _N.size
            sids, ts_arr, vals, flags = _aligned(
                np.frombuffer(payload, np.int64, n, off),
                *_unpack_cols(payload, off + 8 * n, n))
            m = sid_maps.get(kind)
            if m:
                # remap through a lookup into a fresh array: in-place
                # substitution corrupts chained maps like {6: 5, 5: 6}
                keys = np.asarray(sorted(m), np.int64)
                lut = np.asarray([m[k] for k in keys.tolist()], np.int64)
                pos = np.minimum(np.searchsorted(keys, sids), len(keys) - 1)
                sids = np.where(keys[pos] == sids, lut[pos], sids)
            store = self._store_for(tsdb, kind)
            return store.append_lines(sids, ts_arr, vals, flags)
        if rtype == T_UID:
            doc = json.loads(payload)
            tsdb.uids.by_kind(doc["kind"]).get_or_create_id(doc["name"])
            return 0
        if rtype == T_HIST:
            head, _, blob = payload.partition(b"\n")
            doc = json.loads(head)
            tsdb.add_histogram_point(doc["m"], doc["ts"], blob,
                                     dict(doc["t"]), _wal=False,
                                     create=True)
            return 1
        if rtype == T_ANNOT:
            tsdb.annotations.store(Annotation.from_json(json.loads(payload)),
                                   _wal=False)
            return 0
        if rtype == T_ANNOT_DEL:
            doc = json.loads(payload)
            tsdb.annotations.delete(doc["tsuid"], doc["start"], _wal=False)
            return 0
        raise ValueError(f"wal: unknown record type {rtype} at seq={seq}")


def _read_segment(path: str, tail: dict | None = None):
    """Yield (type, seq, payload) until the end of the file or its first
    torn or corrupt record (normal after a crash: only the fsynced
    prefix counts).

    ``tail``, when given, receives ``good_end`` (the byte offset past
    the last intact record) and ``torn`` (bytes past it that form no
    valid record), for :meth:`WriteAheadLog.replay` to repair the file.
    """
    if tail is None:
        tail = {}
    tail.update(good_end=0, torn=False)
    try:
        with open(path, "rb") as fh:
            magic = fh.read(len(MAGIC))
            if magic != MAGIC:
                log.warning("wal: %s has bad magic; skipped", path)
                tail["torn"] = bool(magic)
                return
            tail["good_end"] = len(MAGIC)
            while True:
                hdr = fh.read(_HDR.size)
                if not hdr:
                    return
                if len(hdr) < _HDR.size:
                    log.warning("wal: partial record header at end of %s; "
                                "replay stops here", path)
                    tail["torn"] = True
                    return
                rtype, plen, seq, crc = _HDR.unpack(hdr)
                payload = fh.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    log.warning("wal: torn or corrupt record in %s at "
                                "seq=%d; replay stops here", path, seq)
                    tail["torn"] = True
                    return
                tail["good_end"] += _HDR.size + plen
                yield rtype, seq, payload
    except OSError:  # pragma: no cover
        log.exception("wal: cannot read %s", path)


def _segment_last_seq(path: str) -> int | None:
    last = None
    for _, seq, _ in _read_segment(path):
        last = seq
    return last
