"""Per-peer durable write spool: the no-loss half of the handoff (ref:
``opentsdb_tpu/cluster/spool.py``).

When a shard is unreachable (dead, hung, breaker open), the router
must still acknowledge client writes — the reference reaches for a
``StorageExceptionHandler`` plugin to requeue failed RPCs
(``PutDataPointRpc`` SEH spool); here the spool is built in and framed
exactly like the WAL (:mod:`opentsdb_tpu_torch.core.wal`): an append-only
file of ``[len u32 | seq u64 | crc32 u32 | payload]`` records behind a
magic header, fsync'd before the client's write is acknowledged. A
torn tail (crash mid-append) fails the CRC and replay stops at the
acknowledged prefix.

Replay tracks its position in a sidecar ``.offset`` file updated
*after* each record is applied — a crash between apply and offset
update replays that record once more, which is harmless: the peer's
point store dedupes ``(ts, value)`` last-write-wins. When the spool
fully drains the file truncates back to the magic header.

FIFO discipline: while a peer's spool is non-empty, NEW writes for
that peer enqueue behind it instead of racing past — so for
*causally ordered* writes (the second issued after the first was
acknowledged) a same-(series, ts) rewrite is never clobbered by an
older spooled value. Writes concurrently in flight while a peer
fails have no defined order, exactly as two concurrent puts to one
standalone TSD don't: one may forward directly while the other lands
in the spool.

With no directory configured (no ``data_dir`` and no
``tsd.cluster.spool.dir``) the spool degrades to an in-memory queue:
the no-loss guarantee then only spans the router process's lifetime,
reported as ``durable: false`` in ``/api/health``.
"""

from __future__ import annotations

import collections
import logging
import os
import struct
import threading
import zlib

LOG = logging.getLogger("cluster.spool")

MAGIC = b"OTSDBSPOOL1\n"
_HDR = struct.Struct("<IQI")  # payload_len, seq, crc32


class SpoolFull(RuntimeError):
    """The spool hit ``tsd.cluster.spool.max_mb``: the write must be
    refused (reported per-point to the client) — silently dropping the
    oldest record would break the no-loss guarantee."""


class PeerSpool:
    """One peer's durable FIFO of serialized forward bodies."""

    def __init__(self, directory: str | None, name: str,
                 max_bytes: int = 256 << 20,
                 compact_bytes: int = 4 << 20):
        self._lock = threading.Lock()
        # serializes whole replay passes: two concurrent replayers
        # would both apply the head record and then pop TWO records —
        # the second one never applied (held across apply_fn, so it
        # must never be taken while holding self._lock)
        self._replay_lock = threading.Lock()
        self.name = name
        self.max_bytes = int(max_bytes)
        self.compact_bytes = int(compact_bytes)
        self.durable = bool(directory)
        self.appended_records = 0
        self.replayed_records = 0
        self.rejected_full = 0
        # >= 0: file end a failed torn-append rollback still owes us
        # (appends refuse until the truncate finally succeeds)
        self._dirty_end = -1
        if not directory:
            self._queue: collections.deque[bytes] = collections.deque()
            self._mem_bytes = 0
            self.path = self.offset_path = ""
            return
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.spool")
        self.offset_path = self.path + ".offset"
        self._fh = None
        self._offset = self._load_offset()
        # startup scan: count the pending tail (and stop at a torn
        # record, truncating it off like WAL replay does)
        self._pending, self._pending_bytes, good_end = self._scan()
        if good_end < len(MAGIC):
            # missing or magic-less file: the sidecar offset belongs
            # to a spool that no longer exists — forget it, or replay
            # would seek past EOF forever while appends pile up
            self._offset = 0
        elif self._offset > good_end:
            # stale sidecar PAST the scanned end (crash between the
            # drained-spool truncate and the offset rewrite, or a
            # mangled sidecar): same seek-past-EOF wedge — new
            # appends would never drain. Reset to the header and
            # replay the whole readable file: duplicates are
            # harmless (peer point store dedupes last-write-wins),
            # silent loss is not.
            self._offset = len(MAGIC)
            self._pending, self._pending_bytes, good_end = \
                self._scan()
        self._repair_tail(good_end)

    # ---------------- durable file form ----------------

    def _load_offset(self) -> int:
        try:
            with open(self.offset_path, "r", encoding="ascii") as fh:
                return max(int(fh.read().strip() or 0), 0)
        except (OSError, ValueError):
            return 0

    def _save_offset_locked(self) -> None:
        tmp = self.offset_path + ".tmp"
        with open(tmp, "w", encoding="ascii") as fh:
            fh.write(str(self._offset))
            fh.flush()
            # the replay position must
            # be durable before the record counts as applied; the
            # lock serializes exactly the append-vs-replay race
            os.fsync(fh.fileno())
        os.replace(tmp, self.offset_path)

    def _scan(self) -> tuple[int, int, int]:
        """(pending records, pending bytes, good_end offset) from the
        current offset to the last intact record."""
        pending = nbytes = 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0, 0, 0
        good_end = len(MAGIC)
        try:
            with open(self.path, "rb") as fh:
                if fh.read(len(MAGIC)) != MAGIC:
                    LOG.warning("spool %s has bad magic; starting "
                                "fresh", self.path)
                    return 0, 0, 0
                pos = len(MAGIC)
                while pos < size:
                    hdr = fh.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    plen, _seq, crc = _HDR.unpack(hdr)
                    payload = fh.read(plen)
                    if len(payload) < plen or \
                            zlib.crc32(payload) != crc:
                        LOG.warning("spool %s torn at offset %d; "
                                    "replay stops there",
                                    self.path, pos)
                        break
                    pos += _HDR.size + plen
                    good_end = pos
                    if pos > max(self._offset, len(MAGIC)):
                        pending += 1
                        nbytes += plen
        except OSError:
            LOG.exception("cannot scan spool %s", self.path)
        return pending, nbytes, good_end

    def _repair_tail(self, good_end: int) -> None:
        if good_end < len(MAGIC):
            # bad magic: drop the unreadable content so _open_locked
            # rewrites a fresh header instead of appending after junk
            try:
                if os.path.exists(self.path):
                    os.truncate(self.path, 0)
            except OSError:  # pragma: no cover - best-effort repair
                pass
            return
        try:
            size = os.path.getsize(self.path)
            if good_end < size:
                os.truncate(self.path, good_end)
                LOG.warning("spool %s: truncated torn tail "
                            "(%d -> %d bytes)", self.path, size,
                            good_end)
        except OSError:  # pragma: no cover - best-effort repair
            pass

    def _open_locked(self):
        if self._fh is None:
            self._fh = open(self.path, "ab", buffering=0)
            if self._fh.tell() == 0:
                self._fh.write(MAGIC)
        return self._fh

    # ---------------- public surface ----------------

    @property
    def pending_records(self) -> int:
        with self._lock:
            if not self.durable:
                return len(self._queue)
            return self._pending

    @property
    def pending_bytes(self) -> int:
        with self._lock:
            if not self.durable:
                return self._mem_bytes
            return self._pending_bytes

    def append(self, payload: bytes) -> None:
        """Durably enqueue one forward body (fsync before return —
        the client's ack rides on this). Raises :class:`SpoolFull`
        past the byte cap."""
        with self._lock:
            if not self.durable:
                if self._mem_bytes + len(payload) > self.max_bytes:
                    self.rejected_full += 1
                    raise SpoolFull(
                        f"spool for {self.name} is full "
                        f"({self.max_bytes} bytes)")
                self._queue.append(payload)
                self._mem_bytes += len(payload)
                self.appended_records += 1
                return
            if self._pending_bytes + len(payload) > self.max_bytes:
                self.rejected_full += 1
                raise SpoolFull(
                    f"spool for {self.name} is full "
                    f"({self.max_bytes} bytes)")
            if self._dirty_end >= 0:
                # a previous torn-append rollback could not truncate:
                # heal now or keep refusing — appending after torn
                # bytes would get this record truncated away later
                os.truncate(self.path, self._dirty_end)
                self._dirty_end = -1
            fh = self._open_locked()
            rec = _HDR.pack(len(payload), self.appended_records + 1,
                            zlib.crc32(payload)) + payload
            start = fh.tell()
            try:
                fh.write(rec)
                # the client's ack rides
                # on this fsync (no-loss handoff); the lock enforces
                # the spool's FIFO discipline across appenders
                os.fsync(fh.fileno())
            except OSError:
                # roll the torn record back out of the file: the
                # client is refused (correct), but if the partial
                # bytes stayed, LATER acked appends would land after
                # them and _drop_tail_locked would truncate those
                # acked records away when replay hit the torn one
                try:
                    fh.close()
                except OSError:  # pragma: no cover
                    pass
                self._fh = None
                try:
                    os.truncate(self.path, start)
                except OSError:
                    # remember the debt: every later append must
                    # retry this truncate first (and refuse on
                    # failure), or it would land after the torn
                    # bytes and be lost to the corrupt-record heal
                    self._dirty_end = start
                    LOG.exception("cannot roll back torn append in "
                                  "spool %s", self.path)
                raise
            self.appended_records += 1
            self._pending += 1
            self._pending_bytes += len(payload)

    def replay(self, apply_fn, max_records: int = 0) -> int:
        """Apply pending records in order through ``apply_fn(payload)``
        (which raises on failure — replay stops there, position kept).
        Returns records applied; a fully-drained durable spool
        truncates back to the magic header."""
        applied = 0
        with self._replay_lock:
            while max_records <= 0 or applied < max_records:
                with self._lock:
                    if not self.durable:
                        payload = self._queue[0] if self._queue \
                            else None
                    else:
                        payload = self._read_at_offset_locked()
                if payload is None:
                    break
                apply_fn(payload)  # raises => stop, position unchanged
                with self._lock:
                    if not self.durable:
                        self._queue.popleft()
                        self._mem_bytes -= len(payload)
                    else:
                        self._offset = max(self._offset, len(MAGIC)) \
                            + _HDR.size + len(payload)
                        self._pending -= 1
                        self._pending_bytes -= len(payload)
                        self._save_offset_locked()
                        if self._pending == 0:
                            self._truncate_locked()
                        elif self._offset - len(MAGIC) > \
                                max(self.compact_bytes,
                                    self._pending_bytes) and \
                                self._dirty_end < 0:
                            # the drained-at-zero truncate never
                            # fires on a spool that oscillates
                            # without fully draining: drop the
                            # replayed prefix once it outgrows the
                            # pending tail, or the file accretes
                            # replayed records without bound
                            self._compact_locked()
                    self.replayed_records += 1
                applied += 1
        return applied

    def _read_at_offset_locked(self) -> bytes | None:
        if self._pending <= 0:
            return None
        try:
            with open(self.path, "rb") as fh:
                fh.seek(max(self._offset, len(MAGIC)))
                hdr = fh.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return None
                plen, _seq, crc = _HDR.unpack(hdr)
                payload = fh.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    LOG.warning("spool %s: corrupt record at replay "
                                "offset %d; dropping the tail",
                                self.path, self._offset)
                    # TRUNCATE the unreadable tail (not just zero the
                    # counters): otherwise later appends land after
                    # the corrupt bytes and every replay re-reads the
                    # corrupt head and declares the spool empty — the
                    # new records would never drain
                    self._drop_tail_locked()
                    return None
                return payload
        except OSError:
            LOG.exception("cannot read spool %s", self.path)
            return None

    def _drop_tail_locked(self) -> None:
        """Cut the file back to the replay offset after a mid-file
        corrupt record (caller holds ``self._lock``)."""
        try:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            os.truncate(self.path, max(self._offset, len(MAGIC)))
        except OSError:  # pragma: no cover - disk trouble
            LOG.exception("cannot truncate corrupt spool %s",
                          self.path)
        self._pending = 0
        self._pending_bytes = 0

    def _compact_locked(self) -> None:
        """Rewrite the file without the replayed prefix (caller holds
        ``self._lock``). Crash ordering: the offset resets to the
        header BEFORE the file is replaced — a crash in between
        replays the old prefix again (duplicates, deduped last-write-
        wins on the peer), never the reverse (an offset pointing
        mid-record into the compacted file would read garbage and
        the torn-tail heal would drop acked records)."""
        tmp = self.path + ".compact"
        try:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            with open(self.path, "rb") as src:
                src.seek(self._offset)
                tail = src.read()
            with open(tmp, "wb") as dst:
                dst.write(MAGIC + tail)
                dst.flush()
                # compaction rewrites
                # the file appends race against; holding the lock for
                # the (bounded, compact_mb-sized) copy IS the safety
                os.fsync(dst.fileno())
            self._offset = len(MAGIC)
            self._save_offset_locked()
            os.replace(tmp, self.path)
            dfd = os.open(os.path.dirname(self.path), os.O_RDONLY)
            try:
                # directory fsync pins
                # the rename; same bounded compaction critical section
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - disk trouble
            LOG.exception("cannot compact spool %s", self.path)
            # the offset may already point at the header while the
            # old file survived: resync the counters from a fresh
            # scan, or a later drained-at-zero truncate could fire
            # at the wrong position and drop acked records
            self._pending, self._pending_bytes, good_end = \
                self._scan()
            self._repair_tail(good_end)

    def _truncate_locked(self) -> None:
        try:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            os.truncate(self.path, len(MAGIC))
            self._offset = len(MAGIC)
            self._save_offset_locked()
        except OSError:  # pragma: no cover - disk trouble
            LOG.exception("cannot truncate drained spool %s",
                          self.path)

    def close(self) -> None:
        with self._lock:
            if self.durable and self._fh is not None:
                try:
                    self._fh.close()
                except OSError:  # pragma: no cover
                    pass
                self._fh = None

    def health_info(self) -> dict:
        return {
            "durable": self.durable,
            "pending_records": self.pending_records,
            "pending_bytes": self.pending_bytes,
            "appended_records": self.appended_records,
            "replayed_records": self.replayed_records,
            "rejected_full": self.rejected_full,
        }
