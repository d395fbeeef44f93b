"""Binary columnar cluster wire: persistent framed router↔shard links
(ref: ``opentsdb_tpu/cluster/wire.py``; its bytes exactly).

Per-request JSON HTTP forwarding tears the front doors' columnar
batches back into per-point dicts on every router↔shard hop. This
module keeps both data paths columnar end to end over ONE persistent
connection per peer and direction:

- **frames** are the spool's proven ``len|seq|crc`` shape
  (:mod:`opentsdb_tpu_torch.cluster.spool`) lifted to the socket: a
  17-byte
  ``<IIBQ`` header (payload length, CRC32, frame type, sequence)
  followed by the payload. A short read, CRC mismatch or oversized
  length means the stream is torn — the connection dies, exactly like
  a torn spool tail truncates the file. No resync is attempted:
  reconnect + retry (writes are idempotent last-write-wins per
  series) is the recovery story.
- **writes** (``T_WRITE`` → ``T_WRITE_ACK``) carry series-grouped
  column blocks: per group a metric, a tags JSON blob, ``int64``
  timestamps, ``float64`` values and a packed int-ness bitmask. The
  shard lands a delivered block through ``TSDB.add_point_groups`` —
  one WAL write, one group-committed fsync, zero intermediate JSON.
  Requests PIPELINE: concurrent router deliveries interleave on the
  socket and complete by sequence-matched acks, bounded by
  ``tsd.cluster.wire.max_inflight``; past the bound the router sheds
  the batch into the peer's durable spool (:class:`WireBacklogged`)
  instead of blocking — spool-style backpressure, never a stall.
- **reads** (``T_QUERY`` → ``T_QRES``* → ``T_QDONE``) stream each
  sub-query's partial grids as framed column blocks AS THE SHARD
  FINISHES THEM, so the router's incremental merge
  (``cluster/merge.StreamMerger``) tracks the slowest shard's first
  byte, not its last.
- **negotiation**: the router opens with ``MAGIC`` + a ``T_HELLO``
  frame. A version-matched shard answers ``T_HELLO_ACK``; anything
  else — an old server routing ``TSDW`` to its telnet parser, a
  closed socket from a ``tsd.cluster.wire.enable=false`` gate, a
  version mismatch — fails the handshake and marks the peer
  HTTP-only for ``tsd.cluster.wire.fallback_ttl_ms``
  (:class:`WireUnsupported`). JSON HTTP remains a first-class
  transport: version skew degrades throughput, never correctness.
- **failure contracts** carry over exactly: transport failures raise
  ``OSError`` subclasses so the router's breaker/spool/degraded
  machinery fires unchanged; :class:`WireUnsupported`,
  :class:`WireBacklogged` and :class:`WireEncodeError` deliberately
  do NOT subclass ``OSError`` — they reroute (to HTTP or the spool)
  without recording a peer failure the peer never committed. Trace
  identity rides a frame header field (the ``X-TSD-Trace``
  equivalent), and the ``cluster.wire`` / ``cluster.wire.<peer>``
  fault sites inject into the wire exchange exactly like
  ``cluster.peer`` injects into HTTP.

Encoding is STRICT on the write path: only canonical datapoints
(``{metric, timestamp, value, tags}`` with a real ``int``/``float``
value and all-string tags) are wire-encodable. Anything else — string
values, exotic key sets, >2^53 integers — raises
:class:`WireEncodeError` and the whole batch falls back to JSON HTTP,
where the shard's validation answers byte-identically to today. The
wire never widens or narrows the accept set.
"""

from __future__ import annotations

import json
import logging
import queue as queue_mod
import socket
import struct
import threading
import time
import zlib
from typing import Any

import asyncio

import numpy as np

from opentsdb_tpu_torch.obs.trace import (TRACE_HEADER, trace_begin,
                                          trace_end)

LOG = logging.getLogger("cluster.wire")

#: connection preamble the server sniffs (4 bytes, like HTTP methods)
MAGIC = b"TSDW"
WIRE_VERSION = 1
#: frames above this are protocol damage, not data (the spool's
#: sanity-bound idiom): a torn length field must not allocate 4 GiB
MAX_FRAME = 1 << 26

_HDR = struct.Struct("<IIBQ")  # payload_len, crc32, frame type, seq
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

T_HELLO = 1       # router -> shard: {"v": WIRE_VERSION}
T_HELLO_ACK = 2   # shard -> router: {"v": WIRE_VERSION}
T_WRITE = 3       # router -> shard: columnar put batch
T_WRITE_ACK = 4   # shard -> router: u16 status + put-summary body
T_QUERY = 5       # router -> shard: trace + TSQuery JSON body
T_QRES = 6        # shard -> router: one chunk of partial grids
T_QDONE = 7       # shard -> router: u16 status + error body (if any)
T_CQ = 8          # router -> shard: continuous-query control op
T_CQ_RES = 9      # shard -> router: u16 status + JSON body

_DP_KEYS = frozenset({"metric", "timestamp", "value", "tags"})


class WireUnsupported(RuntimeError):
    """The peer does not (currently) speak this wire version: fall
    back to JSON HTTP. NOT an ``OSError`` — the peer is alive, so the
    breaker must not record a failure it never committed."""


class WireBacklogged(RuntimeError):
    """The peer's wire pipeline is at ``max_inflight``: shed this
    batch into the durable spool instead of blocking the router. NOT
    an ``OSError`` — backpressure is not peer damage."""


class WireEncodeError(RuntimeError):
    """The batch is not canonically wire-encodable (string values,
    exotic keys, >2^53 integers): deliver it over JSON HTTP so shard
    validation answers exactly as it always has."""


class WireProtocolError(Exception):
    """The frame stream is torn (bad CRC, oversized length, trailing
    bytes): the connection is unrecoverable and must close."""


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def _frame(ftype: int, seq: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise WireEncodeError(
            f"frame payload of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME}-byte wire bound")
    return _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF,
                     ftype, seq) + payload


def encode_status(status: int, body: bytes = b"") -> bytes:
    """``T_WRITE_ACK`` / ``T_QDONE`` payload: the HTTP exchange's
    (status, body) tuple, verbatim — summary docs, structured errors
    and no-such-name 400 bodies cross the wire unchanged so every
    router-side body check keeps working."""
    return _U16.pack(int(status) & 0xFFFF) + (body or b"")


def decode_status(payload: bytes) -> tuple[int, bytes]:
    (status,) = _U16.unpack_from(payload, 0)
    return status, payload[2:]


def encode_query(trace: str, body: bytes) -> bytes:
    tb = (trace or "").encode("utf-8")
    if len(tb) > 0xFFFF:
        tb = b""  # a malformed giant header is droppable, not fatal
    return _U16.pack(len(tb)) + tb + body


def decode_query(payload: bytes) -> tuple[str, bytes]:
    (tl,) = _U16.unpack_from(payload, 0)
    return payload[2:2 + tl].decode("utf-8", "replace"), \
        payload[2 + tl:]


def encode_cq(trace: str, method: str, path: str,
              body: bytes) -> bytes:
    """``T_CQ`` payload: one continuous-query control op — register,
    delete, pull, delta drain — as an HTTP-shaped (method, path,
    body) replay. The shard routes it through the REAL HTTP handler,
    so QoS gates, fault sites and chaos hangs cover the wire path
    identically to the JSON path."""
    tb = (trace or "").encode("utf-8")
    if len(tb) > 0xFFFF:
        tb = b""
    mb = method.encode("ascii")
    pb = path.encode("utf-8")
    if len(mb) > 0xFF or len(pb) > 0xFFFF:
        raise WireEncodeError("oversized CQ method/path")
    return _U16.pack(len(tb)) + tb + bytes([len(mb)]) + mb + \
        _U16.pack(len(pb)) + pb + (body or b"")


def decode_cq(payload: bytes) -> tuple[str, str, str, bytes]:
    try:
        (tl,) = _U16.unpack_from(payload, 0)
        off = 2 + tl
        trace = payload[2:off].decode("utf-8", "replace")
        ml = payload[off]
        off += 1
        method = payload[off:off + ml].decode("ascii")
        off += ml
        (pl,) = _U16.unpack_from(payload, off)
        off += 2
        path = payload[off:off + pl].decode("utf-8")
        off += pl
    except (struct.error, IndexError, UnicodeDecodeError) as exc:
        raise WireProtocolError(f"torn CQ frame: {exc}") from exc
    return trace, method, path, payload[off:]


# -- write batches ----------------------------------------------------------

def encode_write(dps: list, trace: str = "") -> bytes:
    """Series-grouped column blocks for one put batch. STRICT: any
    non-canonical datapoint raises :class:`WireEncodeError` and the
    caller delivers the whole batch over HTTP instead — the wire
    carries only values that survive an f64/i64 round trip exactly,
    so shard-side semantics cannot drift from the JSON path."""
    tb = (trace or "").encode("utf-8")
    if len(tb) > 0xFFFF:
        tb = b""
    groups: dict[tuple, tuple] = {}
    for dp in dps:
        if type(dp) is not dict or not _DP_KEYS >= dp.keys():
            raise WireEncodeError("non-canonical datapoint shape")
        metric = dp.get("metric")
        if type(metric) is not str or not metric:
            raise WireEncodeError("non-canonical metric")
        ts = dp.get("timestamp")
        if type(ts) is not int or not -(1 << 63) <= ts < (1 << 63):
            raise WireEncodeError("non-canonical timestamp")
        v = dp.get("value")
        if type(v) is int:
            if not -(1 << 53) < v < (1 << 53):
                raise WireEncodeError(
                    "integer value beyond f64 precision")
            is_int = 1
        elif type(v) is float:
            is_int = 0
        else:
            raise WireEncodeError("non-canonical value")
        tags = dp.get("tags")
        if tags is None:
            tags = {}
        elif type(tags) is not dict or not all(
                type(k) is str and type(tv) is str
                for k, tv in tags.items()):
            raise WireEncodeError("non-canonical tags")
        key = (metric, tuple(sorted(tags.items())))
        g = groups.get(key)
        if g is None:
            g = groups[key] = (metric, tags, [], [], [])
        g[2].append(ts)
        g[3].append(v)
        g[4].append(is_int)
    parts = [_U16.pack(len(tb)), tb, _U32.pack(len(groups))]
    for metric, tags, ts_list, vals, masks in groups.values():
        mb = metric.encode("utf-8")
        if len(mb) > 0xFFFF:
            raise WireEncodeError("non-canonical metric")
        tj = json.dumps(tags).encode("utf-8")
        parts.extend((
            _U16.pack(len(mb)), mb, _U32.pack(len(tj)), tj,
            _U32.pack(len(ts_list)),
            np.asarray(ts_list, dtype="<i8").tobytes(),
            np.asarray(vals, dtype="<f8").tobytes(),
            np.packbits(np.asarray(masks, dtype=np.uint8),
                        bitorder="little").tobytes()))
    payload = b"".join(parts)
    if len(payload) > MAX_FRAME:
        raise WireEncodeError("batch exceeds the one-frame wire bound")
    return payload


def decode_write(payload: bytes) -> tuple[str, list[tuple]]:
    """-> (trace header value, groups) where each group is the
    ``(metric, tags, dp_refs, ts_list, values)`` tuple
    ``TSDB.add_point_groups`` (and the put handler's error reporting)
    expects — ``values`` restores Python ``int``-ness from the packed
    mask so shard storage sees exactly what the JSON path decodes."""
    try:
        off = 0
        (tl,) = _U16.unpack_from(payload, off)
        off += 2
        trace = payload[off:off + tl].decode("utf-8", "replace")
        off += tl
        (ng,) = _U32.unpack_from(payload, off)
        off += 4
        groups: list[tuple] = []
        for _ in range(ng):
            (ml,) = _U16.unpack_from(payload, off)
            off += 2
            metric = payload[off:off + ml].decode("utf-8")
            off += ml
            (tjl,) = _U32.unpack_from(payload, off)
            off += 4
            tags = json.loads(payload[off:off + tjl])
            off += tjl
            (n,) = _U32.unpack_from(payload, off)
            off += 4
            ts = np.frombuffer(payload, dtype="<i8", count=n,
                               offset=off)
            off += 8 * n
            vals = np.frombuffer(payload, dtype="<f8", count=n,
                                 offset=off)
            off += 8 * n
            nmb = (n + 7) // 8
            mask = np.unpackbits(
                np.frombuffer(payload, dtype=np.uint8, count=nmb,
                              offset=off),
                count=n, bitorder="little")
            off += nmb
            ts_list = ts.tolist()
            values = [int(v) if m else v
                      for v, m in zip(vals.tolist(), mask.tolist())]
            refs = [{"metric": metric, "timestamp": t, "value": v,
                     "tags": tags}
                    for t, v in zip(ts_list, values)]
            groups.append((metric, tags, refs, ts_list, values))
        if off != len(payload):
            raise WireProtocolError("trailing bytes in write frame")
        return trace, groups
    except WireProtocolError:
        raise
    except Exception as exc:  # struct/json/unicode: the frame is torn
        raise WireProtocolError(
            f"undecodable write frame: {exc}") from exc


# -- streamed partial grids -------------------------------------------------

def _integral_mask(vals: np.ndarray) -> np.ndarray:
    """The serializer's int-emission rule (json_serializer.py): finite,
    |v| < 2^53 and integral — the exact set of values HTTP JSON would
    have emitted as ints, so the router-side merge and any row
    iteration see identical Python values on either transport."""
    finite = np.isfinite(vals)
    return finite & (np.abs(vals) < 2 ** 53) \
        & (vals == np.floor(np.where(finite, vals, 0.0)))


def _encode_qres_row(r, tsq) -> bytes:
    """One QueryResult as meta-JSON + ts/vals columns + int mask. The
    meta carries exactly what ``_result_head`` would have (gated the
    same way); ``query.index`` is restored router-side from the
    chunk's sub index."""
    meta: dict[str, Any] = {"metric": r.metric, "tags": r.tags,
                            "aggregateTags": r.aggregated_tags}
    if r.tsuids:
        meta["tsuids"] = r.tsuids
    if not tsq.no_annotations and r.annotations:
        meta["annotations"] = [a.to_json() for a in r.annotations]
    if tsq.global_annotations and r.global_annotations:
        meta["globalAnnotations"] = [a.to_json()
                                     for a in r.global_annotations]
    if getattr(r, "sketches", None):
        # sketch partials travel in the meta (b64, same shape the
        # HTTP serializer emits) — decode_qres restores them wholesale
        import base64
        meta["sketchDps"] = [
            [int(t), base64.b64encode(b).decode("ascii")]
            for t, b in r.sketches]
    arrs = getattr(r, "dps_arrays", None)
    if arrs is not None:
        ts_arr = np.ascontiguousarray(arrs[0], dtype="<i8")
        vals = np.ascontiguousarray(arrs[1], dtype="<f8")
    else:
        pts = list(r.dps)
        ts_arr = np.asarray([p[0] for p in pts], dtype="<i8")
        vals = np.asarray([float(p[1]) for p in pts], dtype="<f8")
    mj = json.dumps(meta).encode("utf-8")
    return b"".join((
        _U32.pack(len(mj)), mj, _U32.pack(int(ts_arr.size)),
        ts_arr.tobytes(), vals.tobytes(),
        np.packbits(_integral_mask(vals),
                    bitorder="little").tobytes()))


def qres_frames(seq: int, sub_index: int, results: list, tsq,
                chunk_bytes: int = 1 << 20) -> list[bytes]:
    """One sub-query's results as a list of ready-to-send ``T_QRES``
    frames, chunked near ``chunk_bytes`` so a giant sub streams
    instead of buffering whole (an empty sub emits no frames — the
    router treats absence as the empty partial it is)."""
    frames: list[bytes] = []
    head = _U32.pack(sub_index)
    rows: list[bytes] = []
    size = 0
    for r in results:
        rb = _encode_qres_row(r, tsq)
        rows.append(rb)
        size += len(rb)
        if size >= chunk_bytes:
            frames.append(_frame(T_QRES, seq, b"".join(
                (head, _U32.pack(len(rows)), *rows))))
            rows = []
            size = 0
    if rows:
        frames.append(_frame(T_QRES, seq, b"".join(
            (head, _U32.pack(len(rows)), *rows))))
    return frames


class WireDps:
    """Columnar stand-in for a JSON ``dps`` arrays list: iterates
    ``(int ts, int|float value)`` pairs exactly as ``json.loads`` of
    the HTTP arrays form would yield them, so repair/backfill row
    walks work on either transport without copying."""

    __slots__ = ("ts", "values", "int_mask")

    def __init__(self, ts: np.ndarray, values: np.ndarray,
                 int_mask: np.ndarray):
        self.ts = ts
        self.values = values
        self.int_mask = int_mask

    def __len__(self) -> int:
        return int(self.ts.size)

    def __bool__(self) -> bool:
        return self.ts.size > 0

    def __iter__(self):
        for t, v, m in zip(self.ts.tolist(), self.values.tolist(),
                           self.int_mask.tolist()):
            yield (t, int(v)) if m else (t, v)


def decode_qres(payload: bytes) -> tuple[int, list[dict]]:
    """-> (sub index, result-row dicts shaped like the HTTP arrays
    response rows, with ``dps`` as a :class:`WireDps` column view)."""
    try:
        off = 0
        (sub_index,) = _U32.unpack_from(payload, off)
        off += 4
        (nrows,) = _U32.unpack_from(payload, off)
        off += 4
        rows: list[dict] = []
        for _ in range(nrows):
            (mjl,) = _U32.unpack_from(payload, off)
            off += 4
            meta = json.loads(payload[off:off + mjl])
            off += mjl
            (n,) = _U32.unpack_from(payload, off)
            off += 4
            ts = np.frombuffer(payload, dtype="<i8", count=n,
                               offset=off)
            off += 8 * n
            vals = np.frombuffer(payload, dtype="<f8", count=n,
                                 offset=off)
            off += 8 * n
            nmb = (n + 7) // 8
            mask = np.unpackbits(
                np.frombuffer(payload, dtype=np.uint8, count=nmb,
                              offset=off),
                count=n, bitorder="little")
            off += nmb
            meta["query"] = {"index": sub_index}
            meta["dps"] = WireDps(ts, vals, mask)
            rows.append(meta)
        if off != len(payload):
            raise WireProtocolError(
                "trailing bytes in partial-grid frame")
        return sub_index, rows
    except WireProtocolError:
        raise
    except Exception as exc:
        raise WireProtocolError(
            f"undecodable partial-grid frame: {exc}") from exc


# ---------------------------------------------------------------------------
# router side: negotiation, connection, manager
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed during wire handshake")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _negotiate(host: str, port: int, connect_timeout_s: float,
               io_timeout_s: float) -> socket.socket:
    """Open + handshake one wire connection. A pre-connect failure
    propagates as ``OSError`` (the peer is DOWN: breaker/spool
    territory); any post-connect failure — the old server's telnet
    parser never answering, a closed socket from a disabled shard
    gate, a version mismatch — raises :class:`WireUnsupported` (the
    peer is alive but not speaking wire: HTTP fallback territory)."""
    sock = socket.create_connection((host, port),
                                    timeout=connect_timeout_s)
    try:
        sock.settimeout(connect_timeout_s)
        sock.sendall(MAGIC + _frame(
            T_HELLO, 0, json.dumps({"v": WIRE_VERSION}).encode()))
        ln, crc, ftype, _seq = _HDR.unpack(
            _recv_exact(sock, _HDR.size))
        if ftype != T_HELLO_ACK or ln > 4096:
            raise WireProtocolError(
                f"unexpected handshake frame type {ftype}")
        payload = _recv_exact(sock, ln)
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise WireProtocolError("handshake frame CRC mismatch")
        if int(json.loads(payload).get("v", 0)) != WIRE_VERSION:
            raise WireProtocolError("wire version mismatch")
    except Exception as exc:
        try:
            sock.close()
        except OSError:
            # closing a socket the handshake
            # already failed on; the WireUnsupported below carries
            # the real error
            pass
        raise WireUnsupported(
            f"peer {host}:{port} does not speak wire "
            f"v{WIRE_VERSION}: {type(exc).__name__}: {exc}") from exc
    sock.settimeout(io_timeout_s)
    return sock


_DEAD = object()  # broadcast sentinel: the connection died under you


class WireConnection:
    """One persistent, pipelined wire connection (router side).

    Sends interleave under a socket lock; a daemon reader thread
    demultiplexes response frames to per-sequence waiter queues, so
    any number of pool threads share the link concurrently. Any
    transport or protocol failure marks the connection dead, wakes
    every waiter with a ``ConnectionError`` and closes the socket —
    the manager opens a fresh connection on the next use (torn-frame
    truncation semantics: no resync inside a damaged stream)."""

    def __init__(self, name: str, sock: socket.socket,
                 io_timeout_s: float, stats: Any = None):
        self.name = name
        self.sock = sock
        self.timeout_s = io_timeout_s
        self.stats = stats  # Peer counter sink (wire_frames_* etc.)
        self.dead = False
        self.dead_exc: Exception | None = None
        self._wlock = threading.Lock()   # seq + waiter registry
        self._slock = threading.Lock()   # socket sends
        self._seq = 0
        self._waiters: dict[int, queue_mod.Queue] = {}
        self._reader = threading.Thread(
            target=self._read_loop, name=f"tsd-wire-{name}",
            daemon=True)
        self._reader.start()

    # -- reader thread -------------------------------------------------

    def _read_loop(self) -> None:
        buf = b""
        hdr = _HDR.size
        stats = self.stats
        while True:
            while len(buf) >= hdr:
                ln, crc, ftype, seq = _HDR.unpack_from(buf)
                if ln > MAX_FRAME:
                    self._fail(WireProtocolError(
                        f"oversized frame ({ln} bytes) from "
                        f"{self.name}"))
                    return
                if len(buf) < hdr + ln:
                    break
                payload = bytes(buf[hdr:hdr + ln])
                buf = buf[hdr + ln:]
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    self._fail(WireProtocolError(
                        f"frame CRC mismatch from {self.name}"))
                    return
                if stats is not None:
                    stats.wire_frames_in += 1
                    stats.wire_bytes_in += hdr + ln
                with self._wlock:
                    q = self._waiters.get(seq)
                if q is not None:
                    q.put((ftype, payload))
                # else: a late frame for an abandoned sequence
                # (timed-out waiter) — drop it
            if self.dead:
                return
            try:
                chunk = self.sock.recv(65536)
            except socket.timeout:
                continue  # idle is normal; partial frames stay in buf
            except OSError as exc:
                self._fail(exc)
                return
            if not chunk:
                self._fail(ConnectionError(
                    f"peer {self.name} closed the wire connection"))
                return
            buf += chunk

    # -- request lifecycle ---------------------------------------------

    def begin(self, ftype: int, payload: bytes
              ) -> tuple[int, queue_mod.Queue]:
        """Register a waiter, then send the request frame. Returns
        (seq, queue); pair with :meth:`end` in a finally."""
        with self._wlock:
            if self.dead:
                raise ConnectionError(
                    f"wire connection to {self.name} is dead: "
                    f"{self.dead_exc}")
            self._seq += 1
            seq = self._seq
            q: queue_mod.Queue = queue_mod.Queue()
            self._waiters[seq] = q
        data = _frame(ftype, seq, payload)
        try:
            with self._slock:
                self.sock.sendall(data)
        except OSError as exc:
            self.end(seq)
            self._fail(exc)
            raise
        if self.stats is not None:
            self.stats.wire_frames_out += 1
            self.stats.wire_bytes_out += len(data)
        return seq, q

    def wait(self, q: queue_mod.Queue, timeout_s: float
             ) -> tuple[int, bytes]:
        """Next response frame for one sequence. A timeout raises
        ``TimeoutError`` (an ``OSError``: breaker/retry territory)
        WITHOUT killing the connection — write acks are in flight
        order, a slow shard is not a torn stream, and a retried
        delivery is idempotent (same-series last-write-wins)."""
        try:
            item = q.get(timeout=max(timeout_s, 0.001))
        except queue_mod.Empty:
            raise TimeoutError(
                f"wire response timeout from {self.name} "
                f"({timeout_s:.1f}s)") from None
        if item is _DEAD:
            raise ConnectionError(
                f"wire connection to {self.name} died: "
                f"{self.dead_exc}")
        return item

    def end(self, seq: int) -> None:
        with self._wlock:
            self._waiters.pop(seq, None)

    def _fail(self, exc: Exception) -> None:
        with self._wlock:
            if self.dead:
                return
            self.dead = True
            self.dead_exc = exc
            waiters = list(self._waiters.values())
        for q in waiters:
            q.put(_DEAD)
        try:
            # shutdown first: close alone does not wake the reader
            # thread blocked in recv, which would hold the router's
            # stop for a whole socket timeout
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected, or the peer already went away
        try:
            self.sock.close()
        except OSError:
            # double-close race on a socket
            # that is already dead; dead_exc carries the real error
            pass

    def close(self) -> None:
        self._fail(ConnectionError(
            f"wire connection to {self.name} closed"))
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2)


class _ConnSlot:
    """One (peer, direction) connection holder; the slot lock
    serializes reconnects without blocking other peers."""

    __slots__ = ("lock", "conn")

    def __init__(self):
        self.lock = threading.Lock()
        self.conn: WireConnection | None = None


class WireManager:
    """Router-side owner of the per-peer wire links and the HTTP
    fallback policy. Writes and reads use SEPARATE connections per
    peer ('w'/'r') so a shard wedged mid-put cannot stall the read
    scatter's streaming acks."""

    def __init__(self, router):
        self.router = router
        config = router.config
        self.enabled = config.get_bool("tsd.cluster.wire.enable",
                                       True)
        self.max_inflight = max(config.get_int(
            "tsd.cluster.wire.max_inflight", 32), 1)
        self.fallback_ttl_s = config.get_float(
            "tsd.cluster.wire.fallback_ttl_ms", 30000.0) / 1000.0
        self.connect_timeout_s = config.get_float(
            "tsd.cluster.wire.connect_timeout_ms", 1000.0) / 1000.0
        self._lock = threading.Lock()
        # both maps are bounded by the peer set x 2 directions
        self._slots: dict[tuple[str, str], _ConnSlot] = {}
        self._sems: dict[str, threading.BoundedSemaphore] = {}
        # peer name -> monotonic stamp of the failed negotiation;
        # bounded by the peer set, entries expire after fallback_ttl
        self._unsupported: dict[str, float] = {}

    # -- policy --------------------------------------------------------

    def usable(self, peer) -> bool:
        """Whether the next exchange with this peer should try the
        wire (vs going straight to HTTP)."""
        if not self.enabled:
            return False
        if self.router.hedge_after_s > 0:
            # tail-latency hedging races duplicate HTTP requests;
            # the wire has no duplicate-cancel story, so a hedged
            # router keeps the HTTP transport wholesale
            return False
        with self._lock:
            stamp = self._unsupported.get(peer.name)
            if stamp is None:
                return True
            if time.monotonic() - stamp >= self.fallback_ttl_s:
                del self._unsupported[peer.name]
                return True
            return False

    def _mark_unsupported(self, peer) -> None:
        with self._lock:
            self._unsupported[peer.name] = time.monotonic()
        peer.wire_fallbacks += 1
        LOG.info("peer %s does not speak wire v%d; HTTP fallback for "
                 "%.0fs", peer.name, WIRE_VERSION, self.fallback_ttl_s)

    def _check_faults(self, peer) -> None:
        """``cluster.wire`` twin of the router's ``cluster.peer``
        sites: an armed fault raises ``InjectedFault`` (an OSError)
        INSIDE the guarded exchange, driving breaker/spool/degrade
        exactly like real wire damage."""
        faults = getattr(self.router.tsdb, "faults", None)
        if faults is not None:
            faults.check("cluster.wire")
            faults.check(f"cluster.wire.{peer.name}")

    # -- connections ---------------------------------------------------

    def _slot(self, peer, kind: str) -> _ConnSlot:
        with self._lock:
            return self._slots.setdefault((peer.name, kind),
                                          _ConnSlot())

    def _sem(self, name: str) -> threading.BoundedSemaphore:
        with self._lock:
            sem = self._sems.get(name)
            if sem is None:
                sem = self._sems[name] = threading.BoundedSemaphore(
                    self.max_inflight)
            return sem

    def _conn(self, peer, kind: str) -> WireConnection:
        slot = self._slot(peer, kind)
        with slot.lock:
            conn = slot.conn
            if conn is not None and not conn.dead:
                return conn
            sp = trace_begin("cluster.wire.connect", peer=peer.name,
                             kind=kind)
            try:
                sock = _negotiate(peer.client.host, peer.client.port,
                                  self.connect_timeout_s,
                                  self.router.timeout_s)
            except WireUnsupported as exc:
                trace_end(sp, error=exc)
                self._mark_unsupported(peer)
                raise
            except BaseException as exc:
                trace_end(sp, error=exc)
                raise
            trace_end(sp)
            conn = WireConnection(f"{peer.name}-{kind}", sock,
                                  self.router.timeout_s, stats=peer)
            slot.conn = conn
            peer.wire_connects += 1
            return conn

    def close_all(self) -> None:
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
            self._sems.clear()
            self._unsupported.clear()
        for slot in slots:
            with slot.lock:
                conn, slot.conn = slot.conn, None
            if conn is not None:
                conn.close()

    # -- data paths ----------------------------------------------------

    def put_batch(self, peer, dps: list | None = None,
                  body: bytes | None = None,
                  headers: dict[str, str] | None = None
                  ) -> tuple[int, bytes]:
        """One columnar put delivery; returns the HTTP-shaped
        (status, summary body). Raises :class:`WireEncodeError`
        BEFORE touching the socket for non-canonical batches,
        :class:`WireBacklogged` when the pipeline is at max_inflight
        (shed to spool), :class:`WireUnsupported` when negotiation
        says HTTP, and ``OSError`` for transport failures
        (breaker/spool territory)."""
        if dps is None:
            try:
                dps = json.loads(body)
            except Exception as exc:  # noqa: BLE001 - odd spool body
                raise WireEncodeError(
                    f"undecodable batch body: {exc}") from exc
        trace = (headers or {}).get(TRACE_HEADER, "")
        payload = encode_write(dps, trace)
        self._check_faults(peer)
        conn = self._conn(peer, "w")
        sem = self._sem(peer.name)
        if not sem.acquire(blocking=False):
            raise WireBacklogged(
                f"wire pipeline to {peer.name} is at "
                f"{self.max_inflight} in flight")
        depth = peer.wire_pipeline_depth = peer.wire_pipeline_depth + 1
        if depth > peer.wire_pipeline_max:
            peer.wire_pipeline_max = depth
        try:
            seq, q = conn.begin(T_WRITE, payload)
            try:
                ftype, ack = conn.wait(q, self.router.timeout_s)
            finally:
                conn.end(seq)
            if ftype != T_WRITE_ACK:
                conn.close()
                raise ConnectionError(
                    f"peer {peer.name} answered frame type {ftype} "
                    f"to a write")
            return decode_status(ack)
        finally:
            peer.wire_pipeline_depth -= 1
            sem.release()

    def query(self, peer, body: bytes,
              headers: dict[str, str] | None = None
              ) -> tuple[int, Any]:
        """One streamed scatter leg: returns ``(200, decoded result
        rows)`` — partial grids decoded AS THEY ARRIVE — or
        ``(status, error body bytes)`` for non-200 answers, so every
        router-side status/body check works unchanged."""
        trace = (headers or {}).get(TRACE_HEADER, "")
        payload = encode_query(trace, body)
        self._check_faults(peer)
        conn = self._conn(peer, "r")
        rows: list[dict] = []
        # per-frame gap bound + overall deadline, mirroring the HTTP
        # path's socket timeout + fut.result cap
        deadline = time.monotonic() + self.router.timeout_s * 2
        seq, q = conn.begin(T_QUERY, payload)
        try:
            while True:
                gap = min(self.router.timeout_s,
                          deadline - time.monotonic())
                if gap <= 0:
                    raise TimeoutError(
                        f"streamed read from {peer.name} exceeded "
                        f"{self.router.timeout_s * 2:.1f}s")
                ftype, data = conn.wait(q, gap)
                if ftype == T_QRES:
                    try:
                        _sub, part = decode_qres(data)
                    except WireProtocolError as exc:
                        conn.close()
                        raise ConnectionError(str(exc)) from exc
                    rows.extend(part)
                    continue
                if ftype == T_QDONE:
                    status, done = decode_status(data)
                    if status == 200:
                        return 200, rows
                    return status, done
                conn.close()
                raise ConnectionError(
                    f"peer {peer.name} answered frame type {ftype} "
                    f"to a query")
        finally:
            conn.end(seq)

    def cq(self, peer, method: str, path: str, body: bytes = b"",
           headers: dict[str, str] | None = None) -> tuple[int, bytes]:
        """One continuous-query control exchange (register, delete,
        pull, delta drain) over the persistent read connection (ref:
        ``WireManager.cq``); returns the HTTP-shaped (status, body).
        Raises :class:`WireUnsupported` when negotiation says HTTP and
        ``OSError`` for transport failures: callers fall back to JSON
        HTTP on the first and degrade the shard on the second."""
        trace = (headers or {}).get(TRACE_HEADER, "")
        payload = encode_cq(trace, method, path, body)
        self._check_faults(peer)
        conn = self._conn(peer, "r")
        seq, q = conn.begin(T_CQ, payload)
        try:
            ftype, ack = conn.wait(q, self.router.timeout_s)
        finally:
            conn.end(seq)
        if ftype != T_CQ_RES:
            conn.close()
            raise ConnectionError(
                f"peer {peer.name} answered frame type {ftype} "
                f"to a CQ op")
        return decode_status(ack)


# ---------------------------------------------------------------------------
# shard side: the accept-loop session
# ---------------------------------------------------------------------------

async def _read_frame(reader) -> tuple[int, int, bytes]:
    hdr = await reader.readexactly(_HDR.size)
    ln, crc, ftype, seq = _HDR.unpack(hdr)
    if ln > MAX_FRAME:
        raise WireProtocolError(f"oversized frame ({ln} bytes)")
    payload = await reader.readexactly(ln)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireProtocolError("frame CRC mismatch")
    return ftype, seq, payload


async def serve_wire(server, reader, writer) -> None:
    """One shard-side wire session (the server sniffed ``MAGIC``).

    Structure: a read loop dispatches frames — writes to a SERIAL
    worker (frame order is delivery order, like the HTTP keep-alive
    pipeline), queries to per-request tasks that run on the query
    pool under the SAME admission/timeout/SLO discipline as
    ``_serve_http`` — while a sender task drains one output queue
    (frames from executor threads hop in via
    ``call_soon_threadsafe``, which keeps every partial-grid frame
    ordered before its ``T_QDONE``). A watchdog closes the session
    when the listener stops serving, because chaos harnesses (and
    ``stop()``) close only the LISTENER — without it a persistent
    wire connection would outlive its killed server and the router
    would never see the failure."""
    tsdb = server.tsdb
    if not tsdb.config.get_bool("tsd.cluster.wire.enable", True):
        return  # close without an ack = "speak HTTP" to the router
    try:
        ftype, _seq, payload = await asyncio.wait_for(
            _read_frame(reader), 5)
        if ftype != T_HELLO or \
                int(json.loads(payload).get("v", 0)) != WIRE_VERSION:
            return
    except Exception:  # noqa: BLE001
        # a malformed handshake is a client
        # that cannot speak wire: closing IS the negotiated answer
        return
    writer.write(_frame(T_HELLO_ACK, 0,
                        json.dumps({"v": WIRE_VERSION}).encode()))
    await writer.drain()

    loop = asyncio.get_running_loop()
    outq: asyncio.Queue = asyncio.Queue()
    wq: asyncio.Queue = asyncio.Queue()
    qtasks: set[asyncio.Task] = set()
    peername = writer.get_extra_info("peername")
    remote = f"{peername[0]}:{peername[1]}" if peername else ""

    def listener_dead() -> bool:
        # the kill idioms (tests' LivePeer.kill, bench Peer.kill,
        # server.stop) close the LISTENER and model "the network
        # died": a persistent session must honor that the moment a
        # request arrives (or an answer would leave), or a killed
        # shard would keep serving through pre-established links —
        # the failure contract HTTP gets for free from per-request
        # connects
        srv = server._server
        return srv is None or not srv.is_serving()

    async def sender() -> None:
        while True:
            data = await outq.get()
            if listener_dead():
                return  # drop the answer: the shard is "down"
            writer.write(data)
            await writer.drain()

    def handle_write(seq: int, payload: bytes) -> bytes:
        # executor thread: decode columns -> the REAL put handler
        # (server.http_router.handle, a dynamic attribute on purpose:
        # chaos hang("/api/put") swaps it and must catch wire writes
        # too) with the decoded groups attached — add_point_groups
        # lands the block as one WAL write + one fsync, zero JSON
        from opentsdb_tpu_torch.tsd.http_api import HttpRequest
        t0 = time.monotonic()
        trace, groups = decode_write(payload)
        req = HttpRequest(
            method="POST", path="/api/put",
            params={"summary": ["true"], "details": ["true"]},
            headers={TRACE_HEADER: trace} if trace else {},
            body=b"", remote=remote, received_at=t0)
        req.wire_groups = groups
        resp = server.http_router.handle(req)
        elapsed_ms = (time.monotonic() - t0) * 1000
        tsdb.stats.latency_put.add(elapsed_ms)
        if tsdb.slo.enabled:
            tsdb.slo.record("put", elapsed_ms, resp.status >= 500)
        return _frame(T_WRITE_ACK, seq,
                      encode_status(resp.status, resp.body))

    async def write_worker() -> None:
        while True:
            seq, payload = await wq.get()
            try:
                data = await loop.run_in_executor(
                    server._http_pool, handle_write, seq, payload)
            except WireProtocolError:
                raise  # torn payload: the session must die
            except Exception as exc:  # noqa: BLE001 - per-batch 500
                LOG.exception("wire write failed")
                data = _frame(T_WRITE_ACK, seq, encode_status(
                    500, json.dumps({"error": {
                        "code": 500, "message": str(exc)}}).encode()))
            outq.put_nowait(data)

    async def handle_query(seq: int, payload: bytes) -> None:
        from opentsdb_tpu_torch.tsd.server import _structured_error
        t0 = time.monotonic()
        shed = server.admission.try_admit(server.query_queue_depth())
        if shed is not None:
            resp = server._overload_response(shed)
            outq.put_nowait(_frame(T_QDONE, seq, encode_status(
                resp.status, resp.body)))
            return

        def sink(tsq, sub_index: int, results: list) -> None:
            # query-pool thread: ship one sub's grids the moment the
            # engine finishes them. call_soon_threadsafe is FIFO with
            # the executor future's resolution, so every T_QRES
            # queues before this request's T_QDONE.
            for fr in qres_frames(seq, sub_index, results, tsq):
                loop.call_soon_threadsafe(outq.put_nowait, fr)

        def tracked() -> Any:
            from opentsdb_tpu_torch.tsd.http_api import HttpRequest
            try:
                trace, qbody = decode_query(payload)
                req = HttpRequest(
                    method="POST", path="/api/query",
                    params={"arrays": ["true"]},
                    headers={TRACE_HEADER: trace} if trace else {},
                    body=qbody, remote=remote, received_at=t0)
                req.wire_sink = sink
                return server.http_router.handle(req)
            finally:
                server.admission.finished()

        fut = loop.run_in_executor(server._query_pool, tracked)
        try:
            if server.query_timeout_ms > 0:
                # shield: the worker runs on to its end, and the
                # cancelled wait must not mark its future cancelled
                resp = await asyncio.wait_for(
                    asyncio.shield(fut), server.query_timeout_ms / 1000.0)
            else:
                resp = await fut
        except asyncio.TimeoutError:
            # the worker keeps running (admission frees on ITS exit);
            # grids it streams after this are dropped router-side by
            # the abandoned sequence
            resp = _structured_error(
                504, "Query timeout exceeded "
                f"({server.query_timeout_ms}ms)")
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - per-query 500
            LOG.exception("wire query failed")
            resp = _structured_error(500, str(exc))
        elapsed_ms = (time.monotonic() - t0) * 1000
        tsdb.stats.latency_query.add(elapsed_ms)
        if tsdb.slo.enabled:
            tsdb.slo.record("query", elapsed_ms, resp.status >= 500)
        outq.put_nowait(_frame(T_QDONE, seq, encode_status(
            resp.status, resp.body)))

    async def handle_cq(seq: int, payload: bytes) -> None:
        # continuous-query control op: replay as a real HTTP request
        # (the handle_write idiom — chaos hangs, fault sites and QoS
        # gates on the HTTP handler cover the wire path for free). No
        # admission gate: registrations and delta drains are control
        # traffic that must not be shed with the query load.
        from opentsdb_tpu_torch.tsd.server import _structured_error

        def tracked() -> Any:
            from opentsdb_tpu_torch.tsd.http_api import HttpRequest
            trace, method, path, qbody = decode_cq(payload)
            if not path.startswith("/api/query/continuous"):
                return _structured_error(
                    400, f"path {path!r} is not a continuous-query "
                    f"operation")
            req = HttpRequest(
                method=method, path=path, params={},
                headers={TRACE_HEADER: trace} if trace else {},
                body=qbody, remote=remote,
                received_at=time.monotonic())
            return server.http_router.handle(req)

        try:
            resp = await loop.run_in_executor(server._http_pool, tracked)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - per-op 500
            LOG.exception("wire CQ op failed")
            resp = _structured_error(500, str(exc))
        outq.put_nowait(_frame(T_CQ_RES, seq, encode_status(
            resp.status, resp.body)))

    async def watchdog() -> None:
        # idle twin of listener_dead(): a session with nothing in
        # flight still follows a kill within one poll
        while True:
            if listener_dead():
                return
            await asyncio.sleep(0.05)

    async def read_dispatch() -> None:
        while True:
            ftype, seq, payload = await _read_frame(reader)
            if listener_dead():
                return  # refuse the request: the shard is "down"
            if ftype == T_WRITE:
                wq.put_nowait((seq, payload))
            elif ftype == T_QUERY:
                task = asyncio.ensure_future(
                    handle_query(seq, payload))
                qtasks.add(task)
                task.add_done_callback(qtasks.discard)
            elif ftype == T_CQ:
                task = asyncio.ensure_future(
                    handle_cq(seq, payload))
                qtasks.add(task)
                task.add_done_callback(qtasks.discard)
            else:
                raise WireProtocolError(
                    f"unexpected frame type {ftype}")

    tasks = [asyncio.ensure_future(t()) for t in
             (read_dispatch, sender, write_worker, watchdog)]
    try:
        await asyncio.wait(tasks,
                           return_when=asyncio.FIRST_COMPLETED)
    finally:
        pending = [*tasks, *qtasks]
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)


__all__ = [
    "MAGIC", "WIRE_VERSION", "MAX_FRAME",
    "WireBacklogged", "WireConnection", "WireDps", "WireEncodeError",
    "WireManager", "WireProtocolError", "WireUnsupported",
    "decode_cq", "decode_qres", "decode_query", "decode_status",
    "decode_write", "encode_cq", "encode_query", "encode_status",
    "encode_write", "qres_frames", "serve_wire",
]
