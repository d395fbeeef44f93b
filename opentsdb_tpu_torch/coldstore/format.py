"""Cold-tier segment file format (ref: ``opentsdb_tpu/coldstore/
format.py``; the bytes are the reference's, so either package reads the
other's segments).

One segment = one spill of one metric's demoted history for one rollup
tier interval, written once and never mutated in place (rewrites go
through tmpfile + atomic rename, like every other persist path in this
build). Layout::

    magic   "TSDBCOLD"                      8 bytes
    version u32 LE                          4 bytes
    hdr_len u32 LE                          4 bytes
    hdr_crc u32 LE (crc32 of header json)   4 bytes
    header  json (hdr_len bytes)
    ts      int32 [rows]  (or int64 when header["scale"] == 0)
    <stat>  float64 [rows]   for each stat in header["stats"]
                             (sum / count / min / max)
    sk_off  int64 [rows+1]   (format 2 only, when header["sketch"])
    sk_blob bytes            concatenated per-row DDSketch blobs;
                             row i spans sk_off[i]..sk_off[i+1]
                             (equal offsets = no sketch for the row)

Format 2 adds the OPTIONAL quantile-sketch column (the fifth stat):
a segment without sketches still writes format 1, so files this build
produces stay readable by format-1 readers unless they actually carry
sketches; format-2 files without corruption are read by this build
whether or not the sketch section is present.

The header json carries the series table (sorted tag NAME pairs with
row offsets — names, not UID ids, so a segment outlives any UID
renumbering), the timestamp packing (``ts = base_ms + ts[i] * scale``,
the reference's ``SeriesBuffer.compact`` int32-offset scheme; scale 0 is
the >int32-span escape hatch and stores raw int64), and the crc32 of
the data section (``data_crc``) so fsck can verify the columns without
trusting the file length.

Readers ``np.memmap`` the columns — a segment's resident cost is the
pages a query actually touches, not the file. The header crc is
verified on every open; the data crc is verified by fsck (a full
sequential read, deliberately not paid at query time).
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np

MAGIC = b"TSDBCOLD"
FORMAT_VERSION = 2
# newest version a reader of this build accepts
SUPPORTED_VERSIONS = (1, 2)
STATS = ("sum", "count", "min", "max")

_PREAMBLE = len(MAGIC) + 4 + 4 + 4


class SegmentError(ValueError):
    """A segment file failed validation (bad magic/version/crc/shape).
    Readers treat this as a degraded-serve condition, never a crash."""


def pack_timestamps(ts_ms: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(column, base_ms, scale): int32 offsets at second (1000) or ms
    (1) resolution when the span fits, raw int64 (scale 0) otherwise.
    ``ts_ms`` need not be globally sorted (rows are per-series runs)."""
    ts_ms = np.asarray(ts_ms, dtype=np.int64)
    if len(ts_ms) == 0:
        return ts_ms.astype(np.int32), 0, 1
    base = int(ts_ms.min())
    scale = 1000 if (base % 1000 == 0 and not (ts_ms % 1000).any()) \
        else 1
    span = (int(ts_ms.max()) - base) // scale
    if span > np.iinfo(np.int32).max:
        return ts_ms.copy(), 0, 0
    return ((ts_ms - base) // scale).astype(np.int32), base, scale


def write_segment(directory: str, name: str, header: dict,
                  ts_col: np.ndarray, cols: dict[str, np.ndarray],
                  sketch: tuple[np.ndarray, bytes] | None = None
                  ) -> dict:
    """Write one segment durably (tmpfile + fsync + atomic rename).
    ``header`` is completed in place with format/crc fields; returns
    the manifest entry for the segment. ``sketch`` is the optional
    fifth column as ``(offsets int64[rows+1], blob bytes)`` — its
    presence bumps the segment to format 2 (a sketch-free segment
    stays format 1, readable by older builds)."""
    os.makedirs(directory, exist_ok=True)
    n = len(ts_col)
    data_parts = [np.ascontiguousarray(ts_col).tobytes()]
    for stat in header["stats"]:
        col = np.ascontiguousarray(cols[stat], dtype=np.float64)
        if len(col) != n:
            raise SegmentError(f"stat column {stat!r} length {len(col)}"
                               f" != {n} rows")
        data_parts.append(col.tobytes())
    header = dict(header)
    version = 1
    if sketch is not None:
        sk_off, sk_blob = sketch
        sk_off = np.ascontiguousarray(sk_off, dtype=np.int64)
        if len(sk_off) != n + 1:
            raise SegmentError(
                f"sketch offsets length {len(sk_off)} != {n + 1}")
        if int(sk_off[-1]) != len(sk_blob):
            raise SegmentError(
                f"sketch blob length {len(sk_blob)} != "
                f"offset end {int(sk_off[-1])}")
        data_parts.append(sk_off.tobytes())
        data_parts.append(sk_blob)
        header["sketch"] = {"blob_len": len(sk_blob)}
        version = 2
    data = b"".join(data_parts)
    header["format"] = version
    header["rows"] = n
    header["data_crc"] = zlib.crc32(data) & 0xFFFFFFFF
    hdr_json = json.dumps(header, sort_keys=True).encode()
    hdr_crc = zlib.crc32(hdr_json) & 0xFFFFFFFF
    blob = (MAGIC
            + version.to_bytes(4, "little")
            + len(hdr_json).to_bytes(4, "little")
            + hdr_crc.to_bytes(4, "little")
            + hdr_json + data)
    path = os.path.join(directory, name)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".seg-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    entry = {"file": name, "interval": header["interval"],
             "start_ms": header["start_ms"],
             "end_ms": header["end_ms"],
             "rows": n, "bytes": len(blob),
             "data_crc": header["data_crc"], "header_crc": hdr_crc}
    if sketch is not None:
        entry["sketch"] = True
    return entry


def read_header(path: str) -> tuple[dict, int]:
    """(header, data_offset). Raises :class:`SegmentError` on any
    structural problem — including a bad header crc."""
    try:
        with open(path, "rb") as fh:
            pre = fh.read(_PREAMBLE)
            if len(pre) < _PREAMBLE or pre[:len(MAGIC)] != MAGIC:
                raise SegmentError(f"{path}: bad magic")
            version = int.from_bytes(pre[8:12], "little")
            if version not in SUPPORTED_VERSIONS:
                raise SegmentError(f"{path}: unsupported segment "
                                   f"format {version}")
            hdr_len = int.from_bytes(pre[12:16], "little")
            hdr_crc = int.from_bytes(pre[16:20], "little")
            hdr_json = fh.read(hdr_len)
    except OSError as exc:
        raise SegmentError(f"{path}: {exc}") from exc
    if len(hdr_json) != hdr_len or \
            (zlib.crc32(hdr_json) & 0xFFFFFFFF) != hdr_crc:
        raise SegmentError(f"{path}: header checksum mismatch")
    try:
        header = json.loads(hdr_json)
    except ValueError as exc:
        raise SegmentError(f"{path}: header not json ({exc})") from exc
    return header, _PREAMBLE + hdr_len


class Segment:
    """One mmapped segment: the ts column plus per-stat value columns,
    opened read-only. Columns are ``np.memmap`` views — touching a row
    faults in that page only."""

    __slots__ = ("path", "header", "ts", "cols", "series",
                 "sk_off", "sk_blob")

    def __init__(self, path: str):
        header, off = read_header(path)
        n = int(header["rows"])
        ts_dtype = np.int64 if header.get("scale", 1) == 0 else np.int32
        sk_meta = header.get("sketch")
        try:
            size = os.path.getsize(path)
            ts_bytes = n * np.dtype(ts_dtype).itemsize
            need = off + ts_bytes + 8 * n * len(header["stats"])
            if sk_meta is not None:
                need += 8 * (n + 1) + int(sk_meta["blob_len"])
            if size < need:
                raise SegmentError(
                    f"{path}: truncated ({size} < {need} bytes)")
            if n:
                self.ts = np.memmap(path, dtype=ts_dtype, mode="r",
                                    offset=off, shape=(n,))
            else:
                self.ts = np.empty(0, dtype=ts_dtype)
            self.cols = {}
            pos = off + ts_bytes
            for stat in header["stats"]:
                if n:
                    self.cols[stat] = np.memmap(
                        path, dtype=np.float64, mode="r", offset=pos,
                        shape=(n,))
                else:
                    self.cols[stat] = np.empty(0, dtype=np.float64)
                pos += 8 * n
            self.sk_off = None
            self.sk_blob = None
            if sk_meta is not None:
                blob_len = int(sk_meta["blob_len"])
                self.sk_off = np.memmap(path, dtype=np.int64,
                                        mode="r", offset=pos,
                                        shape=(n + 1,))
                pos += 8 * (n + 1)
                self.sk_blob = np.memmap(
                    path, dtype=np.uint8, mode="r", offset=pos,
                    shape=(blob_len,)) if blob_len else \
                    np.empty(0, dtype=np.uint8)
        except OSError as exc:
            raise SegmentError(f"{path}: {exc}") from exc
        self.path = path
        self.header = header
        # [(sorted ((tagk_name, tagv_name), ...), off, cnt)]
        self.series = [(tuple(tuple(p) for p in e["tags"]),
                        int(e["off"]), int(e["cnt"]))
                       for e in header["series"]]

    @property
    def has_sketches(self) -> bool:
        return self.sk_off is not None

    def sketch_blob(self, row: int) -> bytes | None:
        """One row's serialized sketch (None when the segment or the
        row has no sketch column — format-1 segments, or rows spilled
        before their cells were ever folded)."""
        if self.sk_off is None:
            return None
        lo, hi = int(self.sk_off[row]), int(self.sk_off[row + 1])
        if hi <= lo:
            return None
        return bytes(self.sk_blob[lo:hi])

    def ts64(self, lo: int, hi: int) -> np.ndarray:
        """Row slice materialized as int64 ms."""
        scale = self.header.get("scale", 1)
        if scale == 0:
            return np.asarray(self.ts[lo:hi], dtype=np.int64)
        return (int(self.header["base_ms"])
                + self.ts[lo:hi].astype(np.int64) * scale)


def row_bounds_many(seg: Segment, off: np.ndarray, cnt: np.ndarray,
                    start_ms: int, end_ms: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Per series ``(lo, hi)``: the absolute rows of its run
    ``[off, off + cnt)`` within the inclusive [start_ms, end_ms] window,
    one vectorized bisection over all runs in the packed domain, with no
    column materialization."""
    from opentsdb_tpu_torch.core.store import _row_search
    off = np.asarray(off, dtype=np.int64)
    end = off + np.asarray(cnt, dtype=np.int64)
    scale = seg.header.get("scale", 1)
    ts = np.asarray(seg.ts)
    if scale == 0:
        lo_v, hi_v = start_ms, end_ms
    else:
        base = int(seg.header["base_ms"])
        lo_v, hi_v = -((base - start_ms) // scale), (end_ms - base) // scale
    lo = _row_search(ts, off, end, lo_v, right=False)
    return lo, _row_search(ts, lo, end, hi_v, right=True)


def verify_data_crc(path: str) -> bool:
    """Full sequential read of the data section vs the header's
    ``data_crc`` (the fsck check; query reads never pay this)."""
    header, off = read_header(path)
    crc = 0
    with open(path, "rb") as fh:
        fh.seek(off)
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return (crc & 0xFFFFFFFF) == header.get("data_crc")
