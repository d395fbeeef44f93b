"""Byte-level storage codec: row keys, qualifiers, values.

Implements the reference storage format (ref: ``src/core/Internal.java``,
``src/core/RowKey.java``, ``opentsdb_tpu/core/codec.py``) so that bulk
import/export and ``fsck`` are bit-compatible with OpenTSDB 2.4 tables:

- row key   = ``[salt][metric_uid][base_time(4B)][tagk_uid tagv_uid]*``
  with ``base_time`` aligned down to :data:`const.MAX_TIMESPAN` (3600 s)
  (ref: src/core/IncomingDataPoints.java, RowKey.java:115-165)
- qualifier = 2 bytes for second precision (12-bit delta << 4 | flags) or
  4 bytes for ms precision (0xF nibble, 22-bit ms delta << 6 | flags)
  (ref: src/core/Internal.java:848-864)
- value     = 1/2/4/8-byte big-endian int, or 4/8-byte IEEE float, with
  flags = (FLAG_FLOAT if float) | (length - 1)

The hot query path never touches this codec (series live in the column
stores, :mod:`opentsdb_tpu_torch.core.store` and the native store, as
contiguous arrays), but the codec is the interoperability contract.
"""

from __future__ import annotations

import struct
from typing import Iterator, NamedTuple

from opentsdb_tpu_torch.core import const


class IllegalDataError(ValueError):
    """Corrupt or malformed stored data (ref: src/core/IllegalDataException.java)."""


# ---------------------------------------------------------------------------
# Value encoding (ref: src/core/Internal.java value extraction + TSDB.java)
# ---------------------------------------------------------------------------

def encode_value(value: int | float) -> tuple[bytes, int]:
    """Encode a datapoint value, returning ``(value_bytes, flags)``.

    Integers use variable-length encoding (1/2/4/8 bytes, big-endian,
    two's-complement); floats always encode as IEEE-754 (4 bytes when
    exactly representable in single precision, else 8).
    (ref: src/core/TSDB.java addPointInternal value handling)
    """
    if isinstance(value, bool):
        raise ValueError("boolean is not a valid datapoint value")
    if isinstance(value, int):
        if -(1 << 7) <= value < (1 << 7):
            return struct.pack(">b", value), 0
        if -(1 << 15) <= value < (1 << 15):
            return struct.pack(">h", value), 1
        if -(1 << 31) <= value < (1 << 31):
            return struct.pack(">i", value), 3
        if -(1 << 63) <= value < (1 << 63):
            return struct.pack(">q", value), 7
        raise ValueError(f"integer value out of int64 range: {value}")
    fval = float(value)
    as_f32 = struct.unpack(">f", struct.pack(">f", fval))[0]
    if as_f32 == fval or fval != fval:  # exact in f32, or NaN
        return struct.pack(">f", fval), const.FLAG_FLOAT | 3
    return struct.pack(">d", fval), const.FLAG_FLOAT | 7


def decode_value(value: bytes, flags: int) -> int | float:
    """Decode a value given its qualifier flags (ref: Internal.java:216-334)."""
    vlen = (flags & const.LENGTH_MASK) + 1
    if len(value) != vlen:
        raise IllegalDataError(
            f"value length {len(value)} does not match flags {flags:#x}")
    if flags & const.FLAG_FLOAT:
        if vlen == 4:
            return struct.unpack(">f", value)[0]
        if vlen == 8:
            return struct.unpack(">d", value)[0]
        raise IllegalDataError(f"invalid float length {vlen}")
    if vlen == 1:
        return struct.unpack(">b", value)[0]
    if vlen == 2:
        return struct.unpack(">h", value)[0]
    if vlen == 4:
        return struct.unpack(">i", value)[0]
    if vlen == 8:
        return struct.unpack(">q", value)[0]
    raise IllegalDataError(f"invalid integer length {vlen}")


# ---------------------------------------------------------------------------
# Timestamps
# ---------------------------------------------------------------------------

def is_ms_timestamp(timestamp: int) -> bool:
    """True when a unix timestamp is in milliseconds (ref: Const SECOND_MASK)."""
    return (timestamp & const.SECOND_MASK) != 0


def to_ms(timestamp: int) -> int:
    """Normalize a second-or-ms unix timestamp to milliseconds."""
    return timestamp if is_ms_timestamp(timestamp) else timestamp * 1000


def base_time(timestamp: int) -> int:
    """Row base time in *seconds*, aligned down to MAX_TIMESPAN.

    (ref: src/core/TSDB.java addPointInternal / Internal.java:850-856)
    """
    ts_sec = timestamp // 1000 if is_ms_timestamp(timestamp) else timestamp
    return ts_sec - (ts_sec % const.MAX_TIMESPAN)


# ---------------------------------------------------------------------------
# Qualifiers (ref: src/core/Internal.java:848-864)
# ---------------------------------------------------------------------------

def build_qualifier(timestamp: int, flags: int) -> bytes:
    """Build a 2-byte (seconds) or 4-byte (ms) column qualifier."""
    if is_ms_timestamp(timestamp):
        bt = base_time(timestamp)
        qual = ((int(timestamp - bt * 1000) << const.MS_FLAG_BITS) | flags
                | const.MS_FLAG) & 0xFFFFFFFF
        return struct.pack(">I", qual)
    bt = base_time(timestamp)
    qual = ((timestamp - bt) << const.FLAG_BITS) | flags
    return struct.pack(">H", qual)


def qualifier_is_ms(qualifier: bytes, offset: int = 0) -> bool:
    return (qualifier[offset] & const.MS_BYTE_FLAG) == const.MS_BYTE_FLAG


def qualifier_length(qualifier: bytes, offset: int = 0) -> int:
    return 4 if qualifier_is_ms(qualifier, offset) else 2

def parse_qualifier(qualifier: bytes, offset: int = 0) -> tuple[int, int]:
    """Parse one qualifier at ``offset``, returning ``(offset_ms, flags)``.

    ``offset_ms`` is the delta from the row base time in milliseconds
    (ref: Internal.java getOffsetFromQualifier).
    """
    if qualifier_is_ms(qualifier, offset):
        qual = struct.unpack_from(">I", qualifier, offset)[0]
        offset_ms = (qual & ~const.MS_FLAG) >> const.MS_FLAG_BITS
        flags = qual & ((1 << const.MS_FLAG_BITS) - 1) & const.FLAGS_MASK
        return offset_ms, flags
    qual = struct.unpack_from(">H", qualifier, offset)[0]
    offset_s = qual >> const.FLAG_BITS
    flags = qual & const.FLAGS_MASK
    return offset_s * 1000, flags


# ---------------------------------------------------------------------------
# Row keys (ref: src/core/RowKey.java, IncomingDataPoints.java)
# ---------------------------------------------------------------------------

class ParsedRowKey(NamedTuple):
    salt: bytes
    metric_uid: bytes
    base_time: int  # seconds
    tags: tuple[tuple[bytes, bytes], ...]  # ((tagk_uid, tagv_uid), ...) sorted


def build_row_key(metric_uid: bytes, timestamp: int,
                  tags: dict[bytes, bytes] | list[tuple[bytes, bytes]],
                  salt_width: int | None = None,
                  salt_buckets: int | None = None) -> bytes:
    """Build ``[salt][metric][base_time][tagk tagv]*`` (tags sorted by tagk).

    (ref: src/core/IncomingDataPoints.java rowKeyTemplate +
    RowKey.prefixKeyWithSalt, RowKey.java:141-165)
    """
    sw = const.salt_width() if salt_width is None else salt_width
    sb = const.salt_buckets() if salt_buckets is None else salt_buckets
    pairs = sorted(tags.items() if isinstance(tags, dict) else tags)
    body = bytearray(metric_uid)
    body += struct.pack(">I", base_time(timestamp))
    for tagk, tagv in pairs:
        body += tagk
        body += tagv
    if sw == 0:
        return bytes(body)
    bucket = salt_bucket(bytes(body), len(metric_uid), sb)
    return bucket.to_bytes(sw, "big") + bytes(body)


def salt_bucket(key_body: bytes, metric_width: int,
                buckets: int | None = None) -> int:
    """Salt bucket for an (unsalted) key: hash of metric+tags modulo buckets.

    (ref: RowKey.prefixKeyWithSalt, RowKey.java:141-165 — Java
    ``Arrays.hashCode`` over the key minus the timestamp, mod buckets.)
    """
    sb = const.salt_buckets() if buckets is None else buckets
    # Java Arrays.hashCode over metric + tags bytes (signed bytes).
    h = 1
    for b in key_body[:metric_width]:
        sb8 = b - 256 if b > 127 else b
        h = (31 * h + sb8) & 0xFFFFFFFF
    for b in key_body[metric_width + const.TIMESTAMP_BYTES:]:
        sb8 = b - 256 if b > 127 else b
        h = (31 * h + sb8) & 0xFFFFFFFF
    if h >= 0x80000000:
        h -= 0x100000000
    return abs(h) % sb


def parse_row_key(key: bytes, metric_width: int = const.METRICS_WIDTH,
                  tagk_width: int = const.TAG_NAME_WIDTH,
                  tagv_width: int = const.TAG_VALUE_WIDTH,
                  salt_width: int | None = None) -> ParsedRowKey:
    """Split a row key into salt / metric / base_time / tag pairs."""
    sw = const.salt_width() if salt_width is None else salt_width
    salt = key[:sw]
    pos = sw
    metric = key[pos:pos + metric_width]
    pos += metric_width
    (bt,) = struct.unpack_from(">I", key, pos)
    pos += const.TIMESTAMP_BYTES
    tags = []
    pair_w = tagk_width + tagv_width
    if (len(key) - pos) % pair_w != 0:
        raise IllegalDataError(f"row key length {len(key)} is not aligned")
    while pos < len(key):
        tags.append((key[pos:pos + tagk_width],
                     key[pos + tagk_width:pos + pair_w]))
        pos += pair_w
    return ParsedRowKey(salt, metric, bt, tuple(tags))


def tsuid_from_row_key(key: bytes, salt_width: int | None = None) -> bytes:
    """TSUID = metric uid + tag uids (timestamp and salt stripped).

    (ref: src/uid/UniqueId.java getTSUIDFromKey)
    """
    parsed = parse_row_key(key, salt_width=salt_width)
    out = bytearray(parsed.metric_uid)
    for tagk, tagv in parsed.tags:
        out += tagk
        out += tagv
    return bytes(out)


# ---------------------------------------------------------------------------
# Cells and compaction (ref: src/core/CompactionQueue.java:340,
# src/core/Internal.java:216-334)
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One (qualifier, value) storage cell, possibly compacted."""
    qualifier: bytes
    value: bytes

    def datapoints(self, row_base_time: int) -> Iterator[tuple[int, int | float]]:
        """Yield ``(timestamp_ms, value)`` for every point in this cell."""
        for ts_ms, _flags, val in iter_cell(self.qualifier, self.value,
                                            row_base_time):
            yield ts_ms, val


def iter_cell(qualifier: bytes, value: bytes,
              row_base_time: int) -> Iterator[tuple[int, int, int | float]]:
    """Iterate ``(timestamp_ms, flags, value)`` over a single or compacted cell.

    Compacted cells concatenate qualifiers and values; when second- and
    ms-precision points are mixed, a trailing MS_MIXED_COMPACT byte is
    appended to the value (ref: CompactionQueue.java:340, Internal.java).
    """
    n_quals = 0
    qpos = 0
    vlen_total = 0
    while qpos < len(qualifier):
        _, flags = parse_qualifier(qualifier, qpos)
        vlen_total += (flags & const.LENGTH_MASK) + 1
        qpos += qualifier_length(qualifier, qpos)
        n_quals += 1
    vbytes = value
    if vlen_total == len(vbytes) - 1:
        # mixed-precision compacted cell: trailing flag byte
        if vbytes[-1] != const.MS_MIXED_COMPACT:
            raise IllegalDataError(
                f"unexpected trailing value byte {vbytes[-1]:#x}")
        vbytes = vbytes[:-1]
    elif vlen_total != len(vbytes):
        raise IllegalDataError(
            f"value length {len(vbytes)} does not match qualifiers "
            f"({vlen_total} expected)")
    qpos = 0
    vpos = 0
    while qpos < len(qualifier):
        offset_ms, flags = parse_qualifier(qualifier, qpos)
        vlen = (flags & const.LENGTH_MASK) + 1
        val = decode_value(vbytes[vpos:vpos + vlen], flags)
        yield row_base_time * 1000 + offset_ms, flags, val
        qpos += qualifier_length(qualifier, qpos)
        vpos += vlen


def compact_cells(cells: list[Cell]) -> Cell:
    """Merge N single-point cells into one compacted cell.

    Points are sorted by time offset; on duplicate timestamps the
    *last-written* cell wins (matches the reference's fix-up semantics,
    ref: CompactionQueue.java:340-500). A trailing MS_MIXED_COMPACT byte is
    appended when precisions are mixed.
    """
    points: dict[int, tuple[int, bytes, bool]] = {}
    for cell in cells:
        qpos = 0
        vpos = 0
        while qpos < len(cell.qualifier):
            offset_ms, flags = parse_qualifier(cell.qualifier, qpos)
            is_ms = qualifier_is_ms(cell.qualifier, qpos)
            vlen = (flags & const.LENGTH_MASK) + 1
            points[offset_ms] = (flags, cell.value[vpos:vpos + vlen], is_ms)
            qpos += qualifier_length(cell.qualifier, qpos)
            vpos += vlen
    quals = bytearray()
    vals = bytearray()
    any_ms = False
    any_sec = False
    for offset_ms in sorted(points):
        flags, vbytes, is_ms = points[offset_ms]
        if is_ms:
            any_ms = True
            qual = ((offset_ms << const.MS_FLAG_BITS) | flags
                    | const.MS_FLAG) & 0xFFFFFFFF
            quals += struct.pack(">I", qual)
        else:
            any_sec = True
            qual = ((offset_ms // 1000) << const.FLAG_BITS) | flags
            quals += struct.pack(">H", qual)
        vals += vbytes
    if any_ms and any_sec:
        vals.append(const.MS_MIXED_COMPACT)
    return Cell(bytes(quals), bytes(vals))
