"""Storage-format constants (ref: ``src/core/Const.java``,
``opentsdb_tpu/core/const.py``).

The byte-level contract with the reference storage schema: UID-encoded
series, salted row keys, hourly rows, 2/4-byte qualifiers. The codec
(:mod:`opentsdb_tpu_torch.core.codec`), ``fsck`` and the import and
export tools keep to it, though the column stores do not use the byte
encoding on their hot path.
"""

# Number of bytes on which a timestamp is encoded in a row key
# (ref: src/core/Const.java:25).
TIMESTAMP_BYTES = 4

# Number of LSBs in time_deltas reserved for flags (seconds qualifiers)
# (ref: src/core/Const.java:62).
FLAG_BITS = 4

# Number of LSBs in time_deltas reserved for flags (ms qualifiers)
# (ref: src/core/Const.java:65).
MS_FLAG_BITS = 6

# Flag set in a qualifier when the value is a float (ref: Const.java:71).
FLAG_FLOAT = 0x8

# Mask for extracting (value_length - 1) from qualifier flags
# (ref: Const.java:74).
LENGTH_MASK = 0x7

# Mask selecting all flag bits (ref: Const.java:86).
FLAGS_MASK = FLAG_FLOAT | LENGTH_MASK

# 4-byte qualifier prefix marking a millisecond-precision cell
# (ref: Const.java:80).
MS_FLAG = 0xF0000000

# First byte of a 4-byte ms qualifier has its top nibble set
# (ref: Const.java "MS_BYTE_FLAG").
MS_BYTE_FLAG = 0xF0

# Flag appended to a compacted cell value when it mixes second and ms
# precision points (ref: Const.java:83).
MS_MIXED_COMPACT = 1

# Row width in seconds: one storage row covers one hour of one series
# (ref: Const.java:95), the reference's time-blocking unit.
MAX_TIMESPAN = 3600

# Maximum number of tags allowed per data point (ref: Const.java:28-36).
MAX_NUM_TAGS = 8

# Any unix timestamp strictly above this is in milliseconds
# (ref: Const.java "SECOND_MASK" usage: ts & 0xFFFFFFFF00000000L != 0).
SECOND_MASK = 0xFFFFFFFF00000000

# Max unix epoch in seconds that fits the 4-byte row-key timestamp.
MAX_SECOND_TIMESTAMP = 0xFFFFFFFF

# Salting: the reference prefixes row keys with hash(series) % SALT_BUCKETS
# to spread load over HBase regions and scan 20-way in parallel
# (ref: Const.java:127-176, src/core/RowKey.java:141). ``fsck`` groups
# series into as many scan shards by the same count.
DEFAULT_SALT_BUCKETS = 20
DEFAULT_SALT_WIDTH = 0  # 0 = salting disabled (reference default)

# Annotation cells use a 1-byte 0x01 qualifier prefix
# (ref: src/meta/Annotation.java:86).
ANNOTATION_QUAL_PREFIX = 0x01

# Append-mode cells use qualifier 0x05 0x00 0x00
# (ref: src/core/AppendDataPoints.java:45-49).
APPEND_COLUMN_PREFIX = 0x05
APPEND_COLUMN_QUALIFIER = bytes((0x05, 0x00, 0x00))

# Histogram cells use a 0x06 qualifier prefix
# (ref: src/core/HistogramDataPoint.java:30).
HISTOGRAM_PREFIX = 0x06

# Default UID widths in bytes for metric / tagk / tagv
# (ref: src/uid/UniqueId.java, src/core/TSDB.java:245-250).
METRICS_WIDTH = 3
TAG_NAME_WIDTH = 3
TAG_VALUE_WIDTH = 3


class _SaltConfig:
    """Mutable salt configuration (ref: Const.java:127-176).

    Kept as module state behind accessors like the reference so tests can
    flip salting on/off (the reference's Salted test twins do exactly this).
    """

    def __init__(self) -> None:
        self.width = DEFAULT_SALT_WIDTH
        self.buckets = DEFAULT_SALT_BUCKETS


_salt = _SaltConfig()


def salt_width() -> int:
    return _salt.width


def salt_buckets() -> int:
    return _salt.buckets


def set_salt_width(width: int) -> None:
    if width < 0 or width > 8:
        raise ValueError(f"Invalid salt width: {width}")
    _salt.width = width


def set_salt_buckets(buckets: int) -> None:
    if buckets < 1:
        raise ValueError(f"Invalid salt buckets: {buckets}")
    _salt.buckets = buckets
