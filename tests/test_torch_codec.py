"""The port's storage codec (``opentsdb_tpu_torch/core/codec.py`` and
``core/const.py``) held against the JAX package's, byte for byte: every
case of ``tests/test_codec.py`` run through both packages, and a
hypothesis round trip over values, second and millisecond timestamps,
flags and salt settings whose encodings must be equal. No tolerance:
the bytes, flags, offsets and decoded values are compared exactly (NaN
by its bits). The salt is module state in each package; every case
restores both packages' settings after it runs."""

from __future__ import annotations

import math
import struct

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from opentsdb_tpu.core import codec as jcodec
from opentsdb_tpu.core import const as jconst
from opentsdb_tpu_torch.core import codec as tcodec
from opentsdb_tpu_torch.core import const as tconst

PAIRS = ((jcodec, jconst), (tcodec, tconst))


@pytest.fixture(autouse=True)
def salt_state():
    saved = [(c.salt_width(), c.salt_buckets()) for _, c in PAIRS]
    yield
    for (_, c), (w, b) in zip(PAIRS, saved):
        c.set_salt_width(w)
        c.set_salt_buckets(b)


def both(fn):
    """``fn(codec, const)`` on each package; the two answers must be
    equal (a raise must be of the same kind with the same message)."""
    out = []
    for codec, const in PAIRS:
        try:
            out.append(("ok", fn(codec, const)))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("raise", type(e).__name__, str(e)))
    assert _same(out[0], out[1]), out
    return out[1]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return struct.pack(">d", a) == struct.pack(">d", b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b or (
        type(a).__name__ == type(b).__name__ and a == b)


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


# -- tests/test_codec.py, case by case ---------------------------------------

@pytest.mark.parametrize("value,expected_len,expected_flags", [
    (0, 1, 0), (127, 1, 0), (-128, 1, 0),
    (128, 2, 1), (-129, 2, 1), (32767, 2, 1),
    (32768, 4, 3), (2**31 - 1, 4, 3),
    (2**31, 8, 7), (-2**63, 8, 7),
    (4.2, 8, jconst.FLAG_FLOAT | 7),
    (1.5, 4, jconst.FLAG_FLOAT | 3),
    (0.0, 4, jconst.FLAG_FLOAT | 3),
])
def test_value_roundtrip(value, expected_len, expected_flags):
    data, flags = both(lambda c, k: c.encode_value(value))[1]
    assert len(data) == expected_len and flags == expected_flags
    out = both(lambda c, k: c.decode_value(data, flags))[1]
    assert out == value
    assert isinstance(out, float) == isinstance(value, float)


def test_int64_overflow_rejected():
    assert both(lambda c, k: c.encode_value(2**63))[0] == "raise"


def test_bad_length_rejected():
    got = both(lambda c, k: c.decode_value(b"\x00\x00\x00", 3))
    assert got[:2] == ("raise", "IllegalDataError")


def test_second_precision_qualifier():
    q = both(lambda c, k: c.build_qualifier(1356998430, 0x3))[1]
    assert len(q) == 2
    assert both(lambda c, k: c.parse_qualifier(q))[1] == (30000, 0x3)
    assert both(lambda c, k: c.qualifier_is_ms(q))[1] is False


def test_ms_precision_qualifier():
    flags = jconst.FLAG_FLOAT | 0x3
    q = both(lambda c, k: c.build_qualifier(1356998430123, flags))[1]
    assert len(q) == 4
    assert both(lambda c, k: c.qualifier_is_ms(q))[1] is True
    assert both(lambda c, k: c.parse_qualifier(q))[1] == (30123, flags)


def test_max_second_delta():
    q = both(lambda c, k: c.build_qualifier(1356998400 + 3599, 0x7))[1]
    assert both(lambda c, k: c.parse_qualifier(q))[1] == (3599000, 0x7)


def test_base_time_alignment():
    for ts, want in ((1356998430, 1356998400), (1356998430123, 1356998400),
                     (3600, 3600), (3599, 0)):
        assert both(lambda c, k: c.base_time(ts))[1] == want


METRIC = b"\x00\x00\x01"
TAGK = b"\x00\x00\x02"
TAGV = b"\x00\x00\x03"


def test_row_key_build_parse_roundtrip():
    key = both(lambda c, k: c.build_row_key(METRIC, 1356998430,
                                            {TAGK: TAGV}, salt_width=0))[1]
    assert key == METRIC + (1356998400).to_bytes(4, "big") + TAGK + TAGV
    parsed = both(lambda c, k: tuple(c.parse_row_key(key, salt_width=0)))[1]
    assert parsed == (b"", METRIC, 1356998400, ((TAGK, TAGV),))


def test_row_key_tags_sorted_by_tagk():
    k1, v1 = b"\x00\x00\x09", b"\x00\x00\x0a"
    k2, v2 = b"\x00\x00\x02", b"\x00\x00\x0b"
    key = both(lambda c, k: c.build_row_key(
        METRIC, 0, [(k1, v1), (k2, v2)], salt_width=0))[1]
    tags = both(lambda c, k: c.parse_row_key(key, salt_width=0).tags)[1]
    assert tags == ((k2, v2), (k1, v1))


def test_salted_row_key():
    key = both(lambda c, k: c.build_row_key(
        METRIC, 1356998430, {TAGK: TAGV}, salt_width=1,
        salt_buckets=20))[1]
    assert len(key) == 1 + 3 + 4 + 6 and 0 <= key[0] < 20
    assert both(lambda c, k: c.parse_row_key(
        key, salt_width=1).metric_uid)[1] == METRIC
    key2 = both(lambda c, k: c.build_row_key(
        METRIC, 1356998430 + 7200, {TAGK: TAGV}, salt_width=1,
        salt_buckets=20))[1]
    assert key2[0] == key[0]


def test_tsuid_from_row_key():
    key = both(lambda c, k: c.build_row_key(METRIC, 1356998430,
                                            {TAGK: TAGV}, salt_width=0))[1]
    assert both(lambda c, k: c.tsuid_from_row_key(key, salt_width=0))[1] \
        == METRIC + TAGK + TAGV


def _cell(codec, ts, value):
    vbytes, flags = codec.encode_value(value)
    return codec.Cell(codec.build_qualifier(ts, flags), vbytes)


def _compacted(codec, points):
    return tuple(codec.compact_cells([_cell(codec, ts, v)
                                      for ts, v in points]))


def test_compact_and_iterate():
    base = 1356998400
    pts = [(base + 30, 42), (base + 10, 1.5), (base + 20, 7)]
    cell = both(lambda c, k: _compacted(c, pts))[1]
    got = both(lambda c, k: list(c.Cell(*cell).datapoints(base)))[1]
    assert got == [(base * 1000 + 10000, 1.5), (base * 1000 + 20000, 7),
                   (base * 1000 + 30000, 42)]


def test_mixed_precision_gets_flag_byte():
    base = 1356998400
    cell = both(lambda c, k: _compacted(c, [(base + 1, 1),
                                            (base * 1000 + 2500, 2)]))[1]
    assert cell[1][-1] == jconst.MS_MIXED_COMPACT
    assert [v for _, v in both(lambda c, k: list(
        c.Cell(*cell).datapoints(base)))[1]] == [1, 2]


def test_duplicate_timestamp_last_wins():
    base = 1356998400
    cell = both(lambda c, k: _compacted(c, [(base + 5, 1), (base + 5, 99)]))[1]
    assert both(lambda c, k: list(c.Cell(*cell).datapoints(base)))[1] == \
        [(base * 1000 + 5000, 99)]


def test_compacted_roundtrip_through_iter_cell():
    base = 1356998400
    cell = both(lambda c, k: _compacted(
        c, [(base + i, i * 1.5) for i in range(10)]))[1]
    assert [v for _, v in both(lambda c, k: list(
        c.Cell(*cell).datapoints(base)))[1]] == [i * 1.5 for i in range(10)]


# -- a round trip over the whole input space ---------------------------------

values = st.one_of(
    st.integers(min_value=-2**63, max_value=2**63 - 1),
    st.floats(allow_nan=True, allow_infinity=True, width=64),
    st.floats(width=32))
seconds = st.integers(min_value=1, max_value=0xFFFFFFFF)
millis = st.integers(min_value=2**32, max_value=(0xFFFFFFFF + 3600) * 1000)
uid3 = st.binary(min_size=3, max_size=3)


@settings(max_examples=300, deadline=None)
@given(value=values, ts=st.one_of(seconds, millis),
       tags=st.lists(st.tuples(uid3, uid3), min_size=0, max_size=8),
       salt_width=st.integers(min_value=0, max_value=4),
       salt_buckets=st.integers(min_value=1, max_value=300),
       more=st.lists(st.tuples(st.integers(min_value=0, max_value=3599),
                               values), max_size=12))
def test_encodings_equal_byte_for_byte(value, ts, tags, salt_width,
                                       salt_buckets, more):
    """Value, qualifier, row key (salted through the module state and
    through the arguments), TSUID and a compacted cell of second and
    millisecond points: both packages give the same bytes, and decode
    them to the same values."""
    def run(codec, const):
        const.set_salt_width(salt_width)
        const.set_salt_buckets(salt_buckets)
        data, flags = codec.encode_value(value)
        decoded = codec.decode_value(data, flags)
        qual = codec.build_qualifier(ts, flags)
        key = codec.build_row_key(METRIC, ts, tags)
        parsed = tuple(codec.parse_row_key(key))
        bucket = codec.salt_bucket(METRIC + b"\0\0\0\0"
                                   + b"".join(k + v for k, v in tags),
                                   3, salt_buckets)
        base = codec.base_time(ts)
        cells = [_cell(codec, base + off, v) for off, v in more]
        if base * 1000 > 0xFFFFFFFF:   # a millisecond timestamp
            cells += [_cell(codec, base * 1000 + off * 7 % 3600000, v)
                      for off, v in more[::3]]
        compacted = tuple(codec.compact_cells(cells)) if cells else None
        points = (list(codec.iter_cell(*compacted, base)) if compacted
                  else [])
        return (data, flags, decoded, qual, codec.parse_qualifier(qual),
                key, parsed, bucket, codec.tsuid_from_row_key(key),
                codec.is_ms_timestamp(ts), codec.to_ms(ts), compacted,
                points)

    # a double just past float32's range raises OverflowError in the
    # reference's encode_value (struct's "f" pack); the port raises the
    # same, which ``both`` holds like any other answer
    got = both(run)
    if got[0] == "ok" and isinstance(value, float) \
            and not math.isnan(value):
        assert got[1][2] == value
