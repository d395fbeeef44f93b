"""The port's native store (``opentsdb_tpu_torch.native``) against the
JAX package's (``opentsdb_tpu.native.store_backend``), function by
function, on the CPU.

- Each library is built from its own copy of ``tsdbstore.cc`` with the
  same compiler and flags, so every read, parse and format must agree
  bit for bit: floats are compared by their bits.
- The same writes, made from a seed, go into both stores: series created
  in bulk, sorted and out-of-order chunks, duplicate timestamps (the
  last write wins), NaN and infinite values, and integer flags.
- The port's two backends (``native`` and ``memory``) take the same
  writes: materialized points must be equal bit for bit;
  ``bucket_reduce`` counts equal, minima and maxima equal in value (of
  0.0 and -0.0 in one bucket each store may keep either), and sums
  within 1e-12 relative (the memory store adds a bucket's points
  pairwise, the native one in time order).
- Config-3-shaped data (a few hundred series) queried through the JAX
  ``TSDB`` (its native default) and the port's on the CPU with each
  backend: equal rows between the port's backends, and within rtol 1e-9
  of the JAX package's (``torch_pair.assert_rows_close``).
- No fallback: a failing build raises from ``TSDB()``, an unknown
  backend raises, the JAX package's library is never loaded, two
  processes building at once both load a good library, and importing
  needs no compiler.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.native import store_backend as jnative
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.store import TimeSeriesStore
from opentsdb_tpu_torch.native import _build
from opentsdb_tpu_torch.native import store_backend as native
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from torch_pair import (ENGINE_KEYS, GRID_ON, T0, assert_rows_close,
                        jax_native_library, rows)

ROOT = Path(__file__).resolve().parent.parent
MS = T0 * 1000
S = 30                     # series per store
SUM_RTOL = 1e-12           # bucket_reduce sums, memory against native


def _jstore():
    if jax_native_library() is None:
        pytest.skip("no C++ compiler on this host: the JAX package's "
                    "native store cannot be built")
    # a library that fails to load fails the test
    return jnative.NativeTimeSeriesStore()


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def assert_bits(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _writes(seed: int):
    """A seeded list of store writes: ('bulk', tags_list),
    ('lines', sids, ts, vals, ints), ('many', sid, ts, vals, ints) and
    ('one', sid, ts, val, int)."""
    rng = np.random.default_rng(seed)
    tags = [((1, i), (2, i % 4)) for i in range(S)]
    out = [("bulk", tags[:S // 2]), ("bulk", tags[S // 3:])]
    # a sorted chunk: every series, one point a second
    sids = np.repeat(np.arange(S), 40)
    ts = MS + 1000 * np.tile(np.arange(40), S)
    vals = rng.normal(size=len(ts))
    out.append(("lines", sids, ts, vals, np.zeros(len(ts), np.uint8)))
    for _ in range(4):
        n = 200
        sids = rng.integers(-2, S, n)              # negative: skipped
        ts = MS + 1000 * rng.integers(-5, 60, n)   # overlaps, repeats
        vals = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)
        special = rng.random(n)
        vals[special < 0.05] = np.nan
        vals[(special >= 0.05) & (special < 0.08)] = np.inf
        vals[(special >= 0.08) & (special < 0.1)] = -np.inf
        ints = (rng.random(n) < 0.3).astype(np.uint8)
        vals[ints == 1] = np.round(vals[ints == 1])
        out.append(("lines", sids, ts, vals, ints))
    ts = MS + 1000 * rng.permutation(70)[:30]
    out.append(("many", 3, ts, rng.normal(size=30),
                np.ones(30, np.uint8)))
    out.append(("one", 5, MS + 7000, 42.0, 1))     # overwrites a point
    return out


def _apply(store, writes, flags: bool = True) -> None:
    for w in writes:
        if w[0] == "bulk":
            store.get_or_create_series_bulk(7, w[1])
        elif w[0] == "lines":
            store.append_lines(*w[1:4], w[4] if flags else None)
        elif w[0] == "many":
            store.append_many(*w[1:4], w[4] if flags else False)
        elif flags:
            store.append(*w[1:])
        else:
            store.append_lines([w[1]], [w[2]], [w[3]])


@pytest.fixture(params=[0, 1])
def pair(request):
    writes = _writes(request.param)
    j, t = _jstore(), native.NativeTimeSeriesStore()
    _apply(j, writes)
    _apply(t, writes)
    return j, t


WINDOWS = [(0, 2**62), (MS, MS + 30_000), (MS + 10_500, MS + 10_999),
           (MS - 5000, MS - 1), (MS + 100_000, MS + 200_000)]


def _selections():
    rng = np.random.default_rng(5)
    return [np.arange(S), rng.permutation(S)[:17], np.array([4, 4, 2]),
            np.empty(0, np.int64)]


@pytest.mark.parametrize("lo,hi", WINDOWS)
def test_range_reads_bit_for_bit(pair, lo, hi):
    j, t = pair
    assert t.points_written == j.points_written
    assert t.num_series() == j.num_series() == S
    for sel in _selections():
        assert_bits(t.count_range(sel, lo, hi), j.count_range(sel, lo, hi))
        got, want = t.materialize(sel, lo, hi), j.materialize(sel, lo, hi)
        for a, b in zip(got, want):
            assert_bits(a, b)
        got = t.materialize_padded(sel, lo, hi)
        want = j.materialize_padded(sel, lo, hi)
        for a, b in zip(got, want):
            assert_bits(a, b)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("t0,interval,nb", [
    (MS, 10_000, 6),            # the whole window in buckets
    (MS + 5000, 7000, 3),       # points before t0 and past the last bucket
    (MS - 5000, 1000, 80),      # one point a bucket
    (MS, 3_600_000, 1)])
def test_bucket_reduce_bit_for_bit(pair, minmax, t0, interval, nb):
    j, t = pair
    for sel in _selections()[:3]:
        got = t.bucket_reduce(sel, MS - 5000, MS + 65_000, t0, interval,
                              nb, want_minmax=minmax)
        want = j.bucket_reduce(sel, MS - 5000, MS + 65_000, t0, interval,
                               nb, want_minmax=minmax)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert_bits(a, b)


def test_series_points_and_integer_flags(pair):
    j, t = pair
    for sid in range(S):
        got = t.series_points(sid)
        want = j.series(sid).buffer.view_full()
        for a, b in zip(got, want):
            assert_bits(a, b)
    with pytest.raises(IndexError):
        t.series_points(S)


def test_append_paths_count_and_refuse(pair):
    j, t = pair
    sids, ts, vals = [-1, 2, 2, -5, 0], [MS] * 5, [1.0, 2.0, 3.0, 4.0, 5.0]
    assert t.append_lines(sids, ts, vals, [0, 1, 0, 0, 1]) == \
        j.append_lines(sids, ts, vals, [0, 1, 0, 0, 1]) == 3
    assert t.points_written == j.points_written
    before = t.points_written
    with pytest.raises(IndexError):
        t.append_lines([0, S], [MS, MS], [1.0, 2.0])
    assert t.points_written == before     # checked before any write
    with pytest.raises(ValueError):
        t.append_lines([0, 1], [MS], [1.0])
    with pytest.raises(IndexError):
        t.append(S, MS, 1.0)
    with pytest.raises(IndexError):
        t.append_many(S, [MS], [1.0])
    with pytest.raises(ValueError):
        t.bucket_reduce([0], 0, 2**62, MS, 0, 1)
    with pytest.raises(IndexError):
        t.count_range([S], 0, 2**62)
    assert_bits(t.materialize([2], MS, MS).values,
                j.materialize([2], MS, MS).values)


def test_delete_range(pair):
    j, t = pair
    sel = [0, 3, 5, 9]
    assert t.delete_range(sel, MS + 10_000, MS + 20_000) == \
        j.delete_range(sel, MS + 10_000, MS + 20_000) > 0
    assert t.mutation_epoch == j.mutation_epoch == 1
    assert t.delete_range(sel, MS + 10_000, MS + 20_000) == 0
    assert t.mutation_epoch == 1
    for a, b in zip(t.materialize(np.arange(S), 0, 2**62),
                    j.materialize(np.arange(S), 0, 2**62)):
        assert_bits(a, b)
    with pytest.raises(IndexError):
        t.delete_range([S], 0, 1)


@pytest.mark.parametrize("drop_nonfinite", [True, False])
def test_repair_series(pair, drop_nonfinite):
    j, t = pair
    for sid in range(S):
        assert t.repair_series(sid, MS, MS + 30_000, drop_nonfinite) == \
            j.repair_series(sid, MS, MS + 30_000, drop_nonfinite)
    assert t.mutation_epoch == j.mutation_epoch > 0
    for a, b in zip(t.materialize_padded(np.arange(S), 0, 2**62),
                    j.materialize_padded(np.arange(S), 0, 2**62)):
        assert_bits(a, b)
    with pytest.raises(IndexError):
        t.repair_series(S, 0, 1)


def test_patch_value(pair):
    j, t = pair
    ts, _, _ = t.series_points(4)
    for st in (t, j):
        st.patch_value(4, int(ts[3]), -0.0, True)
        st.patch_value(4, int(ts[-1]), np.nan)
    for a, b in zip(t.series_points(4), j.series(4).buffer.view_full()):
        assert_bits(a, b)
    assert t.mutation_epoch == 2
    with pytest.raises(KeyError):
        t.patch_value(4, MS + 999, 1.0)
    with pytest.raises(IndexError):
        t.patch_value(S, MS, 1.0)


def test_append_grid(pair):
    j, t = pair
    rng = np.random.default_rng(3)
    sids = rng.permutation(S)[:12]
    bts = MS + 15_000 * np.arange(8)           # on and between points
    grid = rng.normal(size=(12, 8))
    mask = rng.random((12, 8)) < 0.6
    assert t.append_grid(sids, bts, grid, mask) == \
        j.append_grid(sids, bts, grid, mask) == int(mask.sum())
    assert t.points_written == j.points_written
    for a, b in zip(t.materialize(np.arange(S), 0, 2**62),
                    j.materialize(np.arange(S), 0, 2**62)):
        assert_bits(a, b)
    with pytest.raises(IndexError):
        t.append_grid([S], bts[:1], grid[:1, :1], mask[:1, :1])
    with pytest.raises(ValueError):
        t.append_grid(sids, bts, grid[:, :3], mask)


def test_memory_info_and_stats(pair):
    j, t = pair
    assert t.memory_info() == j.memory_info()
    assert t.total_points() == j.total_points()

    class Collector:
        def __init__(self):
            self.seen = {}

        def record(self, name, value, **tags):
            self.seen[name] = value

    c = Collector()
    t.collect_stats(c)
    assert c.seen["storage.series.count"] == S
    assert c.seen["storage.points.written"] == t.points_written
    assert c.seen["storage.live_bytes"] == 17 * t.total_points()


# -- the import parse --------------------------------------------------------

IMPORT_LINES = [
    b"sys.cpu 1356998400 42 host=a dc=x",
    b"sys.cpu 1356998460 4.5e1 dc=x host=a",          # same series
    b"sys.cpu\t1356998400000  -0 host=b",            # ms, tabs, -0
    b"",                                             # blank
    b"   # an indented comment",
    b"sys.cpu 1356998400 1",                         # 1: too few
    b"sys.cpu 13569x8400 1 host=a",                  # 2: timestamp
    b"sys.cpu 0 1 host=a",                           # 2: zero
    b"sys.cpu 999999999999999 1 host=a",             # 2: too long
    b"sys.cpu 1356998400 nan host=a",                # 3: nan
    b"sys.cpu 1356998400 0x10 host=a",               # 3: hex
    b"sys.cpu 1356998400 1.5.2 host=a",              # 3
    b"sys.cpu 1356998400 1 hosta",                   # 4: no '='
    b"sys.cpu 1356998400 1 host=",                   # 4: empty value
    b"sys.cpu 1356998400 1 " + b" ".join(b"k%d=v" % i for i in range(9)),
    b"sys.cpu " + b"1 " * 20 + b"a=b",               # 4: > 16 tokens
    b"bad! 1356998400 1 host=a",                     # 5: metric
    b"sys.cpu 1356998400 1 host=a=b",                # 5: value
    b"sys.cpu 1356998400 123456789012345678 host=c",  # integer path
    b"sys.cpu 1356998400 1234567890123456789 host=c",  # float path
    b"caf\xc3\xa9.m 1356998400 1 host=\xc3\xa9\r",   # UTF-8, CRLF
    b"sys.mem 1356998400 +7 host=a",
]


def _import_buffer(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = list(IMPORT_LINES)
    for i in range(400):
        lines.append(b"m%d %d %s h=%d r=%d" % (
            rng.integers(0, 3), T0 + int(rng.integers(0, 10**6)),
            repr(float(rng.normal())).encode(), rng.integers(0, 20),
            rng.integers(0, 5)))
    order = rng.permutation(len(lines))
    return b"\n".join(lines[i] for i in order)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed,trailing", [(0, b""), (1, b"\n")])
def test_parse_import_bit_for_bit(threads, seed, trailing):
    buf = _import_buffer(seed) + trailing
    got = native.parse_import_buffer(buf, threads=threads)
    want = jnative.parse_import_buffer(buf, threads=threads)
    for name in ("ts", "values", "is_int", "group_ids", "errors"):
        assert_bits(getattr(got, name), getattr(want, name))
    assert got.rep_lines == want.rep_lines
    assert got.num_groups == want.num_groups
    assert got.num_lines == want.num_lines == buf.count(b"\n") + \
        (not buf.endswith(b"\n"))
    assert set(got.errors.tolist()) == {-1, 0, 1, 2, 3, 4, 5}
    assert native.IMPORT_ERRORS == jnative.IMPORT_ERRORS


def test_parse_import_empty():
    got = native.parse_import_buffer(b"")
    assert got.num_lines == got.num_groups == 0 and not got.rep_lines


# -- the dps formatter -------------------------------------------------------

SPECIAL_VALUES = [np.nan, np.inf, -np.inf, -0.0, 2.0**53, 2.0**60, 1e16,
                  1e-5, 0.1, 123456.789, 5e-324, 1.7976931348623157e308,
                  -2.0**53 + 1, 1e22, 1.2345678901234568e16, 0.0001, 3.0,
                  -7.5, 1e-7, 99.99, 2.5e15]


def _dps(seed: int):
    """300 points at distinct ms timestamps: values over 37 decades, a
    seventh of them integral, and the special values."""
    rng = np.random.default_rng(seed)
    n = 300
    ts = MS + np.sort(rng.choice(10**8, n, replace=False))
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-12, 25, n)
    vals[::7] = np.round(vals[::7])
    vals[1:1 + 11 * len(SPECIAL_VALUES):11] = SPECIAL_VALUES
    return ts, vals


@pytest.mark.parametrize("seconds", [False, True])
@pytest.mark.parametrize("as_arrays", [False, True])
def test_format_dps_bit_for_bit(seconds, as_arrays):
    assert native.format_dps_is_fast() == jnative.format_dps_is_fast()
    for seed in range(3):
        ts, vals = _dps(seed)
        got = native.format_dps(ts, vals, seconds, as_arrays)
        assert got == jnative.format_dps(ts, vals, seconds, as_arrays)
        if seconds and not as_arrays:
            continue        # a map keyed on seconds may merge points
        # the text parses to the same doubles
        body = (b"[" + got + b"]") if as_arrays else (b"{" + got + b"}")
        parsed = json.loads(body)
        items = parsed if as_arrays else [[int(k), v]
                                          for k, v in parsed.items()]
        want = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        back = np.array([want[v] if isinstance(v, str) else float(v)
                         for _, v in items])
        np.testing.assert_array_equal(back, vals)
    assert native.format_dps(np.empty(0), np.empty(0), True, False) == b""


# -- the port's two backends -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backends_agree(seed):
    """The same writes into the port's native and memory stores (the
    memory store drops the integer flags)."""
    writes = _writes(seed)
    nat, mem = native.NativeTimeSeriesStore(), TimeSeriesStore()
    _apply(nat, writes)
    _apply(mem, writes, flags=False)
    assert nat.version == mem.version
    for lo, hi in WINDOWS:
        for sel in _selections():
            assert_bits(nat.count_range(sel, lo, hi),
                        mem.count_range(sel, lo, hi))
            for a, b in zip(nat.materialize(sel, lo, hi),
                            mem.materialize(sel, lo, hi)):
                assert_bits(a, b)
            for a, b in zip(nat.materialize_padded(sel, lo, hi),
                            mem.materialize_padded(sel, lo, hi)):
                assert_bits(a, b)
    for t0, interval, nb in ((MS, 10_000, 6), (MS + 5000, 7000, 3),
                             (MS - 5000, 1000, 80)):
        for sel in _selections()[:3]:
            got = nat.bucket_reduce(sel, MS - 5000, MS + 65_000, t0,
                                    interval, nb, want_minmax=True)
            want = mem.bucket_reduce(sel, MS - 5000, MS + 65_000, t0,
                                     interval, nb, want_minmax=True)
            for name, a, b in zip(("sum", "count", "min", "max"), got,
                                  want):
                if name == "sum":
                    np.testing.assert_allclose(a, b, rtol=SUM_RTOL,
                                               atol=0)
                else:
                    np.testing.assert_array_equal(a, b)
    sids, triples = nat.metric_index(7).arrays()
    msids, mtriples = mem.metric_index(7).arrays()
    assert_bits(sids, msids)
    assert_bits(triples, mtriples)


def test_make_store_and_default():
    from opentsdb_tpu_torch.utils.config import Config as C
    assert C().get_string("tsd.storage.backend") == "native"
    assert isinstance(native.make_store(C()), native.NativeTimeSeriesStore)
    assert isinstance(native.make_store(C(**{"tsd.storage.backend":
                                              "memory"})), TimeSeriesStore)
    with pytest.raises(ValueError, match="unknown tsd.storage.backend"):
        native.make_store(C(**{"tsd.storage.backend": "hbase"}))
    with pytest.raises(ValueError, match="unknown tsd.storage.backend"):
        TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.storage.backend": "Native"}))
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    assert t.store.backend == "native"


# -- the engine at config 3's shape ------------------------------------------

CONFIG3_QUERIES = ("sum:5m-avg:rate:sys.cpu.user{dc=*}",
                   "sum:5m-avg:rate:sys.cpu.user{rack=*}")
N3, P3 = 400, 60


def _config3_data():
    """Config 3's shape at 400 series: ``sys.cpu.user`` tagged host, dc
    (i % 100) and rack (i % 2000), 60 points at one a minute,
    normal(100, 15) values, seed 0."""
    rng = np.random.default_rng(0)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}", "rack": f"r{i % 2000}"}
            for i in range(N3)]
    ts2d = np.broadcast_to(T0 + 60 * np.arange(P3, dtype=np.int64),
                           (N3, P3))
    return tags, ts2d, rng.normal(100.0, 15.0, (N3, P3))


@pytest.mark.parametrize("keys", [ENGINE_KEYS, GRID_ON],
                         ids=["point", "grid"])
def test_engine_config3_shape_on_both_backends(keys):
    tags, ts2d, vals = _config3_data()
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu", **keys}))
    assert isinstance(jt.store, jnative.NativeTimeSeriesStore)
    for i, t in enumerate(tags):
        jt.add_points("sys.cpu.user", ts2d[i], vals[i], t)
    got = {}
    for backend in ("native", "memory"):
        tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                            "tsd.torch.dtype": "float64",
                            "tsd.core.auto_create_metrics": "true",
                            "tsd.storage.backend": backend, **keys}))
        assert tt.store.backend == backend
        tt.add_series_points("sys.cpu.user", tags, ts2d, vals)
        for m in CONFIG3_QUERIES:
            q = {"start": str(T0), "end": str(T0 + P3 * 60 - 1),
                 "queries": [_sub(m)]}
            want = rows(jt.execute_query(JQuery.from_json(q).validate()))
            got[backend, m] = rows(tt.execute_query(
                TSQuery.from_json(q).validate()))
            assert_rows_close(got[backend, m], want)
        tt.shutdown()
    jt.shutdown()
    for m in CONFIG3_QUERIES:
        assert len(got["native", m]) in (100, 400)
        if keys is ENGINE_KEYS:
            # the same points on the same path: the same bits
            assert got["native", m] == got["memory", m]


def _sub(m: str) -> dict:
    from torch_pair import uri_query
    return uri_query(m)["queries"][0]


# -- bulk import through the TSDB --------------------------------------------

def _pair_tsdbs():
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu", **ENGINE_KEYS}))
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64",
                        "tsd.core.auto_create_metrics": "true",
                        **ENGINE_KEYS}))
    return jt, tt


def _by_tags(results):
    return sorted(rows(results), key=lambda r: sorted(r[1].items()))


def test_import_buffer_matches_reference():
    """The same buffer through both ``TSDB.import_buffer``: the same
    points written, errors on the same lines, the same answers."""
    buf = _import_buffer(4)
    jt, tt = _pair_tsdbs()
    jerr, terr = [], []
    jn, _ = jt.import_buffer(buf, on_error=lambda i, e: jerr.append(i))
    tn, errors = tt.import_buffer(buf, on_error=lambda i, e: terr.append(i))
    assert tn == jn > 400 and sorted(jerr) == terr and len(errors) == len(terr)
    assert tt.datapoints_added == tn
    for m in ("m0", "m1", "m2", "sys.cpu"):
        q = {"start": "1356998000", "end": str(T0 + 10**6 + 10),
             "queries": [{"aggregator": "sum", "metric": m,
                          "filters": [{"type": "wildcard", "tagk": "h"
                                       if m != "sys.cpu" else "host",
                                       "filter": "*", "groupBy": True}]}]}
        # new tag values get UIDs in another order (the reference
        # resolves series in its parser's group order): rows by tags
        want = _by_tags(jt.execute_query(JQuery.from_json(q).validate()))
        assert_rows_close(_by_tags(tt.execute_query(
            TSQuery.from_json(q).validate())), want)
    jt.shutdown()
    tt.shutdown()


def test_import_buffer_in_line_order():
    """UIDs are assigned, and failing lines reported, in line order: a
    series whose first line comes later resolves later, and each
    failure is reported after every line before it has landed."""
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.core.auto_create_metrics": "true"}))
    seen = []

    def on_error(lineno, exc):
        seen.append((lineno, tt.store.points_written))

    buf = (b"o.m 1356998400 1 host=z\n"
           b"o.m 1356998400 nan host=w\n"
           b"o.m 1356998460 2 host=y\n"
           b"o.m 1356998520 3 host=z\n"
           b"o.m 1356998400 1 host=x=1\n"
           b"o.m 1356998580 4 host=x\n")
    written, errors = tt.import_buffer(buf, on_error=on_error)
    assert written == 4
    assert seen == [(2, 1), (5, 3)]
    assert errors == ["line 2: invalid value",
                      "line 5: invalid character in metric or tag"]
    assert sorted("zyx", key=tt.uids.tag_values.get_id) == ["z", "y", "x"]
    mem = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.storage.backend": "memory"}))
    with pytest.raises(RuntimeError, match="needs tsd.storage.backend"):
        mem.import_buffer(buf)


def test_import_buffer_unknown_metric_fails_each_line():
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.core.auto_create_metrics": "true"}))
    tt.add_point("known", T0, 1, {"host": "a"})
    tt.auto_metric = False
    got = []
    written, errors = tt.import_buffer(
        b"new.m 1356998400 1 host=a\nknown 1356998460 2 host=a\n"
        b"new.m 1356998520 3 host=a\n",
        on_error=lambda i, e: got.append((i, type(e).__name__)))
    assert written == 1
    assert got == [(1, "NoSuchUniqueName"), (3, "NoSuchUniqueName")]


def test_integer_flags_kept_by_the_native_store():
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.core.auto_create_metrics": "true"}))
    tt.add_point("f.m", T0, 3, {"host": "a"})
    tt.add_point("f.m", T0 + 60, 3.5, {"host": "a"})
    tt.add_points("f.m", [T0 + 120, T0 + 180], np.array([4, 5]),
                  {"host": "a"})
    tt.import_buffer(b"f.m 1356998640 6 host=a\nf.m 1356998700 6.5 host=a\n")
    ts, vals, ints = tt.store.series_points(0)
    assert ints.tolist() == [True, False, True, True, True, False]
    np.testing.assert_array_equal(vals, [3, 3.5, 4, 5, 6, 6.5])


# -- the serializer's native formatter -----------------------------------------

def test_http_answer_bytes_equal_reference():
    """Through each package's HTTP router, a query whose values spell
    differently in the native formatter than in Python's repr: the
    port's answer is the reference's, byte for byte, on the native
    backend; on the memory backend it parses to the same values."""
    rng = np.random.default_rng(9)
    common = {"tsd.core.auto_create_metrics": "true", **ENGINE_KEYS}
    jt = JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", **common}))
    ts = T0 + 60 * np.arange(60)
    data = []
    for h in range(3):
        vals = rng.normal(size=60) * 10.0 ** rng.integers(-6, 20, 60)
        vals[5] = 1e-4
        vals[7] = 1.2345678901234568e16
        data.append(({"host": f"h{h}"}, vals))
        jt.add_points("b.m", ts, vals, {"host": f"h{h}"})
    params = {"start": [str(T0)], "end": [str(T0 + 3599)],
              "m": ["sum:b.m{host=*}"]}
    want = JRouter(jt).handle(JRequest(method="GET", path="/api/query",
                                       params=params, body=b""))
    bodies = {}
    for backend in ("native", "memory"):
        tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                            "tsd.torch.dtype": "float64",
                            "tsd.storage.backend": backend, **common}))
        for tags, vals in data:
            tt.add_points("b.m", ts, vals, tags)
        got = HttpRpcRouter(tt).handle(HttpRequest(
            method="GET", path="/api/query", params=params, body=b""))
        assert got.status == want.status == 200
        bodies[backend] = got.body
    assert bodies["native"] == want.body
    assert b"1e-04" in want.body
    assert bodies["memory"] != want.body
    assert json.loads(bodies["memory"]) == json.loads(want.body)
    jt.shutdown()


# -- no fallback, isolation, concurrent builds ---------------------------------

def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_failing_build_raises_from_tsdb(tmp_path):
    """A compiler that fails: constructing a native TSDB raises with
    its output, and nothing is swapped in. The memory backend still
    works without a compiler."""
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\n"
                  "if [ \"$1\" = --version ]; then echo broken-cc 1.0; "
                  "exit 0; fi\n"
                  "echo 'tsdbstore.cc:1: error: no compiler here' >&2\n"
                  "exit 1\n")
    cc.chmod(0o755)
    code = textwrap.dedent("""
        import sys
        from opentsdb_tpu_torch import TSDB, Config
        from opentsdb_tpu_torch.native._build import NativeBuildError
        try:
            TSDB(Config(**{"tsd.torch.device": "cpu"}))
        except NativeBuildError as e:
            assert sys.argv[1] in str(e), str(e)
        else:
            raise AssertionError("a native TSDB was built")
        t = TSDB(Config(**{"tsd.torch.device": "cpu",
                           "tsd.storage.backend": "memory"}))
        assert t.store.backend == "memory"
        print("ok")
    """)
    for cxx, said in ((str(cc), "error: no compiler here"),
                      ("/bin/false", "/bin/false --version failed")):
        out = subprocess.run([sys.executable, "-c", code, said], cwd=ROOT,
                             env={**os.environ, "CXX": cxx},
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"


def test_import_needs_no_compiler(tmp_path):
    env = {**os.environ, "PATH": str(tmp_path)}
    env.pop("CXX", None)
    out = _run("import opentsdb_tpu_torch.native.store_backend\n"
               "import opentsdb_tpu_torch.tsd.json_serializer\n"
               "print('ok')", env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_never_loads_the_reference_library():
    code = textwrap.dedent("""
        import numpy as np
        from opentsdb_tpu_torch import TSDB, Config
        t = TSDB(Config(**{"tsd.torch.device": "cpu",
                           "tsd.core.auto_create_metrics": "true"}))
        t.import_buffer(b"m 1356998400 1 host=a\\n")
        maps = open("/proc/self/maps").read()
        print("reference" if "opentsdb_tpu/native/libtsdbstore" in maps
              else "clean")
        print("port" if "opentsdb_tpu_torch/_build/tsdbstore_" in maps
              else "missing")
    """)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["clean", "port"]


def test_concurrent_builds_load_one_good_library(tmp_path):
    """Two processes build into an empty directory at once; both load
    a library that works, and no temporary file is left."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        from opentsdb_tpu_torch.native import _build, store_backend
        _build.BUILD_DIR = Path({str(tmp_path)!r})
        st = store_backend.NativeTimeSeriesStore()
        sid = st.get_or_create_series(1, [(1, 1)])
        st.append_many(sid, [3, 1, 2, 1], [30.0, 10.0, 20.0, 11.0])
        print(st.materialize([sid], 0, 10).values.tolist())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        assert out.strip() == "[11.0, 20.0, 30.0]"
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("tsdbstore_") \
        and built[0].endswith(".so")


def test_library_name_tracks_source_flags_compiler_and_cpu(monkeypatch,
                                                          tmp_path):
    base = _build.library_path()
    assert base.parent == _build.BUILD_DIR
    edited = tmp_path / "tsdbstore.cc"
    edited.write_bytes(_build.SOURCE.read_bytes() + b"\n")
    for name, value in (("SOURCE", edited),
                        ("CXX_FLAGS", _build.CXX_FLAGS + ("-g",)),
                        ("_cpu_model", lambda: "another cpu"),
                        ("_compiler_version", lambda: "another g++")):
        with monkeypatch.context() as m:
            m.setattr(_build, name, value)
            assert _build.library_path() != base
    assert _build.library_path() == base


# -- the tests' private build of the JAX package's library --------------------

def test_private_build_flags_match_the_reference():
    """``torch_pair`` compiles the JAX package's source with a copy of
    its flags: each copied flag must still be in its build function."""
    import inspect

    import torch_pair
    src = inspect.getsource(jnative.build_library)
    for flag in (torch_pair.JAX_CXX, *torch_pair.JAX_CXX_FLAGS):
        assert f'"{flag}"' in src, flag


def test_jax_library_is_the_private_build():
    """A process that imports ``torch_pair`` first loads the JAX
    package's library from the private, atomically renamed build,
    never the file the JAX package compiles in place. (In a pytest
    worker a JAX test module may have loaded it before ``torch_pair``
    was imported; the check runs in a fresh process.)"""
    if jax_native_library() is None:
        pytest.skip("no C++ compiler on this host: the JAX package's "
                    "native store cannot be built")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT / "tests")!r})
        import torch_pair
        from opentsdb_tpu.native import store_backend as jnative
        lib = torch_pair.jax_native_library()
        jnative.NativeTimeSeriesStore()
        maps = open("/proc/self/maps").read()
        print(lib.parent == torch_pair.BUILD_DIR,
              lib.name.startswith("jax_tsdbstore_"),
              jnative._LIB_PATH == str(lib), str(lib) in maps,
              "opentsdb_tpu/native/libtsdbstore" in maps)
    """)
    out = _run(code, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "True", "True", "False"]
