"""Histogram datapoints (ref: ``opentsdb_tpu/core/histogram.py``;
``src/core/SimpleHistogram.java``, ``HistogramCodecManager.java``).

Distribution-valued series: each datapoint is a bucketed histogram blob.
A query merges histograms bucket-wise (SUM, the only aggregation the
reference defines, ``HistogramAggregation.java:20``) and extracts
percentiles (``SimpleHistogram.percentile`` :133).

:class:`HistogramArena` keeps one metric's points as flat columns (the
timestamp, the series id and a float64 counts row per point), one
sub-arena per distinct bucket bounds, so a query slices a window with
vectorized masks and uploads the counts as one ``[N, NB]`` matrix
(:mod:`opentsdb_tpu_torch.query.histogram_engine`).

Wire format: the blob's first byte is the codec id; the built-in
:class:`SimpleHistogramCodec` (id 0x01) packs bounds, counts and the
under/overflow counters with ``struct``, byte for byte as the
reference does.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np


class SimpleHistogram:
    """Explicit-bucket histogram (ref: SimpleHistogram.java:43).

    Bucket i is ``[bounds[i], bounds[i+1])`` with a count, beside the
    underflow and overflow counters. A percentile is the midpoint of the
    bucket whose cumulative count crosses the rank
    (SimpleHistogram.java:133-170).
    """

    def __init__(self, bounds: Sequence[float] | None = None):
        self.bounds: list[float] = list(bounds) if bounds is not None else []
        n = max(0, len(self.bounds) - 1)
        self.counts: list[int] = [0] * n
        self.underflow = 0
        self.overflow = 0
        # the arena's views of this point, reset by every mutator
        self._row: np.ndarray | None = None
        self._bkey: tuple | None = None

    def add(self, value: float, count: int = 1) -> None:
        if not self.bounds:
            raise ValueError("histogram has no buckets")
        if value < self.bounds[0]:
            self.underflow += count
            return
        if value >= self.bounds[-1]:
            self.overflow += count
            return
        idx = int(np.searchsorted(self.bounds, value, side="right")) - 1
        self.counts[idx] += count
        self._invalidate()

    def set_bucket(self, lo: float, hi: float, count: int) -> None:
        """Set a bucket's count by its bounds, adding the bucket if new."""
        self._invalidate()
        if not self.bounds:
            self.bounds = [lo, hi]
            self.counts = [count]
            return
        for i in range(len(self.counts)):
            if self.bounds[i] == lo and self.bounds[i + 1] == hi:
                self.counts[i] = count
                return
        if lo >= self.bounds[-1]:
            if lo != self.bounds[-1]:
                self.bounds.append(lo)
                self.counts.append(0)
            self.bounds.append(hi)
            self.counts.append(count)
        elif hi <= self.bounds[0]:
            if hi != self.bounds[0]:
                self.bounds.insert(0, hi)
                self.counts.insert(0, 0)
            self.bounds.insert(0, lo)
            self.counts.insert(0, count)
        else:
            raise ValueError(
                f"bucket [{lo},{hi}) overlaps existing bounds {self.bounds}")

    def total_count(self) -> int:
        return sum(self.counts) + self.underflow + self.overflow

    def merge(self, other: "SimpleHistogram") -> None:
        """Bucket-wise SUM (ref: HistogramAggregation SUM)."""
        if self.bounds and other.bounds and self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        if not self.bounds:
            self.bounds = list(other.bounds)
            self.counts = list(other.counts)
        else:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
        self.underflow += other.underflow
        self.overflow += other.overflow
        self._invalidate()

    def percentile(self, perc: float) -> float:
        """(ref: SimpleHistogram.percentile :133) The midpoint of the
        bucket holding the rank; the bottom bound when the underflow
        holds it, the top bound when the overflow does. The query path
        counts only the buckets (ROADMAP Queue 3)."""
        if not 0 <= perc <= 100:
            raise ValueError(f"invalid percentile {perc}")
        total = self.total_count()
        if total == 0:
            return 0.0
        target = total * perc / 100.0
        acc = self.underflow
        if acc >= target and self.underflow:
            return float(self.bounds[0]) if self.bounds else 0.0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return (self.bounds[i] + self.bounds[i + 1]) / 2.0
        return float(self.bounds[-1]) if self.bounds else 0.0

    def counts_array(self) -> np.ndarray:
        """The counts as a float64 row (cached until a mutation)."""
        if self._row is None:
            self._row = np.asarray(self.counts, dtype=np.float64)
        return self._row

    def bounds_key(self) -> tuple:
        """Hashable bounds identity (cached), the arena's sub-arena key."""
        if self._bkey is None:
            self._bkey = tuple(self.bounds)
        return self._bkey

    def _invalidate(self) -> None:
        self._row = None
        self._bkey = None

    def to_json(self) -> dict:
        return {
            "buckets": {f"{self.bounds[i]},{self.bounds[i+1]}": c
                        for i, c in enumerate(self.counts)},
            "underflow": self.underflow,
            "overflow": self.overflow,
        }


class HistogramArena:
    """Columnar store of one metric's histogram points: flat parallel
    arrays (timestamp, series id, counts row, under/overflow) in one
    sub-arena per distinct bounds tuple; the uniform path of a query is
    a window with one sub-arena. The rows are float64, exact for the
    codec's integer counts below 2^53 (float32 rounds past 2^24)."""

    class _Sub:
        __slots__ = ("bounds", "ts", "sid", "rows", "under", "over",
                     "n")

        def __init__(self, bounds: tuple, nb: int):
            self.bounds = bounds
            cap = 1024
            self.ts = np.empty(cap, dtype=np.int64)
            self.sid = np.empty(cap, dtype=np.int64)
            self.rows = np.empty((cap, nb), dtype=np.float64)
            self.under = np.empty(cap, dtype=np.int64)
            self.over = np.empty(cap, dtype=np.int64)
            self.n = 0

        def _grow(self, need: int) -> None:
            cap = max(need, len(self.ts) * 2)
            self.ts = np.resize(self.ts, cap)
            self.sid = np.resize(self.sid, cap)
            self.rows = np.resize(self.rows, (cap, self.rows.shape[1]))
            self.under = np.resize(self.under, cap)
            self.over = np.resize(self.over, cap)

        def append(self, ts_ms: int, sid: int, row: np.ndarray,
                   under: int = 0, over: int = 0) -> None:
            if self.n == len(self.ts):
                self._grow(self.n + 1)
            self.ts[self.n] = ts_ms
            self.sid[self.n] = sid
            self.rows[self.n] = row
            self.under[self.n] = under
            self.over[self.n] = over
            self.n += 1

        def append_many(self, ts: np.ndarray, sid: np.ndarray,
                        rows: np.ndarray, under=None, over=None) -> None:
            k = len(ts)
            need = self.n + k
            if need > len(self.ts):
                self._grow(need)
            self.ts[self.n:need] = ts
            self.sid[self.n:need] = sid
            self.rows[self.n:need] = rows
            self.under[self.n:need] = 0 if under is None else under
            self.over[self.n:need] = 0 if over is None else over
            self.n = need

        def snapshot(self):
            """(ts[n], sid[n], rows[n, NB]) views that stay valid.

            Take it under the owning TSDB's ``_histogram_lock`` (appends
            run under it): rows ``[0, n)`` never change afterwards, and
            growth replaces the arrays, leaving the captured ones whole.
            """
            ts, sid, rows, n = self.ts, self.sid, self.rows, self.n
            return ts[:n], sid[:n], rows[:n]

        def view(self):
            """:meth:`snapshot` (the same locking contract)."""
            return self.snapshot()

    def __init__(self):
        self.groups: dict[tuple, HistogramArena._Sub] = {}
        self.total_points = 0

    def append(self, ts_ms: int, sid: int,
               hist: SimpleHistogram) -> None:
        key = hist.bounds_key()
        sub = self.groups.get(key)
        if sub is None:
            sub = self.groups[key] = HistogramArena._Sub(
                key, max(1, len(key) - 1))
        sub.append(ts_ms, sid, hist.counts_array(),
                   hist.underflow, hist.overflow)
        self.total_points += 1


class HistogramCodec:
    """Codec ABI (ref: ``HistogramDataPointCodec.java``)."""

    id: int = 0

    def encode(self, hist: SimpleHistogram, include_id: bool) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, includes_id: bool) -> SimpleHistogram:
        raise NotImplementedError


class SimpleHistogramCodec(HistogramCodec):
    """Built-in codec, id 0x01. Payload (big-endian): u16 n_edges,
    f64 * edges, u64 * counts (n_edges - 1), u64 underflow, u64
    overflow."""

    id = 0x01

    def encode(self, hist: SimpleHistogram, include_id: bool = True) -> bytes:
        n = len(hist.bounds)
        out = bytearray()
        if include_id:
            out.append(self.id)
        out += struct.pack(">H", n)
        out += struct.pack(f">{n}d", *hist.bounds)
        out += struct.pack(f">{max(0, n - 1)}Q", *hist.counts)
        out += struct.pack(">QQ", hist.underflow, hist.overflow)
        return bytes(out)

    def decode(self, data: bytes, includes_id: bool = True) -> SimpleHistogram:
        pos = 1 if includes_id else 0
        (n,) = struct.unpack_from(">H", data, pos)
        pos += 2
        bounds = struct.unpack_from(f">{n}d", data, pos)
        pos += 8 * n
        counts = struct.unpack_from(f">{max(0, n - 1)}Q", data, pos)
        pos += 8 * max(0, n - 1)
        under, over = struct.unpack_from(">QQ", data, pos)
        hist = SimpleHistogram(bounds)
        hist.counts = list(counts)
        hist.underflow = under
        hist.overflow = over
        return hist


class HistogramCodecManager:
    """id -> codec registry (ref: HistogramCodecManager.java:47). The
    built-in simple codec is always registered at id 1. The reference
    loads codec plugin classes named by ``tsd.core.histograms.config``;
    the port has no plugin loader, and a non-empty key raises."""

    def __init__(self, config=None):
        self._by_id: dict[int, HistogramCodec] = {}
        self.register(SimpleHistogramCodec())
        if config is not None and config.get_string(
                "tsd.core.histograms.config", ""):
            raise NotImplementedError(
                "tsd.core.histograms.config names histogram codec "
                "plugins, which are not ported yet (ROADMAP Queue 1, "
                "the rest, with no device compute)")

    def register(self, codec: HistogramCodec) -> None:
        self._by_id[codec.id] = codec

    def codec(self, codec_id: int) -> HistogramCodec:
        try:
            return self._by_id[codec_id]
        except KeyError:
            raise ValueError(f"no histogram codec with id {codec_id}") from None

    def decode(self, blob: bytes) -> SimpleHistogram:
        if not blob:
            raise ValueError("empty histogram blob")
        return self.codec(blob[0]).decode(blob, includes_id=True)

    def encode(self, hist: SimpleHistogram, codec_id: int = 1) -> bytes:
        return self.codec(codec_id).encode(hist, include_id=True)
