"""Observability (ref: ``src/stats/``).

- :class:`StatsCollector` — push-style visitor every component implements
  ``collect_stats(collector)`` against (ref: StatsCollector.java:35).
- :class:`Histogram` — fixed-bucket latency histogram with percentile
  extraction (ref: src/stats/Histogram.java:38).
- :class:`QueryStats` — per-query trace threaded through the read path,
  with a registry of running/completed queries for ``/api/stats/query``
  (ref: src/stats/QueryStats.java:58).

The port has no request tracer and no cluster, so the registry keeps
the two request-level latency histograms only (no per-stage map), and
histograms carry no mergeable quantile sketch.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from enum import Enum
from typing import Any


class DuplicateQueryError(ValueError):
    """An identical query is already in flight from the same endpoint
    and ``tsd.query.allow_simultaneous_duplicates`` is off (ref:
    QueryException from QueryStats.java:263)."""


class StatsCollector:
    """(ref: StatsCollector.java:35) Collects ``name value tags`` records."""

    def __init__(self, prefix: str = "tsd"):
        self.prefix = prefix
        self.records: list[tuple[str, float, dict[str, str]]] = []

    def record(self, name: str, value: float, **tags: str) -> None:
        self.records.append((f"{self.prefix}.{name}", float(value),
                             {k: str(v) for k, v in tags.items()}))

    def lines(self) -> list[str]:
        """Telnet ``stats`` output format: ``name timestamp value k=v ...``"""
        now = int(time.time())
        out = []
        for name, value, tags in self.records:
            tag_str = " ".join(f"{k}={v}" for k, v in sorted(tags.items()))
            val = int(value) if float(value).is_integer() else value
            out.append(f"{name} {now} {val}"
                       + (f" {tag_str}" if tag_str else ""))
        return out

    def as_json(self) -> list[dict[str, Any]]:
        now = int(time.time())
        return [{"metric": name, "timestamp": now, "value": value,
                 "tags": tags} for name, value, tags in self.records]


#: percentile points exported for every latency histogram
LATENCY_PCTS = (("p50", 50.0), ("p95", 95.0), ("p99", 99.0),
                ("p999", 99.9))


class StatsCollectorRegistry:
    """Aggregates collect_stats providers; owned by the TSDB. Also owns
    the request-level latency histograms ``latency_put`` and
    ``latency_query``, fed by the server per request and exported with
    p50/p95/p99/p999 at ``/api/stats`` (``tsd.latency.*``)."""

    def __init__(self) -> None:
        self._providers: list[Any] = []
        # 1 ms linear buckets: a bucket-upper-bound percentile over
        # 100 ms buckets would report p50=100 for every single-digit-ms
        # workload
        self.latency_put = Histogram(16000, 2, 1)
        self.latency_query = Histogram(16000, 2, 1)

    def register(self, provider: Any) -> None:
        self._providers.append(provider)

    def collect(self, prefix: str = "tsd") -> StatsCollector:
        collector = StatsCollector(prefix)
        for p in self._providers:
            p.collect_stats(collector)
        for name, hist in (("latency.put", self.latency_put),
                           ("latency.query", self.latency_query)):
            if not hist.count:
                continue
            vals = hist.percentile_many([q for _l, q in LATENCY_PCTS])
            for (label, _q), v in zip(LATENCY_PCTS, vals):
                collector.record(name, v, pct=label)
            collector.record(f"{name}.count", hist.count)
        return collector


class Histogram:
    """Exponentially-bucketed histogram (ref: src/stats/Histogram.java:38).

    Buckets are linear (width ``interval``) up to ``cutoff``, then double
    per bucket — same shape as the reference's constructor
    ``Histogram(max, num_linear? , interval)`` usage for latencies.
    """

    def __init__(self, max_value: int = 16000, num_bands: int = 2,
                 interval: int = 100):
        n_linear = max(1, (max_value // (2 ** (num_bands - 1))) // interval)
        self.bounds: list[int] = [interval * (i + 1) for i in range(n_linear)]
        while self.bounds[-1] < max_value:
            self.bounds.append(min(self.bounds[-1] * 2, max_value))
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        # bisect_left: the first bound >= value, the bucket a linear
        # `value <= bound` scan would pick
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.buckets[min(idx, len(self.buckets) - 1)] += 1
            self.count += 1

    def percentile_many(self, pcts: "list[float]") -> "list[float]":
        """Bucket-upper-bound percentiles in one cumulative pass over a
        snapshot of the buckets, taken outside the lock so a stats read
        never blocks ``add()`` for long."""
        with self._lock:
            count = self.count
            buckets = list(self.buckets)
        if count == 0:
            return [0.0] * len(pcts)
        targets = sorted((count * p / 100.0, j) for j, p in enumerate(pcts))
        out = [float(self.bounds[-1])] * len(pcts)
        acc, t = 0, 0
        for i, c in enumerate(buckets):
            acc += c
            while t < len(targets) and acc >= targets[t][0]:
                out[targets[t][1]] = float(
                    self.bounds[min(i, len(self.bounds) - 1)])
                t += 1
            if t >= len(targets):
                break
        return out


class QueryStat(Enum):
    """Stat points recorded along the read path, those of the
    reference's enum (QueryStats.java :132) that the port records."""
    STRING_TO_UID_TIME = "stringToUidTime"
    MATERIALIZE_TIME = "materializeTime"
    COMPUTE_TIME = "computeTime"
    SERIALIZATION_TIME = "serializationTime"
    TOTAL_TIME = "totalTime"
    DPS_POST_FILTER = "dpsPostFilter"
    EMITTED_DPS = "emittedDPs"
    # storage stats: "storage" is the host column store, a column is a
    # stored point, a row a series
    COLUMNS_FROM_STORAGE = "columnsFromStorage"
    ROWS_FROM_STORAGE = "rowsFromStorage"
    BYTES_FROM_STORAGE = "bytesFromStorage"
    SUCCESSFUL_SCAN = "successfulScan"
    ROWS_PRE_FILTER = "rowsPreFilter"
    ROWS_POST_FILTER = "rowsPostFilter"
    HBASE_TIME = "hbaseTime"                # storage engine wait
    UID_PAIRS_RESOLVED = "uidPairsResolved"
    QUERY_SCAN_TIME = "queryScanTime"
    NAN_DPS = "nanDPs"
    PROCESSING_PRE_WRITE_TIME = "processingPreWriteTime"
    # serve-path result cache outcomes
    RESULT_CACHE_HIT = "resultCacheHit"
    RESULT_CACHE_COALESCED = "resultCacheCoalesced"
    # served from a continuous query's maintained windows (streaming/):
    # no store scan, the tail alone
    STREAMING_HIT = "streamingHit"
    # response body bytes written for this query, and the pixel budget
    # its output was reduced under (0: full resolution)
    PAYLOAD_BYTES = "payloadBytes"
    DOWNSAMPLE_PIXELS = "downsamplePixels"


# time-based stats that get the reference's derived max*/avg* twins in
# /api/stats/query output (one logical scanner here, so max == avg ==
# the base value)
_DERIVED_TIMES = {
    "hbaseTime": ("maxHBaseTime", "avgHBaseTime"),
    "queryScanTime": ("maxQueryScanTime", "avgQueryScanTime"),
    "serializationTime": ("maxSerializationTime",
                          "avgSerializationTime"),
}


class ServePayloadStats:
    """Aggregate serve-path payload counters: total response bytes,
    serialization milliseconds and response count across every
    /api/query answered by this process, exported at ``/api/stats``."""

    __slots__ = ("_lock", "payload_bytes", "serialization_ms",
                 "responses")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.payload_bytes = 0
        self.serialization_ms = 0.0
        self.responses = 0

    def record(self, nbytes: int, ser_ms: float) -> None:
        with self._lock:
            self.payload_bytes += int(nbytes)
            self.serialization_ms += float(ser_ms)
            self.responses += 1

    def collect_stats(self, collector) -> None:
        collector.record("query.payload.bytes_total",
                         self.payload_bytes)
        collector.record("query.payload.serialization_ms_total",
                         self.serialization_ms)
        collector.record("query.payload.responses", self.responses)


class QueryStats:
    """Per-query trace (ref: QueryStats.java:58). Register on start,
    mark complete on finish; recent queries are browsable at
    ``/api/stats/query``. The running and completed lists are
    process-wide, like the reference's static maps."""

    _running: "dict[int, QueryStats]" = {}
    _completed: "deque[QueryStats]" = deque(maxlen=50)
    _registry_lock = threading.Lock()
    _next_id = 0

    def __init__(self, remote: str = "", query: Any = None,
                 allow_duplicates: bool = True):
        self.remote = remote
        self.query = query
        self.start_ns = time.monotonic_ns()
        self.start_time = time.time()
        self.stats: dict[str, float] = {}
        # sub-queries of one TSQuery record concurrently (the engine's
        # fan-out): the read-modify-write in add_stat takes a lock
        self._stats_lock = threading.Lock()
        self.executed = False
        # identity for the duplicate check: endpoint + query content
        # (ref: QueryStats.java:70-73), computed only when duplicates
        # are refused
        self.dup_key = None
        if not allow_duplicates:
            qjson = query.to_json() if query is not None else None
            self.dup_key = (remote, repr(qjson))
        with QueryStats._registry_lock:
            if not allow_duplicates and any(
                    r.dup_key == self.dup_key
                    for r in QueryStats._running.values()):
                # (ref: QueryStats ctor :263 throws QueryException when
                # ENABLE_DUPLICATES is off; answered as a 400)
                raise DuplicateQueryError(
                    "Query is already executing for endpoint: "
                    f"{remote}")
            QueryStats._next_id += 1
            self.query_id = QueryStats._next_id
            QueryStats._running[self.query_id] = self

    def add_stat(self, stat: QueryStat, value: float) -> None:
        with self._stats_lock:
            self.stats[stat.value] = \
                self.stats.get(stat.value, 0.0) + value

    def mark_serialization_successful(self) -> None:
        """The query produced a response (ref: ``executed`` flips only
        on serialization success)."""
        self.executed = True
        self._complete()

    def mark_complete(self) -> None:
        """Move to the completed list without claiming success: the
        finally-path of a failed query (``executed`` stays False)."""
        self._complete()

    def _complete(self) -> None:
        with QueryStats._registry_lock:
            if QueryStats._running.pop(self.query_id, None) is None:
                return  # already completed
            self.stats[QueryStat.TOTAL_TIME.value] = (
                (time.monotonic_ns() - self.start_ns) / 1e6)
            QueryStats._completed.append(self)

    def to_json(self) -> dict[str, Any]:
        stats = dict(self.stats)
        for base, (mx, avg) in _DERIVED_TIMES.items():
            if base in stats:
                stats.setdefault(mx, stats[base])
                stats.setdefault(avg, stats[base])
        return {
            "queryId": self.query_id,
            "remote": self.remote,
            "queryStartTimestamp": int(self.start_time * 1000),
            "executed": self.executed,
            "stats": stats,
            "query": (self.query.to_json()
                      if hasattr(self.query, "to_json") else None),
        }

    @classmethod
    def running_and_completed(cls) -> dict[str, list[dict[str, Any]]]:
        with cls._registry_lock:
            return {
                "running": [q.to_json() for q in cls._running.values()],
                "completed": [q.to_json() for q in cls._completed],
            }
