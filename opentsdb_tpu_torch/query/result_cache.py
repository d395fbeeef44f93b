"""Serve-path query result cache with single-flight coalescing
(ref: ``opentsdb_tpu/query/result_cache.py``).

The reference caches rendered graphs on disk keyed by the query hash
and serves them until they go stale (``GraphHandler.java`` —
``isDiskCacheHit`` + the end-time-relative ``computeMaxAge`` rule).
Here the cached unit is the engine's *result groups* (the
``list[QueryResult]`` one sub-query produces), so a repeated dashboard
refresh skips the whole scan -> device pipeline -> assembly chain.

Correctness model (never serve stale data):

- Entries are keyed by a canonical tuple of the normalized
  TSQuery/sub-query: the window (or, for relative times, the raw time
  strings and a TTL-quantized window bucket), ``timezone``,
  ``use_calendar``, ``ms_resolution``, ``show_tsuids`` and
  :meth:`TSSubQuery.identity_key` — see :func:`cache_plan`.
- Every lookup carries the version of the store the sub-query reads
  (``QueryEngine._sub_version``: the store's identity and its
  ``(points_written, mutation_epoch)``). A version mismatch is a miss
  and evicts the entry, so any write invalidates implicitly.
- Relative-time queries (``end=now`` and friends) are bounded by a
  staleness TTL derived from the downsample interval (the reference's
  GraphHandler rule: a 5m-downsampled dashboard may be served up to 5m
  stale).

Single-flight: concurrent identical queries (same key) block on ONE
execution — the leader computes and populates, waiters share the
result object, and a failed leader propagates its error to every
waiter WITHOUT populating the cache (an error is never cached). A
waiter that captured a newer version than the leader's recomputes
(read-after-write).

Sharded LRU bounded by an estimated byte budget
(``tsd.query.cache.mb``); knobs live under ``tsd.query.cache.*``.

The per-tenant ``insert_gate`` (set by the control plane's tenant
QoS) is asked before an insert; a result it refuses still serves and
is counted ``gated``. Left out, because the port has no such subsystem
yet: the key's annotation flags (``no_annotations``,
``global_annotations``), its ``sketch_partials`` flag and its cluster
replica selection (``sel_cache_key``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

# lookup outcomes
HIT = "hit"
MISS = "miss"
COALESCED = "coalesced"

_MISSING = object()

LOG = logging.getLogger(__name__)


def _is_relative(spec: str | None) -> bool:
    """True when a start/end time string re-resolves against *now*
    (ref: DateTime.parseDateTimeString relative forms)."""
    if spec is None or spec == "":
        return True  # an absent end defaults to now
    s = str(spec).strip().lower()
    return s.endswith("-ago") or s.startswith("now")


def cache_plan(tsq, sub, config) -> tuple[tuple, float] | None:
    """(key, ttl_ms) for one sub-query, or None when it must bypass
    the cache. ``ttl_ms`` is 0 for absolute windows (version
    invalidation only).

    The key folds in every TSQuery field that shapes a sub-query's
    result groups plus the sub-query's value identity — but NOT
    ``sub.index``, so the same sub shared by different dashboards
    still hits (the engine re-labels ``sub_query_index`` on a hit)."""
    if tsq.delete:
        return None  # scanned-and-deleted: running IS the side effect
    relative = _is_relative(tsq.start) or _is_relative(tsq.end)
    ttl_ms = 0.0
    if relative:
        spec = sub.ds_spec
        if spec is not None and not spec.run_all \
                and spec.interval_ms > 0:
            ttl_max = config.get_float("tsd.query.cache.ttl_max_s",
                                       300.0)
            ttl_ms = min(float(spec.interval_ms), ttl_max * 1000.0)
        else:
            ttl_ms = config.get_float(
                "tsd.query.cache.ttl_relative_s", 0.0) * 1000.0
        if ttl_ms <= 0:
            return None
        # TTL-quantized window bucket: requests inside one bucket
        # share an entry (staleness <= ttl by construction); far-apart
        # "1h-ago" queries can never collide on the raw strings alone
        window = ("rel", tsq.start, tsq.end,
                  int(tsq.start_ms // ttl_ms),
                  int(tsq.end_ms // ttl_ms))
    else:
        window = (tsq.start_ms, tsq.end_ms)
    # the pixel budget shapes the result groups, so a full-resolution
    # entry never serves a pixel-budgeted request (ref)
    from opentsdb_tpu_torch.query.model import effective_pixels
    key = (window, tsq.timezone, tsq.use_calendar, tsq.ms_resolution,
           tsq.show_tsuids, sub.identity_key(), effective_pixels(tsq, sub))
    return key, ttl_ms


def detach(value):
    """Per-result ``cache_copy`` snapshots (``QueryResult.cache_copy``):
    applied on PUT and on HIT so a consumer can only change its own
    request-scoped copies, never the entry. Objects without the hook
    pass through unchanged."""
    return [r.cache_copy() if hasattr(r, "cache_copy") else r
            for r in value]


def results_nbytes(results) -> int:
    """Estimated host bytes held by one cached value (a
    ``list[QueryResult]``): array payloads + per-group overhead."""
    total = 512
    for r in results:
        total += 256
        arrays = getattr(r, "dps_arrays", None)
        if arrays is not None:
            total += sum(getattr(a, "nbytes", 0) for a in arrays)
        total += 64 * len(getattr(r, "tsuids", ()) or ())
    return total


class _Flight:
    """One in-flight computation shared by leader + waiters.
    ``version`` is the LEADER's version: a waiter that captured a
    newer one must not share the result (read-after-write)."""

    __slots__ = ("event", "value", "error", "version")

    def __init__(self, version) -> None:
        self.event = threading.Event()
        self.value = None
        self.error: BaseException | None = None
        self.version = version


class _Shard:
    __slots__ = ("lock", "entries", "nbytes", "hits")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # key -> (version, value, nbytes, created_monotonic)
        self.entries: OrderedDict[Any, tuple] = OrderedDict()
        self.nbytes = 0
        # counted under the shard lock the hit already holds
        self.hits = 0


class QueryResultCache:
    """Sharded, byte-bounded, version-invalidated LRU of query results
    with single-flight coalescing (see module docstring)."""

    def __init__(self, max_bytes: int, shards: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.max_bytes = max(int(max_bytes), 1)
        self._clock = clock
        n = max(int(shards), 1)
        self._shards = [_Shard() for _ in range(n)]
        self._shard_budget = max(self.max_bytes // n, 1)
        self._flight_lock = threading.Lock()
        self._inflight: dict[Any, _Flight] = {}
        self._stats_lock = threading.Lock()
        self.misses = 0
        self.coalesced = 0
        self.evicted = 0
        self.bypasses = 0
        self.gated = 0
        # the per-tenant insert gate (control/qos.py): called with the
        # entry's byte size before an insert; False serves the result
        # without keeping it. None keeps the hot path at one read.
        self.insert_gate: Callable[[int], bool] | None = None

    # ------------------------------------------------------------------

    def _shard(self, key) -> _Shard:
        return self._shards[hash(key) % len(self._shards)]

    def _count(self, field: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self, field, getattr(self, field) + n)

    def count_bypass(self) -> None:
        """An uncacheable query went straight to the engine."""
        self._count("bypasses")

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self._shards)

    @property
    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self._shards)

    @property
    def total_entries(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    # ------------------------------------------------------------------

    def _get(self, key, version, ttl_ms: float):
        shard = self._shard(key)
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is not None:
                ver_mismatch = entry[0] != version
                ttl_stale = ttl_ms > 0 and \
                    (self._clock() - entry[3]) * 1000.0 > ttl_ms
                if not ver_mismatch and not ttl_stale:
                    shard.entries.move_to_end(key)
                    shard.hits += 1
                    return entry[1]
                # aged out, or a write landed: drop it — EXCEPT when
                # the resident entry is strictly NEWER than this
                # caller's captured version (a reader that captured
                # its version just before a write must not destroy
                # the entry the post-write reader populated; versions
                # are monotonic, so newer wins)
                evict = ttl_stale
                if ver_mismatch and not evict:
                    try:
                        evict = not entry[0] > version
                    except TypeError:
                        evict = True  # incomparable shapes: replace
                if evict:
                    shard.nbytes -= entry[2]
                    del shard.entries[key]
        return _MISSING

    def _put(self, key, version, value) -> None:
        nbytes = results_nbytes(value)
        if nbytes > self._shard_budget:
            return  # bigger than a whole shard: don't thrash
        gate = self.insert_gate
        if gate is not None and not gate(nbytes):
            self._count("gated")
            return  # an over-budget tenant's result: served, not kept
        shard = self._shard(key)
        evicted = 0
        with shard.lock:
            old = shard.entries.get(key)
            if old is not None:
                try:
                    if old[0] > version:
                        # the resident entry was computed under a
                        # NEWER version: no future reader can match
                        # this one
                        return
                except TypeError:
                    pass
                del shard.entries[key]
                shard.nbytes -= old[2]
            shard.entries[key] = (version, value, nbytes, self._clock())
            shard.nbytes += nbytes
            while shard.nbytes > self._shard_budget and shard.entries:
                _, (_, _, nb, _) = shard.entries.popitem(last=False)
                shard.nbytes -= nb
                evicted += 1
        if evicted:
            self._count("evicted", evicted)

    # ------------------------------------------------------------------

    def get_or_compute(self, key, version, compute: Callable[[], Any],
                       ttl_ms: float = 0.0) -> tuple[Any, str]:
        """Return ``(value, outcome)`` where outcome is one of
        :data:`HIT` / :data:`MISS` / :data:`COALESCED`.

        Exactly one caller per key runs ``compute`` at a time; its
        result populates the cache under ``version`` (captured by the
        caller BEFORE compute, so a write landing mid-compute leaves
        the entry already stale rather than wrongly fresh). A leader
        that raises propagates the error to itself and every waiter
        and caches nothing."""
        value = self._get(key, version, ttl_ms)
        if value is not _MISSING:
            return detach(value), HIT
        with self._flight_lock:
            # the leader may have completed between the miss above and
            # this lock: re-check before joining/starting a flight
            value = self._get(key, version, ttl_ms)
            if value is not _MISSING:
                return detach(value), HIT
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = self._inflight[key] = _Flight(version)
        if not leader:
            flight.event.wait()
            if flight.version != version:
                # the leader started BEFORE a write this caller must
                # observe: sharing its result would break
                # read-after-write. The flight is complete (popped
                # before the event is set), so re-entering either hits
                # a fresh entry or leads a new flight.
                return self.get_or_compute(key, version, compute,
                                           ttl_ms)
            # hits + misses + coalesced + bypasses partition lookups:
            # a waiter is coalesced, success or not
            self._count("coalesced")
            if flight.error is not None:
                raise flight.error
            return flight.value, COALESCED
        self._count("misses")
        try:
            value = compute()
        except BaseException as exc:
            flight.error = exc
            raise
        else:
            flight.value = value
            self.store(key, version, value)
            return value, MISS
        finally:
            # ALWAYS complete the flight — a dead entry in _inflight
            # would hang every future query for this key forever
            with self._flight_lock:
                self._inflight.pop(key, None)
            flight.event.set()

    # ------------------------------------------------------------------
    # explicit probe/populate pair
    # ------------------------------------------------------------------

    def lookup(self, key, version, ttl_ms: float = 0.0):
        """Plain probe without single-flight: a detached copy of the
        entry, or ``None``. For callers that decide after computing
        whether an answer may be retained (they populate through
        :meth:`store`)."""
        value = self._get(key, version, ttl_ms)
        if value is _MISSING:
            self._count("misses")
            return None
        return detach(value)

    def store(self, key, version, value) -> None:
        """Populate an entry (detached as on a hit). Best-effort: a
        failure of the cache's bookkeeping must never fail the query
        that computed ``value``, which the caller still returns."""
        try:
            self._put(key, version, detach(value))
        except Exception:  # noqa: BLE001 - bookkeeping only
            LOG.warning("result cache: an entry was not stored",
                        exc_info=True)

    # ------------------------------------------------------------------

    def clear(self) -> None:
        for shard in self._shards:
            with shard.lock:
                shard.entries.clear()
                shard.nbytes = 0

    # ------------------------------------------------------------------

    def collect_stats(self, collector) -> None:
        collector.record("query.resultcache.bytes", self.total_bytes)
        collector.record("query.resultcache.entries", self.total_entries)
        collector.record("query.resultcache.hits", self.hits)
        collector.record("query.resultcache.misses", self.misses)
        collector.record("query.resultcache.coalesced", self.coalesced)
        collector.record("query.resultcache.evicted", self.evicted)
        collector.record("query.resultcache.bypasses", self.bypasses)
        collector.record("query.resultcache.gated", self.gated)

    def health_info(self) -> dict[str, Any]:
        return {
            "enabled": True,
            "bytes": self.total_bytes,
            "max_bytes": self.max_bytes,
            "entries": self.total_entries,
            "shards": len(self._shards),
            "hits": self.hits,
            "misses": self.misses,
            "coalesced": self.coalesced,
            "evicted": self.evicted,
            "bypasses": self.bypasses,
            "inflight": len(self._inflight),
        }
