"""Deterministic fault injection, retry with backoff and the circuit
breaker (ref: ``opentsdb_tpu/utils/faults.py``), as far as the
write-ahead log, the snapshot flush and the continuous queries use
them.

- :class:`FaultInjector`: injection points armed through ``Config``
  keys ``tsd.faults.<site>_<knob>`` (knob: ``error_rate``,
  ``error_count``, ``error_once``, ``latency_ms``) or :meth:`arm`. The
  sites are the WAL's (``wal.append``, ``wal.fsync``), the snapshot
  flush (``store.flush``), the continuous queries' (``stream.fold``,
  ``stream.worker``, ``stream.watermark``) and the query engine's
  device dispatch (``device.compile``). An error rate is a counted
  schedule (call ``i`` fails iff ``floor(i * r)`` advances), never a
  coin flip, so a failure reproduces.
- :class:`RetryPolicy` and :func:`call_with_retries`: bounded
  exponential backoff under a wall-clock deadline.
- :class:`CircuitBreaker` (closed -> open -> half-open) and
  :class:`DegradedError`, the refusal the HTTP layer answers with a
  structured 503 and ``Retry-After``. The streaming registry and the
  query engine's device breaker (``device.pipeline``) use it in its
  shedding mode only: while it is open, pulls go to the batch engine
  and ``/result`` answers 503, and a query that would touch the device
  answers 503. The reference's host re-answer of a failed device query
  is a fallback, which the port does not have.

The reference's other sites belong to subsystems the port has not
ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

KNOWN_SITES: frozenset[str] = frozenset({
    "wal.fsync",          # core/wal.py fsync leader
    "wal.append",         # core/wal.py framed write
    "store.flush",        # core/persist.py snapshot flush
    "stream.fold",        # streaming/registry.py incremental fold
    "stream.worker",      # streaming/workers.py off-path drain
    "stream.watermark",   # streaming/eventtime/watermark.py marker
    "device.compile",     # query/engine.py device pipeline dispatch
})


class InjectedFault(OSError):
    """A failure raised by an armed fault point. An OSError, so an
    injected disk fault takes the path a real fsync or write failure
    takes."""


class DegradedError(RuntimeError):
    """The serve path is degraded and refuses this request on purpose
    (an open breaker, partials known to be stale). The HTTP layer
    answers it with a structured 503 and ``Retry-After``, never a
    500."""

    def __init__(self, message: str, retry_after_s: int = 1):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class FaultPoint:
    """One armed injection site and its schedule."""

    name: str
    error_rate: float = 0.0   # fail call i iff floor(i*r) advances
    error_count: int = 0      # fail the first N calls, then succeed
    latency_ms: float = 0.0   # added to every call at this site
    calls: int = 0
    injected: int = 0

    def scheduled(self, n: int) -> bool:
        """Whether call ``n`` (1-based) fails: a function of the count
        alone, so a retried call advances the schedule."""
        if self.error_count and n <= self.error_count:
            return True
        if self.error_rate > 0:
            return math.floor(n * self.error_rate) \
                > math.floor((n - 1) * self.error_rate)
        return False


class FaultInjector:
    """The armed :class:`FaultPoint` s, from ``tsd.faults.<site>_<knob>``
    keys (the separator before the knob may be ``_`` or ``.``). With
    nothing armed, :meth:`check` is one dict miss."""

    PREFIX = "tsd.faults."
    _KNOBS = ("error_rate", "error_count", "error_once", "latency_ms")

    def __init__(self, config: Any = None):
        self._lock = threading.Lock()
        self._sites: dict[str, FaultPoint] = {}
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        for key, val in config:
            if not key.startswith(self.PREFIX):
                continue
            rest = key[len(self.PREFIX):]
            for knob in self._KNOBS:
                if rest.endswith(knob) and len(rest) > len(knob) \
                        and rest[-len(knob) - 1] in "._":
                    site = rest[:-len(knob) - 1]
                    break
            else:
                continue
            if site not in KNOWN_SITES:
                # a typo would arm nothing: say so, but come up
                logging.getLogger("faults").warning(
                    "config key %r arms unknown fault site %r; known "
                    "sites: %s", key, site, ", ".join(sorted(KNOWN_SITES)))
            point = self._sites.setdefault(site, FaultPoint(site))
            if knob == "error_rate":
                point.error_rate = float(val)
            elif knob == "error_count":
                point.error_count = int(val)
            elif knob == "error_once":
                if str(val).strip().lower() in ("true", "1", "yes"):
                    point.error_count = max(point.error_count, 1)
            else:
                point.latency_ms = float(val)

    def arm(self, site: str, *, error_rate: float = 0.0,
            error_count: int = 0, latency_ms: float = 0.0) -> FaultPoint:
        """Arm ``site`` (tests); an unknown site raises, so a typo
        cannot test nothing."""
        if site not in KNOWN_SITES:
            raise ValueError(f"unknown fault site {site!r}; known sites: "
                             f"{', '.join(sorted(KNOWN_SITES))}")
        with self._lock:
            point = self._sites[site] = FaultPoint(
                site, error_rate=error_rate, error_count=error_count,
                latency_ms=latency_ms)
            return point

    def disarm(self, site: str | None = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    @property
    def armed(self) -> bool:
        return bool(self._sites)

    def check(self, site: str) -> None:
        """Apply the site's armed behaviour to this call: sleep its
        latency, then raise :class:`InjectedFault` if the call is on
        the failure schedule."""
        point = self._sites.get(site)
        if point is None:
            return
        with self._lock:
            point.calls += 1
            n = point.calls
            fail = point.scheduled(n)
            if fail:
                point.injected += 1
        if point.latency_ms > 0:
            time.sleep(point.latency_ms / 1000.0)
        if fail:
            raise InjectedFault(f"injected fault at {site!r} (call {n})")

    def collect_stats(self, collector) -> None:
        for point in list(self._sites.values()):
            collector.record("faults.calls", point.calls, site=point.name)
            collector.record("faults.injected", point.injected,
                             site=point.name)

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            return {"armed": bool(self._sites), "sites": {
                p.name: {"error_rate": p.error_rate,
                         "error_count": p.error_count,
                         "latency_ms": p.latency_ms, "calls": p.calls,
                         "injected": p.injected}
                for p in self._sites.values()}}


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: at most ``attempts`` tries and at
    most ``deadline_ms`` of wall clock, whichever ends first;
    ``attempts=1`` means no retry."""

    attempts: int = 1
    base_ms: float = 5.0
    max_ms: float = 1000.0
    deadline_ms: float = 0.0  # 0: bounded by attempts only
    multiplier: float = 2.0

    @classmethod
    def from_config(cls, config, prefix: str, attempts: int = 1,
                    base_ms: float = 5.0, max_ms: float = 1000.0,
                    deadline_ms: float = 0.0) -> "RetryPolicy":
        """Read ``<prefix>.attempts``, ``.base_ms``, ``.max_ms`` and
        ``.deadline_ms``."""
        return cls(
            attempts=config.get_int(f"{prefix}.attempts", attempts),
            base_ms=config.get_float(f"{prefix}.base_ms", base_ms),
            max_ms=config.get_float(f"{prefix}.max_ms", max_ms),
            deadline_ms=config.get_float(f"{prefix}.deadline_ms",
                                         deadline_ms))


def call_with_retries(fn: Callable[[], Any],
                      policy: RetryPolicy | None = None,
                      retryable: tuple = (OSError,),
                      on_retry: Callable[[int, Exception], None]
                      | None = None,
                      sleep: Callable[[float], None] = time.sleep,
                      clock: Callable[[], float] = time.monotonic) -> Any:
    """Call ``fn`` under ``policy``. Exceptions outside ``retryable``,
    and the last failure, propagate unchanged."""
    policy = policy or RetryPolicy()
    start = clock()
    delay_ms = max(policy.base_ms, 0.0)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retryable as exc:
            if attempt >= max(policy.attempts, 1):
                raise
            if policy.deadline_ms and \
                    (clock() - start) * 1000.0 + delay_ms \
                    > policy.deadline_ms:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(delay_ms / 1000.0)
            delay_ms = min(delay_ms * policy.multiplier, policy.max_ms)


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open ->
    half-open; ref: ``CircuitBreaker``). :meth:`blocking` is the
    read-only check: True while OPEN and inside the reset window.
    :meth:`allow` is the gate and owns the state machine: past the reset
    window it admits exactly one probe (half-open); the probe's
    :meth:`record_success` closes the breaker, :meth:`record_failure`
    opens it again, and other calls while the probe runs are refused."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_ms: float = 30000.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_timeout_ms = float(reset_timeout_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self.failures = 0       # consecutive
        self.total_failures = 0
        self.trips = 0
        self.recoveries = 0
        # the reference counts host re-answers of the engine's device
        # breaker here; the port has no host retry, so it stays 0
        self.fallbacks = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def blocking(self) -> bool:
        """OPEN and still inside the reset window; changes nothing."""
        with self._lock:
            return self._state == self.OPEN and \
                (self._clock() - self._opened_at) * 1000.0 \
                < self.reset_timeout_ms

    def allow(self) -> bool:
        """The gate: call once per guarded operation."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if (self._clock() - self._opened_at) * 1000.0 \
                        >= self.reset_timeout_ms:
                    self._state = self.HALF_OPEN
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self.failures += 1
            self.total_failures += 1
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self.failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    self.trips += 1
                self._state = self.OPEN
                self._opened_at = self._clock()

    def record_success(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self.failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.recoveries += 1

    def collect_stats(self, collector) -> None:
        with self._lock:
            state_val = self._STATE_VALUES[self._state]
        collector.record("breaker.state", state_val, breaker=self.name)
        collector.record("breaker.failures", self.total_failures,
                         breaker=self.name)
        collector.record("breaker.trips", self.trips, breaker=self.name)
        collector.record("breaker.fallbacks", self.fallbacks,
                         breaker=self.name)

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self.failures,
                "total_failures": self.total_failures,
                "failure_threshold": self.failure_threshold,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "fallbacks": self.fallbacks,
                "reset_timeout_ms": self.reset_timeout_ms,
            }
