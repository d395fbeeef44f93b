"""Continuous sampling profiler: where CPU time goes, per thread role
(ref: ``opentsdb_tpu/obs/profiler.py``).

The stage histograms say *which stage* is slow; this says
*what the code was doing* while it was slow. A single bounded
background thread samples ``sys._current_frames()`` at
``tsd.profile.hz`` (default 4 Hz — cheap enough to leave on), folds
each thread's stack into a collapsed-text line (``frame;frame;leaf``,
the flamegraph.pl / speedscope input format), classifies the thread
into a role by its name (ingest / query / fold-worker / cluster /
background / serve), and accumulates counts into a ring of per-second
buckets covering the last ``tsd.profile.ring_s`` seconds — so the
minute BEFORE an incident is queryable after the fact, no restart or
arm step needed.

Surface: ``GET /api/profile?seconds=N[&format=collapsed|json]
[&role=query]`` renders the merged window. Collapsed text prepends
the role as the root frame, so one flamegraph shows the fleet of
thread pools side by side.

Lifecycle: the sampler thread is started by :class:`TSDServer` and
joined by :meth:`stop` (called from ``TSDB.shutdown``). It holds the
TSDB only through its config values, never a reference to the TSDB.

Thread roles: each of the port's threads takes the role of its
counterpart in the reference. The port's HTTP handlers run on a
``tsd-http`` pool where the reference's run on asyncio's default
executor (``ingest``), and :class:`ServerThread` runs the event loop on
a ``tsd-server`` thread where the reference runs it on ``MainThread``
(``serve``)."""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any

LOG = logging.getLogger("obs.profiler")

#: thread-name prefix -> role (first match wins): the reference's table,
#: with the port's two threads of other names mapped to the roles of
#: their counterparts
_ROLE_PREFIXES: tuple[tuple[str, str], ...] = (
    ("tsd-query", "query"),          # server query worker pool
    ("tsd-subq", "query"),           # sub-query fan-out pool
    ("tsd-cluster", "cluster"),      # router scatter/forward pool
    ("cluster-", "cluster"),         # replay / backfill / retire loops
    ("tsd-stream-fold", "fold-worker"),
    ("asyncio", "ingest"),           # default-executor work: event
    #                                  stream frames
    ("tsd-http", "ingest"),          # the port's handler pool: puts,
    #                                  telnet bursts, admin endpoints
    ("tsd-telemetry", "background"),
    ("tsd-lifecycle", "background"),
    ("tsd-warmup", "background"),
    ("wal", "background"),
    ("MainThread", "serve"),         # the asyncio event loop
    ("tsd-server", "serve"),         # ServerThread's event loop
)


def thread_role(name: str) -> str:
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


class SamplingProfiler:
    """The sampler thread + its bounded per-second ring."""

    def __init__(self, tsdb):
        config = tsdb.config
        self.enabled = config.get_bool("tsd.profile.enable", True)
        # clamped: 0 disables, 250 Hz is already past the point where
        # the GIL-held frame walk starts to tax the workload
        self.hz = min(max(config.get_float("tsd.profile.hz", 4.0),
                          0.0), 250.0)
        self.ring_s = max(config.get_int("tsd.profile.ring_s", 60), 1)
        self.max_depth = max(config.get_int("tsd.profile.max_depth",
                                            48), 4)
        self._lock = threading.Lock()
        # (epoch second, {role: {folded stack: count}}) — maxlen
        # bounds retention to the configured window
        self._ring: deque = deque(maxlen=self.ring_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples = 0           # sampler wakes
        self.stacks_folded = 0     # thread stacks accumulated
        self.sample_errors = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self.hz <= 0 or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="tsd-profiler",
                             daemon=True)
        self._thread = t
        t.start()
        LOG.info("sampling profiler running at %.1f Hz (%ds ring)",
                 self.hz, self.ring_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - a failed sample is counted
                # and logged; the sampler thread outlives it
                self.sample_errors += 1
                LOG.exception("profiler sample failed")

    # -- sampling ------------------------------------------------------

    def sample_once(self, now_s: float | None = None) -> int:
        """One pass over every live thread's current frame (manually
        callable — tests and the bench drive it deterministically).
        Returns the number of stacks folded."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        # sys._current_frames holds the GIL for the dict build; the
        # per-frame walk below reads immutable f_back chains
        frames = sys._current_frames()
        sec = int(now_s if now_s is not None else time.time())
        folded: list[tuple[str, str]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # the profiler observing itself is noise
            role = thread_role(names.get(ident, ""))
            parts: list[str] = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                code = frame.f_code
                parts.append(f"{os.path.basename(code.co_filename)}"
                             f":{code.co_name}")
                frame = frame.f_back
                depth += 1
            if not parts:
                continue
            # outermost frame first — flamegraph root-to-leaf order
            folded.append((role, ";".join(reversed(parts))))
        with self._lock:
            if not self._ring or self._ring[-1][0] != sec:
                self._ring.append((sec, {}))
            bucket = self._ring[-1][1]
            for role, stack in folded:
                per = bucket.setdefault(role, {})
                per[stack] = per.get(stack, 0) + 1
            self.samples += 1
            self.stacks_folded += len(folded)
        return len(folded)

    # -- retrieval -----------------------------------------------------

    def report(self, seconds: int | None = None,
               role: str = "", now_s: float | None = None
               ) -> dict[str, dict[str, int]]:
        """Merged ``{role: {stack: count}}`` over the trailing
        ``seconds`` of the ring (clamped to the ring span)."""
        window = min(max(int(seconds or self.ring_s), 1), self.ring_s)
        now = int(now_s if now_s is not None else time.time())
        with self._lock:
            buckets = list(self._ring)
        out: dict[str, dict[str, int]] = {}
        for sec, per_role in buckets:
            if now - sec >= window:
                continue
            for r, stacks in per_role.items():
                if role and r != role:
                    continue
                acc = out.setdefault(r, {})
                for stack, n in stacks.items():
                    acc[stack] = acc.get(stack, 0) + n
        return out

    def collapsed(self, seconds: int | None = None, role: str = "",
                  now_s: float | None = None) -> str:
        """Flamegraph-ready collapsed text: one ``role;stack count``
        line per distinct stack, role as the root frame."""
        lines = []
        for r, stacks in sorted(self.report(seconds, role,
                                            now_s).items()):
            for stack, n in sorted(stacks.items()):
                lines.append(f"{r};{stack} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- observability -------------------------------------------------

    def collect_stats(self, collector) -> None:
        collector.record("profiler.samples", self.samples)
        collector.record("profiler.stacks_folded", self.stacks_folded)
        collector.record("profiler.sample_errors", self.sample_errors)

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            ring_len = len(self._ring)
        return {
            "enabled": self.enabled,
            "running": self.running,
            "hz": self.hz,
            "ring_s": self.ring_s,
            "ring_filled_s": ring_len,
            "samples": self.samples,
            "stacks_folded": self.stacks_folded,
            "sample_errors": self.sample_errors,
        }


__all__ = ["SamplingProfiler", "thread_role"]
