"""Shared fold-worker pool: off-path execution for continuous-query
folds and push publication (ref: ``opentsdb_tpu/streaming/workers.py``).

The ingest tap (``TSDB.add_point*`` -> ``ContinuousQueryRegistry``)
is an O(1) columnar enqueue into each shared partial's pending
buffer. When a partial's backlog crosses the drain threshold
(``tsd.streaming.buffer_points``), the tap hands the partial to this
pool instead of folding inline — the write path never executes a
fold, so high-cardinality standing queries cost ingest a buffer
append, nothing more. The pool also runs the rate-limited SSE
publish walk after drains when subscribers exist (v1 ran it on the
write path).

Degradation (under the ``stream.worker`` fault site and the
streaming breaker): a worker failure marks the
partial for rebuild-on-serve and is counted — it can NEVER fail or
block an acknowledged write, and the serve path drains/rebuilds
synchronously before answering so a lagging worker can never cause
a stale serve. When a partial's backlog exceeds
``tsd.streaming.workers.max_pending_points`` the registry degrades
it instead of buffering unboundedly: the backlog is dropped and the
partial rebuilds from the store on its next serve.

``tsd.streaming.workers.count = 0`` disables the pool; the tap then
folds inline at the drain threshold — the escape hatch for
single-threaded embedders.

Threads (``tsd-stream-fold-<i>``) start lazily on the first hand-off
and stop with the registry (``TSDB.shutdown`` ->
``ContinuousQueryRegistry.shutdown``).
"""

from __future__ import annotations

import collections
import logging
import threading

LOG = logging.getLogger("streaming.workers")

# idle wake interval: a worker with an empty queue re-checks the
# publish flag this often so a subscriber behind a rate-limited
# publish window is never stranded until the next ingest tick
_IDLE_WAKE_S = 0.25


class FoldWorkerPool:
    """(see module docstring)"""

    def __init__(self, registry, count: int):
        self.registry = registry
        self.count = max(int(count), 0)
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = threading.Event()
        # dirty partials, FIFO with membership dedupe: a partial
        # already queued is not queued twice however many writes land
        self._dirty: collections.deque = collections.deque()
        self._queued: set = set()
        self._publish_pending = False
        self._threads: list[threading.Thread] = []
        self._started = False
        # counters (exported via the registry's stats/health surface)
        self.drains = 0
        self.errors = 0
        self.publish_runs = 0

    @property
    def enabled(self) -> bool:
        return self.count > 0

    @property
    def started(self) -> bool:
        return self._started

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Spawn the worker threads (idempotent, lazy — the first
        hand-off calls this; the TSD server also starts them at startup
        so a server's first ingest burst never pays thread creation)."""
        if not self.enabled or self._started:
            return
        with self._lock:
            if self._started:
                return
            self._stop.clear()
            for i in range(self.count):
                t = threading.Thread(target=self._loop,
                                     name=f"tsd-stream-fold-{i}",
                                     daemon=True)
                self._threads.append(t)
                t.start()
            self._started = True
        LOG.info("streaming fold-worker pool running (%d workers)",
                 self.count)

    def stop(self) -> None:
        self._stop.set()
        self._event.set()
        threads, self._threads = self._threads, []
        for t in threads:
            if t.is_alive():
                t.join(timeout=5)
        self._started = False

    # ------------------------------------------------------------------
    # hand-off surface (called from the ingest tap)
    # ------------------------------------------------------------------

    def submit(self, partial) -> None:
        """Queue one shared partial for an off-path drain (O(1):
        set-membership check + deque append + event set)."""
        self.start()
        with self._lock:
            if partial not in self._queued:
                self._queued.add(partial)
                self._dirty.append(partial)
        self._event.set()

    def notify_publish(self) -> None:
        """Ask a worker to run the rate-limited publish walk (there
        are live SSE subscribers and fresh folds)."""
        self.start()
        self._publish_pending = True
        self._event.set()

    def _take(self):
        with self._lock:
            if not self._dirty:
                return None
            partial = self._dirty.popleft()
            self._queued.discard(partial)
            return partial

    # ------------------------------------------------------------------

    def _loop(self) -> None:
        registry = self.registry
        while not self._stop.is_set():
            self._event.wait(timeout=_IDLE_WAKE_S)
            self._event.clear()
            while not self._stop.is_set():
                partial = self._take()
                if partial is None:
                    break
                try:
                    registry.worker_drain(partial)
                    self.drains += 1
                except Exception:  # noqa: BLE001 - a worker never dies
                    # the drain already counted the error and marked
                    # the partial for rebuild; the next serve re-seeds
                    self.errors += 1
                    LOG.exception("fold worker drain failed; partial "
                                  "will rebuild on serve")
            if self._publish_pending and not self._stop.is_set():
                self._publish_pending = False
                try:
                    registry._maybe_publish()
                    self.publish_runs += 1
                except Exception:  # noqa: BLE001 - a worker never dies
                    # the next ingest tick or SSE heartbeat publishes
                    self.errors += 1
                    LOG.exception("worker publish walk failed")

    # ------------------------------------------------------------------

    def health_info(self) -> dict:
        with self._lock:
            backlog = len(self._dirty)
        return {
            "workers": self.count,
            "started": self._started,
            "backlog_partials": backlog,
            "drains": self.drains,
            "errors": self.errors,
            "publish_runs": self.publish_runs,
        }
