"""In-memory log ring buffer (ref: ``opentsdb_tpu/utils/logring.py``,
the logback ``CyclicBufferAppender`` read by ``src/tsd/LogsRpc.java``).
Attaches a handler to the root logger at import; ``/logs`` serves the
most recent 1024 records newest-first."""

from __future__ import annotations

import collections
import logging
import threading


class RingBufferHandler(logging.Handler):
    def __init__(self, capacity: int = 1024):
        super().__init__()
        self._records: collections.deque[str] = collections.deque(
            maxlen=capacity)
        self._lock2 = threading.Lock()
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s [%(threadName)s] "
            "%(name)s: %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # noqa: BLE001 - logging's own contract: a
            # record that fails to format is dropped, never raised
            self.handleError(record)
            return
        with self._lock2:
            self._records.append(line)

    def lines(self) -> list[str]:
        with self._lock2:
            return list(reversed(self._records))


ring_buffer = RingBufferHandler()
logging.getLogger().addHandler(ring_buffer)
