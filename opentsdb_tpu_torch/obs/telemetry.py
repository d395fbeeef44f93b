"""Self-telemetry: the TSD ingests its own stats as ``tsd.*`` series
(ref: ``opentsdb_tpu/obs/telemetry.py``).

A ``tsd.stats.self_interval`` loop snapshots everything the stats
registry knows — every component counter, the gauges and the per-stage
latency percentiles — and writes them into the TSD's *own* store
through the normal :meth:`TSDB.add_point_groups` ingest path. So every
serving feature applies to the TSD monitoring itself: ``/api/query``
works on ``tsd.*`` metrics, continuous queries maintain live windows
over them and lifecycle policies age them out. (The reference's router
forwards the pump's points through its ring; that comes with the port
of ``cluster/``.)

Metric names are the collector's (already ``tsd.``-prefixed); tag
values are sanitized to the storage charset (``:`` becomes ``_``). UIDs
for self-metrics are minted directly: an operator's
``tsd.core.auto_create_metrics=false`` policy governs client traffic,
not the TSD's own heartbeat.

The pump holds its TSDB by a weak reference, so neither it nor its
thread keeps a dropped TSDB alive; ``TSDB.shutdown`` joins the thread.
"""

from __future__ import annotations

import logging
import math
import platform
import threading
import time
import weakref

from opentsdb_tpu_torch.obs import trace as trace_mod

LOG = logging.getLogger("obs.telemetry")

_ALLOWED_PUNCT = set("-_./")


def _sanitize(value: str) -> str:
    """Map an arbitrary label onto the tag-value charset."""
    out = "".join(c if (c.isascii() and c.isalnum())
                  or c in _ALLOWED_PUNCT else "_"
                  for c in str(value))
    return out or "_"


class SelfTelemetry:
    """The pump and its background loop: ``tsd.stats.self_interval``
    seconds between pumps; <= 0 runs no loop (``pump()`` stays
    callable)."""

    def __init__(self, tsdb):
        self._tsdb_ref = weakref.ref(tsdb)
        self.interval_s = tsdb.config.get_float(
            "tsd.stats.self_interval", 0.0)
        # node identity tag on every record: tsd.stats.self_tag, or
        # hostname-port
        tag = tsdb.config.get_string("tsd.stats.self_tag", "")
        if not tag:
            tag = (f"{platform.node() or 'tsd'}-"
                   f"{tsdb.config.get_int('tsd.network.port', 4242)}")
        self.host_tag = _sanitize(tag)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.pumps = 0
        self.points_written = 0
        self.point_errors = 0
        self.pump_errors = 0

    @property
    def tsdb(self):
        return self._tsdb_ref()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="tsd-telemetry",
                             daemon=True)
        self._thread = t
        t.start()
        LOG.info("self-telemetry pumping every %.0fs", self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.tsdb is None:
                return  # the TSDB was dropped without a shutdown
            try:
                self.pump()
            except Exception:  # noqa: BLE001 - pump() counted it; the
                # loop outlives a failed pump
                LOG.exception("self-telemetry pump failed")

    # -- the pump ------------------------------------------------------

    def snapshot(self) -> list[tuple[str, float, dict[str, str]]]:
        """One collector pass over every registered provider (the
        records ``/api/stats`` serves), finite values only and tags
        sanitized to the storage charset."""
        t = self.tsdb
        collector = t.stats.collect()
        t.collect_stats(collector)
        out = []
        for name, value, tags in collector.records:
            if not math.isfinite(value):
                continue
            clean = {_sanitize(k): _sanitize(v) for k, v in tags.items()}
            clean.setdefault("host", self.host_tag)
            out.append((name, float(value), clean))
        return out

    def pump(self, now_s: int | None = None) -> int:
        """Ingest one snapshot through the normal columnar group write
        (WAL, stream taps, lifecycle and the result-cache invalidation
        all see it like any client put) under a ``telemetry.pump``
        trace root; returns the points written."""
        t = self.tsdb
        tracer = t.tracer
        tctx = tracer.start_background("telemetry.pump")
        now = int(now_s if now_s is not None else time.time())
        try:
            with trace_mod.use(tctx):
                groups = []
                for metric, value, tags in self.snapshot():
                    # self-metrics mint their own UIDs: the auto-create
                    # policy gates client traffic, not the heartbeat
                    t.uids.metrics.get_or_create_id(metric)
                    for k, v in tags.items():
                        t.uids.tag_names.get_or_create_id(k)
                        t.uids.tag_values.get_or_create_id(v)
                    groups.append((metric, tags, [None], [now], [value]))

                def on_error(_ref, _exc) -> None:
                    self.point_errors += 1

                written, _errs = t.add_point_groups(groups,
                                                    on_error=on_error)
            self.pumps += 1
            self.points_written += written
            if tctx is not None:
                tctx.tag(points=written)
        except Exception as exc:
            self.pump_errors += 1
            if tctx is not None:
                tctx.set_error(exc)
            raise
        finally:
            tracer.finish(tctx)
        return written

    # -- observability -------------------------------------------------

    def collect_stats(self, collector) -> None:
        collector.record("telemetry.pumps", self.pumps)
        collector.record("telemetry.points", self.points_written)
        collector.record("telemetry.point_errors", self.point_errors)
        collector.record("telemetry.pump_errors", self.pump_errors)

    def health_info(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "running": self._thread is not None
            and self._thread.is_alive(),
            "pumps": self.pumps,
            "points_written": self.points_written,
            "point_errors": self.point_errors,
            "pump_errors": self.pump_errors,
        }
