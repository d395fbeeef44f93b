"""SLO burn-rate derivation: "are we eating the error budget" as one
query (ref: ``opentsdb_tpu/obs/slo.py``).

Per-endpoint objectives are declared in config (``tsd.slo.*``): a
latency objective ("99% of queries answer under 1000 ms") and an
availability objective ("99.9% of queries don't shed or 5xx"). The
tracker folds every served request into per-10s buckets of
``(total, slow, errored)`` per endpoint — fed by the socket server
at response time (so admission-shed 503s and query-timeout 504s,
which never enter the HTTP router, still burn the budget and the
latency includes the queue wait), or by :meth:`HttpRpcRouter.handle`
for direct-handler callers (tests, benches) — and derives
**multi-window burn rates** on read (the Google SRE workbook shape: a
short window catches fast burns, a long window catches slow leaks)::

    burn = (bad_fraction over window) / (1 - objective)

1.0 means the error budget is being consumed exactly at the rate that
exhausts it by the end of the SLO period; alert thresholds are
typically 14.4 (fast) and ~1-6 (slow). The gauges export at
``/metrics`` (``tsd_slo_burn_rate{endpoint,slo,window}``) and in the
``slo`` section of ``/api/health``.

The bucket ring is bounded by the longest configured window, so the
tracker is O(windows) memory regardless of traffic.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

#: endpoint -> (latency_ms default, latency objective default,
#: availability objective default)
_ENDPOINT_DEFAULTS = {
    "query": (1000.0, 0.99, 0.999),
    "put": (500.0, 0.99, 0.999),
}

_BUCKET_S = 10


class SloTracker:
    """Windowed good/bad event counts + burn-rate gauges."""

    def __init__(self, config):
        self.enabled = config.get_bool("tsd.slo.enable", True)
        windows = []
        for part in config.get_string("tsd.slo.windows",
                                      "300,3600").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                w = int(part)
            except ValueError:
                continue
            if w >= _BUCKET_S:
                windows.append(w)
        self.windows_s: tuple[int, ...] = tuple(sorted(set(windows))) \
            or (300, 3600)
        self.objectives: dict[str, dict[str, float]] = {}
        for ep, (lat_ms, lat_obj, avail_obj) in \
                _ENDPOINT_DEFAULTS.items():
            self.objectives[ep] = {
                "latency_ms": config.get_float(
                    f"tsd.slo.{ep}.latency_ms", lat_ms),
                "latency_objective": _clamp_objective(config.get_float(
                    f"tsd.slo.{ep}.latency_objective", lat_obj)),
                "availability_objective": _clamp_objective(
                    config.get_float(
                        f"tsd.slo.{ep}.availability_objective",
                        avail_obj)),
            }
        self._lock = threading.Lock()
        # ring of (bucket start second, {endpoint: [total, slow, err]})
        # — bounded by the longest window
        self._buckets: deque = deque(
            maxlen=max(self.windows_s) // _BUCKET_S + 1)
        self.events = 0

    # -- feed ----------------------------------------------------------

    def record(self, endpoint: str, latency_ms: float,
               errored: bool, now_s: float | None = None) -> None:
        """One served request. ``errored`` = the availability-SLO
        violation (5xx/shed); the latency SLO additionally counts the
        request bad when it exceeded the endpoint's threshold."""
        obj = self.objectives.get(endpoint)
        if obj is None or not self.enabled:
            return
        now = int(now_s if now_s is not None else time.time())
        sec = now - now % _BUCKET_S
        slow = latency_ms > obj["latency_ms"]
        with self._lock:
            if not self._buckets or self._buckets[-1][0] != sec:
                self._buckets.append((sec, {}))
            per = self._buckets[-1][1].setdefault(endpoint, [0, 0, 0])
            per[0] += 1
            if slow:
                per[1] += 1
            if errored:
                per[2] += 1
            self.events += 1

    # -- derivation ----------------------------------------------------

    def _window_counts(self, now: int) -> dict[int, dict[str, list]]:
        """{window_s: {endpoint: [total, slow, err]}} in one pass over
        a locked snapshot of the ring."""
        with self._lock:
            buckets = list(self._buckets)
        out: dict[int, dict[str, list]] = {
            w: {} for w in self.windows_s}
        for sec, per in buckets:
            age = now - sec
            for w in self.windows_s:
                if age >= w:
                    continue
                acc = out[w]
                for ep, (total, slow, err) in per.items():
                    a = acc.setdefault(ep, [0, 0, 0])
                    a[0] += total
                    a[1] += slow
                    a[2] += err
        return out

    def burn_rates(self, now_s: float | None = None
                   ) -> dict[str, dict[str, dict[str, float]]]:
        """{endpoint: {slo: {window label: burn}}}. Windows with no
        traffic report 0.0 (no evidence of burn, not "unknown" — a
        health probe must not flap on an idle TSD)."""
        now = int(now_s if now_s is not None else time.time())
        counts = self._window_counts(now)
        out: dict[str, dict[str, dict[str, float]]] = {}
        for ep, obj in self.objectives.items():
            per_slo: dict[str, dict[str, float]] = {
                "latency": {}, "availability": {}}
            for w in self.windows_s:
                label = _window_label(w)
                total, slow, err = counts[w].get(ep, (0, 0, 0))
                per_slo["latency"][label] = _burn(
                    slow, total, obj["latency_objective"])
                per_slo["availability"][label] = _burn(
                    err, total, obj["availability_objective"])
            out[ep] = per_slo
        return out

    # -- exposition ----------------------------------------------------

    def gauges(self, now_s: float | None = None
               ) -> list[tuple[dict[str, str], float]]:
        """Flat (labels, value) burn-rate samples for /metrics."""
        out = []
        for ep, per_slo in self.burn_rates(now_s).items():
            for slo, per_w in per_slo.items():
                for label, burn in per_w.items():
                    out.append(({"endpoint": ep, "slo": slo,
                                 "window": label}, burn))
        return out

    def collect_stats(self, collector) -> None:
        if not self.enabled:
            return
        for labels, burn in self.gauges():
            collector.record("slo.burn_rate", burn, **labels)
        collector.record("slo.events", self.events)

    def health_info(self, now_s: float | None = None
                    ) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "enabled": self.enabled,
            "windows_s": list(self.windows_s),
            "events": self.events,
        }
        if self.enabled:
            doc["objectives"] = {
                ep: dict(obj) for ep, obj in self.objectives.items()}
            doc["burn_rates"] = self.burn_rates(now_s)
        return doc


def _clamp_objective(x: float) -> float:
    """Objectives live strictly inside (0, 1) — 1.0 would make the
    budget zero and every burn infinite."""
    return min(max(x, 0.0), 0.999999)


def _burn(bad: int, total: int, objective: float) -> float:
    if total <= 0 or bad <= 0:
        return 0.0
    return round((bad / total) / (1.0 - objective), 4)


def _window_label(w: int) -> str:
    if w % 3600 == 0:
        return f"{w // 3600}h"
    if w % 60 == 0:
        return f"{w // 60}m"
    return f"{w}s"


__all__ = ["SloTracker"]
