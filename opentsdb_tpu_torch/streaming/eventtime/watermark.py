"""Watermark/lateness policy + completeness markers for standing CQs
(ref: ``opentsdb_tpu/streaming/eventtime/watermark.py``).

The policy is ONE number — allowed lateness — but it changes three
contracts at once:

- **ring sizing**: registration adds ``lateness_buckets`` trailing
  columns per view, so every bucket inside the allowed-lateness
  horizon stays resident and a late point REFOLDS into its (already
  published) window through the normal fold scatter; the dirty-bucket
  path then republishes it over SSE like any other fold.
- **finality**: the watermark is the newest folded event time minus
  the allowed lateness. Once it passes a bucket's end, that bucket is
  final — later points into it are dropped AND counted
  (``late_dropped``), never folded and never silent
  (:meth:`opentsdb_tpu_torch.streaming.plan.SharedPartial.fold`).
- **surfacing**: every pull (``GET .../result``) and SSE frame of a
  policy-carrying CQ carries a completeness marker built here —
  watermark position, refold/drop counters, whether the emitted range
  is final, and open/closed session counts for session views. The
  marker builder runs under the ``stream.watermark`` fault site: an
  armed fault degrades the PULL to a structured 503 (the registry
  maps it) and the PUSH to a ``{"degraded": true}`` marker — results
  without a trustworthy marker are refused or flagged, not passed
  off as complete.

A policy also REMOVES the CQ from the ``/api/query`` pull fast path:
a strict-lateness partial drops late points the raw store accepted,
so it can no longer answer batch queries value-identically. Pull
consumers use the ``.../result`` surface, where the marker tells them
what they got.
"""

from __future__ import annotations

from typing import Any

from opentsdb_tpu_torch.query.model import BadRequestError
from opentsdb_tpu_torch.utils import datetime_util


class WatermarkPolicy:
    """Validated per-CQ lateness policy (``None`` means the legacy
    processing-time contract: refold anywhere in the ring, drop only
    at the ring horizon, no markers)."""

    __slots__ = ("lateness_ms",)

    def __init__(self, lateness_ms: int):
        self.lateness_ms = int(lateness_ms)

    @classmethod
    def from_json(cls, obj) -> "WatermarkPolicy | None":
        if obj in (None, {}):
            return None
        if not isinstance(obj, dict):
            raise BadRequestError("watermark must be an object")
        raw = obj.get("allowedLateness")
        if not raw:
            raise BadRequestError(
                "watermark requires 'allowedLateness' (e.g. \"5m\")")
        try:
            ms = datetime_util.parse_duration_ms(str(raw))
        except ValueError as e:
            raise BadRequestError(str(e)) from None
        if ms <= 0:
            raise BadRequestError(
                f"allowedLateness {raw!r} must be positive")
        return cls(ms)

    def lateness_buckets(self, interval_ms: int) -> int:
        """Extra trailing ring columns that keep the full allowed-
        lateness horizon resident at ``interval_ms`` granularity."""
        return -(-self.lateness_ms // int(interval_ms))

    def to_json(self) -> dict[str, Any]:
        return {"allowedLatenessMs": self.lateness_ms}


def completeness_marker(registry, cq, end_ms: int) -> dict[str, Any]:
    """The completeness marker for one policy-carrying CQ's emitted
    results ending at ``end_ms``: the joint watermark (minimum over
    the CQ's distinct partials — a range is only as final as its
    least-advanced fold), the lateness bound, the cumulative
    refold/drop counters, and per-session-view gap-close counts.

    Runs the ``stream.watermark`` fault site FIRST: callers must
    treat a raised fault as "marker unavailable" (503 the pull, flag
    the push) — never emit results silently stripped of their
    completeness contract."""
    faults = getattr(registry.tsdb, "faults", None)
    if faults is not None:
        faults.check("stream.watermark")
    policy = cq.policy
    wm: int | None = None
    dropped = refolded = 0
    sessions_open = sessions_closed = 0
    have_sessions = False
    seen: set[int] = set()
    for view in cq.plans:
        g = view.shared
        with g.lock:
            w = g.watermark_ms()
            if id(g) not in seen:
                seen.add(id(g))
                wm = w if wm is None else min(wm, w)
                dropped += g.late_dropped
                refolded += g.late_refolded
            if view.window.kind == "session":
                have_sessions = True
                o, c = g.session_stats(view.window.gap_ms, w)
                sessions_open += o
                sessions_closed += c
    wm = int(wm or 0)
    out: dict[str, Any] = {
        "watermarkMs": wm,
        "latenessMs": policy.lateness_ms,
        "lateRefolded": refolded,
        "lateDropped": dropped,
        # every bucket ending at or before the watermark is final; a
        # range whose end the watermark has passed cannot change
        "complete": wm >= int(end_ms),
    }
    if have_sessions:
        out["sessionsOpen"] = sessions_open
        out["sessionsClosed"] = sessions_closed
    return out


__all__ = ["WatermarkPolicy", "completeness_marker"]
