"""Event-time layer over the shared-partial engine (ref:
``opentsdb_tpu/streaming/eventtime/``).

The shared partials (:mod:`opentsdb_tpu_torch.streaming.plan`) are
PROCESSING-time correct: late points refold wherever the ring still
covers them and silently drop past its horizon, and nothing tells a
consumer whether a window it just read is final. This package makes
the engine event-time correct, in three pieces:

- :mod:`.watermark` — the per-CQ watermark/lateness policy
  (``{"watermark": {"allowedLateness": "5m"}}`` on registration):
  the ring grows extra lateness columns so in-lateness points REFOLD
  into already-published windows (counted, republished through the
  normal dirty-bucket path), points past the watermark drop and
  count — never silently — and every pull/SSE result carries a
  completeness marker (watermark position, refold/drop counters,
  window finality).
- :mod:`.sessions` — session windows keyed by a tag
  (``{"type": "session", "gap": "2m", "by": "user"}``): one
  :class:`~opentsdb_tpu_torch.streaming.eventtime.sessions.SessionPartial`
  folds millions of concurrent per-user sessions as ONE columnar
  scatter over a shared per-metric ring — rows key by the tag VALUE,
  not the series — with gap-close decided by the watermark.
- hopping windows (slide > interval) live in the core window machinery
  (:class:`~opentsdb_tpu_torch.streaming.plan.WindowSpec` +
  :func:`~opentsdb_tpu_torch.ops.stream_fold.combine_hopping`) as the
  generalization of the existing sliding view-time combine.

The reference also federates all of the above across a cluster's
shards (``cluster/cq.py``); the port has no cluster yet (ROADMAP
Queue 1, the rest, with no device compute).
"""

from opentsdb_tpu_torch.streaming.eventtime.sessions import \
    SessionPartial
from opentsdb_tpu_torch.streaming.eventtime.watermark import (
    WatermarkPolicy, completeness_marker)

__all__ = ["SessionPartial", "WatermarkPolicy", "completeness_marker"]
