"""Observability (ref: ``opentsdb_tpu/obs/``).

- :mod:`~opentsdb_tpu_torch.obs.trace`: sampled span records over the
  ingest, query and background paths, the slow-request log and the
  query-shape log.
- :mod:`~opentsdb_tpu_torch.obs.telemetry`: the
  ``tsd.stats.self_interval`` pump of the TSD's own stats into its own
  store as ``tsd.*`` series.
- :mod:`~opentsdb_tpu_torch.obs.openmetrics`: ``GET /metrics``.
- :mod:`~opentsdb_tpu_torch.obs.profiler`: the sampling profiler
  behind ``GET /api/profile``.
- :mod:`~opentsdb_tpu_torch.obs.slo`: per-endpoint SLO burn rates.
"""

from opentsdb_tpu_torch.obs.trace import (KNOWN_SPANS, Tracer, current,
                                          record_span, trace_begin,
                                          trace_end, trace_span, use)

__all__ = ["KNOWN_SPANS", "Tracer", "current", "record_span",
           "trace_begin", "trace_end", "trace_span", "use"]
