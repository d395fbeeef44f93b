"""Continuous-query subsystem: standing TSQueries maintained
incrementally under ingest (registry + incremental window folds + SSE
push transport). See :mod:`opentsdb_tpu_torch.streaming.registry`
(ref: ``opentsdb_tpu/streaming/``)."""

from opentsdb_tpu_torch.streaming.registry import (ContinuousQuery,
                                                   ContinuousQueryRegistry)

__all__ = ["ContinuousQuery", "ContinuousQueryRegistry"]
