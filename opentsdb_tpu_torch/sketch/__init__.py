"""Mergeable quantile sketches (ref: ``opentsdb_tpu/sketch/``): the
DDSketch that serves percentile sub-queries over scalar metrics
(:mod:`opentsdb_tpu_torch.sketch.query`)."""

from opentsdb_tpu_torch.sketch.ddsketch import DDSketch

__all__ = ["DDSketch"]
