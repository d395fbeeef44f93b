"""Downsampling specification and bucket assignment (host numpy).

(ref: ``src/core/DownsamplingSpecification.java``, ``FillPolicy.java``,
``Downsampler.java``)

Points are mapped to fixed-interval buckets aligned down to the
interval, like the reference aligns its output timestamps. Calendar
buckets (a ``c`` suffix, month/year units, ``useCalendar``) arrive with
a later slice of the port and raise NotImplementedError here.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from opentsdb_tpu_torch.core.store import pad_mask
from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.utils import datetime_util


class FillPolicy(Enum):
    """(ref: src/core/FillPolicy.java:22)"""
    NONE = "none"
    ZERO = "zero"
    NOT_A_NUMBER = "nan"
    NULL = "null"
    SCALAR = "scalar"

    @classmethod
    def from_string(cls, name: str) -> "FillPolicy":
        for p in cls:
            if p.value == name.lower():
                return p
        raise ValueError(f"Unrecognized fill policy: {name}")


@dataclass(frozen=True)
class DownsamplingSpecification:
    """Parsed ``interval-function[-fillpolicy]`` spec
    (ref: DownsamplingSpecification.java:82-116). ``interval`` may be
    ``0all`` (one bucket over the whole query) or carry a ``c`` suffix
    for calendar alignment; scalar fill is written ``scalar#<value>``."""
    interval_ms: int
    function: str
    fill_policy: FillPolicy = FillPolicy.NONE
    fill_value: float = float("nan")
    use_calendar: bool = False
    run_all: bool = False
    interval: int = 0
    unit: str = ""
    timezone: str | None = None
    string_interval: str = ""

    @classmethod
    def parse(cls, spec: str, timezone: str | None = None
              ) -> "DownsamplingSpecification":
        parts = spec.split("-")
        if len(parts) < 2:
            raise ValueError(
                f"Invalid downsampling specification: {spec}")
        interval_str, function = parts[0], parts[1]
        fill_policy = FillPolicy.NONE
        fill_value = float("nan")
        if len(parts) >= 3:
            fp = parts[2]
            if fp.startswith("scalar#"):
                fill_policy = FillPolicy.SCALAR
                fill_value = float(fp.split("#", 1)[1])
            else:
                fill_policy = FillPolicy.from_string(fp)
                if fill_policy == FillPolicy.ZERO:
                    fill_value = 0.0
        if not aggs_mod.exists(function):
            raise ValueError(f"No such downsampling function: {function}")
        # canonicalize registry aliases ("mult" -> "multiply")
        function = aggs_mod.get(function).name
        if interval_str in ("0all", "all"):
            return cls(interval_ms=0, function=function,
                       fill_policy=fill_policy, fill_value=fill_value,
                       run_all=True, string_interval=interval_str,
                       timezone=timezone)
        use_calendar = interval_str.endswith("c")
        if use_calendar:
            interval_str = interval_str[:-1]
        interval = datetime_util.duration_interval(interval_str)
        unit = datetime_util.duration_unit(interval_str)
        interval_ms = datetime_util.parse_duration_ms(interval_str)
        return cls(interval_ms=interval_ms, function=function,
                   fill_policy=fill_policy, fill_value=fill_value,
                   use_calendar=use_calendar, interval=interval, unit=unit,
                   timezone=timezone, string_interval=interval_str)


def fixed_bucket_edges(start_ms: int, end_ms: int,
                       interval_ms: int) -> np.ndarray:
    """Bucket start times for a fixed interval, aligned down to the
    interval (Downsampler timestamps are modulo-aligned)."""
    first = start_ms - (start_ms % interval_ms)
    return np.arange(first, end_ms + 1, interval_ms, dtype=np.int64)


def assign_buckets(ts_ms: np.ndarray, spec: DownsamplingSpecification,
                   start_ms: int, end_ms: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Map point timestamps to bucket indices. Returns
    ``(bucket_idx int32[N], bucket_ts int64[B])``."""
    if spec.run_all:
        bucket_ts = np.asarray([start_ms], dtype=np.int64)
        return np.zeros(len(ts_ms), dtype=np.int32), bucket_ts
    if spec.use_calendar or spec.unit in ("n", "y"):
        raise NotImplementedError(
            "calendar-aligned downsampling is not ported yet")
    edges = fixed_bucket_edges(start_ms, end_ms, spec.interval_ms)
    idx = ((ts_ms - edges[0]) // spec.interval_ms).astype(np.int32)
    return idx, edges


def assign_buckets_padded(ts2d: np.ndarray, counts: np.ndarray,
                          spec: DownsamplingSpecification,
                          start_ms: int, end_ms: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Padded-layout bucket assignment: ``ts2d[S, Pmax]`` with per-row
    point counts. Returns ``(bucket_idx2d int32[S, Pmax] with -1 pads,
    bucket_ts int64[B])``."""
    idx, bucket_ts = assign_buckets(ts2d.reshape(-1), spec, start_ms,
                                    end_ms)
    idx = idx.reshape(ts2d.shape)
    idx[pad_mask(counts, ts2d.shape[1])] = -1
    return idx, bucket_ts
