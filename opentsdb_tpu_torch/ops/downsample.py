"""Downsampling: the specification, bucket assignment (host numpy) and
the time-bucket reductions ahead of aggregation (PyTorch).

(ref: ``src/core/DownsamplingSpecification.java``, ``FillPolicy.java``,
``Downsampler.java``; port of ``opentsdb_tpu/ops/downsample.py``)

Points are mapped to fixed-interval buckets aligned down to the
interval, like the reference aligns its output timestamps. Calendar
buckets (a ``c`` suffix, or the month and year units) get their edges
on the host, time-zone and DST aware, and points are assigned by a
search: the reductions never see calendar logic.

Two reductions produce the ``[series, bucket]`` grid with NaN holes:

- :func:`bucketize` over a flat point batch sorted by (series, time):
  one segmented reduction per statistic (:mod:`.segment`), and one
  sort for the rank functions (median, percentiles);
- :func:`bucketize_padded` over the row-padded layout, for the
  functions in :data:`PADDED_FNS`. The reference reduces a broadcast
  ``[S, P, B]`` membership compare that XLA keeps virtual; eager
  PyTorch would materialize it (2.9 GB per float32 temporary at
  ``[1M, 60] x 12``). Rows are time-ascending, so a bucket's points lie
  in a narrow band of columns: each bucket is reduced over its band
  only, with fixed-shape reductions along the point axis.

Every reduction walks its points in a fixed order (no atomics), so a
query gives the same bits on every call.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

import torch

from opentsdb_tpu_torch.core.store import pad_mask
from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops import segment
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


def calendar_bucket_edges(start_ms: int, end_ms: int, interval: int,
                          unit: str, tz: str | None) -> np.ndarray:
    """Host-computed calendar bucket starts (time-zone and DST aware).

    Sub-day units step in local wall time, so where a local time occurs
    twice (the hour a zone sets its clocks back) the next edge can fall
    at or before the last one; the reference then loops forever. Here
    that raises ValueError."""
    edges = [datetime_util.previous_interval_ms(start_ms, interval, unit,
                                                tz)]
    while edges[-1] <= end_ms:
        nxt = datetime_util.next_interval_ms(edges[-1], interval, unit, tz)
        if nxt <= edges[-1]:
            raise ValueError(
                f"calendar interval {interval}{unit} does not advance "
                f"past {edges[-1]} ms in zone {tz}: a repeated local time")
        edges.append(nxt)
    return np.asarray(edges[:-1] if edges[-1] > end_ms else edges,
                      dtype=np.int64)


def assign_buckets(ts_ms: np.ndarray, spec: DownsamplingSpecification,
                   start_ms: int, end_ms: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Map point timestamps to bucket indices. Returns
    ``(bucket_idx int32[N], bucket_ts int64[B])``."""
    if spec.run_all:
        bucket_ts = np.asarray([start_ms], dtype=np.int64)
        return np.zeros(len(ts_ms), dtype=np.int32), bucket_ts
    if spec.use_calendar or spec.unit in ("n", "y"):
        edges = calendar_bucket_edges(start_ms, end_ms, spec.interval,
                                      spec.unit, spec.timezone)
        idx = np.searchsorted(edges, ts_ms, side="right") - 1
        return idx.astype(np.int32), edges
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


# ---------------------------------------------------------------------------
# the bucket reductions
# ---------------------------------------------------------------------------

def bucketize(values, series_idx, bucket_idx, num_series: int,
              num_buckets: int, function: str):
    """Downsample a flat point batch into a dense ``[S, B]`` grid.

    The points must be sorted by (series, time), as the store
    materializes them, so the segment ids ``series * B + bucket`` are
    non-decreasing. Returns ``(grid [S, B] with NaN holes,
    count [S, B])``: the reference's whole Downsampler pass over every
    series at once. Stored NaN values count as missing."""
    nseg = num_series * num_buckets
    seg_ids = series_idx.long() * num_buckets + bucket_idx.long()
    # the segments' bounds, found once for every statistic
    off = segment.segment_offsets(seg_ids, nseg)

    def red(x, how="sum"):
        return segment.reduce_at(x, off, how)

    valid = ~torch.isnan(values)
    x0 = torch.where(valid, values, 0.0)
    cnt = red(valid.to(values.dtype))
    mask = cnt > 0

    if function in ("sum", "zimsum", "pfsum"):
        out = red(x0)
    elif function in ("min", "mimmin"):
        out = red(torch.where(valid, values, torch.inf), "min")
    elif function in ("max", "mimmax"):
        out = red(torch.where(valid, values, -torch.inf), "max")
    elif function == "avg":
        out = red(x0) / cnt.clamp(min=1)
    elif function == "count":
        out = cnt
    elif function == "multiply":
        out = red(torch.where(valid, values, 1.0), "prod")
    elif function == "squareSum":
        out = red(x0 * x0)
    elif function in ("first", "last", "diff"):
        first, last = segment.first_last_at(values, valid, off)
        out = {"first": first, "last": last}.get(function)
        if out is None:  # diff: a single point gives 0 (Aggregators.Diff)
            out = torch.where(cnt == 1, 0.0, last - first)
    elif function == "dev":
        safe = cnt.clamp(min=1)
        mean = red(x0) / safe
        # population variance (divisor n), as agg_dev
        var = (red(x0 * x0) / safe - mean * mean).clamp(min=0.0)
        out = torch.where(cnt == 1, 0.0, torch.sqrt(var))
    elif function == "median":
        out = _bucketize_rank(values, seg_ids, nseg, 50.0, "median")
    else:
        agg = aggs_mod.get(function)
        if not agg.is_percentile:
            raise ValueError(f"unsupported downsample function {function}")
        out = _bucketize_rank(values, seg_ids, nseg, agg.percentile,
                              agg.estimation)
    grid = torch.where(mask, out, torch.nan).reshape(num_series,
                                                     num_buckets)
    return grid, cnt.reshape(num_series, num_buckets)


# downsample functions of the padded layout: the simple statistics;
# median and the percentiles take the flat layout's sort
PADDED_FNS = frozenset(
    ("sum", "zimsum", "pfsum", "avg", "count", "squareSum", "dev",
     "min", "mimmin", "max", "mimmax", "multiply", "first", "last",
     "diff"))


def padded_supported(function: str, num_buckets: int) -> bool:
    return function in PADDED_FNS


def bucket_bands(bucket_idx2d: torch.Tensor,
                 num_buckets: int) -> list[tuple[int, int]]:
    """[(lo, hi)] per bucket: the columns of the padded layout that can
    hold its points. Bucket b can sit in column c only when the least
    and greatest bucket of that column (pads aside) bracket b; rows are
    time-ascending, so the band is narrow. One host sync."""
    b = num_buckets
    colmin = torch.where(bucket_idx2d >= 0, bucket_idx2d, b).amin(0)
    colmax = bucket_idx2d.amax(0)
    lo_hi = torch.stack([colmin, colmax]).cpu().numpy()
    buckets = np.arange(b)[:, None]
    inside = (lo_hi[0][None, :] <= buckets) & (buckets <= lo_hi[1][None, :])
    any_col = inside.any(axis=1)
    first = np.argmax(inside, axis=1)
    last = inside.shape[1] - np.argmax(inside[:, ::-1], axis=1)
    return [(int(f), int(h)) if a else (0, 0)
            for f, h, a in zip(first, last, any_col)]


def bucketize_padded(values2d, bucket_idx2d, num_buckets: int,
                     function: str):
    """Downsample the row-padded layout without a scatter.

    ``values2d [S, P]`` (NaN pads), ``bucket_idx2d [S, P]`` int (-1 for
    pads), each row time-ascending -> ``(grid [S, B] with NaN holes,
    count [S, B])``. Each bucket's statistics reduce its band of
    columns (:func:`bucket_bands`) along the point axis, as the
    reference reduces its ``[S, P, B]`` compare over P."""
    if function not in PADDED_FNS:
        raise ValueError(
            f"padded path does not support downsample fn {function!r}")
    s = values2d.shape[0]
    dt = values2d.dtype
    cols, cnts = [], []
    for b, (lo, hi) in enumerate(bucket_bands(bucket_idx2d, num_buckets)):
        if hi == lo:  # no column holds bucket b: an empty column
            cols.append(values2d.new_zeros(s))
            cnts.append(values2d.new_zeros(s))
            continue
        v = values2d[:, lo:hi]
        m = (bucket_idx2d[:, lo:hi] == b) & ~torch.isnan(v)
        cnt = m.sum(1).to(dt)
        x0 = torch.where(m, v, 0.0)
        if function in ("sum", "zimsum", "pfsum"):
            out = x0.sum(1)
        elif function == "avg":
            out = x0.sum(1) / cnt.clamp(min=1)
        elif function == "count":
            out = cnt
        elif function == "squareSum":
            out = (x0 * x0).sum(1)
        elif function == "dev":
            safe = cnt.clamp(min=1)
            mean = x0.sum(1) / safe
            # population variance (divisor n), as agg_dev
            var = ((x0 * x0).sum(1) / safe - mean * mean).clamp(min=0.0)
            out = torch.where(cnt == 1, 0.0, torch.sqrt(var))
        elif function in ("min", "mimmin"):
            out = torch.where(m, v, torch.inf).amin(1)
        elif function in ("max", "mimmax"):
            out = torch.where(m, v, -torch.inf).amax(1)
        elif function == "multiply":
            out = torch.where(m, v, 1.0).prod(1)
        else:  # first, last, diff: rows are time-ascending
            col = torch.arange(hi - lo, device=v.device)
            first = torch.where(m, col, hi - lo).amin(1, keepdim=True)
            last = torch.where(m, col, -1).amax(1, keepdim=True)
            firstv = x0.gather(1, first.clamp(max=hi - lo - 1))[:, 0]
            lastv = x0.gather(1, last.clamp(min=0))[:, 0]
            out = {"first": firstv, "last": lastv}.get(function)
            if out is None:  # diff: a single point gives 0
                out = lastv - firstv
        cols.append(out)
        cnts.append(cnt)
    if not cols:
        empty = values2d.new_zeros((s, 0))
        return empty, empty
    cnt = torch.stack(cnts, 1)
    grid = torch.where(cnt > 0, torch.stack(cols, 1), torch.nan)
    return grid, cnt


def _bucketize_rank(values, seg_ids, nseg, q: float, estimation: str):
    """Percentile or median per (series, bucket) by one sort of the
    points within their segments (:func:`segment.segment_sort_ranks`)."""
    sorted_vals, _, starts, counts = segment.segment_sort_ranks(
        values, seg_ids, nseg)
    n = counts.to(values.dtype)
    p = q / 100.0
    one = torch.ones_like(n)
    if estimation == "median":
        # upper median: 1-based rank n//2 + 1 (ref: Median sorted[n/2])
        h = torch.floor(n / 2) + 1
    elif estimation == "legacy":
        h = torch.minimum((p * (n + 1)).clamp(min=1.0),
                          torch.maximum(n, one))
    elif estimation == "r3":
        h = torch.minimum(torch.ceil(p * n - 0.5).clamp(min=1.0),
                          torch.maximum(n, one))
    elif estimation == "r7":
        h = torch.minimum(((n - 1) * p + 1).clamp(min=1.0),
                          torch.maximum(n, one))
    else:
        raise ValueError(f"unknown estimation {estimation!r}")
    if estimation in ("r3", "median"):
        h = torch.floor(h)  # a pure rank select, no interpolation
    return segment.select_rank(sorted_vals, starts, counts, h)
