"""Group-by aggregation over the series axis.

(ref: ``src/core/TsdbQuery.java:916-1045`` GroupByAndAggregateCB)

A group is a segment id per series: after interpolation fill
(:mod:`opentsdb_tpu_torch.ops.interp`), one segment reduction over axis
0 of the ``[series, bucket]`` grid aggregates every group and bucket at
once — ``index_add_`` for the sums, ``scatter_reduce_`` for min, max,
product and the first/last positions. The order-statistic aggregators
(median, percentiles) raise NotImplementedError until a later slice
ports their group stage.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops.interp import fill_gaps


def _group_sum(data, group_ids, num_groups: int):
    """Segment-sum over the series axis: data[S,B] -> [G,B]."""
    out = data.new_zeros((num_groups,) + tuple(data.shape[1:]))
    return out.index_add_(0, group_ids, data)


_EXTREMUM = {"min": ("amin", torch.inf), "max": ("amax", -torch.inf),
             "prod": ("prod", 1.0)}


def _group_extremum(data, group_ids, num_groups: int, mode: str):
    """Non-linear segment reduction (min/max/prod) over the series
    axis: data[S,B] -> [G,B]. Missing cells are pre-filled by the
    caller with the reduction's identity; an empty group holds it."""
    reduce, identity = _EXTREMUM[mode]
    out = data.new_full((num_groups,) + tuple(data.shape[1:]), identity)
    idx = group_ids[:, None].expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce=reduce)


def _group_reduce(filled, group_ids, num_groups: int, agg_name: str):
    """Aggregate filled[S,B] into [G,B] per ``agg_name``. NaN = missing."""
    nan = float("nan")
    valid = ~torch.isnan(filled)
    x0 = torch.where(valid, filled, 0.0)
    cnt = _group_sum(valid.to(filled.dtype), group_ids, num_groups)
    any_valid = cnt > 0

    if agg_name in ("sum", "zimsum", "pfsum"):
        out = _group_sum(x0, group_ids, num_groups)
    elif agg_name == "avg":
        out = _group_sum(x0, group_ids, num_groups) / cnt.clamp(min=1)
    elif agg_name == "count":
        out = cnt
    elif agg_name in ("min", "mimmin"):
        out = _group_extremum(torch.where(valid, filled, torch.inf),
                              group_ids, num_groups, "min")
        out = torch.where(torch.isinf(out) & (out > 0), nan, out)
        # mimmin holes filled with +inf are valid contributions; a
        # group where *everything* is +inf has no real data
        any_valid = any_valid & ~torch.isnan(out)
    elif agg_name in ("max", "mimmax"):
        out = _group_extremum(torch.where(valid, filled, -torch.inf),
                              group_ids, num_groups, "max")
        out = torch.where(torch.isinf(out) & (out < 0), nan, out)
        any_valid = any_valid & ~torch.isnan(out)
    elif agg_name == "multiply":
        out = _group_extremum(torch.where(valid, filled, 1.0),
                              group_ids, num_groups, "prod")
    elif agg_name == "squareSum":
        out = _group_sum(x0 * x0, group_ids, num_groups)
    elif agg_name == "dev":
        s1 = _group_sum(x0, group_ids, num_groups)
        mean = s1 / cnt.clamp(min=1)
        centered = torch.where(valid, filled - mean[group_ids], 0.0)
        m2 = _group_sum(centered * centered, group_ids, num_groups)
        # population variance (divisor n), see aggregators.agg_dev
        var = m2 / cnt.clamp(min=1)
        out = torch.where(cnt == 1, 0.0, torch.sqrt(var.clamp(min=0.0)))
    elif agg_name in ("first", "last", "diff"):
        s = filled.shape[0]
        pos = torch.arange(s, device=filled.device)[:, None] \
            .expand_as(filled)
        idx = group_ids[:, None].expand_as(filled)
        first_pos = pos.new_full(cnt.shape, s).scatter_reduce_(
            0, idx, torch.where(valid, pos, s), reduce="amin")
        last_pos = pos.new_full(cnt.shape, -1).scatter_reduce_(
            0, idx, torch.where(valid, pos, -1), reduce="amax")
        first_val = torch.gather(filled, 0, first_pos.clamp(0, s - 1))
        last_val = torch.gather(filled, 0, last_pos.clamp(0, s - 1))
        if agg_name == "first":
            out = first_val
        elif agg_name == "last":
            out = last_val
        else:  # diff: exactly one value -> 0 (ref: Aggregators.Diff)
            out = torch.where(cnt == 1, 0.0, last_val - first_val)
    elif aggs_mod.exists(agg_name):
        raise NotImplementedError(
            f"group aggregator {agg_name!r} (median/percentile) is not "
            "ported yet")
    else:
        raise ValueError(f"unsupported group aggregator {agg_name}")
    return torch.where(any_valid, out, nan)


def group_aggregate(grid, bucket_ts, group_ids, num_groups: int,
                    agg: aggs_mod.Aggregator, interpolate: bool = True):
    """The reference's SpanGroup.iterator + AggregationIterator pass:
    interpolation fill per the aggregator's mode, then one segmented
    reduction over the series axis. grid[S,B] -> [G,B].

    ``interpolate=False`` for NAN/NULL downsample fill policies: the
    reference emits explicit NaN points there, so the merge loop skips
    the NaN value instead of interpolating across a gap."""
    filled = (fill_gaps(grid, bucket_ts, agg.interpolation.value)
              if interpolate else grid)
    return _group_reduce(filled, group_ids, num_groups, agg.name)
