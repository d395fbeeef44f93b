"""Group-by aggregation over the series axis.

(ref: ``src/core/TsdbQuery.java:916-1045`` GroupByAndAggregateCB)

A group is a segment id per series: after interpolation fill
(:mod:`opentsdb_tpu_torch.ops.interp`), one segment reduction over axis
0 of the ``[series, bucket]`` grid aggregates every group and bucket at
once.

Every reduction follows a fixed order (:class:`GroupPlan`), so the
same inputs give the same bits on every call, on the card as on the
CPU: the rows are taken in a stable group order, each group's rows are
cut into blocks of :data:`BLOCK`, each block is reduced by a
fixed-shape reduction (sums and products in float64), and the blocks'
results are reduced the same way until one is left per group, which is
rounded once. ``index_add_`` and ``scatter_reduce_`` add with atomics
in no fixed order on CUDA and are not used: even a min or max by
atomics could return either of -0.0 and +0.0. The order-statistic
aggregators (median, percentiles) sort each bucket's column by (group,
value) with two stable sorts and pick ranks at the plan's group
starts, as the reference's ``lax.sort`` does.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops.interp import fill_gaps

# the most rows reduced together at one level of a GroupPlan
BLOCK = 32


class GroupPlan:
    """The fixed reduction order of one group vector, built once per
    query from ``group_ids`` [S] on their device and shared by every
    group sum and product of the query.

    Level 1 reads each group's rows in a stable group order, ``block``
    at a time (a group's last block padded with the reduction's
    identity), and reduces each block with a fixed-shape reduction;
    each later level does the same over the previous level's block
    results, until one is left per group. ``block`` is :data:`BLOCK`,
    or less when the groups are small on average, so that the padding
    adds at most S rows to a level. The largest group sets the number
    of levels: reading it is the plan's one host sync. Every other
    shape is a bound from S and G (a level has at most
    ``ceil(rows / block) + G`` blocks), so no other count crosses to
    the host."""

    def __init__(self, group_ids: torch.Tensor, num_groups: int):
        gids = group_ids.long()
        self.group_ids = gids
        self.num_groups = g = num_groups
        self.num_series = s = gids.shape[0]
        dev = gids.device
        # level 1 gathers from the caller's row order through the
        # stable group sort; later levels from the blocks in place
        sorted_ids, rows_of = torch.sort(gids, stable=True)
        ids = torch.arange(g, device=dev)
        starts = torch.searchsorted(sorted_ids, ids)
        sizes = torch.searchsorted(sorted_ids, ids, right=True) - starts
        # [G] each group's first row in the stable group order
        self.group_starts = starts
        self.block = b = max(2, min(BLOCK, s // max(g, 1)))
        largest = int(sizes.max()) if s and g else 0
        lane = torch.arange(b, device=dev)
        # (source row [nb * block], valid [nb, block, 1], nb) per level
        self.levels: list[tuple[torch.Tensor, torch.Tensor, int]] = []
        n = s
        while largest > 1:
            nblk = (sizes + (b - 1)) // b
            bend = torch.cumsum(nblk, 0)
            boff = bend - nblk
            nb = -(-n // b) + g
            blk = torch.arange(nb, device=dev)
            # blocks past the last group's fall in it, and hold no row
            grp = torch.searchsorted(bend, blk, right=True).clamp_(
                max=g - 1)
            first = (blk - boff[grp]) * b   # the block's first row
            valid = lane < (sizes[grp] - first)[:, None]
            src = ((starts[grp] + first)[:, None] + lane).clamp_(
                max=n - 1)
            if rows_of is not None:
                src = rows_of[src]
            self.levels.append((src.view(-1), valid[:, :, None], nb))
            sizes, starts, n, rows_of = nblk, boff, nb, None
            largest = -(-largest // b)
        self._has = (sizes > 0)[:, None]
        final = starts.clamp(max=max(n - 1, 0))
        if rows_of is not None and s:
            final = rows_of[final]   # no level: groups of one row
        self._final = final

    def _reduce(self, data: torch.Tensor, mode: str) -> torch.Tensor:
        reduce, ident, wide = _MODES[mode]
        cur = data.flatten(1) if data.dim() > 1 else data[:, None]
        if self.num_series == 0:
            cur = cur.new_zeros((1, cur.shape[1]))
        for src, valid, nb in self.levels:
            blocks = torch.where(
                valid, cur.index_select(0, src).view(nb, self.block, -1),
                ident)
            cur = (getattr(blocks, reduce)(1, dtype=torch.float64) if wide
                   else getattr(blocks, reduce)(1))
        out = torch.where(self._has, cur.index_select(0, self._final),
                          ident)
        return out.to(data.dtype).view((self.num_groups,)
                                       + tuple(data.shape[1:]))

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """Fixed-order group sum over the series axis: [S, ...] ->
        [G, ...], added in float64 and rounded once to data's dtype."""
        return self._reduce(data, "sum")

    def sums(self, *arrays: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """:meth:`sum` of several [S, B] arrays of one dtype in one
        pass, side by side."""
        out = self.sum(torch.cat(arrays, dim=1))
        return out.split([a.shape[1] for a in arrays], dim=1)

    def prod(self, data: torch.Tensor) -> torch.Tensor:
        """Fixed-order group product (1 for an empty group)."""
        return self._reduce(data, "prod")

    def min(self, data: torch.Tensor) -> torch.Tensor:
        """Group minimum (+inf for an empty group); missing cells are
        pre-filled by the caller with +inf."""
        return self._reduce(data, "min")

    def max(self, data: torch.Tensor) -> torch.Tensor:
        """Group maximum (-inf for an empty group)."""
        return self._reduce(data, "max")


# mode -> (tensor reduction, identity, reduced in float64)
_MODES = {"sum": ("sum", 0.0, True), "prod": ("prod", 1.0, True),
          "min": ("amin", torch.inf, False),
          "max": ("amax", -torch.inf, False)}


def _group_reduce(filled, group_ids, num_groups: int, agg_name: str,
                  plan: GroupPlan | None = None):
    """Aggregate filled[S,B] into [G,B] per ``agg_name``. NaN = missing.
    ``plan`` is the :class:`GroupPlan` of ``group_ids``, built here when
    not given."""
    nan = float("nan")
    if plan is None:
        plan = GroupPlan(group_ids, num_groups)
    valid = ~torch.isnan(filled)
    valid_f = valid.to(filled.dtype)
    x0 = torch.where(valid, filled, 0.0)
    if agg_name in ("sum", "zimsum", "pfsum", "avg", "dev"):
        cnt, total = plan.sums(valid_f, x0)
    elif agg_name == "squareSum":
        cnt, total = plan.sums(valid_f, x0 * x0)
    else:
        cnt = plan.sum(valid_f)
    any_valid = cnt > 0

    if agg_name in ("sum", "zimsum", "pfsum", "squareSum"):
        out = total
    elif agg_name == "avg":
        out = total / cnt.clamp(min=1)
    elif agg_name == "count":
        out = cnt
    elif agg_name in ("min", "mimmin"):
        out = plan.min(torch.where(valid, filled, torch.inf))
        out = torch.where(torch.isinf(out) & (out > 0), nan, out)
        # mimmin holes filled with +inf are valid contributions; a
        # group where *everything* is +inf has no real data
        any_valid = any_valid & ~torch.isnan(out)
    elif agg_name in ("max", "mimmax"):
        out = plan.max(torch.where(valid, filled, -torch.inf))
        out = torch.where(torch.isinf(out) & (out < 0), nan, out)
        any_valid = any_valid & ~torch.isnan(out)
    elif agg_name == "multiply":
        out = plan.prod(torch.where(valid, filled, 1.0))
    elif agg_name == "dev":
        mean = total / cnt.clamp(min=1)
        centered = torch.where(valid, filled - mean[plan.group_ids], 0.0)
        m2 = plan.sum(centered * centered)
        # population variance (divisor n), see aggregators.agg_dev
        var = m2 / cnt.clamp(min=1)
        out = torch.where(cnt == 1, 0.0, torch.sqrt(var.clamp(min=0.0)))
    elif agg_name in ("first", "last", "diff"):
        # row positions as float64 (exact): the first and last present
        # row of each group and bucket
        s = filled.shape[0]
        pos = torch.arange(s, device=filled.device,
                           dtype=torch.float64)[:, None]
        first_pos = plan.min(torch.where(valid, pos, torch.inf))
        last_pos = plan.max(torch.where(valid, pos, -torch.inf))
        first_val = torch.gather(filled, 0,
                                 first_pos.clamp(0, s - 1).long())
        last_val = torch.gather(filled, 0, last_pos.clamp(0, s - 1).long())
        if agg_name == "first":
            out = first_val
        elif agg_name == "last":
            out = last_val
        else:  # diff: exactly one value -> 0 (ref: Aggregators.Diff)
            out = torch.where(cnt == 1, 0.0, last_val - first_val)
    else:
        agg = aggs_mod.get(agg_name)
        if agg_name == "median":
            q, est = 50.0, "median"
        elif agg.is_percentile:
            q, est = agg.percentile, agg.estimation
        else:
            raise ValueError(f"unsupported group aggregator {agg_name}")
        out = _group_rank(filled, cnt, plan, q, est)
    return torch.where(any_valid, out, nan)


def _group_rank(filled, cnt, plan: GroupPlan, q: float, est: str):
    """Order statistics per (group, bucket): each column sorted by
    (group, value), NaN last within a group, by a stable sort by value
    and then a stable sort by group (the reference's two-key
    ``lax.sort``), and ranks picked at the plan's group starts."""
    s = filled.shape[0]
    by_value = torch.sort(filled, dim=0, stable=True).indices
    by_group = torch.sort(plan.group_ids[by_value], dim=0,
                          stable=True).indices
    sorted_vals = torch.gather(filled, 0, by_value.gather(0, by_group))
    n = cnt  # [G, B] valid counts
    p = q / 100.0
    if est == "median":
        h = torch.floor(n / 2) + 1
    elif est == "legacy":
        h = torch.minimum((p * (n + 1)).clamp(min=1.0), n.clamp(min=1.0))
    elif est == "r3":
        h = torch.floor(torch.minimum(torch.ceil(p * n - 0.5).clamp(min=1.0),
                                      n.clamp(min=1.0)))
    elif est == "r7":
        h = torch.minimum(((n - 1) * p + 1).clamp(min=1.0),
                          n.clamp(min=1.0))
    else:
        raise ValueError(f"unknown estimation {est!r}")
    h_floor = torch.floor(h)
    frac = (h - h_floor) if est in ("legacy", "r7") \
        else torch.zeros_like(h)
    lo_off = (h_floor.long() - 1).clamp(min=0)
    max_off = (n.long() - 1).clamp(min=0)
    hi_off = torch.minimum(lo_off + 1, max_off)
    starts = plan.group_starts[:, None]
    lo_row = (starts + torch.minimum(lo_off, max_off)).clamp(0, s - 1)
    hi_row = (starts + hi_off).clamp(0, s - 1)
    lo = torch.gather(sorted_vals, 0, lo_row)
    hi = torch.gather(sorted_vals, 0, hi_row)
    return lo + frac * (hi - lo)


def group_aggregate(grid, bucket_ts, group_ids, num_groups: int,
                    agg: aggs_mod.Aggregator, interpolate: bool = True,
                    plan: GroupPlan | None = None):
    """The reference's SpanGroup.iterator + AggregationIterator pass:
    interpolation fill per the aggregator's mode, then one segmented
    reduction over the series axis. grid[S,B] -> [G,B]. ``plan`` is the
    :class:`GroupPlan` of ``group_ids``, built here when not given.

    ``interpolate=False`` for NAN/NULL downsample fill policies: the
    reference emits explicit NaN points there, so the merge loop skips
    the NaN value instead of interpolating across a gap."""
    filled = (fill_gaps(grid, bucket_ts, agg.interpolation.value)
              if interpolate else grid)
    return _group_reduce(filled, group_ids, num_groups, agg.name, plan)
