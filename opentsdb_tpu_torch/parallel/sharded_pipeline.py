"""Multi-device query pipeline over a ('series', 'time') mesh (port of
``opentsdb_tpu/parallel/sharded_pipeline.py``).

The reference runs each step as one ``shard_map`` program; here a step
runs the shard-local work once per mesh position this process holds,
one after another, and crosses the axes with the explicit collectives
of :mod:`.collectives`:

- **series axis**: the salt axis. Each shard owns a contiguous block of
  series (``series_idx // s_loc``, so an all-gather returns them in
  natural order, which first, last and diff depend on) and bucketizes,
  fills and rates them locally. The group-by crosses the axis with
  ``psum``/``pmin``/``pmax`` of per-shard partials (replacing the merge
  of 20 scanner callbacks, SaltScanner.java:463-536). Percentiles and
  median sum per-shard bucketed histograms; first and last gather only
  per-shard candidates; diff and multiply all-gather the filled grid.
- **time axis**: long ranges split into bucket blocks. Rate and LERP
  interpolation need the nearest present value across block edges:
  these carries move by an exclusive log-step ``ppermute`` scan
  (Hillis-Steele) over the axis.

The shard-local pipeline reuses the port's single-device functions
(``ops.downsample.bucketize``, ``ops.pipeline.apply_fill_policy``, and
``ops.blocked``'s boundary helpers with their carries), and the
per-shard group reductions are the fixed-order ``GroupPlan`` ones, so
every answer is reproducible bit for bit. As in the reference, the
fused kernels K1 and K2 do not run inside a shard: the mesh path
launches neither.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import groupby as gb_mod
from opentsdb_tpu_torch.ops.blocked import (_block_boundaries, _block_slices,
                                            _empty_carry,
                                            _fill_with_boundaries,
                                            _merge_carry,
                                            _rate_with_boundary,
                                            pick_block_buckets)
from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec,
                                             apply_fill_policy,
                                             device_bucket_ts)
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.parallel import collectives as coll
from opentsdb_tpu_torch.parallel.distributed import put_global, to_host
from opentsdb_tpu_torch.parallel.mesh import Mesh, ShardedArray

# aggregators whose group reduction crosses the series axis with
# psum/pmin/pmax partials and so keep per-device memory at
# [S_loc, B_loc]
REDUCIBLE_AGGS = frozenset((
    "sum", "zimsum", "pfsum", "avg", "count", "min", "max", "mimmin",
    "mimmax", "squareSum", "dev"))

# [G, B, BINS] histogram cell cap for the distributed percentile path;
# beyond it the reduction all-gathers the series axis instead (with
# that many groups each group holds few series)
PERCENTILE_HIST_MAX_CELLS = 1 << 25

# histogram bins of the distributed percentile estimate; the
# estimator's error is at most (per-cell value range) / BINS
PERCENTILE_BINS = 512

# per-DEVICE cell budget of the sharded blocked scan
DEFAULT_CELL_BUDGET_PER_DEVICE = 1 << 26

_COUNT_LOCK = threading.Lock()


def _hist_eligible(num_groups: int, num_buckets: int) -> bool:
    return (num_groups * num_buckets * PERCENTILE_BINS
            <= PERCENTILE_HIST_MAX_CELLS)


def agg_mesh_class(agg_name: str) -> str:
    """Memory class of an aggregator's cross-shard reduction:
    'safe': per-device O(S_loc x B) (psum partials / edge candidates);
    'pct': histogram psum, safe while the [G, B, BINS] partial fits
    (:func:`_hist_eligible`, decided by each query's shape);
    'gather': all-gathers the series axis (diff/multiply)."""
    if agg_name in REDUCIBLE_AGGS or agg_name in ("first", "last"):
        return "safe"
    if agg_name == "median" or \
            aggs_mod.get(agg_name).percentile is not None:
        return "pct"
    return "gather"


def mesh_memory_safe(agg_name: str, num_groups: int | None = None,
                     num_buckets: int | None = None) -> bool:
    """True when the mesh reduction keeps per-device memory at
    O(S_loc x B): the engine's cell budget scales with the mesh then.
    Percentiles qualify only while their [G, B, BINS] histogram
    partial fits :data:`PERCENTILE_HIST_MAX_CELLS`."""
    cls = agg_mesh_class(agg_name)
    if cls == "safe":
        return True
    if cls == "pct":
        if num_groups is None or num_buckets is None:
            return False  # unknown shape: be conservative
        return _hist_eligible(num_groups + 1, num_buckets)
    return False


# ---------------------------------------------------------------------------
# cross-block carries (time axis)
# ---------------------------------------------------------------------------

def _pad_bts_tail(bts: np.ndarray, target_len: int) -> np.ndarray:
    """Monotonic tail padding of bucket timestamps (extrapolating the
    last step, so carry timestamps stay ordered)."""
    bts = np.asarray(bts)
    need = target_len - len(bts)
    if need <= 0:
        return bts
    step = int(bts[-1] - bts[-2]) if len(bts) > 1 else 1000
    extra = bts[-1] + step * np.arange(1, need + 1, dtype=bts.dtype)
    return np.concatenate([bts, extra])


def _scan_boundary(val: list, ts: list, present: list, n_shards: int,
                   reverse: bool, group=None):
    """Exclusive 'nearest-present' scan across the time axis.

    ``val``/``ts``/``present`` hold this process's time shards' boundary
    candidates of one series row, in shard order (the last present cell
    per series for a forward scan, the first for a reverse one). Each
    shard receives the nearest present candidate among the shards
    strictly before (after, if ``reverse``) it: log2(n) ``ppermute``
    rounds (Hillis-Steele), then one more shift by 1."""
    if n_shards == 1:
        return ([torch.zeros_like(v) for v in val],
                [torch.zeros_like(t) for t in ts],
                [torch.zeros_like(p) for p in present])

    def shift(x, d):
        if reverse:
            perm = [(i, i - d) for i in range(d, n_shards)]
        else:
            perm = [(i, i + d) for i in range(n_shards - d)]
        return coll.ppermute(x, perm, group)

    v, t, p = list(val), list(ts), list(present)
    d = 1
    while d < n_shards:
        vin, tin, pin = shift(v, d), shift(t, d), shift(p, d)
        # keep own (nearer) when present, else take incoming (farther)
        v = [torch.where(pk, vk, vi) for vk, vi, pk in zip(v, vin, p)]
        t = [torch.where(pk, tk, ti) for tk, ti, pk in zip(t, tin, p)]
        p = [pk | pi for pk, pi in zip(p, pin)]
        d *= 2
    # shift by one to make the scan exclusive
    return shift(v, 1), shift(t, 1), shift(p, 1)


def _combine_carry(scan_v, scan_t, scan_p, host_v, host_t, host_p):
    """Nearest-present: the in-block scan where it found one, else the
    host-chained carry of earlier (later) blocks."""
    return _merge_carry((scan_v, scan_t, scan_p), (host_v, host_t, host_p))


def _unzip(triples) -> tuple[list, list, list]:
    """[(v, t, p), ...] -> ([v, ...], [t, ...], [p, ...])."""
    return tuple(list(x) for x in zip(*triples))


def _last_across_time(v: list, t: list, p: list, n_time_shards: int,
                      group=None) -> list:
    """The block-global LAST present candidate per series of one row:
    each time shard contributes its local last; the highest present
    shard wins. Returns the candidate for each local shard."""
    return _edge_across_time(v, t, p, n_time_shards, group, last=True)


def _first_across_time(v: list, t: list, p: list, n_time_shards: int,
                       group=None) -> list:
    return _edge_across_time(v, t, p, n_time_shards, group, last=False)


def _edge_across_time(v, t, p, n_time_shards, group, last: bool) -> list:
    if n_time_shards == 1:
        return [(v[0], t[0], p[0])]
    vs, ts, ps = (coll.all_gather(x, group=group)[0] for x in (v, t, p))
    order = range(n_time_shards - 1, -1, -1) if last \
        else range(n_time_shards)
    out = None
    for k in order:
        cand = (vs[k], ts[k], ps[k])
        out = cand if out is None else _merge_carry(out, cand)
    return [tuple(x.to(vk.device) for x in out) for vk in v]


# ---------------------------------------------------------------------------
# cross-shard group reduction (series axis)
# ---------------------------------------------------------------------------

def _group_reduce_psum(filled: list, plans: list, num_groups: int,
                       agg_name: str) -> list:
    """Partial group reduction per series shard (its ``GroupPlan``) and
    a collective combine. ``filled`` and ``plans`` hold one time
    column's shards in series order; returns the combined [G, B] on
    each shard's device."""
    valid = [~torch.isnan(f) for f in filled]
    x0 = [torch.where(v, f, 0.0) for v, f in zip(valid, filled)]

    def seg(xs):
        return [pl.sum(x) for pl, x in zip(plans, xs)]

    nan = float("nan")
    cnt = coll.psum(seg([v.to(f.dtype) for v, f in zip(valid, filled)]))
    if agg_name in ("sum", "zimsum", "pfsum"):
        out = coll.psum(seg(x0))
    elif agg_name == "avg":
        out = [s / c.clamp(min=1)
               for s, c in zip(coll.psum(seg(x0)), cnt)]
    elif agg_name == "count":
        out = cnt
    elif agg_name in ("min", "mimmin"):
        part = [pl.min(torch.where(v, f, torch.inf))
                for pl, v, f in zip(plans, valid, filled)]
        out = [torch.where(torch.isinf(o) & (o > 0), nan, o)
               for o in coll.pmin(part)]
    elif agg_name in ("max", "mimmax"):
        part = [pl.max(torch.where(v, f, -torch.inf))
                for pl, v, f in zip(plans, valid, filled)]
        out = [torch.where(torch.isinf(o) & (o < 0), nan, o)
               for o in coll.pmax(part)]
    elif agg_name == "squareSum":
        out = coll.psum(seg([x * x for x in x0]))
    elif agg_name == "dev":
        # two-pass mean-shifted variance, as the single-device group
        # stage: the global mean first, then the centered squares (the
        # one-pass E[x^2]-E[x]^2 form cancels when mean >> std)
        s1 = coll.psum(seg(x0))
        mean = [s / c.clamp(min=1) for s, c in zip(s1, cnt)]
        centered = [torch.where(v, f - m[pl.group_ids], 0.0)
                    for v, f, m, pl in zip(valid, filled, mean, plans)]
        m2 = coll.psum(seg([c * c for c in centered]))
        # population variance (divisor n), as aggregators.agg_dev
        out = [torch.where(c == 1, 0.0,
                           torch.sqrt((m / c.clamp(min=1)).clamp(min=0.0)))
               for m, c in zip(m2, cnt)]
    else:
        raise ValueError(f"{agg_name} is not psum-reducible")
    return [torch.where(c > 0, o, nan) for o, c in zip(out, cnt)]


def _order_stat_from_hist(counts, cum, lo, width, k):
    """Estimate the k-th (1-based, [G, B]) order statistic from a
    per-cell histogram by grouped-data interpolation: the position
    within the rank-crossing bin is (k - cum_before - 0.5) / bin
    count."""
    bins = counts.shape[-1]
    kk = k.clamp(min=1.0)
    # the first bin whose running count reaches kk (argmax of cum >= kk:
    # bin 0 where none does)
    idx = torch.searchsorted(cum, kk[..., None].contiguous())
    idx = torch.where(idx >= bins, 0, idx)
    cnt_in = torch.gather(counts, -1, idx)[..., 0]
    cum_at = torch.gather(cum, -1, idx)[..., 0]
    cum_before = cum_at - cnt_in
    within = ((kk - cum_before - 0.5) / cnt_in.clamp(min=1.0)) \
        .clamp(0.0, 1.0)
    pos = (idx[..., 0].to(lo.dtype) + within) / bins
    return lo + pos * width


def _group_percentile_hist(filled: list, plans: list, num_groups: int,
                           q: float, estimation: str) -> list:
    """Distributed percentile without gathering the series axis:
    per-shard bucketed histograms summed across shards, the translation
    of the reference's mergeable SimpleHistogram.percentile
    (SimpleHistogram.java:133). Per-device memory stays
    O(S_loc x B + G x B x BINS).

    Bin edges are linear between the group's global min and max per
    (g, b) cell. The rank ``h`` follows the exact path's commons-math3
    convention and the two adjacent order statistics are estimated by
    grouped-data interpolation inside their rank-crossing bins, so the
    estimator's error is at most the cell's value range / BINS. The
    counts are integers (``bincount``, summed in int64), so the
    estimate is the same bits on every run."""
    valid = [~torch.isnan(f) for f in filled]
    lo = coll.pmin([pl.min(torch.where(v, f, torch.inf))
                    for pl, v, f in zip(plans, valid, filled)])
    hi = coll.pmax([pl.max(torch.where(v, f, -torch.inf))
                    for pl, v, f in zip(plans, valid, filled)])
    nbins = PERCENTILE_BINS
    parts = []
    for f, v, pl, lo_k, hi_k in zip(filled, valid, plans, lo, hi):
        b = f.shape[1]
        width = (hi_k - lo_k).clamp(min=1e-30)
        frac = (f - lo_k[pl.group_ids]) / width[pl.group_ids]
        bins = torch.where(v, frac * nbins, 0.0).to(torch.int64) \
            .clamp(0, nbins - 1)
        col = torch.arange(b, device=f.device)[None, :]
        cells = num_groups * b * nbins
        flat = (pl.group_ids[:, None] * b + col) * nbins + bins
        # a missing cell counts in one slot past the end, cut off
        flat = torch.where(v, flat, cells)
        parts.append(torch.bincount(flat.reshape(-1),
                                    minlength=cells + 1)[:cells])
    counts_i = coll.psum(parts)[0].view(num_groups, -1, nbins)
    lo0, hi0 = lo[0], hi[0]
    dtype = lo0.dtype
    width = (hi0 - lo0).clamp(min=1e-30)
    counts = counts_i.to(dtype)
    n = counts_i.sum(-1).to(dtype)                         # [G, B]
    # rank h per the exact path's estimation convention
    p = q / 100.0
    if estimation == "legacy":
        h = p * (n + 1)
    elif estimation == "r3":
        h = torch.ceil(p * n - 0.5)
    elif estimation == "upper-median":
        # Aggregators.Median :397: sorted[n // 2], no interpolation
        h = torch.floor(n / 2) + 1
    else:  # r7
        h = (n - 1) * p + 1
    h = torch.minimum(h.clamp(min=1.0), n.clamp(min=1.0))
    h_floor = torch.floor(h)
    hfrac = h - h_floor
    cum = torch.cumsum(counts_i, -1).to(dtype)    # integer running count
    est_lo = _order_stat_from_hist(counts, cum, lo0, width, h_floor)
    est_hi = _order_stat_from_hist(counts, cum, lo0, width,
                                   torch.minimum(h_floor + 1, n))
    est = est_lo + hfrac * (est_hi - est_lo)
    # exact degenerate case: zero range
    est = torch.where(width <= 1e-30, lo0, est)
    out = torch.where(n > 0, est, float("nan"))
    return [out.to(f.device) for f in filled]


def _group_edge_pick(filled: list, plans: list, num_groups: int,
                     pick: str, s_loc: int) -> list:
    """Distributed first/last: the value of the globally lowest
    (highest) present series index per (g, b). Each shard reduces to
    [G, B] candidates; the cross-shard combine gathers only those."""
    nan = float("nan")
    idx_parts, val_parts = [], []
    for shard, (f, pl) in enumerate(zip(filled, plans)):
        valid = ~torch.isnan(f)
        # the global series index, exact in float32 below 2^24 series
        gidx = (shard * s_loc + torch.arange(s_loc, device=f.device)) \
            [:, None].to(f.dtype).expand_as(f)
        if pick == "first":
            cand_idx = pl.min(torch.where(valid, gidx, torch.inf))
        else:
            cand_idx = pl.max(torch.where(valid, gidx, -torch.inf))
        # the value at the candidate index (a group's one match)
        match = (gidx == cand_idx[pl.group_ids]) & valid
        idx_parts.append(cand_idx)
        val_parts.append(pl.sum(torch.where(match, f, 0.0)))
    idx_all = coll.all_gather(idx_parts)[0]             # [Ds, G, B]
    val_all = coll.all_gather(val_parts)[0]
    sel = (idx_all.argmin(dim=0) if pick == "first"
           else idx_all.argmax(dim=0))[None]
    best = torch.gather(idx_all, 0, sel)[0]
    out = torch.where(torch.isinf(best), nan,
                      torch.gather(val_all, 0, sel)[0])
    return [out.to(f.device) for f in filled]


def _group_reduce_distributed(filled: list, plans: list, num_groups: int,
                              agg_name: str, s_loc: int | None = None
                              ) -> list:
    """Cross-shard group reduction for the aggregators outside
    :data:`REDUCIBLE_AGGS`, keeping per-device memory sublinear in the
    global series count wherever the math allows:

    - percentiles (p*/ep*) and median: bucketed-histogram sums (the
      estimator of :func:`_group_percentile_hist`);
    - first/last: per-shard edge candidates and a [Ds, G, B] gather;
    - diff/multiply (rare): an all-gather of the series axis, reduced
      by the single-device group stage."""
    agg = aggs_mod.get(agg_name)
    if (agg.percentile is not None or agg_name == "median") and \
            _hist_eligible(num_groups, filled[0].shape[-1]):
        q = agg.percentile if agg.percentile is not None else 50.0
        est = ("upper-median" if agg_name == "median"
               else agg.estimation or "r7")
        return _group_percentile_hist(filled, plans, num_groups, q, est)
    if agg_name in ("first", "last") and s_loc is not None:
        return _group_edge_pick(filled, plans, num_groups, agg_name, s_loc)
    full = coll.all_gather(filled, tiled=True)[0]
    gids_full = coll.all_gather([pl.group_ids for pl in plans],
                                tiled=True)[0]
    out = gb_mod._group_reduce(full, gids_full, num_groups, agg_name)
    return [out.to(f.device) for f in filled]


# ---------------------------------------------------------------------------
# the steps: shard-local work per mesh position, collectives between
# ---------------------------------------------------------------------------

def _local(mesh: Mesh, fn) -> list:
    """``[[fn(i, j) for each local time column j] for each series row
    i]``: the nested per-position layout every step works in."""
    return [[fn(i, j) for j in mesh.local_time]
            for i in range(mesh.shape["series"])]


def _plans(mesh: Mesh, group_ids: ShardedArray, num_groups: int) -> list:
    """One ``GroupPlan`` per position, built once per group-id block
    and device."""
    memo: dict = {}

    def plan(i, j):
        gids = group_ids[i, j]
        if id(gids) not in memo:
            memo[id(gids)] = gb_mod.GroupPlan(gids, num_groups)
        return memo[id(gids)]
    return _local(mesh, plan)


def _bucketize_local(mesh: Mesh, spec: PipelineSpec, values, series_idx,
                     bucket_idx, s_loc: int, b_loc: int):
    """Step 1: each position's points into its [S_loc, B_loc] grid, then
    the fill policy. The padding (the dummy bucket B_loc, after a
    cell's points) is cut off first: it would all fall in one segment,
    which a segmented reduction walks in one thread."""
    def cell(i, j):
        bidx = bucket_idx[i, j].reshape(-1)
        n = int(torch.count_nonzero(bidx < b_loc))
        return ds_mod.bucketize(values[i, j].reshape(-1)[:n],
                                series_idx[i, j].reshape(-1)[:n],
                                bidx[:n], s_loc, b_loc, spec.ds_function)

    grid, has = [], []
    for row in _local(mesh, cell):
        pairs = [apply_fill_policy(g, cnt > 0, spec) for g, cnt in row]
        grid.append([g for g, _ in pairs])
        has.append([h for _, h in pairs])
    return grid, has


def _host_carry(mesh: Mesh, carry) -> list | None:
    """A host-chained carry (three [S_pad] ShardedArrays cut over the
    series axis) as one (v, t, p) per position, or None."""
    if carry is None:
        return None
    return _local(mesh, lambda i, j: tuple(c[i, j] for c in carry))


def _rate_rows(mesh: Mesh, spec: PipelineSpec, ro: RateOptions, grid,
               has, bts, host=None) -> None:
    """Step 2, in place: per series row, the rate with the carry
    across time shards, under ``host`` (the carry of earlier blocks)
    where the row's own scan found none."""
    group = mesh.time_group
    for i, row in enumerate(grid):
        lasts = [_block_boundaries(g, t)[0] for g, t in zip(row, bts[i])]
        cv, ct, cp = _scan_boundary(*_unzip(lasts), mesh.shape["time"],
                                    reverse=False, group=group)
        for jj, g in enumerate(row):
            carry = (cv[jj], ct[jj], cp[jj])
            if host is not None:
                carry = _combine_carry(*carry, *host[i][jj])
            row[jj] = _rate_with_boundary(g, bts[i][jj], spec, ro, carry)
            has[i][jj] = has[i][jj] & ~torch.isnan(row[jj])


def _fill_rows(mesh: Mesh, mode: str, grid, bts, bounds, prev_host=None,
               next_host=None) -> list:
    """Step 3: interpolation fill with carries both ways; ``bounds``
    holds each position's ``_block_boundaries``."""
    group, n_time = mesh.time_group, mesh.shape["time"]
    out = []
    for i, row in enumerate(grid):
        pv, pt, pp = _scan_boundary(*_unzip([b[0] for b in bounds[i]]),
                                    n_time, reverse=False, group=group)
        nv, nt, npp = _scan_boundary(*_unzip([b[1] for b in bounds[i]]),
                                     n_time, reverse=True, group=group)
        filled = []
        for jj, g in enumerate(row):
            prev = (pv[jj], pt[jj], pp[jj])
            nxt = (nv[jj], nt[jj], npp[jj])
            if prev_host is not None:
                prev = _combine_carry(*prev, *prev_host[i][jj])
                nxt = _combine_carry(*nxt, *next_host[i][jj])
            filled.append(_fill_with_boundaries(g, bts[i][jj], mode, prev,
                                                nxt))
        out.append(filled)
    return out


def _reduce_columns(mesh: Mesh, spec: PipelineSpec, filled, has, plans,
                    s_loc: int, b_loc: int):
    """Step 4: per time column, the group aggregation across the series
    axis, and the emit mask: a psum of an integer segment sum over the
    series axis (fill NONE), else every bucket. Returns (result, emit),
    ``[G + 1, B_pad]`` arrays cut over the time axis."""
    g_padded = spec.num_groups + 1  # a trailing dummy group pads
    n_series = mesh.shape["series"]
    results, emits = {}, {}
    for jj, j in enumerate(mesh.local_time):
        col = [filled[i][jj] for i in range(n_series)]
        pl = [plans[i][jj] for i in range(n_series)]
        if spec.agg_name in REDUCIBLE_AGGS:
            res = _group_reduce_psum(col, pl, g_padded, spec.agg_name)
        else:
            res = _group_reduce_distributed(col, pl, g_padded,
                                            spec.agg_name, s_loc=s_loc)
        if spec.fill_policy == ds_mod.FillPolicy.NONE:
            seg = [p.sum(has[i][jj].to(torch.float64)).to(torch.int64)
                   for i, p in enumerate(pl)]
            emit = [e > 0 for e in coll.psum(seg)]
        else:
            emit = [torch.ones((g_padded, b_loc), dtype=torch.bool,
                               device=c.device) for c in col]
        for i in range(n_series):
            results[(i, j)] = res[i]
            emits[(i, j)] = emit[i]
    shape = (g_padded, b_loc * mesh.shape["time"])
    return (ShardedArray(mesh, (None, "time"), shape, results),
            ShardedArray(mesh, (None, "time"), shape, emits))


def _per_series_out(mesh: Mesh, grid, has, s_loc: int, b_loc: int):
    """``emit_raw``: the per-series grids, cut over both axes."""
    shape = (s_loc * mesh.shape["series"], b_loc * mesh.shape["time"])
    pos = {(i, j): (i, jj) for i in range(mesh.shape["series"])
           for jj, j in enumerate(mesh.local_time)}
    return tuple(ShardedArray(mesh, ("series", "time"), shape,
                              {p: x[i][jj] for p, (i, jj) in pos.items()})
                 for x in (grid, has))


def _sharded_tail(mesh: Mesh, spec: PipelineSpec, grid, has, bts, plans,
                  ro: RateOptions, s_loc: int, b_loc: int):
    """Steps 2-4 of a sharded step over the local grids."""
    if spec.rate:
        _rate_rows(mesh, spec, ro, grid, has, bts)
    if spec.emit_raw:
        return _per_series_out(mesh, grid, has, s_loc, b_loc)
    # only fill NONE leaves true gaps that interpolate at merge;
    # NAN/NULL emit explicit NaN points the merge skips, and
    # ZERO/SCALAR were substituted in step 1
    if spec.fill_policy == ds_mod.FillPolicy.NONE:
        mode = aggs_mod.get(spec.agg_name).interpolation.value
        bounds = [[_block_boundaries(g, t) for g, t in zip(row, bts[i])]
                  for i, row in enumerate(grid)]
        filled = _fill_rows(mesh, mode, grid, bts, bounds)
    else:
        filled = grid
    return _reduce_columns(mesh, spec, filled, has, plans, s_loc, b_loc)


@dataclass(frozen=True)
class ShardedBatch:
    """Host-prepared, device-ready inputs for the sharded pipeline.

    Shapes (Ds = series shards, Dt = time shards):

    - values/series_idx/bucket_idx: [Ds, Dt, Npad], per-cell point lists
      in (series, bucket) order, padded with bucket_idx == B_loc (a
      dummy bucket) at the last local series, so the segment ids stay
      sorted;
    - bucket_ts: [B_pad] (split over 'time');
    - group_ids: [Ds * S_loc] (split over 'series'), dummy group == G.
    """
    values: np.ndarray
    series_idx: np.ndarray
    bucket_idx: np.ndarray
    bucket_ts: np.ndarray
    group_ids: np.ndarray
    s_loc: int
    b_loc: int
    num_groups: int  # real groups (dummy excluded)


def build_sharded_step(mesh: Mesh, spec: PipelineSpec, s_loc: int,
                       b_loc: int):
    """The multi-device query step for ``mesh`` and these shapes: a
    fn(values, series_idx, bucket_idx, bucket_ts, group_ids,
    rate_options) of :func:`sharded_device_args`' arrays ->
    (result [G+1, B_pad], emit [G+1, B_pad]) cut over 'time', or, for
    ``emit_raw``, the per-series [S_pad, B_pad] grid and mask."""
    def step(values, series_idx, bucket_idx, bucket_ts, group_ids,
             rate_options=None):
        ro = rate_options or RateOptions()
        grid, has = _bucketize_local(mesh, spec, values, series_idx,
                                     bucket_idx, s_loc, b_loc)
        bts = _local(mesh, lambda i, j: bucket_ts[i, j])
        plans = None if spec.emit_raw else \
            _plans(mesh, group_ids, spec.num_groups + 1)
        return _sharded_tail(mesh, spec, grid, has, bts, plans, ro, s_loc,
                             b_loc)
    return step


# ---------------------------------------------------------------------------
# host-side sharding prep
# ---------------------------------------------------------------------------

def prepare_sharded_batch(values: np.ndarray, series_idx: np.ndarray,
                          bucket_idx: np.ndarray, bucket_ts: np.ndarray,
                          group_ids: np.ndarray, num_series: int,
                          num_groups: int, n_series_shards: int,
                          n_time_shards: int) -> ShardedBatch:
    """Partition a flat point batch onto the mesh.

    Series land on series shards in contiguous *blocks* (shard =
    series_idx // s_loc): after an all-gather over the series axis the
    rows come back in natural series order, which the order-sensitive
    aggregators (first/last/diff pick the lowest/highest series index,
    matching the reference's span order) depend on. Buckets split into
    contiguous time blocks. Point lists are padded per (Ds, Dt) cell to
    the largest cell's population. The points are taken in (series,
    bucket) order, as the store materializes them (a batch in another
    order is sorted first): a series shard is then one run of the
    batch, found by a binary search, and a time shard's points are taken
    out of it by a mask, which keeps that order inside each cell."""
    s_loc = -(-num_series // n_series_shards)
    b = len(bucket_ts)
    b_loc = -(-b // n_time_shards)
    b_pad = b_loc * n_time_shards
    ds, dt = n_series_shards, n_time_shards

    # pad bucket_ts monotonically so carry timestamps stay ordered
    bucket_ts = _pad_bts_tail(np.asarray(bucket_ts, dtype=np.int64), b_pad)

    values = np.asarray(values)
    series_idx = np.asarray(series_idx)
    bucket_idx = np.asarray(bucket_idx)
    step = np.diff(series_idx)
    if (step < 0).any() or ((step == 0) & (np.diff(bucket_idx) < 0)).any():
        first = np.argsort(series_idx.astype(np.int64) * b + bucket_idx,
                           kind="stable")
        values, series_idx, bucket_idx = (
            values[first], series_idx[first], bucket_idx[first])
    del step
    cut = np.searchsorted(series_idx, np.arange(ds + 1) * s_loc)
    cells = []     # [(i, j, values, local series, local bucket)]
    for i in range(ds):
        sv, ss, sb = (x[cut[i]:cut[i + 1]]
                      for x in (values, series_idx, bucket_idx))
        if dt == 1:
            cells.append((i, 0, sv, ss, sb))
            continue
        shard = sb // b_loc
        for j in range(dt):
            m = shard == j
            cells.append((i, j, sv[m], ss[m], sb[m] - j * b_loc))
    npad = max([len(c[2]) for c in cells] + [1])
    pvals = np.zeros((ds, dt, npad), dtype=values.dtype)
    # padding: the dummy bucket at the last local series, so the
    # segment ids stay sorted
    psidx = np.full((ds, dt, npad), s_loc - 1, dtype=np.int32)
    pbidx = np.full((ds, dt, npad), b_loc, dtype=np.int32)
    for i, j, sv, ss, sb in cells:
        c = len(sv)
        pvals[i, j, :c] = sv
        np.subtract(ss, i * s_loc, out=psidx[i, j, :c], casting="unsafe")
        pbidx[i, j, :c] = sb
    del cells

    # group ids: [Ds * S_loc]; the block layout keeps natural series
    # order (row shard*s_loc+loc == global sid); padding -> dummy group G
    gids = np.full(ds * s_loc, num_groups, dtype=np.int32)
    gids[:num_series] = group_ids
    return ShardedBatch(pvals, psidx, pbidx, bucket_ts, gids, s_loc, b_loc,
                        num_groups)


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def sharded_device_args(mesh: Mesh, batch: ShardedBatch, dtype):
    """Upload a :class:`ShardedBatch` cut over the mesh, so a repeat
    query can reuse the device-resident copies (the mesh twin of the
    single-device prepared-batch cache)."""
    s3 = ("series", "time", None)
    return (put_global(np.asarray(batch.values, _np_dtype(dtype)), mesh, s3),
            put_global(batch.series_idx, mesh, s3),
            put_global(batch.bucket_idx, mesh, s3),
            put_global(device_bucket_ts(batch.bucket_ts), mesh, ("time",)),
            put_global(batch.group_ids, mesh, ("series",)))


def _count(fn, **deltas) -> None:
    with _COUNT_LOCK:
        for name, d in deltas.items():
            setattr(fn, name, getattr(fn, name) + d)


def run_sharded_device(mesh: Mesh, spec: PipelineSpec, device_args,
                       s_loc: int, b_loc: int, num_groups: int,
                       rate_options=None):
    """Execute the sharded step over uploaded arrays -> host (result
    [G, B], emit [G, B]) trimmed of padding (``[S, B]`` rows for
    ``emit_raw``, ``num_groups`` being S there)."""
    step = build_sharded_step(mesh, spec, s_loc, b_loc)
    result, emit = step(*device_args, rate_options)
    result, emit = to_host(result), to_host(emit)
    _count(run_sharded_device, runs=1)
    b = spec.num_buckets
    return result[:num_groups, :b], emit[:num_groups, :b]


def run_sharded(mesh: Mesh, spec: PipelineSpec, batch: ShardedBatch,
                rate_options=None, *, dtype: torch.dtype):
    """Upload and execute the sharded step; returns host (result [G, B],
    emit [G, B]) trimmed of padding."""
    args = sharded_device_args(mesh, batch, dtype)
    return run_sharded_device(mesh, spec, args, batch.s_loc, batch.b_loc,
                              batch.num_groups, rate_options)


# sharded point-step runs since the last reset
run_sharded_device.runs = 0


# ---------------------------------------------------------------------------
# grid-tail step: storage-side bucketized [S, B] grids on the mesh
# (fill -> rate -> interpolate -> reduce; no bucketize)
# ---------------------------------------------------------------------------

def build_sharded_grid_step(mesh: Mesh, spec: PipelineSpec, s_loc: int,
                            b_loc: int):
    """Steps 2-4 of :func:`build_sharded_step` over a pre-bucketized
    grid cut over ('series', 'time'): the mesh twin of
    ``ops.pipeline.execute_grid``, so the store's [S, B] reduction
    feeds the mesh without a flatten back to points."""
    def step(grid, has_data, bucket_ts, group_ids, rate_options=None):
        ro = rate_options or RateOptions()
        pairs = _local(mesh, lambda i, j: apply_fill_policy(
            grid[i, j], has_data[i, j], spec))
        g = [[p[0] for p in row] for row in pairs]
        h = [[p[1] for p in row] for row in pairs]
        bts = _local(mesh, lambda i, j: bucket_ts[i, j])
        plans = None if spec.emit_raw else \
            _plans(mesh, group_ids, spec.num_groups + 1)
        return _sharded_tail(mesh, spec, g, h, bts, plans, ro, s_loc,
                             b_loc)
    return step


def prepare_sharded_grid(mesh: Mesh, grid: np.ndarray,
                         has_data: np.ndarray, bucket_ts: np.ndarray,
                         dtype: torch.dtype):
    """Pad and upload a host [S, B] grid cut over the mesh. Returns
    (data_args, s_loc, b_loc, s_pad) for :func:`run_sharded_grid`. The
    device arrays are what the engine's grid cache holds under a mesh:
    device-resident and already cut. Group ids are not part of them:
    the same data answers queries with other group-bys
    (:func:`sharded_grid_gids`)."""
    ds_, dt_ = mesh.shape["series"], mesh.shape["time"]
    s, b = grid.shape
    s_loc = -(-s // ds_)
    b_loc = -(-b // dt_)
    s_pad, b_pad = s_loc * ds_, b_loc * dt_
    g = np.full((s_pad, b_pad), np.nan, dtype=_np_dtype(dtype))
    g[:s, :b] = grid
    h = np.zeros((s_pad, b_pad), dtype=bool)
    h[:s, :b] = has_data
    bts = _pad_bts_tail(np.asarray(bucket_ts, dtype=np.int64), b_pad)
    s2 = ("series", "time")
    args = (put_global(g, mesh, s2), put_global(h, mesh, s2),
            put_global(device_bucket_ts(bts), mesh, ("time",)))
    return args, s_loc, b_loc, s_pad


def sharded_grid_gids(mesh: Mesh, group_ids: np.ndarray, s_pad: int,
                      num_groups: int) -> ShardedArray:
    """Per-query group-id upload (a small [S_pad] vector)."""
    gids = np.full(s_pad, num_groups, dtype=np.int32)
    gids[:len(group_ids)] = group_ids
    return put_global(gids, mesh, ("series",))


def run_sharded_grid(mesh: Mesh, spec: PipelineSpec, device_args,
                     s_loc: int, b_loc: int, num_groups: int,
                     rate_options=None):
    """Execute the grid-tail step over uploaded, cut grids -> host
    (result, emit) trimmed of padding."""
    step = build_sharded_grid_step(mesh, spec, s_loc, b_loc)
    result, emit = step(*device_args, rate_options)
    result, emit = to_host(result), to_host(emit)
    _count(run_sharded_grid, runs=1)
    b = spec.num_buckets
    rows = spec.num_series if spec.emit_raw else num_groups
    return result[:rows, :b], emit[:rows, :b]


# sharded grid-step runs since the last reset
run_sharded_grid.runs = 0


# ---------------------------------------------------------------------------
# blocked (streaming) execution over the mesh: the carry-chained block
# scan as a sharded step, so over-budget long ranges keep the fan-out
# ---------------------------------------------------------------------------

def build_sharded_blocked_step(mesh: Mesh, spec: PipelineSpec, s_loc: int,
                               b_loc: int, summary_only: bool = False):
    """One time BLOCK of the streaming scan, sharded over the mesh.

    ``ops.blocked``'s per-block work (bucketize -> fill policy -> rate
    -> interpolation fill -> group reduce) with three kinds of carries:

    - inside the block, across time shards: the ``ppermute`` scans of
      :func:`_scan_boundary`, as in :func:`build_sharded_step`;
    - across blocks: host-chained (rate, prev-fill, next-fill) [S_pad]
      carries, cut over 'series', taken wherever the in-block scan
      found nothing;
    - outgoing: the block's own boundary summaries (pre-rate last,
      post-rate last, post-rate first), reduced across time shards and
      returned cut over 'series' for the host to chain.

    ``summary_only`` builds the light pass-1 variant: bucketize, rate
    and the summaries, without the fill and the group reduction.

    Returns fn(values, sidx, bidx, bts, gids, rate_options, rate_carry,
    prev_carry, next_carry) -> (result [G+1, B_pad], emit, pre_last,
    post_last, post_first), result and emit None in summary mode, each
    summary three [S_pad] arrays."""
    n_time = mesh.shape["time"]
    group = mesh.time_group
    mode = aggs_mod.get(spec.agg_name).interpolation.value

    def summary(rows) -> tuple:
        """Per-row candidates -> three [S_pad] arrays cut over 'series'."""
        shape = (s_loc * mesh.shape["series"],)
        out = ({}, {}, {})
        for i, per_col in enumerate(rows):
            for jj, j in enumerate(mesh.local_time):
                for k in range(3):
                    out[k][(i, j)] = per_col[jj][k]
        return tuple(ShardedArray(mesh, ("series",), shape, o) for o in out)

    def step(values, series_idx, bucket_idx, bucket_ts, group_ids,
             rate_options, rate_carry, prev_carry, next_carry):
        ro = rate_options or RateOptions()
        grid, has = _bucketize_local(mesh, spec, values, series_idx,
                                     bucket_idx, s_loc, b_loc)
        bts = _local(mesh, lambda i, j: bucket_ts[i, j])
        # the pre-rate block-last summary (chains the NEXT block's rate)
        pre_last = []
        for i, row in enumerate(grid):
            lasts = [_block_boundaries(g, t)[0] for g, t in zip(row, bts[i])]
            pre_last.append(_last_across_time(*_unzip(lasts), n_time,
                                              group))
        if spec.rate:
            _rate_rows(mesh, spec, ro, grid, has, bts,
                       _host_carry(mesh, rate_carry))
        # post-rate boundary summaries for the host chain
        bounds = [[_block_boundaries(g, t) for g, t in zip(row, bts[i])]
                  for i, row in enumerate(grid)]
        post_last = [_last_across_time(*_unzip([b[0] for b in row]),
                                       n_time, group) for row in bounds]
        post_first = [_first_across_time(*_unzip([b[1] for b in row]),
                                         n_time, group) for row in bounds]
        summaries = (summary(pre_last), summary(post_last),
                     summary(post_first))
        if summary_only:
            return (None, None) + summaries
        if spec.fill_policy == ds_mod.FillPolicy.NONE:
            filled = _fill_rows(mesh, mode, grid, bts, bounds,
                                _host_carry(mesh, prev_carry),
                                _host_carry(mesh, next_carry))
        else:
            filled = grid
        result, emit = _reduce_columns(
            mesh, spec, filled, has,
            _plans(mesh, group_ids, spec.num_groups + 1), s_loc, b_loc)
        return (result, emit) + summaries
    return step


def execute_blocked_sharded(mesh: Mesh, batch_values: np.ndarray,
                            series_idx: np.ndarray,
                            bucket_idx: np.ndarray,
                            bucket_ts: np.ndarray,
                            group_ids: np.ndarray, spec: PipelineSpec,
                            rate_options=None, *, dtype: torch.dtype,
                            block_buckets: int | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """The streaming twin of ``ops.blocked.execute_blocked`` running
    every block over the mesh: per-DEVICE memory is O(S_loc x block),
    so the budget scales with the fan-out (ref: the 20 SaltScanners
    stream concurrently, SaltScanner.java:463-536).

    The same two-pass structure as ``execute_blocked``: interpolating
    aggregators need each block's NEXT-present carry over ALL later
    blocks, so a light summary pass (bucketize, rate, boundaries; no
    fill or reduce) sweeps forward first and a backward host scan
    chains the next-carries; the others skip pass 1."""
    if spec.emit_raw:
        raise ValueError("blocked execution aggregates; emit_raw "
                         "queries stream per-series instead")
    np_dtype = _np_dtype(dtype)
    ro = rate_options or RateOptions()
    s, b, g = spec.num_series, spec.num_buckets, spec.num_groups
    ds_shards = mesh.shape["series"]
    dt_shards = mesh.shape["time"]
    s_loc = -(-s // ds_shards)
    s_pad = s_loc * ds_shards
    # per-device cells = (s_pad/Ds) x (bb/Dt): the global budget scales
    # by the whole mesh
    bb = block_buckets or pick_block_buckets(
        s_pad, b, DEFAULT_CELL_BUDGET_PER_DEVICE * ds_shards * dt_shards)
    # the block size must split evenly over the time shards
    bb = max(dt_shards, (bb // dt_shards) * dt_shards)
    slices = _block_slices(np.asarray(batch_values),
                           np.asarray(series_idx), np.asarray(bucket_idx),
                           b, bb, np_dtype)
    dev_bts = device_bucket_ts(bucket_ts)
    blocks = [(b0, min(b0 + bb, b), i)
              for i, b0 in enumerate(range(0, b, bb))]

    agg = aggs_mod.get(spec.agg_name)
    needs_next = spec.fill_policy == ds_mod.FillPolicy.NONE \
        and agg.interpolation.value in ("lerp", "max", "min")
    b_loc = bb // dt_shards
    step = build_sharded_blocked_step(mesh, spec, s_loc, b_loc)

    gids_full = np.full(s_pad, g, dtype=np.int32)
    gids_full[:s] = group_ids
    gids_dev = put_global(gids_full, mesh, ("series",))

    # per-block batches, kept for the second pass: the per-cell packing
    # runs once per block
    memo: dict[int, ShardedBatch] = {}

    def shard_block(blk) -> ShardedBatch:
        b0, b1, i = blk
        if i not in memo:
            sv, ssi, sbi = slices[i]
            memo[i] = prepare_sharded_batch(
                sv, ssi, sbi - b0, _pad_bts_tail(dev_bts[b0:b1], bb),
                gids_full, s_pad, g, ds_shards, dt_shards)
        return memo[i]

    def carry_dev(c):
        return tuple(put_global(x.numpy(), mesh, ("series",)) for x in c)

    def run(blk, which, rate_carry, prev_carry, next_carry):
        sb = shard_block(blk)
        s3 = ("series", "time", None)
        return which(
            put_global(np.asarray(sb.values, np_dtype), mesh, s3),
            put_global(sb.series_idx, mesh, s3),
            put_global(sb.bucket_idx, mesh, s3),
            put_global(sb.bucket_ts, mesh, ("time",)),
            gids_dev, ro, carry_dev(rate_carry), carry_dev(prev_carry),
            carry_dev(next_carry))

    def host_carry(x) -> tuple:
        return tuple(torch.from_numpy(to_host(a)) for a in x)

    empty = _empty_carry(s_pad, dtype, "cpu")
    n_blocks = len(blocks)
    next_carries = [empty] * n_blocks
    if needs_next and n_blocks > 1:
        # pass 1 (light): a forward sweep collecting each block's
        # first-present summary, then a backward host scan accumulating
        # the next-carry over ALL later blocks (a gap spanning whole
        # blocks must still interpolate)
        sstep = build_sharded_blocked_step(mesh, spec, s_loc, b_loc,
                                           summary_only=True)
        firsts = []
        rate_carry = empty
        for blk in blocks:
            _, _, pre_last, _, post_first = run(blk, sstep, rate_carry,
                                                empty, empty)
            firsts.append(host_carry(post_first))
            if spec.rate:
                rate_carry = _merge_carry(host_carry(pre_last), rate_carry)
        nc = empty
        for i in range(n_blocks - 1, -1, -1):
            next_carries[i] = nc
            nc = _merge_carry(firsts[i], nc)

    # pass 2: the full sweep with every carry chained
    out = np.empty((g, b), dtype=np_dtype)
    emit_out = np.empty((g, b), dtype=bool)
    rate_carry = prev_carry = empty
    for blk, nxt in zip(blocks, next_carries):
        res, emit, pre_last, post_last, _ = run(
            blk, step, rate_carry, prev_carry, nxt)
        b0, b1 = blk[0], blk[1]
        out[:, b0:b1] = to_host(res)[:g, :b1 - b0]
        emit_out[:, b0:b1] = to_host(emit)[:g, :b1 - b0]
        if spec.rate:
            rate_carry = _merge_carry(host_carry(pre_last), rate_carry)
        prev_carry = _merge_carry(host_carry(post_last), prev_carry)
    _count(execute_blocked_sharded, runs=1, blocks=n_blocks)
    return out, emit_out


# sharded blocked executions and the blocks they ran, since the last reset
execute_blocked_sharded.runs = 0
execute_blocked_sharded.blocks = 0
