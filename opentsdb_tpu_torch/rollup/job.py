"""The rollup job: batch pre-aggregation of raw data into the tiers
(ref: ``opentsdb_tpu/rollup/job.py``; BASELINE config 5). The reference
system has no compactor of its own: external jobs write rollups through
the API (``TSDB.add_aggregate_point``).

The raw window is processed in (series chunk x time window) tiles, so
the working set stays bounded whatever the range. Each tile yields all
four statistics of the finest tier (sum, count, min and max; avg is sum
over count at query time), and coarser tiers whose interval nests in
the finest reduce its grids (1h sum = sum of 1m sums, 1h min = min of
1m mins, ...) with no second pass over the raw points. A tier that does
not nest takes its own pass.

Two routes, chosen by ``tsd.rollups.job.device`` (off by default, as in
the reference):

- the storage route: the store reduces each tile to the finest tier's
  ``[S, B]`` statistics (``bucket_reduce``, ``tss_bucket_reduce`` on the
  native store) and coarser tiers coarsen on the host, so the raw
  points never leave the store;
- the device route: the tile's points are materialized row-padded and
  reduced in PyTorch on the TSDB's device (``tsd.torch.device``; the
  card, or the CPU for a TSDB built for it), regular cadence by a
  ``[S, B, k]`` view (:func:`_rollup_tile_dense`), anything else by the
  band-based padded reduction (:func:`_rollup_tile`), and coarser tiers
  by :func:`_coarsen` on the device. A failure raises: nothing carries
  on elsewhere.

Both compute in float64 whatever ``tsd.torch.dtype`` says, as the tier
stores hold float64. The dense tile adds each bucket's points in time
order, as ``tss_bucket_reduce`` does, so the two routes write the
finest tier's sums bit for bit alike; a coarsened sum adds in another
order on each route (numpy's pairwise sum on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops.pipeline import detect_regular_padded, upload
from opentsdb_tpu_torch.rollup.config import RollupConfig, RollupInterval

ROLLUP_AGGS = ("sum", "count", "min", "max")

# cells of a tile (series x raw points at up to one a second) and base
# buckets per window; the cap bounds the [S, B] grids
_TILE_CELL_BUDGET = 64_000_000
_MAX_WINDOW_BUCKETS = 360
# an irregular tile past this many [S, P, B] cells is re-tiled: narrower
# windows when the nested tiers allow, else half the series
_PADDED_TILE_MAX_CELLS = 500_000_000
_SPLIT_WINDOW_BUCKETS = 64


def _finish(sums, cnts, mins, maxs) -> torch.Tensor:
    """[4, S, B] in ROLLUP_AGGS order, NaN where a cell holds no point."""
    empty = cnts == 0
    return torch.stack([torch.where(empty, torch.nan, x)
                        for x in (sums, cnts, mins, maxs)])


def _rollup_tile_dense(values2d: torch.Tensor, num_buckets: int,
                       k: int) -> torch.Tensor:
    """A regular-cadence tile (every row full, ``k`` points a bucket)
    -> ``[4, S, B]`` (ref: ``_rollup_tile_dense``): the four statistics
    of a ``[S, B, k]`` view, NaN points skipped. Each bucket's sum adds
    its points in time order from 0.0, as ``tss_bucket_reduce`` does."""
    x = values2d.reshape(values2d.shape[0], num_buckets, k)
    valid = ~torch.isnan(x)
    x0 = torch.where(valid, x, 0.0)
    sums = torch.zeros_like(x0[..., 0])
    for j in range(k):
        sums += x0[..., j]
    cnts = valid.sum(-1).to(values2d.dtype)
    mins = torch.where(valid, x, torch.inf).amin(-1)
    maxs = torch.where(valid, x, -torch.inf).amax(-1)
    return _finish(sums, cnts, mins, maxs)


def _rollup_tile(values2d: torch.Tensor, bucket_idx2d: torch.Tensor,
                 num_buckets: int) -> torch.Tensor:
    """An irregular tile (row-padded, ``bucket_idx2d`` -1 on pads) ->
    ``[4, S, B]`` (ref: ``_rollup_tile``), each statistic by the padded
    layout's band reduction (:func:`.downsample.bucketize_padded`)."""
    return torch.stack([ds_mod.bucketize_padded(values2d, bucket_idx2d,
                                                num_buckets, agg)[0]
                        for agg in ROLLUP_AGGS])


def _coarsen(grids: torch.Tensor, off: int, factor: int,
             num_coarse: int) -> torch.Tensor:
    """``[4, S, Bf]`` -> ``[4, S, Bc]`` (ref: ``_coarsen``): coarse sum
    = sum of fine sums, count = sum of counts, min = min of mins, max =
    max of maxes. Fine bucket i lies in coarse bucket ``(off + i) //
    factor``: the fine axis is padded by ``off`` in front and to
    ``num_coarse * factor`` behind, with each statistic's identity (NaN
    cells too), and reduced as ``[S, Bc, factor]``; partial coarse
    buckets at the window's edges still materialize."""
    s, bf = grids.shape[1], grids.shape[2]
    pad = (off, num_coarse * factor - off - bf)

    def fold(x: torch.Tensor, fill: float) -> torch.Tensor:
        x = F.pad(torch.where(torch.isnan(x), fill, x), pad, value=fill)
        return x.reshape(s, num_coarse, factor)

    return _finish(fold(grids[0], 0.0).sum(-1), fold(grids[1], 0.0).sum(-1),
                   fold(grids[2], torch.inf).amin(-1),
                   fold(grids[3], -torch.inf).amax(-1))


def _chunk_tier_sids(tsdb, tiers: list[RollupInterval], chunk
                     ) -> dict[tuple[str, str], np.ndarray]:
    """Raw series id -> tier series id for every (tier, agg), once per
    series chunk (the map holds for every window). Each run of one
    metric is created in bulk, in chunk order, so ids are those a
    series-by-series creation would give."""
    recs = [tsdb.store.series(int(sid)) for sid in chunk]
    runs, lo = [], 0
    for hi in range(1, len(recs) + 1):
        if hi == len(recs) or recs[hi].metric_id != recs[lo].metric_id:
            runs.append((recs[lo].metric_id, [r.tags for r in recs[lo:hi]]))
            lo = hi
    out = {}
    for tier in tiers:
        for agg in ROLLUP_AGGS:
            store = tsdb.rollup_store.tier(tier.interval, agg)
            out[(tier.interval, agg)] = np.concatenate(
                [store.get_or_create_series_bulk(mid, tags)
                 for mid, tags in runs] or [np.empty(0, dtype=np.int64)])
    return out


def _write_outs(tsdb, rsid_map, outs, written: dict[str, int]) -> None:
    """Bring a window's grids to the host (a device route's tensors
    wait for their device work here) and write them to the tiers."""
    for tier, bucket_ts, grids, row_off in outs:
        if isinstance(grids, torch.Tensor):
            grids = grids.cpu().numpy()
        _write_grids(tsdb, tier, rsid_map, bucket_ts, grids, row_off,
                     written)


def _write_grids(tsdb, tier: RollupInterval, rsid_map, bucket_ts,
                 grids: np.ndarray, row_off: int,
                 written: dict[str, int]) -> None:
    """Write the four statistics' grids by ``append_grid``. They share
    one NaN pattern (a cell is NaN where its count is 0), so the count
    grid's mask serves all four. ``row_off`` places grid row 0 in the
    chunk (a series-split tile covers part of it)."""
    mask = ~np.isnan(grids[1])
    any_rows = mask.any(axis=1)
    if not any_rows.any():
        return
    rows = np.flatnonzero(any_rows)
    sub_mask = mask[rows]
    for ai, agg in enumerate(ROLLUP_AGGS):
        store = tsdb.rollup_store.tier(tier.interval, agg)
        rsids = rsid_map[(tier.interval, agg)][row_off + rows]
        written[tier.interval] += store.append_grid(
            rsids, np.asarray(bucket_ts), grids[ai][rows], sub_mask)


def _split_window(tsdb, chunk, row_off: int, start_ms: int, end_ms: int,
                  base: RollupInterval, nested: list[RollupInterval]) -> list:
    """Re-tile an oversized irregular window (ref: ``_split_window``):
    narrower windows aligned to the nested tiers when their lcm allows,
    else the series axis halved (each half may split again)."""
    factors = [t.interval_ms // base.interval_ms for t in nested]
    sub_buckets = _window_buckets(factors, cap=_SPLIT_WINDOW_BUCKETS)
    cur_buckets = (end_ms - start_ms) // base.interval_ms + 1
    outs = []
    if sub_buckets < cur_buckets:
        sub_ms = base.interval_ms * sub_buckets
        t0 = start_ms - (start_ms % sub_ms)
        while t0 <= end_ms:
            outs.extend(_rollup_window(
                tsdb, chunk, row_off, max(t0, start_ms),
                min(t0 + sub_ms - 1, end_ms), base, nested,
                can_split=False))
            t0 += sub_ms
        return outs
    half = len(chunk) // 2
    if half == 0:
        # one series still over the cap: reduce it as it is
        return _rollup_window(tsdb, chunk, row_off, start_ms, end_ms, base,
                              nested, can_split=False)
    outs.extend(_rollup_window(tsdb, chunk[:half], row_off, start_ms, end_ms,
                               base, nested))
    outs.extend(_rollup_window(tsdb, chunk[half:], row_off + half, start_ms,
                               end_ms, base, nested))
    return outs


def _rollup_window(tsdb, chunk, row_off: int, start_ms: int, end_ms: int,
                   base: RollupInterval, nested: list[RollupInterval],
                   can_split: bool = True) -> list:
    """One (series chunk x time window) tile on the device route (ref:
    ``_rollup_window``): the base tier from the raw points, then the
    nested tiers by coarsening on the device. Returns ``[(tier,
    bucket_ts, grids [4, S, B] on the device, row_off), ...]``; the
    device work may still be running."""
    if can_split:
        # split a clearly irregular oversized window from the counts
        # alone, before the materialize (equal counts almost surely are
        # the regular case, which builds no [S, P, B] band; the check
        # after the bucket assignment backs the rest)
        counts = tsdb.store.count_range(chunk, start_ms, end_ms)
        pmax = int(counts.max()) if len(counts) else 0
        nb_est = (end_ms - start_ms) // base.interval_ms + 1
        if pmax and int(counts.min()) != pmax and \
                len(chunk) * pmax * nb_est > _PADDED_TILE_MAX_CELLS:
            return _split_window(tsdb, chunk, row_off, start_ms, end_ms,
                                 base, nested)
    padded = tsdb.store.materialize_padded(chunk, start_ms, end_ms)
    if padded.num_points == 0:
        return []
    spec = ds_mod.DownsamplingSpecification(interval_ms=base.interval_ms,
                                            function="sum")
    bucket_idx2d, bucket_ts = ds_mod.assign_buckets_padded(
        padded.ts2d, padded.counts, spec, start_ms, end_ms)
    nb = len(bucket_ts)
    k = detect_regular_padded(padded.counts, bucket_idx2d, nb)
    if k is None and can_split and \
            padded.values2d.size * nb > _PADDED_TILE_MAX_CELLS:
        return _split_window(tsdb, chunk, row_off, start_ms, end_ms, base,
                             nested)
    dev = tsdb.device
    values = upload(padded.values2d, torch.float64, dev)
    if k is not None:
        grids = _rollup_tile_dense(values, nb, k)
    else:
        grids = _rollup_tile(values, torch.from_numpy(bucket_idx2d).to(dev),
                             nb)
    outs = [(base, bucket_ts, grids, row_off)]
    for tier in nested:
        coarse_edges = ds_mod.fixed_bucket_edges(
            int(bucket_ts[0]), int(bucket_ts[-1]), tier.interval_ms)
        off = int((bucket_ts[0] - coarse_edges[0]) // base.interval_ms)
        outs.append((tier, coarse_edges,
                     _coarsen(grids, off, tier.interval_ms // base.interval_ms,
                              len(coarse_edges)), row_off))
    return outs


def _rollup_window_native(tsdb, chunk, row_off: int, start_ms: int,
                          end_ms: int, base: RollupInterval,
                          nested: list[RollupInterval]) -> list:
    """One tile on the storage route (ref: ``_rollup_window_native``):
    the store's range reduction gives the base tier's four statistics
    (``bucket_reduce``), and nested tiers coarsen by reshape reductions
    on the host. Same output as :func:`_rollup_window`, on the host."""
    bucket_ts = ds_mod.fixed_bucket_edges(start_ms, end_ms, base.interval_ms)
    b = len(bucket_ts)
    sums, cnts, mins, maxs = tsdb.store.bucket_reduce(
        chunk, start_ms, end_ms, int(bucket_ts[0]), base.interval_ms, b,
        want_minmax=True)
    if not cnts.any():
        return []
    outs = []

    def finalize(s_, c_, mn_, mx_, tier, bts):
        empty = c_ == 0
        outs.append((tier, bts, np.stack([
            np.where(empty, np.nan, s_), np.where(empty, np.nan, c_),
            np.where(empty, np.nan, mn_), np.where(empty, np.nan, mx_)]),
            row_off))

    finalize(sums, cnts, mins, maxs, base, bucket_ts)
    s = len(chunk)
    for tier in nested:
        f = tier.interval_ms // base.interval_ms
        coarse_edges = ds_mod.fixed_bucket_edges(
            int(bucket_ts[0]), int(bucket_ts[-1]), tier.interval_ms)
        # the base axis aligned to the coarse grid and padded at the
        # tail; an empty base cell holds its statistic's identity (0,
        # 0, +inf, -inf), so it vanishes in the coarse cell
        off = int((bucket_ts[0] - coarse_edges[0]) // base.interval_ms)
        pad_hi = len(coarse_edges) * f - (off + b)

        def pad(a, fill):
            return np.pad(a, ((0, 0), (off, pad_hi)),
                          constant_values=fill).reshape(s, -1, f)

        finalize(pad(sums, 0.0).sum(axis=2), pad(cnts, 0.0).sum(axis=2),
                 pad(mins, np.inf).min(axis=2),
                 pad(maxs, -np.inf).max(axis=2), tier, coarse_edges)
    return outs


def _window_buckets(nested_factors: list[int],
                    cap: int = _MAX_WINDOW_BUCKETS) -> int:
    """Base buckets per window: a multiple of every nested factor (so
    no coarse bucket straddles a window edge), capped. A sweep's lcm is
    at most ``_MAX_WINDOW_BUCKETS``; under a smaller cap (the irregular
    split) the result may pass the cap."""
    lcm = 1
    for f in nested_factors:
        lcm = math.lcm(lcm, f)
    return lcm * max(1, cap // lcm)


def run_rollup_job(tsdb, start_ms: int, end_ms: int,
                   intervals: list[str] | None = None,
                   series_chunk: int | None = None, progress=None,
                   series_ids=None) -> dict[str, int]:
    """Write the rollup tiers of the raw data in ``[start_ms, end_ms]``
    (ref: ``run_rollup_job``): every configured tier, or those of
    ``intervals``; every raw series, or those of ``series_ids``.
    ``progress(done, total)`` is called after each series chunk.
    Returns ``{interval: points written}``."""
    if tsdb.rollup_store is None:
        raise RuntimeError("rollups are not enabled")
    config: RollupConfig = tsdb.rollup_config
    tiers = ([config.get_interval(iv) for iv in intervals]
             if intervals else config.intervals)
    tiers = sorted(tiers, key=lambda t: t.interval_ms)
    written: dict[str, int] = {iv.interval: 0 for iv in tiers}
    if not tiers:
        return written
    finest = tiers[0]
    # nest coarser tiers under the finest pass while the lcm of their
    # factors keeps one window within the bucket cap; the rest take a
    # raw pass of their own
    nested: list[RollupInterval] = []
    lcm = 1
    for t in tiers[1:]:
        if t.interval_ms % finest.interval_ms:
            continue
        f = t.interval_ms // finest.interval_ms
        if math.lcm(lcm, f) <= _MAX_WINDOW_BUCKETS:
            nested.append(t)
            lcm = math.lcm(lcm, f)
    direct = [t for t in tiers[1:] if t not in nested]

    if series_ids is not None:
        all_sids = np.asarray(series_ids, dtype=np.int64)
    else:
        all_sids = np.concatenate(
            [tsdb.store.series_ids_for_metric(mid)
             for mid in tsdb.store.metric_ids()]
            or [np.empty(0, dtype=np.int64)])
    if len(all_sids):
        # series with no point in the window get no tier series (they
        # would stay empty in memory and in every snapshot)
        counts = np.asarray(tsdb.store.count_range(all_sids, start_ms,
                                                   end_ms))
        all_sids = all_sids[counts > 0]
    sweeps = [(finest, nested)] + [(t, []) for t in direct]
    total_work = len(all_sids) * len(sweeps)
    done = 0
    use_device = tsdb.config.get_bool("tsd.rollups.job.device")

    for base, sub in sweeps:
        factors = [t.interval_ms // base.interval_ms for t in sub]
        win_ms = base.interval_ms * _window_buckets(factors)
        if series_chunk is None:
            # sized for this sweep's window at up to one point a second
            chunk_sz = max(1, _TILE_CELL_BUDGET // max(1, win_ms // 1000))
        else:
            chunk_sz = series_chunk
        for lo in range(0, len(all_sids), chunk_sz):
            chunk = all_sids[lo:lo + chunk_sz]
            rsid_map = _chunk_tier_sids(tsdb, [base] + sub, chunk)
            # windows align to their own width (a multiple of every
            # nested interval), so no coarse bucket straddles two: its
            # timestamp would be written twice and one half lost to
            # last-write-wins. A window's device work runs while the
            # one before it is brought back and written.
            pending = None
            t0 = start_ms - (start_ms % win_ms)
            while t0 <= end_ms:
                window = (tsdb, chunk, 0, max(t0, start_ms),
                          min(t0 + win_ms - 1, end_ms), base, sub)
                outs = (_rollup_window(*window) if use_device
                        else _rollup_window_native(*window))
                if pending:
                    _write_outs(tsdb, rsid_map, pending, written)
                pending = outs
                t0 += win_ms
            if pending:
                _write_outs(tsdb, rsid_map, pending, written)
            done += len(chunk)
            if progress is not None:
                progress(done, total_work)
    return written
