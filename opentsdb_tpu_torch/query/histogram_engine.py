"""Histogram / percentile sub-queries (ref:
``opentsdb_tpu/query/histogram_engine.py``; ``TsdbQuery.isHistogramQuery``
:776 routes a sub-query with ``percentiles`` to the
HistogramSpan/HistogramAggregationIterator pipeline: a bucket-wise SUM
merge, then ``SimpleHistogram.percentile``).

The window's histogram points of every selected series stack into one
``[N, NB]`` float64 count matrix on the device; the merge by group and
output timestamp is one fixed-order segment sum, and the percentiles a
cumulative count and rank compare over the bucket axis
(:mod:`opentsdb_tpu_torch.ops.histogram_kernels`). The answer equals
:func:`percentiles_from_counts` in float64 bit for bit.

Downsampling (ref: ``HistogramDownsampler.java`` wraps each span before
the group merge): SUM is the merge both across series and across time,
so downsample-then-merge is ONE segment sum keyed by (group, time
bucket); the time axis is the downsample buckets instead of the
distinct timestamps.

A window whose histograms disagree on their bounds takes the host merge
(:func:`_run_mixed_bounds`), chosen from the data before any device
work, as the reference chooses it; it is not a fallback of the device
path, whose errors raise.
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops.histogram_kernels import \
    histogram_percentile_pipeline
from opentsdb_tpu_torch.query.device_cache import array_digest
from opentsdb_tpu_torch.query.filters import FilterEvaluator
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery, TSSubQuery


def percentiles_from_counts(counts: np.ndarray, bounds: np.ndarray,
                            qs) -> np.ndarray:
    """counts [T, NB], bounds [NB + 1] -> [len(qs), T] on the host, in
    float64 (ref: ``percentiles_from_counts``). The midpoint convention
    of ``SimpleHistogram.percentile`` (:133): the bucket whose
    cumulative count crosses the rank contributes its midpoint."""
    totals = counts.sum(axis=1)
    cum = np.cumsum(counts, axis=1)
    mids = (bounds[:-1] + bounds[1:]) / 2.0
    out = np.empty((len(qs), counts.shape[0]), dtype=np.float64)
    for qi, q in enumerate(qs):
        target = totals * (q / 100.0)
        idx = np.sum(cum < target[:, None], axis=1)
        idx = np.clip(idx, 0, len(mids) - 1)
        out[qi] = np.where(totals > 0, mids[idx], 0.0)
    return out


def _time_axis(point_ts: np.ndarray, tsq: TSQuery, sub: TSSubQuery
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(time_idx[N], ts_out[T], in_range[N]): downsample bucket indices
    when the sub-query downsamples (ref: HistogramDownsampler), else one
    slot per distinct timestamp (the raw union merge)."""
    if sub.ds_spec is not None:
        bucket_idx, bucket_ts = ds_mod.assign_buckets(
            point_ts, sub.ds_spec, tsq.start_ms, tsq.end_ms)
        return (bucket_idx, bucket_ts,
                (bucket_idx >= 0) & (bucket_idx < len(bucket_ts)))
    from opentsdb_tpu_torch.query.engine import _distinct
    ts_sorted, ts_idx = _distinct(point_ts)
    return ts_idx, ts_sorted, np.ones(len(point_ts), dtype=bool)


def group_by_kids(uids, sub: TSSubQuery) -> list[int]:
    """The group-by tag keys' UIDs, ascending; a key with no UID groups
    nothing (ref: the ``has_name`` guard)."""
    kids = set()
    for f in sub.filters:
        if f.group_by:
            try:
                kids.add(uids.tag_names.get_id(f.tagk))
            except LookupError:
                pass
    return sorted(kids)


def plan_subquery(tsdb, store, sub: TSSubQuery):
    """Resolve the metric, select its series of ``store`` by the filters
    and group them: (metric_id, sids, tag_mat, group_ids, num_groups),
    or None when no series is left. Raises on an unknown metric."""
    from opentsdb_tpu_torch.query.engine import QueryEngine, TagMatrix
    uids = tsdb.uids
    try:
        metric_id = uids.metrics.get_id(sub.metric)
    except LookupError:
        raise BadRequestError(
            f"No such name for 'metrics': '{sub.metric}'") from None
    sids = store.series_ids_for_metric(metric_id)
    if len(sids) == 0:
        return None
    _, triples = store.metric_index(metric_id).arrays()
    # the TSDB's per-(store, metric) tag matrix, rebuilt when the metric
    # gains a series (as the scalar engine keeps it)
    tm_key = (store.instance_id, metric_id)
    hit = tsdb._tagmat_cache.get(tm_key)
    if hit is not None and hit[0] == len(sids):
        tag_mat = hit[1]
    else:
        tag_mat = TagMatrix.from_triples(sids, triples)
        tsdb._tagmat_cache[tm_key] = (len(sids), tag_mat)
    if sub.filters:
        mask = FilterEvaluator(uids).apply(sub.filters, sids, triples)
        sids = sids[mask]
        tag_mat = tag_mat.select(mask)
        if len(sids) == 0:
            return None
    group_ids, num_groups = QueryEngine._group_ids(
        tag_mat, group_by_kids(uids, sub))
    return metric_id, sids, tag_mat, group_ids, num_groups


def arena_slice(tsdb, tsq: TSQuery, metric_id: int,
                sids: np.ndarray) -> list:
    """The window's points of ``sids`` in each bounds class that holds
    any: ``[((bounds, ts, sid, rows), pos, member), ...]``, where
    ``member`` masks the class's points and ``pos`` places each point's
    series in ``sids``' sorted order. The snapshots are taken under the
    TSDB's histogram lock (``HistogramArena._Sub.snapshot``)."""
    with tsdb._histogram_lock:
        arena = tsdb._histogram_arenas.get(metric_id)
        snaps = [(s.bounds, *s.snapshot())
                 for s in arena.groups.values()] if arena else []
    if not snaps:
        return []
    sorted_sids = np.sort(sids, kind="stable")
    active = []
    for snap in snaps:
        ts_a, sid_a = snap[1], snap[2]
        pos = np.clip(np.searchsorted(sorted_sids, sid_a), 0,
                      len(sorted_sids) - 1)
        member = ((sorted_sids[pos] == sid_a) & (ts_a >= tsq.start_ms)
                  & (ts_a <= tsq.end_ms))
        if member.any():
            active.append((snap, pos, member))
    return active


def window_rows(active_class, sids: np.ndarray):
    """(bounds, counts [N, NB] float64 host rows, point_sidx [N] into
    ``sids``, point_ts [N]) of one bounds class's window. A window that
    holds every point of the class takes the arena's rows as they are
    (no copy)."""
    (bounds, ts_a, _sid_a, rows), pos, member = active_class
    order = np.argsort(sids, kind="stable")
    if member.all():
        return bounds, rows, order[pos].astype(np.int64), ts_a
    return (bounds, rows[member], order[pos[member]].astype(np.int64),
            ts_a[member])


def upload(rows: np.ndarray, device) -> torch.Tensor:
    """The counts matrix on the device, float64."""
    return torch.from_numpy(np.ascontiguousarray(
        rows, dtype=np.float64)).to(device)


def segments(tsq: TSQuery, sub: TSSubQuery, group_ids: np.ndarray,
             num_groups: int, point_sidx: np.ndarray,
             point_ts: np.ndarray):
    """(seg [N'] = group * T + time slot, in_range [N] or None when all
    points are in range, ts_out [T], present [G, T])."""
    time_idx, ts_out, in_range = _time_axis(point_ts, tsq, sub)
    gvec = np.asarray(group_ids, dtype=np.int64)[point_sidx]
    if in_range.all():
        in_range = None
    else:
        gvec, time_idx = gvec[in_range], time_idx[in_range]
    num_ts = len(ts_out)
    seg = gvec * num_ts + time_idx
    present = np.bincount(seg, minlength=num_groups * num_ts) \
        .reshape(num_groups, num_ts) > 0
    return seg, in_range, ts_out, present


def run_histogram_subquery(tsdb, tsq: TSQuery, sub: TSSubQuery) -> list:
    """One percentile sub-query over the stored histogram points."""
    plan = plan_subquery(tsdb, tsdb.histogram_store, sub)
    if plan is None:
        return []
    metric_id, sids, tag_mat, group_ids, num_groups = plan
    # the collected counts stay on the device, keyed by the series and
    # the window and versioned by the histogram writes (ref: ``("hist",
    # digest(sids), start, end)`` at ``_histogram_version``)
    cache = tsdb.device_grid_cache
    hit = None
    if cache is not None:
        ckey = ("hist", array_digest(np.ascontiguousarray(sids)),
                tsq.start_ms, tsq.end_ms)
        # read before the slice: a write landing after it leaves the
        # entry stale, never wrongly fresh
        cver = tsdb._histogram_version
        hit = cache.get(ckey, cver)
    if hit is not None:
        (counts,), meta = hit
        bounds, point_sidx, point_ts = (meta["bounds"], meta["point_sidx"],
                                        meta["point_ts"])
    else:
        active = arena_slice(tsdb, tsq, metric_id, sids)
        if not active:
            return []
        if len(active) > 1:
            # the bounds disagree inside the window: the host merge
            return _run_mixed_bounds(tsdb, tsq, sub, active, sids,
                                     tag_mat, group_ids, num_groups)
        bounds, rows, point_sidx, point_ts = window_rows(active[0], sids)
        counts = upload(rows, tsdb.device)
        if cache is not None:
            cache.put(ckey, cver, (counts,), {
                "point_sidx": point_sidx, "point_ts": point_ts,
                "bounds": bounds})
    seg, in_range, ts_out, present = segments(
        tsq, sub, group_ids, num_groups, point_sidx, point_ts)
    if len(seg) == 0:
        return []
    if in_range is not None:
        counts = counts[torch.from_numpy(in_range).to(counts.device)]
    pcts = histogram_percentile_pipeline(
        counts, seg, num_groups * len(ts_out), bounds, sub.percentiles)
    pcts = pcts.reshape(len(sub.percentiles), num_groups, len(ts_out))
    return _emit_groups(tsdb, tsq, sub, tag_mat, group_ids, num_groups,
                        ts_out, present, pcts)


def _emit_groups(tsdb, tsq, sub, tag_mat, group_ids, num_groups,
                 ts_arr, present, pcts) -> list:
    """One QueryResult per (group, percentile), named
    ``{metric}_pct_{q:g}``, with the group's common and aggregated
    tags."""
    from opentsdb_tpu_torch.query.engine import QueryResult, _common_tags
    uids = tsdb.uids
    order = np.argsort(group_ids, kind="stable")
    sorted_gids = group_ids[order]
    gid_range = np.arange(num_groups, dtype=group_ids.dtype)
    starts = np.searchsorted(sorted_gids, gid_range, side="left")
    ends = np.searchsorted(sorted_gids, gid_range, side="right")
    ts_arr = np.asarray(ts_arr, dtype=np.int64)
    ts_out = ts_arr if tsq.ms_resolution else (ts_arr // 1000) * 1000
    out = []
    for gid in range(num_groups):
        members = order[starts[gid]:ends[gid]]
        if len(members) == 0 or not present[gid].any():
            continue
        tags, agg_tags = _common_tags(tag_mat, members, uids)
        sel = np.nonzero(present[gid])[0]
        for qi, q in enumerate(sub.percentiles):
            out.append(QueryResult(
                metric=f"{sub.metric}_pct_{q:g}", tags=tags,
                aggregated_tags=agg_tags,
                dps_arrays=(ts_out[sel],
                            np.array(pcts[qi, gid, sel], dtype=np.float64)),
                sub_query_index=sub.index))
    return out


def _run_mixed_bounds(tsdb, tsq, sub, active, sids, tag_mat, group_ids,
                      num_groups) -> list:
    """The host merge when the window's histograms disagree on their
    bounds (ref: ``_run_mixed_bounds``): per group, a merge keyed on the
    output timestamp, each slot keeping its own bounds; two bounds at
    one slot raise (ref: HistogramAggregationIterator). Numpy float64.

    ``active`` is :func:`arena_slice`'s list."""
    from opentsdb_tpu_torch.query.engine import QueryResult, _common_tags
    uids = tsdb.uids
    sids = np.asarray(sids)
    sid_order = np.argsort(sids, kind="stable")
    gids_sorted = np.asarray(group_ids)[sid_order]

    # per bounds class: its window's points, their group ids and their
    # output slot
    pre = []
    for (bounds, ts_a, _sid_a, rows), pos, m in active:
        ts_f, rows_f = ts_a[m], rows[m]
        point_gid = gids_sorted[pos[m]]
        if sub.ds_spec is not None:
            bidx, bts = ds_mod.assign_buckets(
                ts_f, sub.ds_spec, tsq.start_ms, tsq.end_ms)
            ok = (bidx >= 0) & (bidx < len(bts))
            slots = bts[np.clip(bidx, 0, len(bts) - 1)]
            rows_f, point_gid, slots = rows_f[ok], point_gid[ok], slots[ok]
        else:
            slots = ts_f
        pre.append((bounds, point_gid, slots, rows_f))

    gid_order = np.argsort(group_ids, kind="stable")
    gids_in_order = np.asarray(group_ids)[gid_order]
    gid_range = np.arange(num_groups, dtype=np.asarray(group_ids).dtype)
    g_starts = np.searchsorted(gids_in_order, gid_range, side="left")
    g_ends = np.searchsorted(gids_in_order, gid_range, side="right")

    out = []
    for gid in range(num_groups):
        merged: dict[int, tuple[tuple, np.ndarray]] = {}
        for b, point_gid, slots_all, rows_f in pre:
            gmask = point_gid == gid
            if not gmask.any():
                continue
            uniq, inv = np.unique(slots_all[gmask], return_inverse=True)
            acc = np.zeros((len(uniq), rows_f.shape[1]), dtype=np.float64)
            np.add.at(acc, inv, rows_f[gmask])
            for k, slot in enumerate(uniq.tolist()):
                if slot in merged:
                    b0, prev = merged[slot]
                    if b0 != b:
                        raise BadRequestError(
                            "cannot merge histograms with different "
                            f"buckets at timestamp {slot}")
                    merged[slot] = (b0, prev + acc[k])
                else:
                    merged[slot] = (b, acc[k])
        if not merged:
            continue
        members = gid_order[g_starts[gid]:g_ends[gid]]
        ts_sorted = sorted(merged)
        pcts = np.stack([
            percentiles_from_counts(
                merged[t][1][None, :],
                np.asarray(merged[t][0], dtype=np.float64),
                sub.percentiles)[:, 0]
            for t in ts_sorted], axis=1)       # [Q, T]
        tags, agg_tags = _common_tags(tag_mat, members, uids)
        ts_arr = np.asarray(ts_sorted, dtype=np.int64)
        if not tsq.ms_resolution:
            ts_arr = (ts_arr // 1000) * 1000
        for qi, q in enumerate(sub.percentiles):
            out.append(QueryResult(
                metric=f"{sub.metric}_pct_{q:g}", tags=tags,
                aggregated_tags=agg_tags,
                dps_arrays=(ts_arr, np.array(pcts[qi], dtype=np.float64)),
                sub_query_index=sub.index))
    return out
