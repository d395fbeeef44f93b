"""Sketch-backed percentile sub-queries over scalar metrics (ref:
``opentsdb_tpu/sketch/query.py``).

``percentiles`` on a metric with no histogram series answers from
quantile sketches: the window's raw points fold, per (group, output
bucket), into one :class:`~opentsdb_tpu_torch.sketch.ddsketch.DDSketch`
each (:func:`opentsdb_tpu_torch.ops.sketch_fold.fold_series_cells`),
and each percentile is extracted from it, emitted as
``{metric}_pct_{q:g}`` rows. Semantics match the histogram path: the
POPULATION percentile of every point a bucket covers, within the
sketch's ``alpha`` (``tsd.sketch.alpha``) of the exact order
statistic. ``tsd.sketch.enable=false`` turns the path off and such a
sub-query answers nothing, as before sketches.

The reference also reads sketch cells of demoted and spilled history
(its lifecycle tiers and cold segments), splices them into a histogram
metric's arena rows, and hands mergeable partials to a cluster router
(``sketchPartials``). The port has neither: a scalar metric's raw range
is the whole window (the reference's ``sketch_zone_read`` with no
lifecycle), a histogram metric answers from its arenas alone (the
reference's ``_hist_zones`` hold nothing without a cold zone), and
partials raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import sketch_fold
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery, TSSubQuery
from opentsdb_tpu_torch.sketch.ddsketch import DDSketch

PARTIALS_NOT_PORTED = ("sketch partials (sketchPartials) serve a cluster "
                       "router, which is not ported yet (ROADMAP Queue 1, "
                       "the rest, with no device compute)")


def _config_sketch(tsdb) -> tuple[bool, float, int]:
    cfg = tsdb.config
    return (cfg.get_bool("tsd.sketch.enable", True),
            cfg.get_float("tsd.sketch.alpha", 0.01),
            cfg.get_int("tsd.sketch.max_buckets", 4096))


def documented_alpha(tsdb) -> float:
    """The sketch's documented relative-error bound (config alpha)."""
    return _config_sketch(tsdb)[1]


def _bucket_of(ts: np.ndarray, tsq: TSQuery, sub: TSSubQuery
               ) -> tuple[np.ndarray, np.ndarray]:
    """(slot_ts[N], in_range[N]): the output bucket's timestamp of each
    input timestamp: downsample buckets when the sub-query downsamples
    (the histogram engine's time-axis rule), else the timestamp."""
    ts = np.asarray(ts, dtype=np.int64)
    if sub.ds_spec is None or not len(ts):
        return ts, np.ones(len(ts), dtype=bool)
    bidx, bts = ds_mod.assign_buckets(ts, sub.ds_spec, tsq.start_ms,
                                      tsq.end_ms)
    bts = np.asarray(bts, dtype=np.int64)
    ok = (bidx >= 0) & (bidx < len(bts))
    return bts[np.clip(bidx, 0, max(len(bts) - 1, 0))], ok


def run_sketch_percentiles(tsdb, tsq: TSQuery, sub: TSSubQuery,
                           partials: bool = False) -> list | None:
    """Serve one percentile sub-query from sketches. None when the
    sketch path is off (``tsd.sketch.enable=false``: the caller keeps
    the behaviour from before sketches), else a possibly empty list of
    QueryResults: empty for a metric with histogram series, which the
    arena engine serves."""
    if partials:
        raise NotImplementedError(PARTIALS_NOT_PORTED)
    enabled, alpha, max_buckets = _config_sketch(tsdb)
    if not enabled:
        return None
    try:
        mid = tsdb.uids.metrics.get_id(sub.metric)
    except LookupError:
        raise BadRequestError(
            f"No such name for 'metrics': '{sub.metric}'") from None
    if len(tsdb.histogram_store.series_ids_for_metric(mid)):
        return []
    return _run_over_store(tsdb, tsq, sub, alpha, max_buckets)


def _run_over_store(tsdb, tsq, sub, alpha, max_buckets):
    """Fold a scalar metric's points in the window into one sketch per
    (group, output bucket) and emit the percentiles."""
    from opentsdb_tpu_torch.query.histogram_engine import plan_subquery
    plan = plan_subquery(tsdb, tsdb.store, sub)
    if plan is None:
        return []
    _mid, sids, tag_mat, group_ids, num_groups = plan
    batch = tsdb.store.materialize(sids, tsq.start_ms, tsq.end_ms)
    if not batch.num_points:
        return []
    slots, ok = _bucket_of(batch.ts_ms, tsq, sub)
    sidx = np.asarray(batch.series_idx, dtype=np.int64)
    vals = np.asarray(batch.values, dtype=np.float64)
    if not ok.all():
        sidx, slots, vals = sidx[ok], slots[ok], vals[ok]
    # (group, output bucket) -> sketch
    acc = sketch_fold.fold_series_cells(
        np.asarray(group_ids, dtype=np.int64)[sidx], slots, vals, 1,
        alpha, max_buckets)
    if not acc:
        return []
    return _emit(tsdb, tsq, sub, tag_mat, group_ids, num_groups, acc)


def _emit(tsdb, tsq, sub, tag_mat, group_ids, num_groups, acc):
    from opentsdb_tpu_torch.query.engine import QueryResult, _common_tags
    uids = tsdb.uids
    order = np.argsort(group_ids, kind="stable")
    sorted_gids = np.asarray(group_ids)[order]
    gid_range = np.arange(num_groups, dtype=np.asarray(group_ids).dtype)
    starts = np.searchsorted(sorted_gids, gid_range, side="left")
    ends = np.searchsorted(sorted_gids, gid_range, side="right")
    by_gid: dict[int, list[tuple[int, DDSketch]]] = {}
    for (gid, slot), sk in acc.items():
        by_gid.setdefault(gid, []).append((slot, sk))
    out = []
    for gid in range(num_groups):
        slots = by_gid.get(gid)
        if not slots:
            continue
        members = order[starts[gid]:ends[gid]]
        if len(members) == 0:
            continue
        slots.sort(key=lambda p: p[0])
        tags, agg_tags = _common_tags(tag_mat, members, uids)
        ts_arr = np.asarray([t for t, _ in slots], dtype=np.int64)
        if not tsq.ms_resolution:
            ts_arr = (ts_arr // 1000) * 1000
        for q in sub.percentiles:
            vals = np.array([float(sk.quantile(q)) for _t, sk in slots],
                            dtype=np.float64)
            out.append(QueryResult(
                metric=f"{sub.metric}_pct_{q:g}", tags=tags,
                aggregated_tags=agg_tags, dps_arrays=(ts_arr, vals),
                sub_query_index=sub.index))
    return out
