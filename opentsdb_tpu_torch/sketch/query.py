"""Sketch-backed percentile sub-queries (ref:
``opentsdb_tpu/sketch/query.py``).

``percentiles`` on a scalar metric answers from quantile sketches
merged across the stitched three-way read
(:func:`opentsdb_tpu_torch.lifecycle.stitch.sketch_zone_read`):

- cold segment sketch blobs for ``[start, spill_b)``,
- the lifecycle's in-RAM sketch tier for ``[spill_b, demote_b)``,
- a vectorized fold (:func:`opentsdb_tpu_torch.ops.sketch_fold.
  fold_series_cells`) of the raw tail for ``[demote_b, end]``; with no
  lifecycle that is the whole window.

Semantics match the histogram path: per (group, output bucket), the
POPULATION percentile of every point the bucket covers, within the
sketch's ``alpha`` (``tsd.sketch.alpha``) of the exact order statistic,
emitted as ``{metric}_pct_{q:g}`` rows. ``tsd.sketch.enable=false``
turns the path off and such a sub-query answers as before sketches.

A histogram metric's live window takes the arena engine; its spilled
history (arena rows turned into sketches by the spill) comes back
through the cold zone here, and the engine splices the two row sets
(:func:`merge_pct_rows`). A cold zone that cannot be read raises
DegradedError (a 503), where the reference serves the other zones.
Partials for a cluster router (``sketchPartials``) raise
NotImplementedError: the router is not ported yet.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import sketch_fold
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery, TSSubQuery
from opentsdb_tpu_torch.sketch.ddsketch import DDSketch, SketchError

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


def _names_of_sids(store, uids, sids) -> dict[tuple, int]:
    """Tag-NAMES tuple -> position in ``sids`` (ref: ``_names_of_sids``;
    the identity cold segments and sketch cells key by). Unresolvable
    series are skipped: their cells cannot be attributed."""
    out: dict[tuple, int] = {}
    for i, sid in enumerate(np.asarray(sids).tolist()):
        rec = store.series(int(sid))
        try:
            names = tuple(sorted((uids.tag_names.get_name(k),
                                  uids.tag_values.get_name(v))
                                 for k, v in rec.tags))
        except LookupError:
            continue
        out[names] = i
    return out


def run_sketch_percentiles(tsdb, tsq: TSQuery, sub: TSSubQuery,
                           partials: bool = False) -> list | None:
    """Serve one percentile sub-query from sketches. None when the
    sketch path is off (``tsd.sketch.enable=false``: the caller keeps
    the behaviour from before sketches), else a possibly empty list of
    QueryResults."""
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
    hist = bool(len(tsdb.histogram_store.series_ids_for_metric(mid)))
    store = tsdb.histogram_store if hist else tsdb.store
    return _run_over_store(tsdb, tsq, sub, store, mid, alpha, max_buckets,
                           hist)


def _run_over_store(tsdb, tsq, sub, store, mid, alpha, max_buckets, hist):
    """Gather the zones' sketches per (group, output bucket), fold the
    raw tail in, and emit the percentiles."""
    from opentsdb_tpu_torch.lifecycle.stitch import sketch_zone_read
    from opentsdb_tpu_torch.query.histogram_engine import plan_subquery
    plan = plan_subquery(tsdb, store, sub)
    if plan is None:
        return []
    _mid, sids, tag_mat, group_ids, num_groups = plan
    gvec = np.asarray(group_ids, dtype=np.int64)
    if hist:
        items, raw_rng = _hist_zones(tsdb, tsq, sub, mid), None
    else:
        items, raw_rng, _ = sketch_zone_read(tsdb, sub.metric, mid,
                                             tsq.start_ms, tsq.end_ms)

    # (group, output bucket) accumulators
    acc: dict[tuple[int, int], DDSketch] = {}

    def fold_in(gid: int, slot: int, sk: DDSketch) -> None:
        cur = acc.get((gid, slot))
        if cur is None:
            acc[(gid, slot)] = sk
        else:
            try:
                cur.merge(sk)
            except SketchError:
                pass  # alpha changed under old cells (as the reference)

    if items:
        pos_of = _names_of_sids(store, tsdb.uids, sids)
        cell_ts = np.asarray([c[1] for c in items], dtype=np.int64)
        slots, ok = _bucket_of(cell_ts, tsq, sub)
        for j, (tags, _cts, sk) in enumerate(items):
            i = pos_of.get(tuple(tags))
            if i is None or not ok[j]:
                continue  # filtered out, or outside the bucket grid
            fold_in(int(gvec[i]), int(slots[j]), sk)

    if raw_rng is not None:
        batch = tsdb.store.materialize(sids, raw_rng[0], raw_rng[1])
        if batch.num_points:
            slots, ok = _bucket_of(batch.ts_ms, tsq, sub)
            sidx = np.asarray(batch.series_idx, dtype=np.int64)
            vals = np.asarray(batch.values, dtype=np.float64)
            if not ok.all():
                sidx, slots, vals = sidx[ok], slots[ok], vals[ok]
            folded = sketch_fold.fold_series_cells(
                gvec[sidx], slots, vals, 1, alpha, max_buckets)
            for (gid, slot), sk in folded.items():
                fold_in(int(gid), int(slot), sk)
    if not acc:
        return []
    return _emit(tsdb, tsq, sub, tag_mat, group_ids, num_groups, acc)


def _hist_zones(tsdb, tsq, sub, mid) -> list:
    """A histogram metric's sketch zone (ref: ``_hist_zones`` without
    partials): the cold sketch rows the arena spill wrote, before the
    spill boundary. The live arena rows are the arena engine's."""
    from opentsdb_tpu_torch.lifecycle.stitch import (_cold_failed,
                                                     guarded_sketch_rows)
    lc = tsdb.lifecycle
    cold = lc.coldstore if lc is not None else None
    if cold is None:
        return []
    spill_b = cold.spill_boundary(sub.metric)
    if not spill_b or tsq.start_ms >= spill_b:
        return []
    rows, _ = guarded_sketch_rows(cold, sub.metric, tsq.start_ms,
                                  min(tsq.end_ms, spill_b - 1))
    items = []
    for tags, cts, blob in rows:
        try:
            items.append((tags, cts, DDSketch.from_bytes(blob)))
        except (SketchError, ValueError) as exc:
            raise _cold_failed(cold, exc, None) from exc
    return items


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


def merge_pct_rows(a: list, b: list) -> list:
    """Splice two percentile row sets covering disjoint time windows
    (live arena rows and spilled-history sketch rows) by (metric, tags,
    sub-query index; ref: ``merge_pct_rows``): points concatenate in
    time order, rows of one side alone pass through, and ``b`` wins an
    exact timestamp collision (only possible mid-sweep)."""
    if not a:
        return b
    if not b:
        return a
    keyed: dict[tuple, object] = {}
    out = []
    for r in a:
        key = (r.metric, tuple(sorted(r.tags.items())), r.sub_query_index)
        keyed[key] = r
        out.append(r)
    for r in b:
        key = (r.metric, tuple(sorted(r.tags.items())), r.sub_query_index)
        cur = keyed.get(key)
        if cur is None:
            keyed[key] = r
            out.append(r)
            continue
        merged = dict(cur.dps)
        merged.update(dict(r.dps))
        ts = np.asarray(sorted(merged), dtype=np.int64)
        cur.dps_arrays = (ts, np.asarray([merged[t] for t in ts.tolist()],
                                         dtype=np.float64))
    return out
