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

``partials=True`` (a cluster router's ``sketchPartials`` scatter) skips
the quantile extraction and returns one row per group carrying its
serialized per-bucket sketches, which the router merges exactly
(canonical DDSketch state is merge-order independent). For a histogram
metric the partials also carry the live arena rows, folded at their
bucket midpoints (:func:`arena_sketch_items`).
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import sketch_fold
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery, TSSubQuery
from opentsdb_tpu_torch.sketch.ddsketch import DDSketch, SketchError

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
    QueryResults (with ``partials``, sketch-partial rows)."""
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
                           hist, partials)


def _run_over_store(tsdb, tsq, sub, store, mid, alpha, max_buckets, hist,
                    partials=False):
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
        items, raw_rng = _hist_zones(tsdb, tsq, sub, mid, alpha,
                                     max_buckets, partials), None
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
    return _emit(tsdb, tsq, sub, tag_mat, group_ids, num_groups, acc,
                 partials)


def _hist_zones(tsdb, tsq, sub, mid, alpha, max_buckets,
                partials) -> list:
    """A histogram metric's sketch zones (ref: ``_hist_zones``): the
    cold sketch rows the arena spill wrote, before the spill boundary,
    and, with ``partials`` only, the live arena rows after it
    (:func:`arena_sketch_items`). A batch query serves the live arena
    through the arena engine instead."""
    from opentsdb_tpu_torch.lifecycle.stitch import (_cold_failed,
                                                     guarded_sketch_rows)
    lc = tsdb.lifecycle
    cold = lc.coldstore if lc is not None else None
    spill_b = cold.spill_boundary(sub.metric) if cold is not None else 0
    items = []
    if spill_b and tsq.start_ms < spill_b:
        rows, _ = guarded_sketch_rows(cold, sub.metric, tsq.start_ms,
                                      min(tsq.end_ms, spill_b - 1))
        for tags, cts, blob in rows:
            try:
                items.append((tags, cts, DDSketch.from_bytes(blob)))
            except (SketchError, ValueError) as exc:
                raise _cold_failed(cold, exc, None) from exc
    if partials:
        items.extend(arena_sketch_items(
            tsdb, mid, max(tsq.start_ms, spill_b), tsq.end_ms, alpha,
            max_buckets))
    return items


def arena_sketch_items(tsdb, mid: int, start_ms: int, end_ms: int,
                       alpha: float, max_buckets: int) -> list:
    """Live histogram arena rows as ``(tag names, ts, DDSketch)`` (ref:
    ``arena_sketch_items``): each row's bucket counts fold at the
    bucket midpoints, the value ``percentiles_from_counts`` emits for
    any rank landing in the bucket, so a sketch's quantile answers
    within alpha of the arena engine's midpoint convention."""
    if start_ms > end_ms:
        return []
    with tsdb._histogram_lock:
        arena = tsdb._histogram_arenas.get(mid)
        snaps = [(s.bounds, *s.snapshot())
                 for s in arena.groups.values()] if arena else []
    if not snaps:
        return []
    uids = tsdb.uids
    store = tsdb.histogram_store
    names_of: dict[int, tuple | None] = {}
    out = []
    for bounds, ts_a, sid_a, rows in snaps:
        b = np.asarray(bounds, dtype=np.float64)
        mids = (b[:-1] + b[1:]) / 2.0
        m = (ts_a >= start_ms) & (ts_a <= end_ms)
        if not m.any():
            continue
        for ts, sid, counts in zip(ts_a[m].tolist(), sid_a[m].tolist(),
                                   np.asarray(rows)[m]):
            if sid not in names_of:
                try:
                    rec = store.series(int(sid))
                    names_of[sid] = tuple(sorted(
                        (uids.tag_names.get_name(k),
                         uids.tag_values.get_name(v))
                        for k, v in rec.tags))
                except LookupError:
                    names_of[sid] = None
            names = names_of[sid]
            if names is None:
                continue
            sk = DDSketch(alpha)
            sk.add_weighted(mids, counts)
            if max_buckets:
                sk.collapse(max_buckets)
            if sk.count:
                out.append((names, int(ts), sk))
    return out


def _emit(tsdb, tsq, sub, tag_mat, group_ids, num_groups, acc,
          partials=False):
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
        if partials:
            r = QueryResult(metric=sub.metric, tags=tags,
                            aggregated_tags=agg_tags,
                            dps_arrays=(np.empty(0, dtype=np.int64),
                                        np.empty(0, dtype=np.float64)),
                            sub_query_index=sub.index)
            r.sketches = [(t, sk.to_bytes()) for t, sk in slots]
            out.append(r)
            continue
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
