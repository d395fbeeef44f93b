"""Scatter-gather partial merging (ref: ``opentsdb_tpu/cluster/merge.py``).

A SERIES lives wholly on one shard (the hash key is the series
identity), so everything per-series — downsampling, rate, counter
resets, interpolation fills — is computed exactly by the owning shard.
Only the cross-series *group aggregation* spans shards, and it merges
exactly when the aggregator decomposes, the same property the rollup
tiers rely on (``rollup/job.py``): sum/count partials add, min/max
partials min/max, and ``avg`` = merged sum / merged count (the
``RollupSpan`` sum+count qualifier trick lifted to the network).
Quantile shapes merge through DDSketches instead of refusing:
``percentiles`` sub-queries scatter as SKETCH PARTIALS (each shard
returns its per-(group, bucket) serialized sketches, the router
merges them — canonical sketch state is merge-order independent, so
the merged sketch is bit-equal to a single node folding every
shard's points — and extracts quantiles once), and the exact
percentile aggregators (p50..p999, median) scatter as ``none``
clones whose per-series downsampled values the router folds into
per-(group, bucket) sketches as legs arrive, never an average of
percentiles. ``dev`` and the estimated ``ep..r3/r7`` variants stay
a clean 400 — a sketch answers quantiles, not variance, and the
estimated variants promise a specific interpolation a sketch cannot
reproduce; a silently-wrong merge would be worse than no answer.

Timestamp grids: peers are queried with ``msResolution`` forced and an
ABSOLUTE window (the router resolves relative times once), so
downsampled sub-queries produce identical bucket timestamps on every
shard and partials align exactly. No-downsample (union-grid) queries
merge at the union of the shards' emitted timestamps — documented as
value-equal only when series don't need cross-shard interpolation
(each timestamp's merged value combines the shards that emitted it).

Group identity across shards is the group-by tag values: every member
of a group shares them, so each shard's partial carries them in its
``tags`` map. SpanGroup tag semantics compose across partials the
same way they compose across series: common tags survive only where
every partial agrees, keys that differ (or were already aggregated on
some shard) become ``aggregateTags``, keys missing from a partial's
tags+aggregateTags vanish.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

from opentsdb_tpu_torch.query.model import BadRequestError


def _add(a: float, b: float) -> float:
    return a + b


def _min(a: float, b: float) -> float:
    return a if a <= b else b


def _max(a: float, b: float) -> float:
    return a if a >= b else b


# group aggregators whose per-shard partials merge exactly; count
# partials are per-shard COUNTS, so they add
_COMBINE: dict[str, Callable[[float, float], float]] = {
    "sum": _add, "zimsum": _add, "pfsum": _add, "count": _add,
    "min": _min, "mimmin": _min, "max": _max, "mimmax": _max,
}


def sketch_agg_quantile(name: str) -> float | None:
    """The quantile a non-decomposable aggregator answers through the
    cross-shard sketch merge, or None. Exact percentile aggregators
    (p50..p999) and ``median`` qualify; the estimated ``ep..r3/r7``
    variants do not (they promise a specific rank interpolation) and
    ``dev`` is not a quantile at all."""
    if name == "median":
        return 50.0
    from opentsdb_tpu_torch.ops import aggregators as aggs_mod
    if not aggs_mod.exists(name):
        return None
    agg = aggs_mod.get(name)
    if agg.is_percentile and agg.estimation == "legacy":
        return float(agg.percentile)
    return None


def decompose_plan(sub) -> str:
    """How one sub-query's partials merge across shards:
    ``"direct"`` (combine op exists), ``"concat"`` (emit-raw: groups
    are single series, no cross-shard combining), ``"avg"``
    (rewritten into sum+count twins), ``"sketch"`` (``percentiles``
    sub: shards return serialized per-bucket sketch partials), or
    ``"sketch_agg"`` (exact percentile aggregator: shards run a
    ``none`` clone, the router folds per-series values into
    sketches). Raises ``BadRequestError`` for aggregators that do
    not decompose."""
    if sub.percentiles:
        return "sketch"
    name = (sub.aggregator or "").lower()
    if name == "none":
        return "concat"
    if name in _COMBINE:
        return "direct"
    if name == "avg":
        return "avg"
    if sketch_agg_quantile(name) is not None:
        return "sketch_agg"
    raise BadRequestError(
        f"aggregator {sub.aggregator!r} does not decompose across "
        "shards (supported: sum, count, min, max, zimsum, mimmin, "
        "mimmax, avg, none, median, p50..p999)")


def group_key(result: dict, gb_keys: list[str]) -> tuple:
    """Cross-shard identity of one partial group."""
    tags = result.get("tags") or {}
    return (result.get("metric"),
            tuple((k, tags.get(k)) for k in gb_keys))


class MergedGroup:
    """One logical group being accumulated across shard partials."""

    __slots__ = ("metric", "tags", "agg_tags", "dps", "_cols",
                 "tsuids", "annotations", "global_annotations")

    def __init__(self, result: dict):
        self.metric = result.get("metric", "")
        self.tags = dict(result.get("tags") or {})
        self.agg_tags = set(result.get("aggregateTags") or ())
        self.dps: dict[int, float] = {}
        # lazy first-contribution columns (wire transport): series
        # never span shards, so most groups see exactly one leg —
        # its (ts, values) arrays pass straight through to the
        # QueryResult unless a second leg collides (then they
        # materialize into the dict fold)
        self._cols: tuple | None = None
        self.tsuids: list[str] = list(result.get("tsuids") or ())
        self.annotations: list[dict] = list(
            result.get("annotations") or ())
        self.global_annotations: list[dict] = list(
            result.get("globalAnnotations") or ())

    def fold_tags(self, result: dict) -> None:
        """SpanGroup semantics across partials (module docstring)."""
        r_tags = result.get("tags") or {}
        r_agg = set(result.get("aggregateTags") or ())
        new_tags: dict[str, str] = {}
        new_agg: set[str] = set()
        for k, v in self.tags.items():
            if k in r_tags:
                if r_tags[k] == v:
                    new_tags[k] = v
                else:
                    new_agg.add(k)
            elif k in r_agg:
                new_agg.add(k)
            # else: absent on some member of that shard -> vanishes
        for k in self.agg_tags:
            if k in r_tags or k in r_agg:
                new_agg.add(k)
        self.tags = new_tags
        self.agg_tags = new_agg
        self.tsuids.extend(result.get("tsuids") or ())
        self.annotations.extend(result.get("annotations") or ())
        self.global_annotations.extend(
            result.get("globalAnnotations") or ())

    def fold_dps(self, dps: Iterable, combine) -> None:
        """Combine one partial's ``[[ts, value], ...]`` rows. NaN is
        "this shard's members contributed nothing here" (fill-policy
        emission), so it is the combine identity; both sides NaN
        keeps the NaN — all members absent emits a gap, exactly what
        the single-node grid does."""
        if self._cols is not None:
            self._materialize()
        elif not self.dps:
            ts_col = getattr(dps, "ts", None)
            if ts_col is not None:
                self._cols = (ts_col, dps.values)
                return
        mine = self.dps
        for ts, val in dps:
            v = float(val)
            cur = mine.get(ts)
            if cur is None:
                mine[ts] = v
            elif math.isnan(cur):
                mine[ts] = v
            elif not math.isnan(v):
                mine[ts] = combine(cur, v)

    def _materialize(self) -> None:
        """Columnar first leg -> the dict fold (a second leg arrived
        for this group, or avg finishing needs keyed lookups). Values
        land exactly as the row-iteration path would have stored them
        (same f8 bits; ``float(int(v)) == v`` for masked ints)."""
        if self._cols is None:
            return
        ts_col, vals = self._cols
        self._cols = None
        mine = self.dps
        for t, v in zip(ts_col.tolist(), vals.tolist()):
            mine[t] = v

    def to_query_result(self, sub_index: int):
        import numpy as np

        from opentsdb_tpu_torch.query.engine import QueryResult
        if self._cols is not None:
            # single-leg group: the engine's grid is already
            # ts-ascending — pass the columns through untouched
            ts_arr = np.asarray(self._cols[0], dtype=np.int64)
            vals = np.asarray(self._cols[1], dtype=np.float64)
            return QueryResult(
                metric=self.metric, tags=self.tags,
                aggregated_tags=sorted(self.agg_tags),
                tsuids=self.tsuids,
                annotations=_to_annotations(self.annotations),
                global_annotations=_to_annotations(
                    self.global_annotations),
                sub_query_index=sub_index,
                dps_arrays=(ts_arr, vals))
        ts_sorted = sorted(self.dps)
        ts_arr = np.asarray(ts_sorted, dtype=np.int64)
        vals = np.asarray([self.dps[t] for t in ts_sorted],
                          dtype=np.float64)
        return QueryResult(
            metric=self.metric, tags=self.tags,
            aggregated_tags=sorted(self.agg_tags),
            tsuids=self.tsuids,
            annotations=_to_annotations(self.annotations),
            global_annotations=_to_annotations(
                self.global_annotations),
            sub_query_index=sub_index,
            dps_arrays=(ts_arr, vals))


def _to_annotations(docs: list[dict]) -> list:
    """Peer-JSON annotation docs -> Annotation objects, deduped on
    (tsuid, start) so overlapping global ranges don't double-emit."""
    if not docs:
        return []
    from opentsdb_tpu_torch.meta.annotation import Annotation
    seen: set[tuple] = set()
    out = []
    for doc in docs:
        note = Annotation.from_json(doc)
        key = (note.tsuid, note.start_time)
        if key in seen:
            continue
        seen.add(key)
        out.append(note)
    return out


def merge_partials(peer_results: list[list[dict]], gb_keys: list[str],
                   combine) -> dict[tuple, MergedGroup]:
    """Fold every shard's partial groups into merged groups keyed by
    cross-shard group identity. Insertion order follows the first
    shard that reported each group (then ring order), stable for
    tests."""
    groups: dict[tuple, MergedGroup] = {}
    for results in peer_results:
        for r in results:
            key = group_key(r, gb_keys)
            g = groups.get(key)
            if g is None:
                g = groups[key] = MergedGroup(r)
            else:
                g.fold_tags(r)
            g.fold_dps(r.get("dps") or (), combine)
    return groups


def merge_direct(peer_results: list[list[dict]], sub,
                 gb_keys: list[str]) -> list:
    combine = _COMBINE[(sub.aggregator or "").lower()]
    groups = merge_partials(peer_results, gb_keys, combine)
    return [g.to_query_result(sub.index) for g in groups.values()]


def merge_concat(peer_results: list[list[dict]], sub) -> list:
    """Emit-raw ("none" aggregator): every partial is one whole series
    (series never span shards) — concatenate, no combining."""
    out = []
    for results in peer_results:
        for r in results:
            g = MergedGroup(r)
            g.fold_dps(r.get("dps") or (), _add)
            out.append(g.to_query_result(sub.index))
    return out


def _avg_results(sums: dict[tuple, MergedGroup],
                 counts: dict[tuple, MergedGroup], sub) -> list:
    """Finish an ``avg`` merge from its folded sum+count twins:
    merged group sums / merged group counts (the rollup-tier avg
    decomposition; engine ``_avg_rollup_pipeline`` is the
    storage-side twin)."""
    out = []
    for key, gs in sums.items():
        gc = counts.get(key)
        if gc is None:
            continue
        gs._materialize()  # keyed lookups need the dict form
        gc._materialize()
        dps: dict[int, float] = {}
        for ts, s in gs.dps.items():
            c = gc.dps.get(ts)
            if c is None or math.isnan(c) or c == 0:
                if math.isnan(s):
                    dps[ts] = s  # all-absent gap survives
                continue
            dps[ts] = s / c
        gs.dps = dps
        out.append(gs.to_query_result(sub.index))
    return out


def merge_avg(sum_peer_results: list[list[dict]],
              count_peer_results: list[list[dict]], sub,
              gb_keys: list[str]) -> list:
    """``avg`` across shards (see :func:`_avg_results`)."""
    sums = merge_partials(sum_peer_results, gb_keys, _add)
    counts = merge_partials(count_peer_results, gb_keys, _add)
    return _avg_results(sums, counts, sub)


def merge_sub(sub, gb_keys: list[str], plan: str,
              primary: list[list[dict]],
              secondary: list[list[dict]] | None = None) -> list:
    if plan == "concat":
        return merge_concat(primary, sub)
    if plan == "avg":
        return merge_avg(primary, secondary or [], sub, gb_keys)
    return merge_direct(primary, sub, gb_keys)


def gb_tag_keys(sub) -> list[str]:
    """The group-by tag keys of one sub-query, sorted — the engine
    groups on exactly this set (``QueryEngine._run_sub``)."""
    return sorted({f.tagk for f in sub.filters if f.group_by})


class StreamMerger:
    """Incremental scatter merge: fold each shard's partial grids the
    moment its leg COMPLETES instead of gather-then-merge, so router
    merge work overlaps the slow shards' network time (the wire
    transport additionally decodes each leg's grids as frames arrive).

    Equivalence with the batch path (``merge_sub`` over a gathered
    ``partials`` list) is exact by construction: the same dict-fold
    ``MergedGroup`` machinery runs over the same rows in the same
    order — leg arrival order here IS the partials-list append order
    there, group insertion order follows the first leg reporting each
    group, and every pairwise float combine happens in the identical
    sequence. That bit-identity (against the single-node oracle) is
    why this stays a dict fold rather than a vectorized scatter.

    A leg must be COMPLETE and SUCCESSFUL before :meth:`add_leg` —
    partial folding of a leg that later dies would poison the
    accumulators, and ``avg``'s sum+count twins must land together."""

    def __init__(self, subs, plans: list[str],
                 slots: list[tuple[int, int | None]],
                 sketch_alpha: float | None = None):
        self.subs = list(subs)
        self.plans = plans
        self.slots = slots
        self.legs = 0  # completed legs folded (incl. empty 400 legs)
        # expanded-sub index -> accumulator: a list for concat subs
        # (every partial row is one whole series), a key->MergedGroup
        # dict for folding subs
        self._concat: dict[int, list[MergedGroup]] = {}
        self._folded: dict[int, dict[tuple, MergedGroup]] = {}
        self._combine: dict[int, Callable[[float, float], float]] = {}
        self._gbk: dict[int, list[str]] = {}
        # sketch plans: group identity (tags fold) lives in
        # _sk_groups, the per-(group, bucket) quantile state in
        # _sk_cells. "sketch_agg" subs additionally record the
        # quantile their aggregator names (_sk_q) — their legs carry
        # plain per-series dps that the router folds itself, with
        # sketch_alpha as the relative-error bound (router config;
        # "sketch" legs carry sketches built at the SHARD's alpha).
        self._sk_groups: dict[int, dict[tuple, MergedGroup]] = {}
        self._sk_cells: dict[int, dict[tuple, dict]] = {}
        self._sk_q: dict[int, float] = {}
        self._sk_alpha = sketch_alpha
        for sub, plan, (p_idx, s_idx) in zip(self.subs, plans, slots):
            gbk = gb_tag_keys(sub)
            if plan == "concat":
                self._concat[p_idx] = []
            elif plan == "avg":
                # sum+count twins both fold with _add
                for idx in (p_idx, s_idx):
                    self._folded[idx] = {}
                    self._combine[idx] = _add
                    self._gbk[idx] = gbk
            elif plan in ("sketch", "sketch_agg"):
                self._sk_groups[p_idx] = {}
                self._sk_cells[p_idx] = {}
                self._gbk[p_idx] = gbk
                if plan == "sketch_agg":
                    q = sketch_agg_quantile(
                        (sub.aggregator or "").lower())
                    self._sk_q[p_idx] = q if q is not None else 50.0
            else:
                self._folded[p_idx] = {}
                self._combine[p_idx] = \
                    _COMBINE[(sub.aggregator or "").lower()]
                self._gbk[p_idx] = gbk

    def add_leg(self, rows: list[dict]) -> None:
        """Fold one shard's complete partial list (``showQuery`` rows:
        each names its expanded sub index)."""
        self.legs += 1
        for r in rows:
            idx = (r.get("query") or {}).get("index")
            if idx in self._sk_cells:
                self._fold_sketch_row(idx, r)
                continue
            folded = self._folded.get(idx)
            if folded is not None:
                key = group_key(r, self._gbk[idx])
                g = folded.get(key)
                if g is None:
                    g = folded[key] = MergedGroup(r)
                else:
                    g.fold_tags(r)
                g.fold_dps(r.get("dps") or (), self._combine[idx])
                continue
            concat = self._concat.get(idx)
            if concat is not None:
                g = MergedGroup(r)
                g.fold_dps(r.get("dps") or (), _add)
                concat.append(g)
            # else: a row naming no known sub index — dropped, exactly
            # as the batch path's _sub_results filter dropped it

    def _fold_sketch_row(self, idx: int, r: dict) -> None:
        """One sketch-plan partial row. ``"sketch"`` rows carry
        ``sketchDps`` ([[bucket_ts, b64 sketch], ...]) — merge each
        bucket's sketch into the group's accumulator (canonical state
        makes the merge order-independent). ``"sketch_agg"`` rows are
        one whole series' downsampled values (``none`` clone) — fold
        each value into the (group, bucket) sketch; NaN is the
        fill-policy "no data here" emission and is skipped, matching
        the single-node percentile reduction's missing-value mask."""
        from opentsdb_tpu_torch.sketch.ddsketch import (DDSketch,
                                                  SketchError)
        key = group_key(r, self._gbk[idx])
        groups = self._sk_groups[idx]
        g = groups.get(key)
        if g is None:
            groups[key] = MergedGroup(r)
        else:
            g.fold_tags(r)
        cells = self._sk_cells[idx].setdefault(key, {})
        if idx in self._sk_q:
            alpha = self._sk_alpha
            for ts, val in (r.get("dps") or ()):
                v = float(val)
                if math.isnan(v):
                    continue
                sk = cells.get(ts)
                if sk is None:
                    sk = cells[ts] = DDSketch(alpha) \
                        if alpha is not None else DDSketch()
                sk.add(v)
            return
        for ts, blob in (r.get("sketchDps") or ()):
            try:
                sk = DDSketch.from_b64(blob) if isinstance(blob, str) \
                    else DDSketch.from_bytes(blob)
            except (SketchError, ValueError):
                continue  # undecodable partial: serve the rest
            cur = cells.get(int(ts))
            if cur is None:
                cells[int(ts)] = sk
            else:
                try:
                    cur.merge(sk)
                except SketchError:
                    pass  # alpha mismatch across shards: config skew

    def _sketch_results(self, sub, plan: str, p_idx: int) -> list:
        """Extract quantiles from the folded sketch state. "sketch"
        emits the single-node percentile row shape (one row per
        (group, q), metric suffixed ``_pct_{q}``); "sketch_agg" emits
        one row per group under the base metric, its aggregator's
        quantile per bucket. Bucket timestamps stay in ms — the
        serializer applies the client's second-vs-ms convention, the
        same way every other merged plan's rows are emitted."""
        out = []
        for key, g in self._sk_groups[p_idx].items():
            cells = self._sk_cells[p_idx].get(key) or {}
            slots = sorted((t, sk) for t, sk in cells.items()
                           if sk.count)
            if not slots:
                continue
            base = g.metric
            if plan == "sketch_agg":
                g.dps = {t: float(sk.quantile(self._sk_q[p_idx]))
                         for t, sk in slots}
                out.append(g.to_query_result(sub.index))
                continue
            for q in (sub.percentiles or ()):
                g.metric = f"{base}_pct_{q:g}"
                g.dps = {t: float(sk.quantile(q)) for t, sk in slots}
                out.append(g.to_query_result(sub.index))
            g.metric = base
        return out

    def results(self) -> list:
        """Finish every sub's merge, in sub order."""
        out: list = []
        for sub, plan, (p_idx, s_idx) in zip(self.subs, self.plans,
                                             self.slots):
            if plan == "concat":
                out.extend(g.to_query_result(sub.index)
                           for g in self._concat[p_idx])
            elif plan == "avg":
                out.extend(_avg_results(self._folded[p_idx],
                                        self._folded[s_idx], sub))
            elif plan in ("sketch", "sketch_agg"):
                out.extend(self._sketch_results(sub, plan, p_idx))
            else:
                out.extend(g.to_query_result(sub.index)
                           for g in self._folded[p_idx].values())
        return out


__all__ = ["decompose_plan", "gb_tag_keys", "group_key",
           "merge_partials", "merge_sub", "MergedGroup",
           "sketch_agg_quantile", "StreamMerger"]
