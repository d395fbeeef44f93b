"""The query engine (ref: ``src/core/TsdbQuery.java:64``), point path.

Port of ``opentsdb_tpu/query/engine.py``'s ``QueryEngine.run`` ->
``_run_sub`` for the configuration that reaches the fused kernels:

1. resolve metric + filters against the UID tables
2. vectorized series selection over the metric's tag index
3. group-key construction from group-by tagv ids
4. materialize the row-padded batch and its time grid: downsample
   buckets, or the union of distinct timestamps without a downsample
5. ``ops.pipeline.execute_auto`` on the TSDB's device
6. result assembly with the reference's tags/aggregateTags semantics

The reference engine's other paths are not ported yet: the storage-side
grid pre-reduction and the device/host/result caches, the host-CPU tail
and its circuit breaker, time-blocked long ranges, the device mesh,
rollup tiers, histogram/percentile sub-queries, tsuid sub-queries and
``delete=true``. Asking for any of them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from opentsdb_tpu_torch.core import store as store_mod
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec, execute_auto
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query.model import (BadRequestError, TSQuery,
                                            TSSubQuery)

# (config key, the value that selects the point path, the missing path)
_POINT_PATH_KEYS = (
    ("tsd.query.grid_reduce", "false", "storage-side grid reduction"),
    ("tsd.query.device_cache_mb", "0", "device batch cache"),
    ("tsd.query.host_tail_max_cells", "-1", "host-CPU tail"),
    ("tsd.query.host_tail_max_cells_linear", "-1", "host-CPU tail"),
)


class QueryResult:
    """One output group — the analogue of one ``DataPoints`` object."""

    __slots__ = ("metric", "tags", "aggregated_tags", "tsuids",
                 "sub_query_index", "dps_arrays")

    def __init__(self, metric: str, tags: dict, aggregated_tags: list,
                 dps_arrays: tuple, tsuids: list | None = None,
                 sub_query_index: int = 0):
        self.metric = metric
        self.tags = tags
        self.aggregated_tags = aggregated_tags
        self.dps_arrays = dps_arrays    # (ts_ms int64 [N], values [N])
        self.tsuids = tsuids if tsuids is not None else []
        self.sub_query_index = sub_query_index

    @property
    def dps(self) -> list:
        ts_arr, vals = self.dps_arrays
        return list(zip(ts_arr.tolist(), vals.tolist()))

    def __repr__(self) -> str:
        return (f"QueryResult(metric={self.metric!r}, "
                f"tags={self.tags!r}, "
                f"aggregated_tags={self.aggregated_tags!r}, "
                f"num_dps={len(self.dps_arrays[0])})")


class NoSuchMetricError(BadRequestError):
    pass


class TagMatrix:
    """Columnar per-series tags for one sub-query's selected series:
    ``vids[i, j]`` is the tagv id of tag key ``kids[j]`` on series i,
    or -1 when the series lacks that key."""

    __slots__ = ("kids", "vids")

    def __init__(self, kids: np.ndarray, vids: np.ndarray):
        self.kids = kids        # int64 [K] sorted distinct tagk ids
        self.vids = vids        # int64 [S, K]; -1 = key absent

    @classmethod
    def from_triples(cls, sids: np.ndarray,
                     triples: np.ndarray) -> "TagMatrix":
        """Build from the metric index's (sid, kid, vid) rows; triples
        for sids outside ``sids`` are ignored."""
        sids = np.asarray(sids, dtype=np.int64)
        kids = (np.unique(triples[:, 1]) if len(triples)
                else np.empty(0, dtype=np.int64))
        vids = np.full((len(sids), len(kids)), -1, dtype=np.int64)
        if len(triples) and len(sids) and len(kids):
            order = np.argsort(sids, kind="stable")
            ssorted = sids[order]
            pos = np.minimum(np.searchsorted(ssorted, triples[:, 0]),
                             len(ssorted) - 1)
            keep = ssorted[pos] == triples[:, 0]
            kcol = np.searchsorted(kids, triples[:, 1])
            vids[order[pos[keep]], kcol[keep]] = triples[keep, 2]
        return cls(kids, vids)

    @property
    def num_series(self) -> int:
        return self.vids.shape[0]

    def col(self, kid: int) -> np.ndarray | None:
        """[S] tagv ids for one key (-1 absent), or None if no series
        has the key at all."""
        j = int(np.searchsorted(self.kids, kid))
        if j < len(self.kids) and self.kids[j] == kid:
            return self.vids[:, j]
        return None

    def select(self, mask_or_idx) -> "TagMatrix":
        return TagMatrix(self.kids, self.vids[mask_or_idx])

    def tags_of(self, i: int) -> list[tuple[int, int]]:
        """Series i's present (kid, vid) pairs, kid-ascending."""
        return [(int(k), int(v)) for k, v in zip(self.kids, self.vids[i])
                if v >= 0]


def compact_row_labels(mat: np.ndarray) -> tuple[np.ndarray, int]:
    """``np.unique(mat, axis=0, return_inverse=True)`` equivalent via
    per-column factorization. Labels preserve the lexicographic row
    order (the reference's ByteMap group-key order)."""
    n_rows, n_cols = mat.shape
    if n_cols == 0 or n_rows == 0:
        return (np.zeros(n_rows, dtype=np.int32), 1 if n_rows else 0)
    labels = None
    count = 1
    for j in range(n_cols):
        u, inv = np.unique(mat[:, j], return_inverse=True)
        if labels is None:
            labels, count = inv.astype(np.int64), len(u)
        else:
            # composite stays < count * len(u) <= n_rows^2: int64-safe,
            # re-compacted each step so it never grows further
            labels = labels * len(u) + inv
            u2, labels = np.unique(labels, return_inverse=True)
            count = len(u2)
    return labels.astype(np.int32), count


class _UidNameCache:
    """Memoized UID->name lookups for result assembly."""

    def __init__(self, registry):
        self._reg = registry
        self._cache: dict[int, str] = {}

    def __call__(self, uid: int) -> str:
        name = self._cache.get(uid)
        if name is None:
            name = self._cache[uid] = self._reg.get_name(uid)
        return name


class QueryEngine:
    """(ref: TsdbQuery; one instance per TSQuery execution)"""

    def __init__(self, tsdb):
        for key, point_path, missing in _POINT_PATH_KEYS:
            if tsdb.config.get_string(key) != point_path:
                raise NotImplementedError(
                    f"{key}={tsdb.config.get_string(key)} selects the "
                    f"{missing}, which is not ported yet; the port "
                    f"serves the point path ({key}={point_path})")
        self.tsdb = tsdb
        self._filter_eval = filters_mod.FilterEvaluator(tsdb.uids)

    def run(self, ts_query: TSQuery) -> list[QueryResult]:
        if ts_query.delete:
            raise NotImplementedError("delete=true is not ported yet")
        results: list[QueryResult] = []
        for sub in ts_query.queries:
            results.extend(self._run_sub(ts_query, sub))
        return results

    def _run_sub(self, tsq: TSQuery,
                 sub: TSSubQuery) -> list[QueryResult]:
        if sub.percentiles:
            raise NotImplementedError(
                "percentile sub-queries are not ported yet")
        if sub.tsuids:
            raise NotImplementedError("tsuid sub-queries are not ported yet")
        uids = self.tsdb.uids
        store = self.tsdb.store
        try:
            metric_id = uids.metrics.get_id(sub.metric)
        except LookupError:
            raise NoSuchMetricError(
                f"No such name for 'metrics': '{sub.metric}'") from None
        sids = store.series_ids_for_metric(metric_id)
        if len(sids) == 0:
            return []

        # --- filters -> series mask (ref: findSpans post-scan filters)
        sids, tag_mat = self._apply_filters(metric_id, sub, sids)
        if len(sids) == 0:
            return []

        # --- group construction (ref: GroupByAndAggregateCB :916)
        gb_kids = []
        for k in sorted({f.tagk for f in sub.filters if f.group_by}):
            try:
                gb_kids.append(uids.tag_names.get_id(k))
            except LookupError:
                return []
        group_ids, num_groups = self._group_ids(tag_mat, gb_kids)
        emit_raw = sub.agg.is_none
        if emit_raw:
            group_ids = np.arange(len(sids), dtype=np.int32)
            num_groups = len(sids)

        # --- materialize + time grid (row-padded layout)
        padded = store.materialize_padded(sids, tsq.start_ms, tsq.end_ms)
        if padded.num_points == 0:
            return []
        grid_complete = False
        if sub.ds_spec is not None:
            ds_function = sub.ds_spec.function
            fill_policy = sub.ds_spec.fill_policy
            fill_value = sub.ds_spec.fill_value
            bucket_idx2d, bucket_ts = ds_mod.assign_buckets_padded(
                padded.ts2d, padded.counts, sub.ds_spec, tsq.start_ms,
                tsq.end_ms)
        else:
            # union-of-timestamps grid: every distinct input timestamp
            # is an output point, like the reference's merge iterator
            ds_function = "sum"  # one point per (series, ts) after dedupe
            fill_policy = ds_mod.FillPolicy.NONE
            fill_value = float("nan")
            bucket_idx2d, bucket_ts, grid_complete = \
                self._union_grid(padded)

        spec = PipelineSpec(
            num_series=len(sids), num_buckets=len(bucket_ts),
            num_groups=num_groups, ds_function=ds_function,
            agg_name=sub.agg.name, fill_policy=fill_policy,
            fill_value=fill_value, rate=sub.rate,
            rate_counter=sub.rate_options.counter,
            rate_drop_resets=sub.rate_options.drop_resets,
            emit_raw=emit_raw,
            complete=grid_complete
            and not (sub.rate and sub.rate_options.drop_resets))
        result, emit = execute_auto(
            padded, bucket_idx2d, bucket_ts, group_ids, spec,
            sub.rate_options, dtype=self.tsdb.dtype,
            device=self.tsdb.device)
        return self._build_results(
            tsq, sub, metric_id, sids, tag_mat, group_ids, num_groups,
            bucket_ts, result.cpu().numpy(), emit.cpu().numpy())

    @staticmethod
    def _union_grid(padded: store_mod.PaddedBatch):
        """Time grid without a downsample: the distinct timestamps.
        Returns (bucket_idx2d with -1 pads, bucket_ts, complete)."""
        pad = store_mod.pad_mask(padded.counts, padded.ts2d.shape[1])
        if not pad.any() and (padded.ts2d == padded.ts2d[0]).all() \
                and (np.diff(padded.ts2d[0]) > 0).all():
            # regular cadence: every series carries the same strictly
            # increasing timestamp row, so the union IS row 0
            bucket_idx2d = np.broadcast_to(
                np.arange(padded.ts2d.shape[1], dtype=np.int32),
                padded.ts2d.shape).copy()
            return (bucket_idx2d, padded.ts2d[0].copy(),
                    not np.isnan(padded.values2d).any())
        bucket_ts, inverse = np.unique(padded.ts2d.reshape(-1),
                                       return_inverse=True)
        bucket_idx2d = inverse.reshape(padded.ts2d.shape).astype(np.int32)
        bucket_idx2d[pad] = -1
        if pad.any():
            # drop union slots only pad sentinels produced
            used = np.zeros(len(bucket_ts), dtype=bool)
            used[bucket_idx2d[~pad]] = True
            remap = np.cumsum(used) - 1
            bucket_ts = bucket_ts[used]
            bucket_idx2d = np.where(bucket_idx2d >= 0,
                                    remap[bucket_idx2d], -1
                                    ).astype(np.int32)
        return bucket_idx2d, bucket_ts, False

    def _apply_filters(self, metric_id: int, sub: TSSubQuery,
                       sids: np.ndarray) -> tuple[np.ndarray, TagMatrix]:
        _, triples = self.tsdb.store.metric_index(metric_id).arrays()
        tags = TagMatrix.from_triples(sids, triples)
        if sub.filters:
            mask = self._filter_eval.apply(sub.filters, sids, triples)
            sids = sids[mask]
            tags = tags.select(mask)
        if sub.explicit_tags and sub.filters:
            # keep series whose tag-KEY set equals the filters' key set
            # (ref: explicit_tags pruning in findSpans)
            filter_keys = set()
            for f in sub.filters:
                try:
                    filter_keys.add(
                        self.tsdb.uids.tag_names.get_id(f.tagk))
                except LookupError:
                    pass
            fk = np.asarray(sorted(filter_keys), dtype=np.int64)
            if len(np.setdiff1d(fk, tags.kids)):
                keep = np.zeros(len(sids), dtype=bool)
            else:
                in_filter = np.isin(tags.kids, fk)
                keep = ((tags.vids >= 0) == in_filter[None, :]) \
                    .all(axis=1)
            sids = sids[keep]
            tags = tags.select(keep)
        return sids, tags

    @staticmethod
    def _group_ids(tags: TagMatrix, gb_kids: list[int]
                   ) -> tuple[np.ndarray, int]:
        """Group id per series + group count. Group key = tuple of
        group-by tagv ids, ordered like the reference's ByteMap of
        group keys (ref: GroupByAndAggregateCB, TsdbQuery.java:995)."""
        if not gb_kids:
            return np.zeros(tags.num_series, dtype=np.int32), 1
        mat = np.empty((tags.num_series, len(gb_kids)), dtype=np.int64)
        for j, k in enumerate(gb_kids):
            col = tags.col(k)
            mat[:, j] = col if col is not None else -1
        return compact_row_labels(mat)

    def _build_results(self, tsq: TSQuery, sub: TSSubQuery,
                       metric_id: int, sids: np.ndarray, tags: TagMatrix,
                       group_ids: np.ndarray, num_groups: int,
                       bucket_ts: np.ndarray, result: np.ndarray,
                       emit: np.ndarray) -> list[QueryResult]:
        uids = self.tsdb.uids
        out: list[QueryResult] = []
        emit = emit.astype(bool)
        bucket_ts = np.asarray(bucket_ts, dtype=np.int64)
        ts_out = (bucket_ts if tsq.ms_resolution
                  else (bucket_ts // 1000) * 1000)
        # group membership via one sort
        order = np.argsort(group_ids, kind="stable")
        sorted_gids = group_ids[order]
        gid_range = np.arange(num_groups, dtype=group_ids.dtype)
        starts = np.searchsorted(sorted_gids, gid_range, side="left")
        ends = np.searchsorted(sorted_gids, gid_range, side="right")
        # SpanGroup tag semantics for all groups in two segment
        # reductions: a key with min vid >= 0 is present on every
        # member; min == max means one distinct value
        kname = _UidNameCache(uids.tag_names)
        vname = _UidNameCache(uids.tag_values)
        k_cnt = tags.vids.shape[1]
        if k_cnt and len(order):
            v_sorted = tags.vids[order]
            seg = np.minimum(starts, len(order) - 1)
            minv = np.minimum.reduceat(v_sorted, seg, axis=0)
            maxv = np.maximum.reduceat(v_sorted, seg, axis=0)
        else:
            minv = maxv = np.empty((num_groups, 0), dtype=np.int64)
        e_gidx, e_bidx = np.nonzero(emit)
        e_starts = np.searchsorted(e_gidx, gid_range, side="left")
        e_ends = np.searchsorted(e_gidx, gid_range, side="right")
        e_ts = ts_out[e_bidx]
        e_vals = np.asarray(result[e_gidx, e_bidx], dtype=np.float64)
        for gid in range(num_groups):
            members = order[starts[gid]:ends[gid]]
            lo_e, hi_e = e_starts[gid], e_ends[gid]
            if len(members) == 0 or lo_e == hi_e:
                continue
            g_tags: dict[str, str] = {}
            agg_tags: list[str] = []
            for j in range(k_cnt):
                lo = minv[gid, j]
                if lo < 0:
                    continue  # key absent on some member: vanishes
                if lo == maxv[gid, j]:
                    g_tags[kname(int(tags.kids[j]))] = vname(int(lo))
                else:
                    agg_tags.append(kname(int(tags.kids[j])))
            tsuids = []
            if tsq.show_tsuids:
                tsuids = [uids.tsuid(metric_id, tags.tags_of(m))
                          .hex().upper() for m in members]
            out.append(QueryResult(
                metric=sub.metric, tags=g_tags, aggregated_tags=agg_tags,
                dps_arrays=(e_ts[lo_e:hi_e], e_vals[lo_e:hi_e]),
                tsuids=tsuids, sub_query_index=sub.index))
        return out
