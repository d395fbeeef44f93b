"""The query engine (ref: ``src/core/TsdbQuery.java:64``).

Port of ``opentsdb_tpu/query/engine.py``'s ``QueryEngine.run`` ->
``_run_sub``:

1. resolve metric + filters against the UID tables
2. vectorized series selection over the metric's tag index
3. group-key construction from group-by tagv ids
4. the grid path (``tsd.query.grid_reduce``): a fixed-interval
   downsample of a grid function is reduced storage-side to a
   ``[S, B]`` grid (``TimeSeriesStore.bucket_reduce``), uploaded once
   and kept in the TSDB's device cache, and only the pipeline's tail
   runs on the device (``ops.pipeline.execute_grid``)
5. otherwise the point path: materialize the window's points, row-padded
   or, when the rows' lengths are too skewed to pad, flat; build their
   time grid (downsample buckets, fixed or calendar, or the union of
   distinct timestamps without a downsample); upload them as a prepared
   batch, kept in the device cache when that is on, and run it
   (``ops.pipeline.run_prepared``: the fused kernels or the dense path
   for regular data, the padded or flat path for irregular data)
6. a long range: when an aggregating query's ``[S, B]`` exceeds the
   cell budget (``tsd.query.max_device_cells``), the point path streams
   it in time blocks instead (``ops.blocked.execute_blocked``), with
   no prepared batch
7. result assembly with the reference's tags/aggregateTags semantics,
   and each group's annotations (those of its member series in the
   query's range, unless ``noAnnotations``) and, with
   ``globalAnnotations``, the global ones

With rollups on (``tsd.rollups.enable``), step 1 picks the store first
(``_select_store``, ref: TsdbQuery's rollup best match and
``ROLLUP_USAGE``): a downsample whose interval a tier divides is read
from that tier's store, ``count`` as the sum of the stored counts, and
``avg`` as the sum tier over the count tier (``_avg_rollup_pipeline``:
both reduced in the store, divided on the device by
``ops.pipeline.execute_avg_divide``). Every later step, the filters and
the caches included, follows the selected store.

Around ``_run_sub`` sit the reference's serve-path mechanisms: the
sub-queries of one TSQuery fan out onto the TSDB's pool
(``tsd.query.fanout.workers``), each asks the continuous-query registry
first (``streaming/``: a registered tumbling query answers its window
from maintained partials, the tail alone on the device) and then goes
through the result cache (``query/result_cache.py``,
``tsd.query.cache.*``), and the per-series tag matrix of a metric is
kept between queries (``TSDB._tagmat_cache``).

Every path that scans checks the TSDB's query limits
(``query/limits.py``) with the count of points it read, and records
its scan in the request's ``QueryStats`` when the caller passes one
(the ``/api/query`` handler does).

Placement (ref: ``host_tail_device``): before any device call, the
grid, point and avg paths decide from the query's padded ``[S, B]``
(and, for median and the percentiles, its groups) and the
``tsd.query.host_tail_max_*`` keys alone whether the pipeline's tail
runs on the host CPU or on the TSDB's device. A host-placed tail runs
the kernels' plain versions on CPU tensors, and its prepared batches
go to the host-RAM pool (``TSDB.host_prep_cache``), never the device
cache. It is chosen by size, never as a retry after a failure.

Every device dispatch runs under the TSDB's device breaker
(``tsd.query.breaker.*``, ``_run_device``) in its shedding mode: a
failure is counted and raised; an open breaker refuses a query that
would touch the device with ``DegradedError`` (503 with Retry-After)
before any device call, and its half-open probe closes it on success.
The reference's host re-answer of a failed query, and its cold re-run
of a failed warm hit, are fallbacks the port does not have.

A sub-query may name its series by tsuid (``_tsuid_store``), and a
``delete=true`` query removes the points it read once its compute
succeeded (sub-queries then run one after another). A pixel budget
(``pixels``/``pixelFn``, ``ops/visual_downsample.py``) reduces each
emitted row last, at result assembly.

With a query mesh (``tsd.query.mesh``, ``TSDB.query_mesh``; ref: the
reference's mesh branches), each path runs its tail over the
('series', 'time') mesh of :mod:`opentsdb_tpu_torch.parallel` instead
of one device: the grid path on cut, cached grids
(``run_sharded_grid``), the point path on cut point batches whose
device copies the prepared-batch cache keeps (``run_sharded_device``),
a long range in time blocks that keep the mesh
(``execute_blocked_sharded``, its cell budget scaled by the mesh where
the reduction's memory allows), and the avg path's tail after a divide
on the host (``_mesh_execute``). A cache entry made with a mesh never
serves a query without one, nor the other way round, and a mesh query
never takes the host tail. After a lifecycle demotion, a tier-eligible
sub-query selects the stitched view of cold segments, tier history and
raw tail (:mod:`opentsdb_tpu_torch.lifecycle.stitch`) in place of the
tier store, so every path above reads it.

A sub-query with ``percentiles`` takes its own path (``_run_sub``'s
first branch, as in the reference): the exact merge over the
histogram arenas (:mod:`~opentsdb_tpu_torch.query.histogram_engine`)
and the sketch fold (:mod:`opentsdb_tpu_torch.sketch.query`), a
scalar metric's three sketch zones or a histogram metric's spilled
history, spliced by group.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from opentsdb_tpu_torch.core import store as store_mod
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.obs.trace import trace_begin, trace_end, trace_span
from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import visual_downsample as vd
from opentsdb_tpu_torch.ops.shapes import shape_bucket
from opentsdb_tpu_torch.ops.blocked import (DEFAULT_CELL_BUDGET,
                                            execute_blocked,
                                            pick_block_buckets)
from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec,
                                             avg_divide_grid,
                                             execute_avg_divide,
                                             execute_grid, flatten_padded,
                                             grid_from_reduce,
                                             prepare_auto, prepare_flat,
                                             put_grid, run_prepared,
                                             upload)
from opentsdb_tpu_torch.parallel import sharded_pipeline as sharded
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query import result_cache as rc_mod
from opentsdb_tpu_torch.query.device_cache import array_digest
from opentsdb_tpu_torch.query.model import (BadRequestError, TSQuery,
                                            TSSubQuery, effective_pixels)
from opentsdb_tpu_torch.stats.stats import QueryStat, QueryStats
from opentsdb_tpu_torch.utils.faults import DegradedError

# the host CPU, where a host-placed tail runs
HOST = torch.device("cpu")
# default padded [S, B] cells under which the tail of a median or
# percentile query runs on the host (ref: HOST_TAIL_DEFAULT_CELLS),
# and its cap on cells x groups (its group stage sorts per group)
HOST_TAIL_DEFAULT_CELLS = 1 << 20
HOST_TAIL_DEFAULT_CELLGROUPS = 1 << 25
# the linear aggregators' cells-only budget (segment reductions)
HOST_TAIL_DEFAULT_CELLS_LINEAR = 1 << 23


def _rank_class_agg(agg_name: str) -> bool:
    """Median and the percentiles: the group stage sorts, it is not a
    segment reduction (ref: ``_rank_class_agg``). An unknown name is
    taken as rank class, the conservative budget."""
    if agg_name == "median":
        return True
    try:
        return aggs_mod.get(agg_name).is_percentile
    except KeyError:
        return True


def host_tail_device(config, padded_cells: int, padded_groups: int = 1,
                     linear_agg: bool = False) -> torch.device | None:
    """The host CPU for a small query's tail, or None for the TSDB's
    device (ref: ``host_tail_device``). A linear aggregator's tail goes
    to the host below ``tsd.query.host_tail_max_cells_linear`` padded
    cells; a rank-class one below ``tsd.query.host_tail_max_cells``
    cells and ``tsd.query.host_tail_max_cellgroups`` cells x groups.
    0 means the default budget, -1 never. The dims are shape-bucketed
    (:func:`host_tail_for_dims`), so the warmup places a class as the
    engine will."""
    if linear_agg:
        limit = config.get_int("tsd.query.host_tail_max_cells_linear", 0) \
            or HOST_TAIL_DEFAULT_CELLS_LINEAR
        if limit < 0 or padded_cells > limit:
            return None
        return HOST
    limit = config.get_int("tsd.query.host_tail_max_cells", 0) \
        or HOST_TAIL_DEFAULT_CELLS
    glimit = config.get_int("tsd.query.host_tail_max_cellgroups", 0) \
        or HOST_TAIL_DEFAULT_CELLGROUPS
    if limit < 0 or glimit < 0 or padded_cells > limit \
            or padded_cells * max(padded_groups, 1) > glimit:
        return None
    return HOST


def host_tail_for_dims(config, s: int, b: int, num_groups: int,
                       emit_raw: bool = False,
                       agg_name: str = "p99") -> torch.device | None:
    """:func:`host_tail_device` from a query's true dims: the one place
    they are shape-bucketed, shared by the engine and the warmup (ref:
    ``host_tail_for_dims``). ``emit_raw`` has no group stage (factor
    1); ``agg_name`` picks the linear or the rank-class budget."""
    return host_tail_device(
        config, shape_bucket(s) * shape_bucket(b),
        1 if emit_raw else shape_bucket(num_groups + 1),
        linear_agg=not _rank_class_agg(agg_name))


# downsample functions the storage-side reduction serves: linear bucket
# statistics (sum/count/min/max; avg is sum over count)
_GRID_FNS = frozenset(("sum", "zimsum", "pfsum", "count", "min",
                       "mimmin", "max", "mimmax", "avg"))
# the padded layout's limits (ref: engine.py:371-373): a batch whose
# S * Pmax exceeds both 4x its points and 10M cells (one long series
# among many short ones), or 500M cells at all, is materialized flat
_PADDED_SKEW_FACTOR = 4
_PADDED_MIN_CELLS = 10_000_000
_PADDED_ABS_MAX_CELLS = 500_000_000


def grid_cache_key(store, sids: np.ndarray, start_ms: int, end_ms: int,
                   bucket_ts: np.ndarray, interval_ms: int,
                   fn: str, mesh=None) -> tuple:
    """Device-cache key of one storage-side reduction (ref:
    ``_grid_pipeline``'s ``ckey``). The group-by is not part of it:
    queries over the same series and window share one grid. The mesh
    is: its entry holds the grid cut over that mesh."""
    return ("grid", store.instance_id,
            array_digest(np.ascontiguousarray(sids)), start_ms, end_ms,
            int(bucket_ts[0]), interval_ms, len(bucket_ts), fn, mesh)


def _agg_class(agg, num_groups: int, mesh=None) -> str | tuple:
    """The aggregator's class in the prepared-batch key (ref: ``acls``).
    On one device, the linear/rank class: a rank-class aggregator's
    group stage is a sort, and two of its group counts must not share
    an entry. Under a mesh, the memory class of its cross-shard
    reduction (``agg_mesh_class``), with the group count for the
    histogram class: the blocked verdict scales the budget by it, and
    a hit must imply the cold path's (unblocked) branch."""
    if mesh is not None:
        cls = sharded.agg_mesh_class(agg.name)
        return ("pct", num_groups) if cls == "pct" else cls
    if agg.name == "median" or agg.percentile is not None:
        return ("rank", num_groups)
    return "lin"


def _distinct(ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(ts, return_inverse=True)`` with an int32 inverse.
    Timestamps of a window in milliseconds span few slots next to their
    count, so a presence bitmap over the span replaces the sort when
    the span is small."""
    span = int(ts.max()) - int(ts.min()) + 1 if len(ts) else 0
    if not 0 < span <= min(max(4 * len(ts), 1 << 20), 1 << 26):
        uniq, inverse = np.unique(ts, return_inverse=True)
        return uniq, inverse.astype(np.int32)
    lo = ts.min()
    off = ts - lo
    present = np.zeros(span, dtype=bool)
    present[off] = True
    slot = np.cumsum(present, dtype=np.int32) - 1
    return np.flatnonzero(present).astype(ts.dtype) + lo, slot[off]


def _host(out) -> tuple[np.ndarray, np.ndarray]:
    """A tail's (result, emit) tensors as host arrays; the copy waits
    for the device, so a device error surfaces here."""
    result, emit = out
    return result.cpu().numpy(), emit.cpu().numpy()


@dataclass
class PointGrid:
    """One sub-query's materialized points and their time grid: a
    row-padded batch with ``bucket_idx`` [S, Pmax] (-1 pads), or a flat
    batch with ``bucket_idx`` [N]; the bucket times and the downsample
    that the pipeline runs over them."""
    padded: store_mod.PaddedBatch | None
    batch: store_mod.PointBatch | None
    bucket_idx: np.ndarray
    bucket_ts: np.ndarray
    ds_function: str
    fill_policy: ds_mod.FillPolicy
    fill_value: float
    # every (series, bucket) cell holds a value: a property of the data
    complete: bool


class QueryResult:
    """One output group — the analogue of one ``DataPoints`` object."""

    __slots__ = ("metric", "tags", "aggregated_tags", "tsuids",
                 "sub_query_index", "dps_arrays", "annotations",
                 "global_annotations", "sketches")

    def __init__(self, metric: str, tags: dict, aggregated_tags: list,
                 dps_arrays: tuple, tsuids: list | None = None,
                 sub_query_index: int = 0, annotations: list | None = None,
                 global_annotations: list | None = None):
        self.metric = metric
        self.tags = tags
        self.aggregated_tags = aggregated_tags
        self.dps_arrays = dps_arrays    # (ts_ms int64 [N], values [N])
        self.tsuids = tsuids if tsuids is not None else []
        self.sub_query_index = sub_query_index
        self.annotations = annotations if annotations is not None else []
        self.global_annotations = global_annotations \
            if global_annotations is not None else []
        # a shard's sketch partials for a cluster router (ref): the
        # [(bucket ts_ms, serialized DDSketch)] of one group, with
        # empty dps
        self.sketches: list | None = None

    def _twin(self, index: int) -> "QueryResult":
        twin = QueryResult(self.metric, self.tags, self.aggregated_tags,
                           self.dps_arrays, self.tsuids, index,
                           self.annotations, self.global_annotations)
        twin.sketches = self.sketches
        return twin

    @property
    def dps(self) -> list:
        ts_arr, vals = self.dps_arrays
        return list(zip(ts_arr.tolist(), vals.tolist()))

    @property
    def num_dps(self) -> int:
        """Point count without materializing ``dps``: the serializer
        takes its columnar formatter by it."""
        return len(self.dps_arrays[0])

    def with_sub_index(self, index: int) -> "QueryResult":
        """A shallow twin carrying another ``sub_query_index``: a result
        cache hit re-labels shared results when the same sub-query sits
        at another position of the requesting TSQuery (the cache key
        leaves the index out)."""
        if self.sub_query_index == index:
            return self
        return self._twin(index)

    def cache_copy(self) -> "QueryResult":
        """Detached twin for the result cache: shares the immutable
        columnar payload, so a consumer re-binding a field of its copy
        never changes the cached entry."""
        return self._twin(self.sub_query_index)

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
    def from_triples(cls, sids: np.ndarray, triples: np.ndarray,
                     kids: np.ndarray | None = None) -> "TagMatrix":
        """Build from the metric index's (sid, kid, vid) rows; triples
        for sids outside ``sids`` are ignored. ``kids`` (sorted, a
        superset of the triples' keys) fixes the columns, by default the
        triples' distinct keys."""
        sids = np.asarray(sids, dtype=np.int64)
        if kids is None:
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

    @classmethod
    def from_pairs(cls, tag_tuples) -> "TagMatrix":
        """Build from per-series ((kid, vid), ...) tuples (small paths:
        the continuous queries' members)."""
        rows = [(i, kid, vid) for i, tags in enumerate(tag_tuples)
                for kid, vid in tags]
        triples = (np.asarray(rows, dtype=np.int64).reshape(-1, 3)
                   if rows else np.empty((0, 3), dtype=np.int64))
        return cls.from_triples(np.arange(len(tag_tuples)), triples)

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


def _match_series_by_tags(src_store, dst_store, sids: np.ndarray,
                          metric_id: int) -> np.ndarray:
    """For each series id of ``src_store`` in ``sids``, the id of the
    series of ``dst_store`` with the same metric and tags, or -1 (ref:
    ``_match_series_by_tags``; the avg path aligns the count tier to the
    sum tier so). Both tag matrices are built over the union of the two
    stores' tag keys, so equal rows mean equal tag sets."""
    dst_sids = dst_store.series_ids_for_metric(metric_id)
    if len(dst_sids) == 0 or len(sids) == 0:
        return np.full(len(sids), -1, dtype=np.int64)
    _, src_triples = src_store.metric_index(metric_id).arrays()
    _, dst_triples = dst_store.metric_index(metric_id).arrays()
    kids = np.union1d(src_triples[:, 1], dst_triples[:, 1])
    a = TagMatrix.from_triples(sids, src_triples, kids).vids
    b = TagMatrix.from_triples(dst_sids, dst_triples, kids).vids
    labels, _ = compact_row_labels(np.concatenate([a, b], axis=0))
    la, lb = labels[:len(a)], labels[len(a):]
    order = np.argsort(lb, kind="stable")
    lb_sorted = lb[order]
    pos = np.minimum(np.searchsorted(lb_sorted, la), len(lb_sorted) - 1)
    return np.where(lb_sorted[pos] == la, dst_sids[order[pos]], -1)


def _common_tags(tags: TagMatrix, members: np.ndarray, uids
                 ) -> tuple[dict[str, str], list[str]]:
    """SpanGroup tag semantics for ONE group (ref: ``_common_tags``; the
    percentile paths' emission): ``tags`` are the k=v pairs every member
    series shares, ``aggregateTags`` the keys every member holds with
    differing values; a key some member lacks vanishes."""
    sub = tags.vids[members]
    out_tags: dict[str, str] = {}
    agg_tags: list[str] = []
    for j, kid in enumerate(tags.kids):
        col = sub[:, j]
        lo = int(col.min()) if len(col) else -1
        if lo < 0:
            continue
        kname = uids.tag_names.get_name(int(kid))
        if lo == int(col.max()):
            out_tags[kname] = uids.tag_values.get_name(lo)
        else:
            agg_tags.append(kname)
    return out_tags, agg_tags


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
        config = tsdb.config
        self.tsdb = tsdb
        self._filter_eval = filters_mod.FilterEvaluator(tsdb.uids)
        self._grid_reduce = config.get_bool("tsd.query.grid_reduce")
        self._budget = config.get_int("tsd.query.max_device_cells") \
            or DEFAULT_CELL_BUDGET
        # the request's QueryStats, set by run(); None records nothing
        self._stats: QueryStats | None = None

    # -- the device breaker, in its shedding mode --------------------

    def _device_degraded(self) -> bool:
        """True while the device breaker is open inside its reset window
        (ref: ``_device_degraded``); read-only: the half-open probe
        belongs to :meth:`_run_device`'s gate."""
        breaker = self.tsdb.device_breaker
        return breaker is not None and breaker.blocking()

    def _tail_device(self, s: int, b: int, num_groups: int,
                     emit_raw: bool, agg_name: str) -> torch.device | None:
        """:func:`host_tail_for_dims`, decided before any device call
        (ref: ``_tail_device``). An open breaker refuses the query with
        ``DegradedError``, as the reference does with
        ``tsd.query.degraded.host_fallback=false``: the port never pins
        a query to the host because the device failed."""
        if self._device_degraded():
            raise DegradedError(
                "device pipeline circuit breaker is open and host "
                "fallback is disabled (tsd.query.degraded.host_fallback)")
        return host_tail_for_dims(self.tsdb.config, s, b, num_groups,
                                  emit_raw, agg_name)

    def _run_device(self, compute, on_device: bool = True):
        """Run a tail under the device breaker (ref: ``_run_device`` with
        ``tsd.query.degraded.host_fallback=false``). ``compute`` must
        return host arrays, so an asynchronous device error surfaces
        inside it. An open breaker raises ``DegradedError`` and
        ``compute`` never runs; a failure is counted and raised; a
        success closes a half-open breaker. A host-placed tail
        (``on_device=False``) bypasses the breaker: a host success says
        nothing of the device."""
        if not on_device:
            return compute()
        breaker = self.tsdb.device_breaker
        if breaker is not None and not breaker.allow():
            raise DegradedError(
                "device pipeline circuit breaker is open and this query "
                "has no host fallback")
        try:
            self.tsdb.faults.check("device.compile")
            out = compute()
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return out

    # ---------------------------------------------------------------

    def run(self, ts_query: TSQuery,
            stats: QueryStats | None = None) -> list[QueryResult]:
        self._stats = stats
        subs = ts_query.queries
        if len(subs) > 1 and not ts_query.delete:
            # delete=true stays serial (ref): a sub's delete_range
            # removes points a parallel sibling may still be reading
            pool = self.tsdb.query_fanout_pool
            if pool is not None:
                return self._run_fanout(ts_query, subs, pool)
        results: list[QueryResult] = []
        for sub in subs:
            results.extend(self._run_sub_cached(ts_query, sub))
        return results

    def _run_fanout(self, tsq: TSQuery, subs,
                    pool) -> list[QueryResult]:
        """Run independent sub-queries in parallel and join (ref:
        ``_run_fanout``). Results concatenate in sub order whatever the
        completion order. The first sub runs on the calling thread. On
        an error, the earliest failing sub (in sub order) wins after
        every sibling has been joined: a running future must not
        outlive its TSQuery. The workers bind the request's trace
        context, so their spans land in its trace."""
        tctx = trace_mod.current()
        futures = [pool.submit(self._run_sub_traced, tctx, tsq, sub)
                   for sub in subs[1:]]
        results: list[QueryResult] = []
        first_err: BaseException | None = None
        try:
            results.extend(self._run_sub_cached(tsq, subs[0]))
        except BaseException as exc:  # noqa: BLE001 - raised below
            first_err = exc
        for fut in futures:
            try:
                out = fut.result()
            except BaseException as exc:  # noqa: BLE001 - raised below
                if first_err is None:
                    first_err = exc
            else:
                if first_err is None:
                    results.extend(out)
        if first_err is not None:
            raise first_err
        return results

    def _run_sub_traced(self, tctx, tsq: TSQuery,
                        sub: TSSubQuery) -> list[QueryResult]:
        """A fan-out worker's entry: bind the request's trace context on
        this thread (ref: ``_run_sub_traced``)."""
        with trace_mod.use(tctx):
            return self._run_sub_cached(tsq, sub)

    def _run_sub_timed(self, tsq: TSQuery,
                       sub: TSSubQuery) -> list[QueryResult]:
        """One engine execution under the ``query.execute`` span (ref:
        ``_run_sub_timed``): the scan, the pipeline and the assembly;
        cache hits never get here. A CUDA launch returns before its
        kernel runs, so this span holds the card's time: the pipeline's
        first host read of a result waits for it."""
        with trace_span("query.execute", sub=sub.index,
                        metric=sub.metric or "<tsuid>"):
            return self._run_sub(tsq, sub)

    def _run_sub_cached(self, tsq: TSQuery,
                        sub: TSSubQuery) -> list[QueryResult]:
        """One sub-query through the streaming lookup, then the result
        cache (ref: ``_run_sub_cached``). A registered tumbling
        continuous query answers its window from the maintained
        partials, fresher than any cache entry. The registry's own
        sheds (a failed rebuild, an open breaker, an unaligned end, a
        window outside the horizon) are its None; any exception out of
        it, a failure of the tail on the device included, propagates:
        the reference answers from the batch engine there, the port
        does not (ROADMAP Queue 3). Then a result-cache hit skips the
        engine; concurrent identical misses share one execution, and a
        failed one caches nothing."""
        streaming = self.tsdb._streaming
        if streaming is not None and not tsq.delete:
            with trace_span("query.streaming_lookup", sub=sub.index):
                served = streaming.try_serve(tsq, sub, self)
            if served is not None:
                if self._stats:
                    self._stats.add_stat(QueryStat.STREAMING_HIT, 1)
                return served
        cache = self.tsdb.result_cache
        if cache is None:
            return self._run_sub_timed(tsq, sub)
        plan = rc_mod.cache_plan(tsq, sub, self.tsdb.config)
        if plan is None:
            cache.count_bypass()
            return self._run_sub_timed(tsq, sub)
        key, ttl_ms = plan
        # captured before the compute: a write landing mid-execution
        # leaves the entry already stale instead of wrongly fresh
        version = self._sub_version(sub)
        value, outcome = cache.get_or_compute(
            key, version, lambda: self._run_sub_timed(tsq, sub), ttl_ms)
        stats = self._stats
        if stats and outcome != rc_mod.MISS:
            stats.add_stat(
                QueryStat.RESULT_CACHE_HIT if outcome == rc_mod.HIT
                else QueryStat.RESULT_CACHE_COALESCED, 1)
        if value and value[0].sub_query_index != sub.index:
            value = [r.with_sub_index(sub.index) for r in value]
        return value

    def _sub_version(self, sub: TSSubQuery) -> tuple:
        """The version of what a sub-query reads (ref: ``_sub_version``):
        the identity and write counters of the stores its plan selects,
        not the whole TSDB's, so an answer from a rollup tier keeps its
        cache entry while raw writes stream in. Selection is made again
        on every lookup, so a write that changes it (the first point of
        an empty tier) changes the version. The avg path may still move
        to the raw store when over budget: its version covers both. A
        percentile sub-query reads the histogram arenas and, through the
        sketch path, the scalar store. When selection itself fails, the
        whole TSDB's version (the query raises the same error). Results
        carry annotations, so every version holds the annotation
        store's (ref: ``_sub_version``'s ``ann``)."""
        t = self.tsdb
        ann = t.annotations.version
        if sub.percentiles:
            parts = ["hist", t._histogram_version,
                     *t.histogram_store.version, t.store.instance_id,
                     *t.store.version, ann]
            # the sketch path also reads the sketch tier and, through
            # it, the cold segments (ref: the sketch key parts)
            lc = t.lifecycle
            if lc is not None and lc.sketches is not None:
                cold = lc.coldstore
                parts += [lc.sketches.cells_folded,
                          lc.sketches.cells_spilled,
                          cold.mutation_epoch if cold is not None else 0]
            return tuple(parts)
        try:
            store, _mid, _sids, cnt_store, _fn = self._select_store(sub)
        except (BadRequestError, ValueError):
            return ("all", t.serve_version())
        parts = ["sel", ann, store.instance_id, *store.version]
        if cnt_store is not None:
            parts += [cnt_store.instance_id, *cnt_store.version,
                      t.store.instance_id, *t.store.version]
        return tuple(parts)

    def _select_store(self, sub: TSSubQuery):
        """Pick the raw store or a rollup tier (ref: ``_select_store``;
        TsdbQuery's best match :143-150 with the ROLLUP_USAGE fallback
        :750). Returns ``(store, metric_id, sids, count_store,
        ds_function)``: ``count_store`` is the count tier when an
        ``avg`` downsample is answered as sum tier over count tier, and
        ``ds_function`` replaces the downsample function where the
        tier's cells already carry the statistic (a ``count`` over the
        count tier sums the stored counts, ref: Downsampler.java:213),
        else None. A tier of a metric the lifecycle demoted is its
        stitched view (:meth:`_maybe_stitch`); while the metric's first
        demotion is in flight, the raw store, which still holds every
        point. A tsuid sub-query reads the raw store
        (:meth:`_tsuid_store`)."""
        if sub.tsuids:
            return self._tsuid_store(sub)
        try:
            metric_id = self.tsdb.uids.metrics.get_id(sub.metric)
        except LookupError:
            raise NoSuchMetricError(
                f"No such name for 'metrics': '{sub.metric}'") from None
        raw = store = self.tsdb.store
        cnt_store = ds_function = None
        usage = (sub.rollup_usage or "ROLLUP_NOFALLBACK").upper()
        rollups = self.tsdb.rollup_store
        ds = sub.ds_spec
        lc = self.tsdb.lifecycle
        lc_pin_raw = lc is not None and \
            lc.first_demotion_in_flight(metric_id)
        if rollups is not None and ds is not None and not ds.run_all \
                and usage != "ROLLUP_RAW" and not lc_pin_raw:
            tier = self.tsdb.rollup_config.best_match(ds.interval_ms)
            fn = ds.function

            def has_cold() -> bool:
                # cold segments are tier data: a tier whose RAM store
                # was spilled empty still wins selection (asked only
                # when the RAM tier holds nothing)
                return lc is not None and lc.has_cold(metric_id,
                                                      tier.interval)
            if tier is None:
                pass
            elif fn in ("sum", "count", "min", "max"):
                if rollups.has_data(tier.interval, fn) or has_cold():
                    store = self._maybe_stitch(
                        rollups.tier(tier.interval, fn), metric_id,
                        tier.interval, fn)
                    if fn == "count":
                        ds_function = "sum"
            elif fn == "avg" and (rollups.has_data(tier.interval, "sum")
                                  or has_cold()) \
                    and (rollups.has_data(tier.interval, "count")
                         or has_cold()):
                store = self._maybe_stitch(
                    rollups.tier(tier.interval, "sum"), metric_id,
                    tier.interval, "sum")
                cnt_store = self._maybe_stitch(
                    rollups.tier(tier.interval, "count"), metric_id,
                    tier.interval, "count")
        sids = store.series_ids_for_metric(metric_id)
        if store is not raw and len(sids) == 0 and \
                usage in ("ROLLUP_FALLBACK", "ROLLUP_FALLBACK_RAW"):
            store, cnt_store, ds_function = raw, None, None
            sids = raw.series_ids_for_metric(metric_id)
        return store, metric_id, sids, cnt_store, ds_function

    def _maybe_stitch(self, tier_store, metric_id: int, interval: str,
                      agg: str):
        """The lifecycle's stitched view of a selected tier store when
        the metric has a demotion boundary, else the tier store itself
        (ref: ``_maybe_stitch``)."""
        lc = self.tsdb.lifecycle
        if lc is None:
            return tier_store
        return lc.stitched(metric_id, interval, agg, tier_store) \
            or tier_store

    def _tsuid_store(self, sub: TSSubQuery):
        """Resolve a sub-query's tsuid hex strings to raw-store series
        (ref: ``_tsuid_store``): each is the metric UID then (tagk, tagv)
        UID pairs at the TSDB's widths. All must name one metric
        (else 400); a tsuid with no series is skipped. Returns what
        :meth:`_select_store` returns, the metric of the first tsuid."""
        uids = self.tsdb.uids
        store = self.tsdb.store
        mw = uids.metrics.width
        kw, vw = uids.tag_names.width, uids.tag_values.width
        sids = []
        metric_id = metric_name = None
        for tsuid in sub.tsuids:
            raw = bytes.fromhex(tsuid)
            mid = int.from_bytes(raw[:mw], "big")
            tags = []
            for pos in range(mw, len(raw), kw + vw):
                tags.append((int.from_bytes(raw[pos:pos + kw], "big"),
                             int.from_bytes(raw[pos + kw:pos + kw + vw],
                                            "big")))
            name = uids.metrics.get_name(mid)
            if metric_name is None:
                metric_id, metric_name = mid, name
            elif name != metric_name:
                raise BadRequestError(
                    "Multiple metrics in the same tsuid query")
            sid = store._key_to_sid.get((mid, tuple(sorted(tags))))
            if sid is not None:
                sids.append(sid)
        return (store, metric_id, np.asarray(sids, dtype=np.int64), None,
                None)

    def _run_percentiles(self, tsq: TSQuery,
                         sub: TSSubQuery) -> list[QueryResult]:
        """A percentile sub-query (ref: ``_run_sub``'s percentile
        branch): the histogram arena's rows spliced by group with the
        sketch rows (a scalar metric's three zones, or a histogram
        metric's spilled history; ``tsd.sketch.enable``)."""
        from opentsdb_tpu_torch.query.histogram_engine import \
            run_histogram_subquery
        from opentsdb_tpu_torch.sketch.query import (merge_pct_rows,
                                                     run_sketch_percentiles)
        sk_rows = run_sketch_percentiles(self.tsdb, tsq, sub,
                                         partials=tsq.sketch_partials)
        if tsq.sketch_partials:
            # a cluster router's scatter: the shard hands back mergeable
            # sketch partials, never extracted quantiles. Sketches off
            # 400 honestly: an empty partial would make the router's
            # merged answer silently wrong (ref)
            if sk_rows is None:
                raise BadRequestError(
                    "sketch partials requested but the sketch "
                    "subsystem is disabled (tsd.sketch.enable)")
            return sk_rows
        rows = run_histogram_subquery(self.tsdb, tsq, sub)
        if sk_rows is not None:
            rows = merge_pct_rows(rows, sk_rows)
        # the pixel budget applies to the assembled rows, as to every
        # other producer's (ref: the post-assembly pass over row.dps)
        px, px_fn = effective_pixels(tsq, sub)
        if px and not tsq.delete:
            for row in rows:
                row.dps_arrays = vd.reduce_arrays(
                    *row.dps_arrays, tsq.start_ms, tsq.end_ms, px, px_fn)
        return rows

    def _run_sub(self, tsq: TSQuery,
                 sub: TSSubQuery) -> list[QueryResult]:
        t0 = time.monotonic()
        stats = self._stats
        if sub.percentiles:
            return self._run_percentiles(tsq, sub)
        uids = self.tsdb.uids
        # the planning stage: store and tier selection, the filters and
        # the groups (ref: the ``query.plan`` span, ended at every exit;
        # on a raise it is not recorded and ``query.execute`` carries
        # the error)
        h_plan = trace_begin("query.plan", sub=sub.index)
        store, metric_id, sids, cnt_store, ds_function = \
            self._select_store(sub)
        if cnt_store is not None:
            # the sum/count divide holds [S, B] whole: an oversized range
            # reads raw data instead (the point path streams it), when
            # raw data exists (tiers may outlive their raw source)
            b_est = ((tsq.end_ms - tsq.start_ms)
                     // max(sub.ds_spec.interval_ms, 1)) + 2
            if len(sids) * b_est > self._budget:
                raw_sids = self.tsdb.store.series_ids_for_metric(metric_id)
                if len(raw_sids):
                    store, sids, cnt_store = self.tsdb.store, raw_sids, None
        if len(sids) == 0:
            trace_end(h_plan)
            return []
        if stats:
            stats.add_stat(QueryStat.ROWS_PRE_FILTER, len(sids))

        # --- filters -> series mask (ref: findSpans post-scan filters)
        sids, tag_mat = self._apply_filters(metric_id, sub, sids, store)
        if len(sids) == 0:
            trace_end(h_plan)
            return []
        if tsq.replica_sel is not None and sub.metric:
            # a replicated router's scatter: keep only the series whose
            # replica set this request was assigned, so each series is
            # read by exactly one replica cluster wide (ref)
            from opentsdb_tpu_torch.cluster import replica as replica_mod
            keep = replica_mod.store_series_mask(
                tsq.replica_sel, store, sub.metric, sids,
                tag_mat.kids, tag_mat.vids, uids.tag_names.get_names,
                uids.tag_values.get_names)
            if not keep.all():
                sids = sids[keep]
                tag_mat = tag_mat.select(keep)
            if len(sids) == 0:
                trace_end(h_plan)
                return []
        if stats:
            stats.add_stat(QueryStat.STRING_TO_UID_TIME,
                           (time.monotonic() - t0) * 1e3)
            stats.add_stat(QueryStat.ROWS_POST_FILTER, len(sids))
            stats.add_stat(QueryStat.UID_PAIRS_RESOLVED,
                           int((tag_mat.vids >= 0).sum()))

        # --- group construction (ref: GroupByAndAggregateCB :916)
        gb_kids = []
        for k in sorted({f.tagk for f in sub.filters if f.group_by}):
            try:
                gb_kids.append(uids.tag_names.get_id(k))
            except LookupError:
                trace_end(h_plan)
                return []
        group_ids, num_groups = self._group_ids(tag_mat, gb_kids)
        emit_raw = sub.agg.is_none
        if emit_raw:
            group_ids = np.arange(len(sids), dtype=np.int32)
            num_groups = len(sids)
        if h_plan is not None:
            h_plan.tag(series=len(sids), groups=num_groups)
        trace_end(h_plan)

        # --- avg from the sum and count tiers (ref: _avg_rollup_pipeline)
        if cnt_store is not None:
            out = self._avg_rollup_pipeline(store, cnt_store, metric_id,
                                            sids, tsq, sub, group_ids,
                                            num_groups, emit_raw)
            if out is None:
                return []
            return self._build_results(tsq, sub, metric_id, sids, tag_mat,
                                       group_ids, num_groups, *out)

        # --- storage-side grid reduction (ref: _grid_pipeline)
        out = self._grid_pipeline(store, metric_id, sids, tsq, sub,
                                  group_ids, num_groups, emit_raw,
                                  ds_function)
        if out is not None:
            result, emit, bucket_ts = out
            if result is None:
                return []
            return self._build_results(
                tsq, sub, metric_id, sids, tag_mat, group_ids,
                num_groups, bucket_ts, result, emit)

        # --- prepared-batch caches: a warm repeat of the same (store,
        # series, window, downsample) finds its batch on the device, or
        # in the host-RAM pool when its tail was host-placed
        mesh = self.tsdb.query_mesh
        cache = self.tsdb.device_grid_cache
        pkey = pver = None
        if cache is not None:
            pkey = ("prep", store.instance_id,
                    array_digest(np.ascontiguousarray(sids)),
                    tsq.start_ms, tsq.end_ms, sub.downsample or "union",
                    getattr(sub.ds_spec, "timezone", None),
                    # the query-level useCalendar aligns the same
                    # downsample string to other buckets
                    getattr(sub.ds_spec, "use_calendar", False), mesh,
                    _agg_class(sub.agg, num_groups, mesh))
            # no annotation version (ref: ``pver``): a hit rebuilds its
            # results through _build_results, which reads the notes anew
            pver = store.version
            # an open breaker skips the device pool (a hit would run on
            # the failing device); the host pool's hits stay valid
            hit = None if self._device_degraded() \
                else cache.get(pkey, pver)
            if hit is None:
                hcache = self.tsdb.host_prep_cache
                if hcache is not None:
                    hit = hcache.get(pkey, pver)
            if hit is not None:
                return self._run_prep_hit(hit, mesh, store, tsq, sub,
                                          metric_id, sids, tag_mat,
                                          group_ids, num_groups, emit_raw)

        # --- materialize + time grid
        t1 = time.monotonic()
        points = self._materialize_points(store, sids, tsq)
        num_points = points.num_points
        self._record_scan((time.monotonic() - t1) * 1e3, num_points,
                          len(sids))
        # byte / data-point guardrails (ref: SaltScanner budget
        # enforcement through QueryLimitOverride)
        self.tsdb.query_limits.check(self._metric_name(sub, metric_id),
                                     num_points)
        if num_points == 0:
            return []
        grid = self._time_grid(sub, tsq, points, ds_function)
        b = len(grid.bucket_ts)
        # the blocked verdict comes first: an over-budget range never
        # lands on the host (ref). A mesh raises the budget only where
        # every device truly holds S_loc x B_loc cells (mesh_scale)
        mesh_scale = mesh.size if mesh is not None and \
            sharded.mesh_memory_safe(sub.agg.name, num_groups, b) else 1
        blocked = not emit_raw and len(sids) * b > self._budget * mesh_scale
        # a mesh query never takes the host tail (ref)
        host_dev = None if blocked or mesh is not None else \
            self._tail_device(len(sids), b, num_groups, emit_raw,
                              sub.agg.name)
        spec = self._point_spec(sub, len(sids), num_groups, emit_raw,
                                grid.bucket_ts, grid.ds_function,
                                grid.fill_policy, grid.fill_value,
                                grid.complete, host=host_dev is not None)
        meta = {"bucket_ts": grid.bucket_ts,
                "ds_function": grid.ds_function,
                "fill_policy": grid.fill_policy,
                "fill_value": grid.fill_value,
                "complete": grid.complete, "num_points": num_points,
                "host": host_dev is not None}
        t2 = time.monotonic()
        if blocked:
            # a long range streams in time blocks (ref: the use_blocked
            # verdict), over the mesh when there is one: no prepared
            # batch is made or cached
            result, emit = self._run_device(lambda: self._run_blocked(
                grid, group_ids, spec, sub.rate_options, mesh=mesh,
                budget=self._budget * mesh_scale))
        elif mesh is not None:
            # the point batch cut over the ('series', 'time') mesh (ref:
            # the salt-scanner fan-out and merge as collectives); the
            # cut device arrays but the per-query group ids are cached,
            # so a warm repeat skips the materialize and the upload
            def mesh_compute():
                sbatch = sharded.prepare_sharded_batch(
                    *self._flat_points(grid), grid.bucket_ts, group_ids,
                    spec.num_series, spec.num_groups, mesh.shape["series"],
                    mesh.shape["time"])
                margs = sharded.sharded_device_args(mesh, sbatch,
                                                    self.tsdb.dtype)
                if cache is not None and pkey is not None:
                    cache.put(pkey, pver, margs[:4], {
                        **meta, "s_loc": sbatch.s_loc,
                        "b_loc": sbatch.b_loc,
                        "s_pad": sbatch.s_loc * mesh.shape["series"]})
                return sharded.run_sharded_device(
                    mesh, spec, margs, sbatch.s_loc, sbatch.b_loc,
                    num_groups, sub.rate_options)

            result, emit = self._run_device(mesh_compute)
        else:
            # a host-placed batch goes to the host-RAM pool, never the
            # device cache
            pool = self.tsdb.host_prep_cache if host_dev is not None \
                else cache

            def compute():
                prep = self._prepare_points(grid, spec, host_dev)
                if pool is not None and pkey is not None:
                    pool.put(pkey, pver, (prep,), meta)
                return _host(run_prepared(prep, grid.bucket_ts, group_ids,
                                          spec, sub.rate_options))

            result, emit = self._run_device(compute,
                                            on_device=host_dev is None)
        if stats:
            stats.add_stat(QueryStat.COMPUTE_TIME,
                           (time.monotonic() - t2) * 1e3)
        self._delete_read(tsq, store, sids)
        return self._build_results(
            tsq, sub, metric_id, sids, tag_mat, group_ids, num_groups,
            grid.bucket_ts, result, emit)

    @staticmethod
    def _delete_read(tsq: TSQuery, store, sids: np.ndarray) -> None:
        """``delete=true``: remove the window's points of the series
        the query read, once its compute succeeded (ref: the
        scanned-and-deleted semantics; the answer still carries them).
        The reference deletes before the cold paths' dispatch; here a
        failed dispatch deletes nothing. No WAL record is written, as
        in the reference: the delete is durable from the next snapshot
        on (ROADMAP Queue 3)."""
        if tsq.delete:
            store.delete_range(sids, tsq.start_ms, tsq.end_ms)

    @staticmethod
    def _materialize_points(store, sids: np.ndarray, tsq: TSQuery):
        """The window's points, row-padded unless the rows' lengths are
        too skewed (ref: the padded/flat choice of ``_run_sub``): a
        ``PaddedBatch`` or a flat ``PointBatch``."""
        counts = store.count_range(sids, tsq.start_ms, tsq.end_ms)
        total = int(counts.sum())
        cells = len(sids) * (int(counts.max()) if len(counts) else 0)
        if total > 0 and cells <= max(_PADDED_SKEW_FACTOR * total,
                                      _PADDED_MIN_CELLS) \
                and cells <= _PADDED_ABS_MAX_CELLS:
            return store.materialize_padded(sids, tsq.start_ms, tsq.end_ms)
        return store.materialize(sids, tsq.start_ms, tsq.end_ms)

    def _time_grid(self, sub: TSSubQuery, tsq: TSQuery, points,
                   ds_function: str | None = None) -> PointGrid:
        """Bucket the points of ``points`` (a ``PaddedBatch`` or a
        ``PointBatch``): the downsample's fixed or calendar buckets,
        reduced by ``ds_function`` when given (a rollup tier's), or
        without a downsample the union of distinct timestamps, one
        point per (series, timestamp)."""
        padded = points if isinstance(points, store_mod.PaddedBatch) \
            else None
        batch = None if padded is not None else points
        complete = False
        if sub.ds_spec is not None:
            ds = sub.ds_spec
            if padded is not None:
                bidx, bts = ds_mod.assign_buckets_padded(
                    padded.ts2d, padded.counts, ds, tsq.start_ms,
                    tsq.end_ms)
            else:
                bidx, bts = ds_mod.assign_buckets(batch.ts_ms, ds,
                                                  tsq.start_ms, tsq.end_ms)
            return PointGrid(padded, batch, bidx, bts,
                             ds_function or ds.function, ds.fill_policy,
                             ds.fill_value, complete)
        if padded is not None:
            bidx, bts, complete = self._union_grid(padded)
        else:
            bts, bidx = _distinct(batch.ts_ms)
        return PointGrid(padded, batch, bidx, bts, "sum",
                         ds_mod.FillPolicy.NONE, float("nan"), complete)

    @staticmethod
    def _point_spec(sub: TSSubQuery, num_series: int, num_groups: int,
                    emit_raw: bool, bucket_ts: np.ndarray,
                    ds_function: str, fill_policy, fill_value: float,
                    complete: bool, host: bool = False) -> PipelineSpec:
        return PipelineSpec(
            num_series=num_series, num_buckets=len(bucket_ts),
            num_groups=num_groups, ds_function=ds_function,
            agg_name=sub.agg.name, fill_policy=fill_policy,
            fill_value=fill_value, rate=sub.rate,
            rate_counter=sub.rate_options.counter,
            rate_drop_resets=sub.rate_options.drop_resets,
            emit_raw=emit_raw, host=host,
            # drop_resets punches holes per series after the downsample
            complete=complete
            and not (sub.rate and sub.rate_options.drop_resets))

    @staticmethod
    def _flat_points(grid: PointGrid
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The points of ``grid`` as a flat (values, series_idx,
        bucket_idx) batch in (series, time) order; a padded batch is
        flattened."""
        if grid.padded is not None:
            return flatten_padded(grid.padded.values2d, grid.bucket_idx,
                                  grid.padded.counts)
        return grid.batch.values, grid.batch.series_idx, grid.bucket_idx

    def _run_blocked(self, grid: PointGrid, group_ids: np.ndarray,
                     spec: PipelineSpec, rate_options, stages=None,
                     mesh=None, budget: int | None = None):
        """Stream the points of ``grid`` in time blocks of at most
        ``budget`` cells (by default the cell budget) -> host (result,
        emit): over ``mesh`` when given
        (``parallel.sharded_pipeline.execute_blocked_sharded``), else on
        the TSDB's device (``ops.blocked.execute_blocked``)."""
        bb = pick_block_buckets(spec.num_series, spec.num_buckets,
                                budget or self._budget)
        if mesh is not None:
            return sharded.execute_blocked_sharded(
                mesh, *self._flat_points(grid), grid.bucket_ts, group_ids,
                spec, rate_options, dtype=self.tsdb.dtype,
                block_buckets=bb)
        return execute_blocked(
            *self._flat_points(grid), grid.bucket_ts, group_ids,
            spec, rate_options, dtype=self.tsdb.dtype,
            device=self.tsdb.device, stages=stages, block_buckets=bb)

    def _prepare_points(self, grid: PointGrid, spec: PipelineSpec,
                        device=None):
        """Upload a sub-query's points as a prepared batch in the
        layout the reference would pick (``prepare_auto`` or
        ``prepare_flat``), to ``device`` (the host for a host-placed
        tail) or else the TSDB's device."""
        dev, dtype = device or self.tsdb.device, self.tsdb.dtype
        if grid.padded is not None:
            return prepare_auto(grid.padded, grid.bucket_idx, spec,
                                dtype=dtype, device=dev)
        return prepare_flat(grid.batch.values, grid.batch.series_idx,
                            grid.bucket_idx, spec, dtype=dtype,
                            device=dev)

    def _run_prep_hit(self, hit, mesh, store, tsq: TSQuery,
                      sub: TSSubQuery, metric_id: int, sids: np.ndarray,
                      tag_mat: "TagMatrix", group_ids: np.ndarray,
                      num_groups: int, emit_raw: bool
                      ) -> list[QueryResult]:
        """Serve one sub-query from a warm prepared batch of either pool
        (ref: ``_run_prep_hit``); under ``mesh`` the entry is the cut
        point batch, and only the per-query group ids upload. A failure
        raises: the reference re-runs a failed warm hit cold, which is a
        fallback the port does not have."""
        cached, meta = hit
        bucket_ts = meta["bucket_ts"]
        num_points = meta["num_points"]
        self.tsdb.query_limits.check(self._metric_name(sub, metric_id),
                                     num_points)
        t2 = time.monotonic()
        spec = self._point_spec(sub, len(sids), num_groups, emit_raw,
                                bucket_ts, meta["ds_function"],
                                meta["fill_policy"], meta["fill_value"],
                                meta["complete"], host=meta["host"])
        if mesh is not None:
            def mesh_compute():
                gids = sharded.sharded_grid_gids(mesh, group_ids,
                                                 meta["s_pad"], num_groups)
                return sharded.run_sharded_device(
                    mesh, spec, tuple(cached) + (gids,), meta["s_loc"],
                    meta["b_loc"], num_groups, sub.rate_options)

            result, emit = self._run_device(mesh_compute)
        else:
            (prep,) = cached
            result, emit = self._run_device(
                lambda: _host(run_prepared(prep, bucket_ts, group_ids, spec,
                                           sub.rate_options)),
                on_device=not spec.host)
        # stats and the delete only after the dispatch succeeded
        stats = self._stats
        if stats:
            stats.add_stat(QueryStat.DPS_POST_FILTER, num_points)
            stats.add_stat(QueryStat.COMPUTE_TIME,
                           (time.monotonic() - t2) * 1e3)
        self._delete_read(tsq, store, sids)
        return self._build_results(
            tsq, sub, metric_id, sids, tag_mat, group_ids, num_groups,
            bucket_ts, result, emit)

    def _metric_name(self, sub: TSSubQuery, metric_id: int) -> str:
        """The sub-query's metric, or the one its tsuids name."""
        return sub.metric or self.tsdb.uids.metrics.get_name(metric_id)

    def _grid_eligible(self, sub: TSSubQuery) -> bool:
        spec = sub.ds_spec
        return (self._grid_reduce and spec is not None
                and not spec.run_all and not spec.use_calendar
                and spec.unit not in ("n", "y")
                and spec.function in _GRID_FNS and spec.interval_ms > 0)

    def _grid_pipeline(self, store, metric_id: int, sids: np.ndarray,
                       tsq: TSQuery, sub: TSSubQuery, group_ids: np.ndarray,
                       num_groups: int, emit_raw: bool,
                       ds_function: str | None = None):
        """Storage-side downsample (ref: ``_grid_pipeline``): the store
        reduces the window to the ``[S, B]`` grid of the downsample
        function (or of ``ds_function``, a rollup tier's), and only the
        fill/rate/interpolate/aggregate tail runs, on the host CPU when
        the grid is small (:meth:`_tail_device`), else on the device,
        where the grid is uploaded once and cached; under a mesh, over
        the mesh on the grid cut and cached there, never on the host.
        Returns None when the query is not eligible or its grid exceeds
        the cell budget (the point path takes it), else (result, emit,
        bucket_ts) with result None when the window holds no point."""
        if not self._grid_eligible(sub):
            return None
        ds_spec = sub.ds_spec
        bucket_ts = ds_mod.fixed_bucket_edges(
            tsq.start_ms, tsq.end_ms, ds_spec.interval_ms)
        b = len(bucket_ts)
        if len(sids) * b > self._budget:
            return None
        fn = ds_function or ds_spec.function
        mesh = self.tsdb.query_mesh
        host_dev = None if mesh is not None else self._tail_device(
            len(sids), b, num_groups, emit_raw, sub.agg.name)
        # a host tail skips the device cache: its store re-scan is
        # cheap, and host entries must not evict the card's grids
        cache = self.tsdb.device_grid_cache if host_dev is None else None
        hit = None
        if cache is not None:
            ckey = grid_cache_key(store, sids, tsq.start_ms, tsq.end_ms,
                                  bucket_ts, ds_spec.interval_ms, fn, mesh)
            cver = store.version
            hit = cache.get(ckey, cver)
        t1 = time.monotonic()
        if hit is not None:
            cached, meta = hit
            num_points = meta["num_points"]
        else:
            sums, cnts, mins, maxs = store.bucket_reduce(
                sids, tsq.start_ms, tsq.end_ms, int(bucket_ts[0]),
                ds_spec.interval_ms, b,
                want_minmax=fn in ("min", "mimmin", "max", "mimmax"))
            num_points = int(cnts.sum())
        self._record_scan((time.monotonic() - t1) * 1e3, num_points,
                          len(sids))
        self.tsdb.query_limits.check(self._metric_name(sub, metric_id),
                                     num_points)
        if num_points == 0:
            self._delete_read(tsq, store, sids)
            return None, None, bucket_ts
        t2 = time.monotonic()
        spec = PipelineSpec(
            num_series=len(sids), num_buckets=b, num_groups=num_groups,
            # the tail never reads it: downsampling happened in the store
            ds_function="avg", agg_name=sub.agg.name,
            fill_policy=ds_spec.fill_policy,
            fill_value=ds_spec.fill_value, rate=sub.rate,
            rate_counter=sub.rate_options.counter,
            rate_drop_resets=sub.rate_options.drop_resets,
            emit_raw=emit_raw, host=host_dev is not None)

        def compute():
            if hit is not None:
                dgrid, dhas = cached
            else:
                dgrid, dhas = put_grid(
                    *grid_from_reduce(fn, sums, cnts, mins, maxs),
                    self.tsdb.dtype, host_dev or self.tsdb.device)
                if cache is not None:
                    cache.put(ckey, cver, (dgrid, dhas),
                              {"num_points": num_points})
            return _host(execute_grid(dgrid, dhas, bucket_ts, group_ids,
                                      spec, sub.rate_options))

        def mesh_compute():
            # the grid tail straight on the mesh (no flatten back to
            # points); the cut grids are cached, the group ids are not
            if hit is not None:
                data_args = cached
                s_loc, b_loc, s_pad = (meta["s_loc"], meta["b_loc"],
                                       meta["s_pad"])
            else:
                data_args, s_loc, b_loc, s_pad = \
                    sharded.prepare_sharded_grid(
                        mesh, *grid_from_reduce(fn, sums, cnts, mins, maxs),
                        bucket_ts, self.tsdb.dtype)
                if cache is not None:
                    cache.put(ckey, cver, data_args,
                              {"num_points": num_points, "s_loc": s_loc,
                               "b_loc": b_loc, "s_pad": s_pad})
            gids = sharded.sharded_grid_gids(mesh, group_ids, s_pad,
                                             num_groups)
            return sharded.run_sharded_grid(
                mesh, spec, tuple(data_args) + (gids,), s_loc, b_loc,
                num_groups, sub.rate_options)

        if mesh is not None:
            compute = mesh_compute

        result, emit = self._run_device(compute,
                                        on_device=host_dev is None)
        if self._stats:
            self._stats.add_stat(QueryStat.COMPUTE_TIME,
                                 (time.monotonic() - t2) * 1e3)
        self._delete_read(tsq, store, sids)
        return result, emit, bucket_ts

    def _avg_rollup_pipeline(self, sum_store, cnt_store, metric_id: int,
                             sids: np.ndarray, tsq: TSQuery,
                             sub: TSSubQuery, group_ids: np.ndarray,
                             num_groups: int, emit_raw: bool):
        """An ``avg`` downsample from the rollup tiers (ref:
        ``_avg_rollup_pipeline``): the bucketed sum tier over the
        bucketed count tier, the true weighted average and not a mean of
        the tiers' averages (ref: RollupSpan reading the sum and count
        qualifiers of one row). A fixed interval reduces both tiers in
        the store; its divide and tail run on the host CPU when the grid
        is small (:meth:`_tail_device`), else on the device, which keeps
        both grids in its cache. Any other downsample materializes the
        tiers' points and buckets them on the device. Under a mesh the
        divide runs on the host and the tail over the mesh, uncached.
        Returns (bucket_ts, result, emit), or None when the window holds
        no point."""
        t1 = time.monotonic()
        dtype = self.tsdb.dtype
        mesh = self.tsdb.query_mesh
        start, end = tsq.start_ms, tsq.end_ms
        ds = sub.ds_spec
        host_dev = None
        csids = present = None

        def align():
            """The count tier's series of each sum tier series (-1: none)
            and the rows that have one; a cache hit needs neither."""
            nonlocal csids, present
            if csids is None:
                csids = _match_series_by_tags(sum_store, cnt_store, sids,
                                              metric_id)
                present = np.flatnonzero(csids >= 0)
            return csids, present

        fixed = (not ds.run_all and not ds.use_calendar
                 and ds.unit not in ("n", "y") and ds.interval_ms > 0)
        if fixed:
            bucket_ts = ds_mod.fixed_bucket_edges(start, end, ds.interval_ms)
            s, b = len(sids), len(bucket_ts)
            t0_ms = int(bucket_ts[0])
            # a mesh query never takes the host tail (ref)
            host_dev = None if mesh is not None else self._tail_device(
                s, b, num_groups, emit_raw, sub.agg.name)
            # a host tail skips the device cache (see _grid_pipeline),
            # and so does the mesh's host-side divide
            cache = self.tsdb.device_grid_cache \
                if mesh is None and host_dev is None else None
            hit = None
            if cache is not None:
                ckey = ("avgdiv", sum_store.instance_id,
                        cnt_store.instance_id,
                        array_digest(np.ascontiguousarray(sids)), start, end,
                        t0_ms, ds.interval_ms, b)
                cver = (*sum_store.version, *cnt_store.version)
                hit = cache.get(ckey, cver)
            if hit is not None:
                (gs, gc), meta = hit
                num_points = meta["num_points"]
            else:
                csids, present = align()
                sum_s, cnt_s, _, _ = sum_store.bucket_reduce(
                    sids, start, end, t0_ms, ds.interval_ms, b)
                sum_c, cnt_c = np.zeros((s, b)), np.zeros((s, b))
                if len(present):
                    sum_c[present], cnt_c[present], _, _ = \
                        cnt_store.bucket_reduce(csids[present], start, end,
                                                t0_ms, ds.interval_ms, b)
                num_points = int(cnt_s.sum() + cnt_c.sum())
                sum_s[cnt_s == 0] = np.nan
                sum_c[cnt_c == 0] = np.nan
        else:
            csids, present = align()
            batch_s = sum_store.materialize(sids, start, end)
            batch_c = cnt_store.materialize(csids[present], start, end)
            num_points = batch_s.num_points + batch_c.num_points
        self._record_scan((time.monotonic() - t1) * 1e3, num_points,
                          len(sids))
        self.tsdb.query_limits.check(self._metric_name(sub, metric_id),
                                     num_points)
        if num_points == 0 or (not fixed and batch_s.num_points == 0):
            self._delete_avg(tsq, sum_store, cnt_store, sids, align)
            return None
        t2 = time.monotonic()
        dev = host_dev or self.tsdb.device
        if not fixed:
            bidx_s, bucket_ts = ds_mod.assign_buckets(batch_s.ts_ms, ds,
                                                      start, end)
            bidx_c, _ = ds_mod.assign_buckets(batch_c.ts_ms, ds, start, end)
            s, b = len(sids), len(bucket_ts)
        spec = PipelineSpec(
            num_series=s, num_buckets=b, num_groups=num_groups,
            ds_function="avg", agg_name=sub.agg.name,
            fill_policy=ds.fill_policy, fill_value=ds.fill_value,
            rate=sub.rate, rate_counter=sub.rate_options.counter,
            rate_drop_resets=sub.rate_options.drop_resets,
            emit_raw=emit_raw, host=host_dev is not None)

        def tier_grids():
            """The two tiers' points bucketed on the device (a
            downsample the store does not reduce)."""
            def grid_of(values, series_idx, bucket_idx):
                return ds_mod.bucketize(
                    upload(values, dtype, dev),
                    torch.from_numpy(series_idx.astype(np.int32)).to(dev),
                    torch.from_numpy(bucket_idx.astype(np.int32)).to(dev),
                    s, b, "sum")[0]

            return (grid_of(batch_s.values, batch_s.series_idx, bidx_s),
                    grid_of(batch_c.values, present[batch_c.series_idx],
                            bidx_c))

        def mesh_compute():
            # the divide on the host, then the tail over the mesh with
            # one point per present cell (bucketizing a one-point cell
            # gives the cell back exactly)
            if fixed:
                gs, gc = torch.from_numpy(sum_s), torch.from_numpy(sum_c)
            else:
                gs, gc = (g.cpu() for g in tier_grids())
            avg, valid = avg_divide_grid(gs, gc)
            sidx2, bidx2 = np.nonzero(valid.numpy())
            return self._mesh_execute(
                mesh, spec, avg.numpy()[sidx2, bidx2],
                sidx2.astype(np.int32), bidx2.astype(np.int32), bucket_ts,
                group_ids, sub.rate_options)

        def compute():
            if not fixed:
                dgs, dgc = tier_grids()
            elif hit is not None:
                dgs, dgc = gs, gc
            else:
                dgs, dgc = upload(sum_s, dtype, dev), upload(sum_c, dtype,
                                                             dev)
                if cache is not None:
                    cache.put(ckey, cver, (dgs, dgc),
                              {"num_points": num_points})
            return _host(execute_avg_divide(dgs, dgc, bucket_ts, group_ids,
                                            spec, sub.rate_options))

        result, emit = self._run_device(
            compute if mesh is None else mesh_compute,
            on_device=host_dev is None)
        if self._stats:
            self._stats.add_stat(QueryStat.COMPUTE_TIME,
                                 (time.monotonic() - t2) * 1e3)
        self._delete_avg(tsq, sum_store, cnt_store, sids, align)
        return bucket_ts, result, emit

    def _mesh_execute(self, mesh, spec: PipelineSpec, values: np.ndarray,
                      series_idx: np.ndarray, bucket_idx: np.ndarray,
                      bucket_ts: np.ndarray, group_ids: np.ndarray,
                      rate_options):
        """Run one sub-query's compute over the mesh (ref:
        ``_mesh_execute``; the series axis as the salt buckets,
        SaltScanner.java:70, the time axis as long-range blocking) ->
        host (result, emit)."""
        batch = sharded.prepare_sharded_batch(
            values, series_idx, bucket_idx, bucket_ts, group_ids,
            spec.num_series, spec.num_groups, mesh.shape["series"],
            mesh.shape["time"])
        return sharded.run_sharded(mesh, spec, batch, rate_options,
                                   dtype=self.tsdb.dtype)

    @staticmethod
    def _delete_avg(tsq: TSQuery, sum_store, cnt_store, sids: np.ndarray,
                    align) -> None:
        """``delete=true`` on the avg path: both tiers' points of the
        window (ref: the sum and the aligned count series)."""
        if tsq.delete:
            csids, present = align()
            sum_store.delete_range(sids, tsq.start_ms, tsq.end_ms)
            cnt_store.delete_range(csids[present], tsq.start_ms, tsq.end_ms)

    def _record_scan(self, ms: float, num_points: int, n_rows: int
                     ) -> None:
        """Storage-scan stat points (ref: the per-scanner stats block,
        QueryStats.java:137-151): "storage" is the host column store, a
        column is a stored point, a row a series."""
        stats = self._stats
        if not stats:
            return
        stats.add_stat(QueryStat.MATERIALIZE_TIME, ms)
        stats.add_stat(QueryStat.QUERY_SCAN_TIME, ms)
        stats.add_stat(QueryStat.HBASE_TIME, ms)
        stats.add_stat(QueryStat.DPS_POST_FILTER, num_points)
        stats.add_stat(QueryStat.COLUMNS_FROM_STORAGE, num_points)
        stats.add_stat(QueryStat.ROWS_FROM_STORAGE, n_rows)
        # 17 bytes per stored point, the reference's count (int64 ts +
        # float64 value + int flag)
        stats.add_stat(QueryStat.BYTES_FROM_STORAGE, num_points * 17)
        stats.add_stat(QueryStat.SUCCESSFUL_SCAN, 1)

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
        # the union of the points' timestamps: pad sentinels make no slot
        bucket_ts, inverse = _distinct(padded.ts2d[~pad])
        bucket_idx2d = np.full(padded.ts2d.shape, -1, dtype=np.int32)
        bucket_idx2d[~pad] = inverse
        return bucket_idx2d, bucket_ts, False

    def _apply_filters(self, metric_id: int, sub: TSSubQuery,
                       sids: np.ndarray, store=None
                       ) -> tuple[np.ndarray, TagMatrix]:
        """The series of ``sids`` (ids of ``store``, by default the raw
        store) that pass the sub-query's filters, and their tags."""
        store = store if store is not None else self.tsdb.store
        if sub.tsuids:
            # a tsuid query names few series: read their identities
            rows = [(int(sid), kid, vid) for sid in sids
                    for kid, vid in store.series(int(sid)).tags]
            triples = (np.asarray(rows, dtype=np.int64).reshape(-1, 3)
                       if rows else np.empty((0, 3), dtype=np.int64))
            tags = TagMatrix.from_triples(sids, triples)
        else:
            idx_sids, triples = store.metric_index(metric_id).arrays()
            # per-(store, metric) matrix cache (ref: engine.py:1784):
            # the index is append-only, so its series count versions
            # the entry; only the metric's whole series array is cached
            tm_cache = self.tsdb._tagmat_cache
            tm_key = (store.instance_id, metric_id)
            hit = tm_cache.get(tm_key)
            if hit is not None and hit[0] == len(idx_sids) \
                    and sids is idx_sids:
                tags = hit[1]
            else:
                tags = TagMatrix.from_triples(sids, triples)
                if sids is idx_sids:
                    tm_cache[tm_key] = (len(idx_sids), tags)
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

    def _annotated_members(self, metric_id: int, tags: TagMatrix,
                           group_ids: np.ndarray) -> dict[int, list[str]]:
        """The hex TSUIDs of the members that carry annotations, by
        group, each group's in member order (ref: ``_build_results``,
        which looks each member's TSUID up). Found from the annotated
        TSUIDs, not from every member: each is decoded to its tag pairs,
        hashed as a row of ``tags`` would be, matched in one pass over
        the rows and checked pair by pair."""
        uids = self.tsdb.uids
        mw, kw, vw = (uids.metrics.width, uids.tag_names.width,
                      uids.tag_values.width)
        kids = tags.kids
        # one odd 64-bit multiplier per tag key column
        mult = (np.arange(len(kids), dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15) + np.uint64(0x632BE59BD9B4E019)) \
            | np.uint64(1)
        wanted: dict[int, tuple] = {}
        for tsuid in self.tsdb.annotations.tsuids():
            raw = bytes.fromhex(tsuid)
            if int.from_bytes(raw[:mw], "big") != metric_id:
                continue
            pairs = tuple(sorted(
                (int.from_bytes(raw[p:p + kw], "big"),
                 int.from_bytes(raw[p + kw:p + kw + vw], "big"))
                for p in range(mw, len(raw), kw + vw)))
            cols = np.searchsorted(kids, [k for k, _ in pairs])
            if any(c >= len(kids) or kids[c] != k
                   for c, (k, _) in zip(cols.tolist(), pairs)):
                continue
            h = 0
            for c, (_, v) in zip(cols.tolist(), pairs):
                h = (h + (v + 1) * int(mult[c])) & 0xFFFFFFFFFFFFFFFF
            wanted.setdefault(h, []).append((pairs, tsuid))
        if not wanted:
            return {}
        with np.errstate(over="ignore"):
            row_h = ((tags.vids + 1).astype(np.uint64)
                     * mult[None, :]).sum(axis=1, dtype=np.uint64)
        rows = np.flatnonzero(np.isin(row_h, np.fromiter(
            wanted, dtype=np.uint64, count=len(wanted))))
        out: dict[int, list[str]] = {}
        for r in rows.tolist():
            pairs = tuple(sorted(tags.tags_of(r)))
            for want, tsuid in wanted[int(row_h[r])]:
                if want == pairs:
                    out.setdefault(int(group_ids[r]), []).append(tsuid)
        return out

    def _build_results(self, tsq: TSQuery, sub: TSSubQuery,
                       metric_id: int, sids: np.ndarray, tags: TagMatrix,
                       group_ids: np.ndarray, num_groups: int,
                       bucket_ts: np.ndarray, result: np.ndarray,
                       emit: np.ndarray) -> list[QueryResult]:
        """The result rows, under the ``query.assemble`` span (ref:
        ``_build_results``)."""
        with trace_span("query.assemble", sub=sub.index,
                        groups=num_groups,
                        pixels=effective_pixels(tsq, sub)[0]):
            return self._build_results_inner(
                tsq, sub, metric_id, sids, tags, group_ids, num_groups,
                bucket_ts, result, emit)

    def _build_results_inner(self, tsq: TSQuery, sub: TSSubQuery,
                             metric_id: int, sids: np.ndarray,
                             tags: TagMatrix, group_ids: np.ndarray,
                             num_groups: int, bucket_ts: np.ndarray,
                             result: np.ndarray, emit: np.ndarray
                             ) -> list[QueryResult]:
        uids = self.tsdb.uids
        out: list[QueryResult] = []
        emit = emit.astype(bool)
        # the pixel budget: the last stage, a keep mask over what the
        # pipeline emitted (ref: the visual_downsample pass), keyed off
        # the requesting sub-query
        px, px_fn = effective_pixels(tsq, sub)
        if px and not tsq.delete:
            keep = vd.keep_mask(np.asarray(result), emit,
                                np.asarray(bucket_ts), tsq.start_ms,
                                tsq.end_ms, px, px_fn)
            if keep is not None:
                emit = emit & keep
        metric = self._metric_name(sub, metric_id)
        notes = self.tsdb.annotations
        start_s, end_s = tsq.start_ms // 1000, tsq.end_ms // 1000
        noted = self._annotated_members(metric_id, tags, group_ids) \
            if not tsq.no_annotations and notes.has_any() else {}
        global_annotations = notes.global_range(start_s, end_s) \
            if tsq.global_annotations else []
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
            if tsq.show_tsuids or sub.tsuids:
                tsuids = [uids.tsuid(metric_id, tags.tags_of(m))
                          .hex().upper() for m in members]
            annotations = []
            for tsuid in noted.get(gid, ()):
                annotations.extend(notes.range(tsuid, start_s, end_s))
            out.append(QueryResult(
                metric=metric, tags=g_tags, aggregated_tags=agg_tags,
                dps_arrays=(e_ts[lo_e:hi_e], e_vals[lo_e:hi_e]),
                tsuids=tsuids, sub_query_index=sub.index,
                annotations=annotations,
                global_annotations=global_annotations))
        return out
