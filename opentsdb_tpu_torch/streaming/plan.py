"""Shared incremental window state + per-query views (ref:
``opentsdb_tpu/streaming/plan.py``).

Two layers:

- :class:`SharedPartial` — ONE ring of per-series sum/count/min/max
  partials per canonical sub-plan identity ``(metric, membership
  filters, base downsample interval)``. Every continuous query over
  the same metric whose filters match and whose downsample interval
  is a multiple of the base attaches to the same array, so one
  vectorized scatter fold (:mod:`opentsdb_tpu_torch.ops.stream_fold`)
  serves N dashboards. The ingest tap is an O(1) columnar append
  into the partial's pending buffer (its own small lock, never the
  fold lock); folding happens off-path on the shared worker pool
  (:mod:`opentsdb_tpu_torch.streaming.workers`) or lazily at serve
  time.
- :class:`PlanView` — one per registered sub-query: derives its
  downsampled grid from the shared channels (stride combine for
  divisible intervals), applies its window type (tumbling, sliding,
  session-gap — view-time combines over the tumbling partials, the
  same sum/count/min/max decomposition the rollup tiers use), then
  runs ONLY the existing fill/rate/interpolate/aggregate tail
  (:func:`opentsdb_tpu_torch.ops.pipeline.execute_grid`) where the
  batch engine would place the same tail: on the host CPU under the
  host-tail budget, else on the TSDB's query device (the reference pins
  it to the host CPU whatever its size). Tumbling views
  stay value-identical to a cold batch ``/api/query`` over the same
  bucket-aligned range; sliding/session views are push/fetch
  surfaces (they are not expressible as a plain TSQuery).

Bootstrap seeds the ring with one ``bucket_reduce`` pass over the raw
store. When the horizon reaches behind the metric's lifecycle demotion
boundary and a rollup tier nests in the base interval, the
pre-boundary part comes channel-wise from the stitched tier views
(cold segments, RAM tier, raw tail; :meth:`SharedPartial.
_seed_tier_views`), and folds drop later backfills behind that
boundary (stitched batch reads ignore them too). The sketch channel
seeds from the three sketch zones the same way.

Windows live in a ring of ``n_windows`` columns keyed by
``(bucket_ts // interval) % n_windows``; a point landing in a newer
bucket than a column holds tumbles that column (reset + re-key), and
points older than the ring's horizon are dropped and counted (they
can no longer affect any servable window).
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import stream_fold
from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec, execute_grid,
                                             grid_from_reduce, put_grid)
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query.engine import host_tail_for_dims
from opentsdb_tpu_torch.query.model import BadRequestError, TSSubQuery
from opentsdb_tpu_torch.utils import datetime_util

# downsample functions whose bucket statistic decomposes into the
# sum/count/min/max partials this plan maintains (avg = sum / count) —
# mirrors the rollup tier decomposition AND the engine's _GRID_FNS, so
# every continuous query is also batch-grid-eligible
DECOMPOSABLE_DS = frozenset(("sum", "zimsum", "pfsum", "count", "min",
                             "mimmin", "max", "mimmax", "avg"))

_GROW = 64  # initial / doubling row capacity for the partial arrays
# the per-statistic tier stores a tier seed reads
_TIER_AGGS = ("sum", "count", "min", "max")

WINDOW_KINDS = ("tumbling", "sliding", "hopping", "session")


class WindowSpec:
    """Window type of one continuous query: tumbling (default),
    sliding (``{"type": "sliding", "size": "5m"}`` — size must be a
    multiple of the downsample interval; each emitted bucket
    aggregates the trailing ``size`` of history, sliding by one
    interval), hopping (``{"type": "hopping", "size": "10m",
    "slide": "5m"}`` — the sliding combine emitting only every
    ``slide``-aligned bucket; slide > interval generalizes the
    sliding view's slide == interval) or session-gap
    (``{"type": "session", "gap": "2m"}`` — gap must be a multiple
    of the interval; buckets closer than the gap merge into one
    session stamped at its first bucket; an optional ``"by"`` tag
    key folds sessions PER TAG VALUE over one shared partial — the
    millions-of-users scenario, :mod:`opentsdb_tpu_torch.streaming.
    eventtime.sessions`)."""

    __slots__ = ("kind", "size_ms", "gap_ms", "slide_ms", "by_tag")

    def __init__(self, kind: str = "tumbling", size_ms: int = 0,
                 gap_ms: int = 0, slide_ms: int = 0,
                 by_tag: str | None = None):
        self.kind = kind
        self.size_ms = int(size_ms)
        self.gap_ms = int(gap_ms)
        self.slide_ms = int(slide_ms)
        self.by_tag = by_tag

    @classmethod
    def from_json(cls, obj, interval_ms: int) -> "WindowSpec":
        """Validate one ``window`` object against a sub-query's
        downsample interval; raises :class:`BadRequestError`."""
        if obj in (None, {}):
            return cls()
        if not isinstance(obj, dict):
            raise BadRequestError("window must be an object")
        kind = str(obj.get("type", "tumbling"))
        if kind not in WINDOW_KINDS:
            raise BadRequestError(
                f"unknown window type {kind!r} "
                f"(supported: {', '.join(WINDOW_KINDS)})")

        def duration(key: str) -> int:
            raw = obj.get(key)
            if not raw:
                raise BadRequestError(
                    f"{kind} window requires {key!r} (e.g. \"5m\")")
            try:
                ms = datetime_util.parse_duration_ms(str(raw))
            except ValueError as e:
                raise BadRequestError(str(e)) from None
            if ms <= 0 or ms % interval_ms:
                raise BadRequestError(
                    f"window {key} {raw!r} must be a positive "
                    f"multiple of the downsample interval "
                    f"({interval_ms} ms)")
            return ms

        if kind == "sliding":
            size = duration("size")
            if size <= interval_ms:
                raise BadRequestError(
                    "sliding window size must exceed the downsample "
                    "interval (equal would be tumbling)")
            return cls("sliding", size_ms=size)
        if kind == "hopping":
            size = duration("size")
            slide = duration("slide")
            if slide <= interval_ms:
                raise BadRequestError(
                    "hopping window slide must exceed the downsample "
                    "interval (equal would be sliding)")
            if size <= slide:
                raise BadRequestError(
                    "hopping window size must exceed its slide "
                    "(equal would be a coarser tumbling window)")
            return cls("hopping", size_ms=size, slide_ms=slide)
        if kind == "session":
            by = obj.get("by")
            if by is not None and (not isinstance(by, str) or not by):
                raise BadRequestError(
                    "session window 'by' must be a non-empty tag key")
            return cls("session", gap_ms=duration("gap"), by_tag=by)
        return cls()

    def lead_for(self, interval_ms: int) -> int:
        """Extra trailing-history buckets a full leading window
        needs (sliding/hopping: the trailing combine reaches
        ``size`` back from each emitted bucket)."""
        return (self.size_ms // interval_ms - 1) \
            if self.kind in ("sliding", "hopping") else 0

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"type": self.kind}
        if self.size_ms:
            out["sizeMs"] = self.size_ms
        if self.gap_ms:
            out["gapMs"] = self.gap_ms
        if self.slide_ms:
            out["slideMs"] = self.slide_ms
        if self.by_tag:
            out["by"] = self.by_tag
        return out


def filter_identity(sub: TSSubQuery) -> tuple:
    """Canonical MEMBERSHIP identity of a sub-query's filter set: the
    ``groupBy`` flag only affects result grouping (a view-time
    concern), not which series belong to the partial array — so two
    queries differing only in groupBy share one fold."""
    keys = []
    for f in sub.filters:
        j = dict(f.to_json())
        j.pop("groupBy", None)
        keys.append(repr(sorted(j.items())))
    return tuple(sorted(keys))


class SharedPartial:
    """One shared partial-aggregate window ring (see module
    docstring). Thread-safe: fold/serve state mutates under ``lock``;
    the ingest tap's pending buffer has its own ``_pending_lock`` so
    an O(1) enqueue never waits on a fold in progress; drains are
    serialized by ``_drain_lock`` so chunks fold in arrival order."""

    def __init__(self, tsdb, metric: str, filters: list,
                 interval_ms: int, n_windows: int):
        self.tsdb = tsdb
        self.metric = metric
        self.filters = filters
        self.metric_id: int | None = None
        self.interval_ms = int(interval_ms)
        self.n_windows = int(n_windows)
        self.lock = threading.RLock()
        self._pending_lock = threading.Lock()
        self._drain_lock = threading.Lock()
        self._filter_eval = filters_mod.FilterEvaluator(tsdb.uids)
        # views attached to this partial (mutated under ``lock``);
        # folds push dirty buckets to every view's changed-set
        self.views: list[PlanView] = []
        # membership: sid -> row slot (-1 = evaluated, not a member)
        self._slots: dict[int, int] = {}
        self._sids: list[int] = []
        self._tag_pairs: list[tuple] = []  # row -> ((kid, vid), ...)
        w = self.n_windows
        cap = _GROW
        self._sum = np.zeros((cap, w))
        self._cnt = np.zeros((cap, w))
        self._min = np.full((cap, w), np.inf)
        self._max = np.full((cap, w), -np.inf)
        # optional fifth channel: per-(row, column) quantile sketches,
        # maintained only while a percentile view is attached
        # (``want_sketch``). ``sketch_from_ms`` is the oldest bucket
        # edge the channel covers exactly — serves reaching further
        # back shed to the batch engine
        self.want_sketch = False
        self._sketch: dict[tuple[int, int], Any] = {}
        self.sketch_from_ms = 0
        self.win_ts = np.full(w, -1, dtype=np.int64)
        # the oldest bucket edge every ring column still covers; a
        # request starting before it cannot be served incrementally
        self.covered_from_ms = 0
        # newest folded timestamp: absolute-range serves past it are
        # exact (nothing newer exists to diverge on)
        self.max_ts_ms = 0
        # newest LIVE-FOLDED event time, the watermark's sole input:
        # unlike max_ts_ms it is never seeded from wall clock or
        # bootstrap scans (a watermark is only emitted after the
        # events that advanced it), so a freshly registered policy CQ
        # finalizes nothing until real folds advance it — and is
        # monotone across ring rebuilds (final stays final). Folds
        # STAGE the advance; the drain loop commits it once per pass
        # (commit_watermark), so a write batch the ingest tap chunked
        # per series folds wholly against the PRE-batch watermark —
        # otherwise the first series' newest point would mass-drop
        # every later series' older half as "late"
        self.wm_event_ms = 0
        self._wm_staged_ms = 0
        # versions: folds invalidate view tail caches, membership
        # changes invalidate the group structures
        self.fold_seq = 0
        self.member_seq = 0
        # event-time lateness policy (streaming/eventtime): 0 = the
        # legacy contract (late points refold anywhere the ring still
        # covers, drop only past the ring horizon). A positive bound
        # FINALIZES buckets once the watermark (newest folded event
        # time minus the bound) passes their end — later points into
        # them drop and count, never silently mutate a final window.
        # Set once at registration (the policy is part of the shared
        # partial's identity, so attached views always agree).
        self.lateness_ms = 0
        # counters (read by the registry's stats/health export)
        self.points_folded = 0
        self.folds = 0
        self.late_dropped = 0
        self.late_refolded = 0
        self.preboundary_dropped = 0
        self.bootstrap_points = 0
        self.backpressure_dropped = 0
        # pending (sids, ts_ms, values) chunks offered by the ingest
        # tap; folded in batches off the hot write path. Single
        # points ride the scalar list — building three 1-element
        # numpy arrays per point costs more than the rest of the tap
        # combined, so take_pending columnarizes them in one shot
        self._pending: list[tuple] = []
        self._pending_scalars: list[tuple] = []
        self.pending_points = 0
        self.needs_rebuild = False
        # when the horizon holds history behind the metric's demotion
        # boundary and a tier interval nests in the base interval,
        # bootstrap seeds the pre-boundary part from the stitched tier
        # views; folds then drop pre-boundary backfills (stitched batch
        # reads ignore them too)
        self.tier_seeded = False
        self.seed_boundary_ms = 0
        self._seed_interval: str | None = None
        # the read-set's mutation epochs at bootstrap: deletes,
        # repairs and lifecycle sweeps bump them, and partials cannot
        # "unfold" removed points — the registry forces a rebuild on
        # mismatch before serving. Known limitation (documented):
        # DUPLICATE writes (same series+timestamp rewritten) fold
        # additively while the store dedupes last-write-wins; they do
        # not bump the epoch, so the divergence persists until a
        # tumble or rebuild. The reference treats duplicate writes as
        # an error condition (tsd.storage.fix_duplicates), so this
        # trades exactness on an abnormal workload for an O(1) write
        # path.
        self.store_epoch: tuple = (-1,)

    # ------------------------------------------------------------------
    # identity / attachment
    # ------------------------------------------------------------------

    def compatible_with(self, interval_ms: int) -> bool:
        """Downsample-divisible: a view whose interval is a multiple
        of the base derives its buckets by stride combine."""
        return interval_ms % self.interval_ms == 0

    def attach(self, view: "PlanView") -> None:
        with self.lock:
            self.views.append(view)

    def detach(self, view: "PlanView") -> bool:
        """Remove one view; returns True when no views remain (the
        registry then drops the whole partial)."""
        with self.lock:
            if view in self.views:
                self.views.remove(view)
            return not self.views

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _epoch_now(self) -> tuple:
        """Mutation epochs of everything this partial was seeded from:
        the raw store always, and the cold store and the four per-stat
        tier stores when tier-seeded (a cold quarantine or a tier delete
        forces a rebuild as a raw one does)."""
        parts = [self.tsdb.store.mutation_epoch]
        if self.tier_seeded and self._seed_interval is not None:
            lc = self.tsdb.lifecycle
            cold = lc.coldstore if lc is not None else None
            parts.append(cold.mutation_epoch if cold is not None else 0)
            rs = self.tsdb.rollup_store
            if rs is not None:
                for agg in _TIER_AGGS:
                    parts.append(rs.tier(self._seed_interval,
                                         agg).mutation_epoch)
        return tuple(parts)

    def epoch_changed(self) -> bool:
        return self.store_epoch != self._epoch_now()

    # ------------------------------------------------------------------
    # bootstrap: one batch scan seeds the partials, then folds keep up
    # ------------------------------------------------------------------

    def _seed_tier_views(self):
        """``({stat: stitched view}, boundary, interval)`` to seed from,
        or None when the horizon holds no demoted history or no
        configured tier nests in the base interval (those windows keep
        shedding to the batch engine; ref: ``_seed_tier_views``)."""
        t = self.tsdb
        lc = t.lifecycle
        rs = t.rollup_store
        if lc is None or rs is None or self.metric_id is None:
            return None
        boundary = lc.demote_boundary(self.metric_id)
        if not boundary or self.covered_from_ms >= boundary:
            return None
        best = None
        for iv in t.rollup_config.intervals:
            if iv.interval_ms <= self.interval_ms \
                    and self.interval_ms % iv.interval_ms == 0 \
                    and boundary % iv.interval_ms == 0:
                # the coarsest nesting tier: fewest cells to reduce
                if best is None or iv.interval_ms > best.interval_ms:
                    best = iv
        if best is None:
            return None
        views = {}
        for agg in _TIER_AGGS:
            st = lc.stitched(self.metric_id, best.interval, agg,
                             rs.tier(best.interval, agg))
            if st is None:
                return None
            views[agg] = st
        return views, boundary, best.interval

    def _reset_members_locked(self) -> None:
        """Clear membership for a re-seed (caller holds ``lock``);
        subclasses with extra membership maps extend this."""
        self._slots.clear()
        self._sids = []
        self._tag_pairs = []

    def _seed_scan(self, cols: np.ndarray, start_edge: int, iv: int,
                   w: int, seeded) -> None:
        """Seed the ring channels from the store for the admitted
        members (caller holds ``lock``; membership was just rebuilt).
        Subclasses that key rows by something other than series
        (per-tag session partials) override the scatter. ``seeded`` is
        what :meth:`_seed_tier_views` found."""
        if not len(self._sids):
            return
        sid_arr = np.asarray(self._sids, dtype=np.int64)
        span_end = int(start_edge + w * iv - 1)
        if seeded is not None:
            # channel-wise tier seed: each stitched view combines its
            # cold, tier and raw-tail parts over the same bucket grid,
            # so sums of sums, counts of counts and extremes of
            # extremes are exact
            views = seeded[0]
            grid = (sid_arr, int(start_edge), span_end, int(start_edge),
                    iv, w)
            sums = views["sum"].bucket_reduce(*grid)[0]
            cnts = views["count"].bucket_reduce(*grid)[0]
            mins = views["min"].bucket_reduce(*grid, want_minmax=True)[2]
            maxs = views["max"].bucket_reduce(*grid, want_minmax=True)[3]
        else:
            sums, cnts, mins, maxs = self.tsdb.store.bucket_reduce(
                sid_arr, int(start_edge), span_end, int(start_edge), iv,
                w, want_minmax=True)
        s = len(sid_arr)
        self._grow_to(s)
        self._sum[:s, cols] = sums
        self._cnt[:s, cols] = cnts
        present = cnts > 0
        self._min[:s, cols] = np.where(present, mins, np.inf)
        self._max[:s, cols] = np.where(present, maxs, -np.inf)
        self.bootstrap_points += int(cnts.sum())

    def bootstrap(self, now_ms: int,
                  n_windows: int | None = None) -> None:
        """Seed the window ring from the store: one fused
        ``bucket_reduce`` pass over the horizon produces exactly the
        sum/count/min/max partials the folds maintain afterwards. When
        demoted history falls inside the horizon, the stitched tier
        views supply it channel-wise (see module docstring).

        Seals the TSDB's ``tap_gate`` first, so that no write is
        between its store append and its offer while the buffers
        clear and the scan runs. Then takes ``_drain_lock`` BEFORE
        ``lock`` (the drain path's order): a drainer holding
        taken-but-unfolded chunks must finish before the re-scan, or
        its late folds would double-count points the scan already
        seeded."""
        with self.tsdb.tap_gate.sealed(), self._drain_lock, self.lock:
            if n_windows is not None:
                self.n_windows = int(n_windows)
            iv, w = self.interval_ms, self.n_windows
            last_edge = now_ms - now_ms % iv
            start_edge = last_edge - (w - 1) * iv
            edges = start_edge + np.arange(w, dtype=np.int64) * iv
            cols = ((edges // iv) % w).astype(np.int64)
            self.win_ts = np.full(w, -1, dtype=np.int64)
            self.win_ts[cols] = edges
            self._reset_members_locked()
            if self._sum.shape[1] != w:
                cap = self._sum.shape[0]
                self._sum = np.zeros((cap, w))
                self._cnt = np.zeros((cap, w))
                self._min = np.full((cap, w), np.inf)
                self._max = np.full((cap, w), -np.inf)
            else:
                self._sum[:] = 0.0
                self._cnt[:] = 0.0
                self._min[:] = np.inf
                self._max[:] = -np.inf
            with self._pending_lock:
                self._pending = []
                self._pending_scalars = []
                self.pending_points = 0
            for v in self.views:
                v.invalidate_caches()
            self._sketch = {}
            self.sketch_from_ms = int(start_edge)
            self.covered_from_ms = int(start_edge)
            self.max_ts_ms = int(now_ms)
            self.tier_seeded = False
            self.seed_boundary_ms = 0
            self._seed_interval = None
            uids = self.tsdb.uids
            try:
                self.metric_id = uids.metrics.get_id(self.metric)
            except LookupError:
                self.metric_id = None  # metric not written yet
                self.store_epoch = self._epoch_now()
                self.member_seq += 1
                self.fold_seq += 1
                return
            # epochs BEFORE the scan: a concurrent mutation during the
            # scan leaves the partial already-stale, never wrongly
            # fresh
            seeded = self._seed_tier_views()
            if seeded is not None:
                self.tier_seeded = True
                self.seed_boundary_ms = seeded[1]
                self._seed_interval = seeded[2]
            self.store_epoch = self._epoch_now()
            store = self.tsdb.store
            sids = store.series_ids_for_metric(self.metric_id)
            if len(sids) and self.filters:
                idx = store.metric_index(self.metric_id)
                _, triples = idx.arrays()
                mask = self._filter_eval.apply(self.filters, sids,
                                               triples)
                sids = sids[mask]
            for sid in np.asarray(sids).tolist():
                self._admit_locked(int(sid), check_filters=False)
            self._seed_scan(cols, int(start_edge), iv, w, seeded)
            if self.want_sketch and len(self._sids):
                self._seed_sketch_locked(
                    int(start_edge), int(start_edge + w * iv - 1))
            self.member_seq += 1
            self.fold_seq += 1

    def ensure_horizon(self, n_windows: int, anchor_ms: int) -> bool:
        """Grow the ring to at least ``n_windows`` columns (a newly
        attached view needs a longer horizon) and re-seed. Returns
        True when a re-bootstrap ran. Caller handles exceptions (a
        failed re-seed leaves ``needs_rebuild`` set). The size change
        applies INSIDE the re-bootstrap (under the drain+fold locks):
        a fold must never see a ring size its arrays don't match."""
        with self.lock:
            newest = int(self.win_ts.max())
            anchor = max(anchor_ms, newest if newest > 0 else 0)
            if n_windows <= self.n_windows:
                return False
        try:
            self.bootstrap(anchor, n_windows=n_windows)
        except BaseException:
            self.needs_rebuild = True
            raise
        return True

    # ------------------------------------------------------------------
    # quantile sketch channel (percentile views)
    # ------------------------------------------------------------------

    def enable_sketch(self) -> None:
        """Turn the sketch channel on for an already-live partial (a
        percentile view attached to a ring that predates it); the next
        rebuild seeds it."""
        with self.lock:
            if not self.want_sketch:
                self.want_sketch = True
                self.needs_rebuild = True

    def _sketch_params(self) -> tuple[float, int]:
        cfg = self.tsdb.config
        return (cfg.get_float("tsd.sketch.alpha", 0.01),
                cfg.get_int("tsd.sketch.max_buckets", 4096))

    def _merge_sketch_cell(self, slot: int, col: int, sk) -> None:
        from opentsdb_tpu_torch.sketch.ddsketch import SketchError
        cur = self._sketch.get((slot, col))
        if cur is None:
            self._sketch[(slot, col)] = sk
        else:
            try:
                cur.merge(sk)
            except SketchError:
                self._sketch[(slot, col)] = sk  # alpha changed: newest wins

    def _fold_sketch_points(self, slots: np.ndarray, ts: np.ndarray,
                            vals: np.ndarray) -> None:
        """Vectorized sketch fold of one chunk (caller holds ``lock``
        and has already masked non-members/NaN/late points)."""
        from opentsdb_tpu_torch.ops import sketch_fold
        iv, w = self.interval_ms, self.n_windows
        alpha, maxb = self._sketch_params()
        bucket = ts - ts % iv
        folded = sketch_fold.fold_series_cells(slots, bucket, vals, 1,
                                               alpha, maxb)
        for (slot, b), sk in folded.items():
            c = int((int(b) // iv) % w)
            if self.win_ts[c] != b:
                continue
            self._merge_sketch_cell(int(slot), c, sk)

    def _seed_sketch_locked(self, start_edge: int,
                            span_end: int) -> None:
        """Seed the sketch channel over the horizon (ref:
        ``_seed_sketch_locked``): demoted and spilled history through
        the three-zone sketch read (exact when the sketch tier's cell
        interval nests in the base interval), the raw tail through the
        vectorized fold. When demoted history cannot seed exactly,
        ``sketch_from_ms`` moves to the demotion boundary, so a
        percentile serve before it sheds to the batch engine."""
        from opentsdb_tpu_torch.lifecycle.stitch import sketch_zone_read
        t = self.tsdb
        iv, w = self.interval_ms, self.n_windows
        self._sketch = {}
        self.sketch_from_ms = int(start_edge)
        items, raw_rng, cold_ok = sketch_zone_read(
            t, self.metric, self.metric_id, int(start_edge),
            int(span_end))
        lc = t.lifecycle
        demote_b = lc.demote_boundary(self.metric_id) \
            if lc is not None else 0
        sketches = lc.sketches if lc is not None else None
        cell_ms = sketches.cell_ms(self.metric) \
            if sketches is not None else 0
        nests = bool(cell_ms) and iv % cell_ms == 0
        if demote_b > start_edge and not (nests and cold_ok):
            self.sketch_from_ms = int(demote_b)
            items = []
        if items:
            uids = t.uids
            pos: dict[tuple, int] = {}
            for slot, pairs in enumerate(self._tag_pairs):
                try:
                    pos[tuple(sorted(
                        (uids.tag_names.get_name(k),
                         uids.tag_values.get_name(v))
                        for k, v in pairs))] = slot
                except LookupError:
                    continue
            for names, cts, sk in items:
                slot = pos.get(tuple(names))
                if slot is None or cts < self.sketch_from_ms:
                    continue
                b = cts - cts % iv
                c = int((b // iv) % w)
                if self.win_ts[c] != b:
                    continue
                self._merge_sketch_cell(slot, c, sk.copy())
        if raw_rng is not None:
            lo = max(int(raw_rng[0]), self.sketch_from_ms)
            hi = min(int(raw_rng[1]), int(span_end))
            if lo <= hi and len(self._sids):
                sid_arr = np.asarray(self._sids, dtype=np.int64)
                batch = t.store.materialize(sid_arr, lo, hi)
                if batch.num_points:
                    self._fold_sketch_points(
                        np.asarray(batch.series_idx, dtype=np.int64),
                        np.asarray(batch.ts_ms, dtype=np.int64),
                        np.asarray(batch.values, dtype=np.float64))

    def sketch_items_for(self, start_ms: int, end_ms: int):
        """Live ``(slot, bucket_ts, sketch)`` triples whose base
        bucket falls inside [start, end], or None when the range
        reaches behind the channel's exact coverage. Caller holds
        ``lock``; the returned sketches are the ring's own — callers
        must copy before merging."""
        if not self.want_sketch:
            return None
        lo = max(int(start_ms), self.sketch_from_ms,
                 self.covered_from_ms)
        if int(start_ms) < lo:
            return None
        out = []
        for (slot, c), sk in self._sketch.items():
            b = int(self.win_ts[c])
            if b < 0 or b < start_ms or b > end_ms:
                continue
            out.append((slot, b, sk))
        return out

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def _grow_to(self, rows: int) -> None:
        cap = self._sum.shape[0]
        if rows <= cap:
            return
        new_cap = cap
        while new_cap < rows:
            new_cap *= 2
        w = self.n_windows

        def grow(arr, fill):
            out = np.full((new_cap, w), fill, dtype=arr.dtype)
            out[:cap] = arr
            return out

        self._sum = grow(self._sum, 0.0)
        self._cnt = grow(self._cnt, 0.0)
        self._min = grow(self._min, np.inf)
        self._max = grow(self._max, -np.inf)

    def _admit_locked(self, sid: int, check_filters: bool = True) -> int:
        """Slot for ``sid``, admitting it when it matches the plan's
        filters (a series first seen by a WRITE is brand new — its
        points arrive through the very fold that admits it, so no
        backfill is needed). Returns -1 for non-members."""
        slot = self._slots.get(sid)
        if slot is not None:
            return slot
        rec = self.tsdb.store.series(sid)
        if self.metric_id is None:
            # the metric materialized after registration: latch its id
            try:
                self.metric_id = self.tsdb.uids.metrics.get_id(
                    self.metric)
            except LookupError:
                return -1
        if rec.metric_id != self.metric_id:
            self._slots[sid] = -1
            return -1
        if check_filters and self.filters:
            triples = (np.asarray(
                [(sid, k, v) for k, v in rec.tags],
                dtype=np.int64).reshape(-1, 3)
                if rec.tags else np.empty((0, 3), dtype=np.int64))
            mask = self._filter_eval.apply(
                self.filters, np.asarray([sid], dtype=np.int64),
                triples)
            if not bool(mask[0]):
                self._slots[sid] = -1
                return -1
        slot = len(self._sids)
        self._grow_to(slot + 1)
        self._slots[sid] = slot
        self._sids.append(sid)
        self._tag_pairs.append(tuple(rec.tags))
        self.member_seq += 1
        return slot

    # ------------------------------------------------------------------
    # ingest tap: O(1) columnar enqueue
    # ------------------------------------------------------------------

    def offer(self, sids: np.ndarray, ts_ms: np.ndarray,
              values: np.ndarray) -> int:
        """Buffer a chunk from the ingest tap (O(1) append under the
        small pending lock — never the fold lock); returns the
        pending-point total so the registry can decide to hand the
        partial to a worker or degrade it."""
        with self._pending_lock:
            self._pending.append((sids, ts_ms, values))
            self.pending_points += len(ts_ms)
            return self.pending_points

    def offer_one(self, sid: int, ts_ms: int, value: float) -> int:
        """Scalar tap: one point, no numpy on the write path (a
        tuple append under the pending lock — ``take_pending``
        columnarizes the accumulated scalars in one conversion)."""
        with self._pending_lock:
            self._pending_scalars.append((sid, ts_ms, value))
            self.pending_points += 1
            return self.pending_points

    def take_pending(self) -> list[tuple]:
        with self._pending_lock:
            out, self._pending = self._pending, []
            sc, self._pending_scalars = self._pending_scalars, []
            self.pending_points = 0
        if sc:
            # float64 carries sid and ts_ms exactly (< 2**53)
            cols = np.asarray(sc, dtype=np.float64)
            out.append((cols[:, 0].astype(np.int64),
                        cols[:, 1].astype(np.int64), cols[:, 2]))
        return out

    def drop_pending(self) -> int:
        """Backpressure degrade: throw the backlog away (the partial
        is marked for rebuild-on-serve by the registry) and return
        the dropped point count. Never blocks the write path."""
        with self._pending_lock:
            dropped = self.pending_points
            self._pending = []
            self._pending_scalars = []
            self.pending_points = 0
        self.backpressure_dropped += dropped
        return dropped

    # ------------------------------------------------------------------
    # folds (run by workers / serve-path drains, never the tap)
    # ------------------------------------------------------------------

    def fold(self, sids: np.ndarray, ts_ms: np.ndarray,
             values: np.ndarray) -> None:
        """Fold one chunk of points into the window partials — ONE
        scatter per stat channel serving every attached view."""
        with self.lock:
            iv, w = self.interval_ms, self.n_windows
            sids = np.asarray(sids, dtype=np.int64).reshape(-1)
            ts_ms = np.asarray(ts_ms, dtype=np.int64).reshape(-1)
            values = np.asarray(values, dtype=np.float64).reshape(-1)
            slots = np.empty(len(sids), dtype=np.int64)
            slot_map = self._slots
            for i, sid in enumerate(sids.tolist()):
                s = slot_map.get(sid)
                if s is None:
                    s = self._admit_locked(sid)
                slots[i] = s
            keep = (slots >= 0) & ~np.isnan(values)
            if not keep.any():
                self.folds += 1
                return
            slots = slots[keep]
            ts = ts_ms[keep]
            vals = values[keep]
            bucket = ts - ts % iv
            if self.tier_seeded and self.seed_boundary_ms:
                # pre-boundary backfills are invisible to stitched batch
                # reads; folding them would serve them once: drop and
                # count
                pre = bucket < self.seed_boundary_ms
                if pre.any():
                    self.preboundary_dropped += int(pre.sum())
                    live0 = ~pre
                    slots, ts = slots[live0], ts[live0]
                    vals, bucket = vals[live0], bucket[live0]
                    if not len(bucket):
                        self.folds += 1
                        return
            if self.lateness_ms > 0:
                # event-time watermark as it stood BEFORE this drain
                # pass: a watermark is only emitted after the events
                # that advanced it, so a batch's own points are never
                # late relative to its own max (a bulk in-order
                # backfill — or the same batch chunked per series —
                # must not mass-drop its older half). Buckets the
                # standing watermark has passed are FINAL — late
                # points into them drop and count instead of silently
                # mutating a window already surfaced as complete.
                wm = self.wm_event_ms - self.lateness_ms
                final = (bucket + iv) <= wm
                if final.any():
                    self.late_dropped += int(final.sum())
                    keep2 = ~final
                    slots, ts = slots[keep2], ts[keep2]
                    vals, bucket = vals[keep2], bucket[keep2]
                    if not len(bucket):
                        self.max_ts_ms = max(self.max_ts_ms,
                                             int(ts_ms[keep].max()))
                        self.folds += 1
                        return
            col = ((bucket // iv) % w).astype(np.int64)
            # tumble columns whose newest incoming bucket is newer
            for c in np.unique(col).tolist():
                nb = int(bucket[col == c].max())
                if nb > self.win_ts[c]:
                    self._sum[:, c] = 0.0
                    self._cnt[:, c] = 0.0
                    self._min[:, c] = np.inf
                    self._max[:, c] = -np.inf
                    if self._sketch:
                        for key in [k for k in self._sketch
                                    if k[1] == c]:
                            del self._sketch[key]
                    self.win_ts[c] = nb
                    self.covered_from_ms = max(
                        self.covered_from_ms, nb - (w - 1) * iv)
            live = bucket == self.win_ts[col]
            self.late_dropped += int((~live).sum())
            # live points landing BEHIND the ring's newest bucket are
            # allowed-lateness refolds into already-published windows
            # (counted so completeness markers can surface them)
            high = int(self.win_ts.max())
            self.late_refolded += int((live & (bucket < high)).sum())
            if live.any():
                slots, col = slots[live], col[live]
                vals, bucket = vals[live], bucket[live]
                stream_fold.scatter_fold(self._sum, self._cnt,
                                         self._min, self._max,
                                         slots, col, vals)
                if self.want_sketch:
                    self._fold_sketch_points(slots, bucket, vals)
                changed = [int(b) for b in np.unique(bucket).tolist()]
                for view in self.views:
                    view.note_changed(changed, self.covered_from_ms)
                self.points_folded += len(vals)
                self.max_ts_ms = max(self.max_ts_ms, int(ts.max()))
                self._wm_staged_ms = max(self._wm_staged_ms,
                                         int(ts.max()))
                self.fold_seq += 1
            self.folds += 1

    # ------------------------------------------------------------------
    # read side: derive per-view channel grids from the shared ring
    # ------------------------------------------------------------------

    def channels_for(self, start_ms: int, end_ms: int,
                     view_interval_ms: int):
        """(sums, cnts, mins, maxs, view_edges) over the requested
        range at the VIEW's bucket granularity (stride combine over
        the base ring), or None when the range is outside the
        maintained horizon. Caller holds ``lock``."""
        base_iv, w = self.interval_ms, self.n_windows
        stride = view_interval_ms // base_iv
        edges = ds_mod.fixed_bucket_edges(start_ms, end_ms,
                                          view_interval_ms)
        if len(edges) == 0:
            return None
        base = (edges[:, None]
                + np.arange(stride, dtype=np.int64)
                * base_iv).reshape(-1)
        if len(base) > w or int(base[0]) < self.covered_from_ms:
            return None
        cols = ((base // base_iv) % w).astype(np.int64)
        live = self.win_ts[cols] == base
        s = len(self._sids)
        sums = np.where(live[None, :], self._sum[:s][:, cols], 0.0)
        cnts = np.where(live[None, :], self._cnt[:s][:, cols], 0.0)
        mins = np.where(live[None, :], self._min[:s][:, cols], np.inf)
        maxs = np.where(live[None, :], self._max[:s][:, cols], -np.inf)
        sums, cnts, mins, maxs = stream_fold.combine_stride(
            sums, cnts, mins, maxs, stride)
        return sums, cnts, mins, maxs, edges

    # ------------------------------------------------------------------
    # event-time observability (streaming/eventtime)
    # ------------------------------------------------------------------

    def commit_watermark(self) -> None:
        """Publish the event times this drain pass folded into the
        watermark basis (see ``wm_event_ms`` in ``__init__``). Called
        by the registry's drain loop AFTER all of a pass's chunks
        folded, under ``_drain_lock``."""
        with self.lock:
            if self._wm_staged_ms > self.wm_event_ms:
                self.wm_event_ms = self._wm_staged_ms

    def watermark_ms(self) -> int:
        """Event-time watermark: the newest live-folded event time
        minus the allowed lateness (without a policy the watermark
        rides the newest point — nothing is ever final)."""
        return max(0, self.wm_event_ms - self.lateness_ms)

    def ring_bytes(self) -> int:
        """Actual resident bytes of the ring channels (the fold-
        memory number the control plane's miner and the QoS tenant
        fold budget account against — capacity, not membership
        estimate)."""
        n = self._sum.nbytes + self._cnt.nbytes + self._min.nbytes \
            + self._max.nbytes + self.win_ts.nbytes
        if self._sketch:
            # dominated by bucket maps; ~16B/bucket is the DDSketch
            # store's observed footprint
            n += sum(16 * len(getattr(sk, "buckets", ()))
                     for sk in self._sketch.values())
        return n

    def session_stats(self, gap_ms: int,
                      watermark_ms: int) -> tuple[int, int]:
        """(open, closed) session counts for a session view at
        ``gap_ms``: a row's session is CLOSED once the watermark has
        passed its last active bucket's end by more than the gap —
        no in-lateness point can extend it. One vectorized pass over
        the ring (caller holds ``lock``)."""
        s = len(self._sids)
        if not s:
            return 0, 0
        live = self.win_ts >= 0
        if not live.any():
            return 0, 0
        present = self._cnt[:s][:, live] > 0
        edges = self.win_ts[live]
        has_any = present.any(axis=1)
        # newest active edge per row: argmax over edge-ranked columns
        rank = np.where(present, edges[None, :], -1)
        last_edge = rank.max(axis=1)
        closed = has_any & (last_edge + self.interval_ms + gap_ms
                            <= watermark_ms)
        return int((has_any & ~closed).sum()), int(closed.sum())

    def info(self) -> dict[str, Any]:
        with self.lock:
            return {
                "metric": self.metric,
                "intervalMs": self.interval_ms,
                "windows": self.n_windows,
                "series": len(self._sids),
                "views": len(self.views),
                "coveredFromMs": self.covered_from_ms,
                "pointsFolded": self.points_folded,
                "folds": self.folds,
                "pendingPoints": self.pending_points,
                "lateDropped": self.late_dropped,
                "lateRefolded": self.late_refolded,
                "latenessMs": self.lateness_ms,
                "watermarkMs": self.watermark_ms(),
                "ringBytes": self.ring_bytes(),
                "preboundaryDropped": self.preboundary_dropped,
                "backpressureDropped": self.backpressure_dropped,
                "bootstrapPoints": self.bootstrap_points,
                "tierSeeded": self.tier_seeded,
                "seedBoundaryMs": self.seed_boundary_ms,
                "needsRebuild": self.needs_rebuild,
                "sketchChannel": self.want_sketch,
                "sketchFromMs": self.sketch_from_ms,
            }


class PlanView:
    """One registered sub-query's view over a :class:`SharedPartial`:
    stride-derived grid + window combine + the pipeline tail. All
    fold/coverage state lives on the shared partial; the view owns
    only its caches, its window spec and its dirty-bucket set."""

    def __init__(self, shared: SharedPartial, sub: TSSubQuery,
                 n_windows: int, window: WindowSpec | None = None):
        self.shared = shared
        self.sub = sub
        self.window = window or WindowSpec()
        self.interval_ms = int(sub.ds_spec.interval_ms)
        self.n_windows = int(n_windows)
        # buckets touched since the last SSE publish (base-interval
        # edges; mutated under shared.lock by folds, drained by
        # take_changed)
        self.changed_ts: set[int] = set()
        self._tail_cache: tuple | None = None
        self._groups_cache: tuple | None = None

    # -- properties delegated to the shared partial (registry + test
    # surface compatibility: ``cq.plans[0].covered_from_ms`` etc.) ----

    @property
    def metric(self) -> str:
        return self.shared.metric

    @property
    def metric_id(self) -> int | None:
        return self.shared.metric_id

    @property
    def covered_from_ms(self) -> int:
        return self.shared.covered_from_ms

    @property
    def max_ts_ms(self) -> int:
        return self.shared.max_ts_ms

    @property
    def late_dropped(self) -> int:
        return self.shared.late_dropped

    @property
    def late_refolded(self) -> int:
        return self.shared.late_refolded

    @property
    def pending_points(self) -> int:
        return self.shared.pending_points

    @property
    def needs_rebuild(self) -> bool:
        return self.shared.needs_rebuild

    @property
    def _sids(self) -> list[int]:
        return self.shared._sids

    @property
    def stride(self) -> int:
        return self.interval_ms // self.shared.interval_ms

    # ------------------------------------------------------------------

    def invalidate_caches(self) -> None:
        self._tail_cache = None
        self._groups_cache = None

    def note_changed(self, buckets: list[int],
                     covered_from_ms: int) -> None:
        """Record fold-dirty base buckets (called under
        ``shared.lock`` by the fold)."""
        self.changed_ts.update(buckets)
        self._tail_cache = None
        if len(self.changed_ts) > 4 * max(
                self.n_windows * self.stride, 1):
            # nobody is draining the changed-set (no subscriber):
            # keep it bounded by the horizon
            self.changed_ts = {c for c in self.changed_ts
                               if c >= covered_from_ms}

    def take_changed(self) -> list[int]:
        with self.shared.lock:
            out = sorted(self.changed_ts)
            self.changed_ts = set()
            return out

    def publish_buckets(self, changed: set[int]) -> set[int] | None:
        """Map fold-dirty BASE buckets to the output buckets an SSE
        delta frame must re-emit: the enclosing view bucket for
        tumbling, the trailing-window fan-out for sliding (hopping
        keeps only the slide-aligned edges of that fan-out), None
        (whole frame) for session windows — a fold anywhere can move
        a session's start bucket."""
        if self.window.kind == "session":
            return None
        iv = self.interval_ms
        out = {c - c % iv for c in changed}
        if self.window.kind == "sliding":
            k = self.window.size_ms // iv
            out = {c + i * iv for c in out for i in range(k)}
        elif self.window.kind == "hopping":
            k = self.window.size_ms // iv
            slide = self.window.slide_ms
            out = {e for c in out
                   for e in range(c - c % slide,
                                  c + (k - 1) * iv + 1, slide)
                   if e >= c}
        return out

    # ------------------------------------------------------------------
    # serve: grid derivation + window combine + pipeline tail
    # ------------------------------------------------------------------

    def _windowed_channels(self, start_ms: int, end_ms: int):
        """Channels over [start, end] at view granularity with the
        window combine applied. Sliding windows extend the derivation
        ``k-1`` buckets into trailing history when the ring covers it
        (leading outputs otherwise aggregate their clipped window).
        Caller holds ``shared.lock``."""
        iv = self.interval_ms
        ch = None
        lead = 0
        if self.window.kind in ("sliding", "hopping"):
            k = self.window.size_ms // iv
            ext = start_ms - (k - 1) * iv
            if ext > 0:
                ch = self.shared.channels_for(ext, end_ms, iv)
                if ch is not None:
                    lead = k - 1
        if ch is None:
            ch = self.shared.channels_for(start_ms, end_ms, iv)
            if ch is None:
                return None
        sums, cnts, mins, maxs, edges = ch
        # the REAL point count, before any window combine: a sliding
        # combine sums the count channel across k overlapping
        # windows, which would k-fold overcount against query limits
        num_points = int(cnts.sum())
        if self.window.kind == "sliding":
            k = self.window.size_ms // iv
            sums, cnts, mins, maxs = stream_fold.combine_sliding(
                sums, cnts, mins, maxs, k)
            if lead:
                sums, cnts = sums[:, lead:], cnts[:, lead:]
                mins, maxs = mins[:, lead:], maxs[:, lead:]
                edges = edges[lead:]
        elif self.window.kind == "hopping":
            k = self.window.size_ms // iv
            body = edges[lead:] if lead else edges
            sel = np.nonzero(body % self.window.slide_ms == 0)[0] \
                + lead
            sums, cnts, mins, maxs = stream_fold.combine_hopping(
                sums, cnts, mins, maxs, k, sel)
            edges = edges[sel]
            if not len(edges):
                # no slide-aligned edge falls in the range: the view
                # has nothing to emit (callers see a 0-bucket frame)
                num_points = 0
        elif self.window.kind == "session":
            sums, cnts, mins, maxs = stream_fold.session_grid(
                sums, cnts, mins, maxs, edges, self.window.gap_ms)
        return sums, cnts, mins, maxs, edges, num_points

    def grid_for(self, start_ms: int, end_ms: int):
        """[S, B] downsampled+windowed grid over the requested range,
        or None when outside the horizon. Caller holds
        ``shared.lock``."""
        ch = self._windowed_channels(start_ms, end_ms)
        if ch is None:
            return None
        sums, cnts, mins, maxs, edges, num_points = ch
        # the engine's grid path builds its grid with the same function
        grid, present = grid_from_reduce(self.sub.ds_spec.function, sums,
                                         cnts, mins, maxs)
        return grid, present, edges, num_points

    def _groups_locked(self):
        """(tag_mat, group_ids, num_groups, gb_kids) over the current
        members, rebuilt only when membership changed. None when a
        group-by key has no UID yet (batch returns [] there too)."""
        cached = self._groups_cache
        if cached is not None and cached[0] == self.shared.member_seq:
            return cached[1]
        from opentsdb_tpu_torch.query.engine import QueryEngine, TagMatrix
        uids = self.shared.tsdb.uids
        tag_mat = TagMatrix.from_pairs(self.shared._tag_pairs)
        gb_tagks = sorted({f.tagk for f in self.sub.filters
                           if f.group_by})
        gb_kids = []
        for k in gb_tagks:
            try:
                gb_kids.append(uids.tag_names.get_id(k))
            except LookupError:
                self._groups_cache = (self.shared.member_seq, None)
                return None
        group_ids, num_groups = QueryEngine._group_ids(tag_mat, gb_kids)
        out = (tag_mat, group_ids, num_groups, gb_kids)
        self._groups_cache = (self.shared.member_seq, out)
        return out

    def serve(self, tsq, sub: TSSubQuery, engine) -> list | None:
        """Answer one request from the maintained windows: drain is
        the caller's job (registry), here the grid derives from the
        shared partials and ONLY the pipeline tail runs, placed as the
        batch engine's grid tail. Returns result groups, [] for genuinely-empty,
        or None when this view cannot serve the window. A failure of
        the tail raises: nothing here answers another way."""
        if self.sub.percentiles:
            return self._serve_percentiles(tsq, sub)
        shared = self.shared
        with shared.lock:
            g = self.grid_for(tsq.start_ms, tsq.end_ms)
            if g is None:
                return None
            grid, present, edges, num_points = g
            shared.tsdb.query_limits.check(shared.metric, num_points)
            if num_points == 0 or not len(shared._sids):
                return []
            groups = self._groups_locked()
            if groups is None:
                return []
            tag_mat, group_ids, num_groups, gb_kids = groups
            emit_raw = self.sub.agg.is_none
            if emit_raw:
                group_ids = np.arange(len(shared._sids),
                                      dtype=np.int32)
                num_groups = len(shared._sids)
            result, emit = self._tail_locked(edges, grid, present,
                                             group_ids, num_groups,
                                             emit_raw)
            sid_arr = np.asarray(shared._sids, dtype=np.int64)
            return engine._build_results(
                tsq, sub, shared.metric_id, sid_arr, tag_mat, group_ids,
                num_groups, edges, result, emit)

    def _serve_percentiles(self, tsq, sub) -> list | None:
        """Answer a percentile pull from the shared sketch channel:
        stride-merge the base buckets of each view bucket per group
        (sketch merges are exact), extract quantiles once through the
        batch sketch path's emitter — so a CQ pull and a batch
        ``/api/query`` over the same aligned window extract from
        identically-folded state."""
        shared = self.shared
        if self.window.kind != "tumbling":
            return None
        from opentsdb_tpu_torch.sketch.ddsketch import SketchError
        from opentsdb_tpu_torch.sketch.query import _emit
        iv = self.interval_ms
        with shared.lock:
            items = shared.sketch_items_for(tsq.start_ms, tsq.end_ms)
            if items is None:
                return None
            groups = self._groups_locked()
            if groups is None:
                return []
            tag_mat, group_ids, num_groups, gb_kids = groups
            gvec = np.asarray(group_ids, dtype=np.int64)
            acc: dict[tuple[int, int], Any] = {}
            num_points = 0
            first_edge = tsq.start_ms - tsq.start_ms % iv
            for slot, b, sk in items:
                out_b = b - b % iv
                if out_b < first_edge or out_b > tsq.end_ms:
                    continue
                num_points += sk.count
                key = (int(gvec[slot]), int(out_b))
                cur = acc.get(key)
                if cur is None:
                    acc[key] = sk.copy()  # never mutate ring state
                else:
                    try:
                        cur.merge(sk)
                    except SketchError:
                        acc[key] = sk.copy()  # alpha skew: newest wins
            shared.tsdb.query_limits.check(shared.metric, num_points)
            if not acc:
                return []
            return _emit(shared.tsdb, tsq, sub, tag_mat, group_ids,
                         num_groups, acc)

    def _tail_locked(self, edges, grid, present, group_ids,
                     num_groups: int, emit_raw: bool):
        """fill/rate/interpolate/aggregate over the derived grid: the
        batch engine's grid tail, uploaded with :func:`put_grid` in the
        TSDB's compute dtype and run by :func:`execute_grid`, with the
        engine's spec normalisation. It is placed as the batch engine
        places a grid tail of these dims (``host_tail_for_dims``): on
        the host CPU under the host-tail budget, else on the TSDB's
        query device (the reference pins this tail to its host CPU
        backend whatever its size). Cached per (fold, membership,
        window)."""
        shared = self.shared
        key = (shared.fold_seq, shared.member_seq, int(edges[0]),
               len(edges))
        cached = self._tail_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        sub = self.sub
        t = shared.tsdb
        host_dev = host_tail_for_dims(t.config, grid.shape[0], len(edges),
                                      num_groups, emit_raw, sub.agg.name)
        spec = PipelineSpec(
            num_series=grid.shape[0], num_buckets=len(edges),
            num_groups=num_groups,
            # normalized like the engine's grid tail: downsampling
            # already happened (partials), the tail never reads it
            ds_function="avg", agg_name=sub.agg.name,
            fill_policy=sub.ds_spec.fill_policy,
            fill_value=sub.ds_spec.fill_value, rate=sub.rate,
            rate_counter=sub.rate_options.counter,
            rate_drop_resets=sub.rate_options.drop_resets,
            emit_raw=emit_raw, host=host_dev is not None)
        dgrid, dhas = put_grid(grid, present, t.dtype, host_dev or t.device)
        result, emit = execute_grid(dgrid, dhas, edges, group_ids, spec,
                                    sub.rate_options)
        out = (result.cpu().numpy(), emit.cpu().numpy().astype(bool))
        self._tail_cache = (key, out)
        return out

    # ------------------------------------------------------------------

    def info(self) -> dict[str, Any]:
        out = self.shared.info()
        out.update({
            "viewIntervalMs": self.interval_ms,
            "viewWindows": self.n_windows,
            "window": self.window.to_json(),
            "stride": self.stride,
        })
        return out
