"""The lifecycle manager: the background sweeper (ref:
``opentsdb_tpu/lifecycle/manager.py``).

One sweep, per metric with a policy (:mod:`.policy`):

1. **retention**: points older than the TTL are purged from the raw
   store, every rollup tier and preagg store, the histogram arenas
   (``TSDB.purge_histograms_before``, under the ``lifecycle.histogram``
   fault site), the sketch tier and the cold segments (the reference
   delegates this to HBase table TTLs, SURVEY.md §5.4).
2. **age-based demotion**: raw points older than the demotion boundary
   are folded into the configured rollup tiers by the rollup job
   (:func:`opentsdb_tpu_torch.rollup.job.run_rollup_job`, restricted to
   the metric's series; its device route is ``_rollup_tile_dense`` and
   ``_coarsen``), and into per-cell quantile sketches, then dropped
   from raw. The boundary aligns down to the coarsest demoted tier's
   interval so every demoted tier cell is complete; the query engine
   stitches tier history and raw tail (:mod:`.stitch`). The order of
   publication: tiers first, the boundary second (stitched reads clip
   raw to the tail while the stale raw points still exist), the raw
   purge last. While a metric's FIRST demotion is in flight, the
   engine reads raw (``first_demotion_in_flight``).
3. **cold spill**: demoted tier history older than ``spill_after`` is
   written into mmap-backed columnar segment files
   (:mod:`opentsdb_tpu_torch.coldstore`) and the spilled range is
   deleted from the in-RAM tier stores: the segment durable first, the
   manifest (segments + moved spill boundary) atomically second, the
   RAM purge last. Histogram arena rows spill as sketch segments.

The reference's third step, compaction, shrinks its memory store's
per-series buffers (``compact_series``). The port's memory store keeps
one CSR column set that every purge already replaces at its new size,
and neither package's native store has the method, so the port leaves
the step out: ``bytesReclaimed`` and ``seriesReleased`` stay 0 (as the
reference's on the native store; ROADMAP Queue 3 item 22).

Every sweep that removed or demoted data bumps the raw store's
``mutation_epoch`` and, with a data_dir, flushes a snapshot and
truncates the WAL so that replay cannot bring expired points back (the
WAL has no delete record; the snapshot is the delete's durability).

The sweep runs under the ``lifecycle.sweep`` fault site (demotion also
under ``lifecycle.demote``, the sketch fold under ``sketch.fold``) and
its own circuit breaker (``tsd.lifecycle.breaker.*``); a failing sweep
is counted, logged and retried next interval, and never fails ingest or
queries. ``POST /api/lifecycle/sweep`` runs one sweep synchronously.
Each sweep is a ``lifecycle.sweep`` background trace root with
``coldstore.spill`` and ``sketch.fold`` stage spans, as in the
reference.

Demotion boundaries persist to ``<data_dir>/lifecycle.json`` (the
reference's file), so a restarted TSD keeps stitching.

Known limitation, as the reference's: a write backfilled behind the
demotion boundary is never re-demoted and stitched reads do not see
it; it stays visible to ``rollupUsage=ROLLUP_RAW`` until retention
purges it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

import numpy as np

from opentsdb_tpu_torch.core.store import FIRST_TS_NONE
from opentsdb_tpu_torch.lifecycle.policy import LifecyclePolicy, PolicySet
from opentsdb_tpu_torch.lifecycle.stitch import StitchedStore
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.obs.trace import trace_span
from opentsdb_tpu_torch.utils.faults import CircuitBreaker

LOG = logging.getLogger("lifecycle")

# the four per-statistic tier stores one demoted tier interval spans
# (rollup/job.py ROLLUP_AGGS — avg derives as sum/count at query time)
_TIER_AGGS = ("sum", "count", "min", "max")


class LifecycleManager:
    """(see module docstring; ref: ``LifecycleManager``)"""

    def __init__(self, tsdb):
        self.tsdb = tsdb
        cfg = tsdb.config
        self.policies = PolicySet.from_config(cfg)
        self.interval_s = cfg.get_float("tsd.lifecycle.interval_s", 0.0)
        self.flush_after_sweep = cfg.get_bool(
            "tsd.lifecycle.flush_after_sweep", True)
        threshold = cfg.get_int(
            "tsd.lifecycle.breaker.failure_threshold", 3)
        self.breaker = CircuitBreaker(
            "lifecycle.sweep", failure_threshold=threshold,
            reset_timeout_ms=cfg.get_float(
                "tsd.lifecycle.breaker.reset_timeout_ms", 60000.0)) \
            if threshold > 0 else None
        if self.breaker is not None:
            tsdb.stats.register(self.breaker)
        # cold-tier disk store (coldstore/): the manifest
        # lives next to lifecycle.json by default; tsd.coldstore.dir
        # overrides, tsd.coldstore.enable=false opts out. With no
        # directory at all there is nowhere to spill — the spill
        # mechanism stays off and everything else works as before.
        self.coldstore = None
        cold_dir = cfg.get_string("tsd.coldstore.dir", "")
        if not cold_dir and getattr(tsdb, "data_dir", ""):
            import os
            cold_dir = os.path.join(tsdb.data_dir, "coldstore")
        if cold_dir and cfg.get_bool("tsd.coldstore.enable", True):
            from opentsdb_tpu_torch.coldstore import ColdStore
            cb_threshold = cfg.get_int(
                "tsd.coldstore.breaker.failure_threshold", 3)
            read_breaker = CircuitBreaker(
                "coldstore.read", failure_threshold=cb_threshold,
                reset_timeout_ms=cfg.get_float(
                    "tsd.coldstore.breaker.reset_timeout_ms",
                    60000.0)) if cb_threshold > 0 else None
            if read_breaker is not None:
                tsdb.stats.register(read_breaker)
            self.coldstore = ColdStore(
                cold_dir, faults=getattr(tsdb, "faults", None),
                uids=tsdb.uids, read_breaker=read_breaker)
        # merge-compaction threshold: a (metric, tier) holding MORE
        # than this many per-sweep segments gets them merged into one
        # on the next sweep (0 = off)
        self.cold_compact_segments = cfg.get_int(
            "tsd.coldstore.compact_segments", 0)
        # the fifth stat column: per-cell quantile sketches of demoted
        # raw data (sketch/). Demotion folds the raw
        # points it purges into cells here; the spill moves cells into
        # the cold segments' sketch blob column. tsd.sketch.enable
        # opts out — demotion then loses percentiles past the
        # boundary, exactly the pre-sketch behavior.
        self.sketches = None
        if cfg.get_bool("tsd.sketch.enable", True):
            from opentsdb_tpu_torch.sketch.store import SketchTierStore
            sk_path = ""
            if getattr(tsdb, "data_dir", ""):
                import os
                sk_path = os.path.join(tsdb.data_dir, "sketches.bin")
            self.sketches = SketchTierStore(
                sk_path,
                alpha=cfg.get_float("tsd.sketch.alpha", 0.01),
                max_buckets=cfg.get_int("tsd.sketch.max_buckets",
                                        4096))
            self.sketches.load()
        # one sweep at a time (admin POST vs the interval thread)
        self._sweep_lock = threading.Lock()
        self._lock = threading.Lock()
        # metric_id -> demotion boundary (ms, exclusive): raw points
        # BEFORE it have been folded into tiers and purged from raw
        # (keyed by policied metric id; persisted in lifecycle.json)
        self._boundaries: dict[int, int] = {}
        # (metric_id, interval, agg) -> StitchedStore for the current
        # boundary; rebuilt when the boundary moves so cache keys
        # derived from instance_id can never alias across boundaries
        self._stitched: dict[tuple, StitchedStore] = {}
        # metrics whose FIRST demotion is in flight: the rollup job
        # has started writing tier cells (has_data flips true) but no
        # boundary exists yet, so tier selection would serve
        # tier-only results missing the raw tail — the engine pins
        # these metrics to raw until the boundary publishes. Stays
        # set across a failed first demotion (partial tier data with
        # no boundary must not be selected).
        self._first_demotions: set[int] = set()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # counters
        self.sweeps = 0
        self.sweep_errors = 0
        self.points_purged = 0
        self.points_demoted = 0
        self.tier_points_written = 0
        self.bytes_reclaimed = 0
        self.series_released = 0
        self.points_spilled = 0
        self.histogram_points_purged = 0
        self.histogram_points_spilled = 0
        self.last_sweep_duration_ms = 0.0
        self.last_sweep_time = 0.0
        self.last_error = ""
        self._boundary_path = ""
        data_dir = getattr(tsdb, "data_dir", "")
        if data_dir:
            import os
            self._boundary_path = os.path.join(data_dir,
                                               "lifecycle.json")
            self._load_boundaries()

    # ------------------------------------------------------------------
    # scheduler surface (started by TSDServer, stopped on shutdown)
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="tsd-lifecycle",
                             daemon=True)
        self._thread = t
        t.start()
        LOG.info("lifecycle sweeper running every %.0fs",
                 self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sweep()  # never raises

    # ------------------------------------------------------------------
    # read-side surface (query engine / streaming registry)
    # ------------------------------------------------------------------

    def demote_boundary(self, metric_id: int) -> int:
        """The metric's demotion boundary (ms, exclusive), 0 = none."""
        with self._lock:
            return self._boundaries.get(metric_id, 0)

    def demote_boundary_for(self, metric: str) -> int:
        try:
            mid = self.tsdb.uids.metrics.get_id(metric)
        except LookupError:
            return 0
        return self.demote_boundary(mid)

    def first_demotion_in_flight(self, metric_id: int) -> bool:
        """True while this metric's tiers hold (possibly partial)
        demoted cells but no boundary exists yet — tier selection
        must stay on raw (which still has every point)."""
        with self._lock:
            return metric_id in self._first_demotions

    def has_cold(self, metric_id: int, interval: str) -> bool:
        """Whether cold segments exist for this (metric, tier) — tier
        selection must treat that as tier data even when the in-RAM
        tier store was fully spilled and emptied."""
        cold = self.coldstore
        if cold is None:
            return False
        try:
            name = self.tsdb.uids.metrics.get_name(metric_id)
        except LookupError:
            return False
        return cold.has_segments(name, interval)

    def stitched(self, metric_id: int, interval: str, agg: str,
                 tier_store) -> StitchedStore | None:
        """The cached stitched view for one (metric, tier, agg), or
        None when the metric has no demotion boundary (plain tier
        serving stays untouched). When the metric has cold segments
        for this tier, the view gets the cold third (spill boundary +
        mmap read view). The cache revalidates on ONE cold
        mutation-epoch read — every cold mutation (spill commit,
        quarantine, delete rewrite, boundary clamp) bumps it, so the
        full name-resolve + boundary lookup only runs when something
        actually changed."""
        cold = self.coldstore
        cold_epoch = cold.mutation_epoch if cold is not None else 0
        with self._lock:
            boundary = self._boundaries.get(metric_id, 0)
            if not boundary:
                return None
            key = (metric_id, interval, agg)
            st = self._stitched.get(key)
            if st is not None and st.boundary_ms == boundary \
                    and st.tier is tier_store \
                    and getattr(st, "cold_epoch", 0) == cold_epoch:
                return st
        spill_b = 0
        cold_view = None
        if cold is not None:
            try:
                name = self.tsdb.uids.metrics.get_name(metric_id)
            except LookupError:
                name = None
            if name is not None:
                spill_b = cold.spill_boundary(name)
                if spill_b and cold.has_segments(name, interval):
                    cold_view = cold.stat_view(name, interval, agg,
                                               self.tsdb.store)
                else:
                    spill_b = 0
        with self._lock:
            boundary = self._boundaries.get(metric_id, 0)
            if not boundary:
                return None
            st = StitchedStore(self.tsdb.store, tier_store,
                               metric_id, boundary, agg,
                               cold=cold_view,
                               spill_boundary_ms=spill_b,
                               cold_store=cold)
            st.cold_epoch = cold_epoch
            self._stitched[key] = st
            return st

    # ------------------------------------------------------------------
    # the sweep
    # ------------------------------------------------------------------

    def sweep(self, now_ms: int | None = None) -> dict[str, Any]:
        """Run one full sweep; returns a report. Never raises: a
        failure is counted, trips the breaker, and the serve path is
        untouched (this is maintenance, not the request path)."""
        if not self._sweep_lock.acquire(blocking=False):
            return {"skipped": "sweep already running"}
        t0 = time.monotonic()
        report: dict[str, Any] = {
            "purged": 0, "demoted": 0, "tierPointsWritten": 0,
            "bytesReclaimed": 0, "seriesReleased": 0, "metrics": 0,
            "spilled": 0, "histogramPurged": 0,
            "histogramSpilled": 0, "coldCompacted": 0,
        }
        # every sweep is a background trace root (ref: the
        # ``lifecycle.sweep`` root; the spill and the sketch fold record
        # their own stage spans)
        tracer = self.tsdb.tracer
        tctx = tracer.start_background("lifecycle.sweep")
        try:
            if self.breaker is not None and not self.breaker.allow():
                report["skipped"] = "breaker open"
                return report
            try:
                with trace_mod.use(tctx):
                    self._sweep_inner(
                        int(now_ms if now_ms is not None
                            else time.time() * 1000), report)
            except Exception as exc:  # noqa: BLE001 - degrade loudly
                self.sweep_errors += 1
                self.last_error = f"{type(exc).__name__}: {exc}"
                if self.breaker is not None:
                    self.breaker.record_failure()
                if tctx is not None:
                    tctx.set_error(exc)
                LOG.warning("lifecycle sweep failed (%s); ingest and "
                            "queries are unaffected", self.last_error)
                report["error"] = self.last_error
                return report
            if self.breaker is not None:
                self.breaker.record_success()
            return report
        finally:
            self.sweeps += 1
            self.last_sweep_time = time.time()
            self.last_sweep_duration_ms = \
                (time.monotonic() - t0) * 1e3
            report["durationMs"] = round(self.last_sweep_duration_ms,
                                         1)
            if tctx is not None:
                if report.get("skipped"):
                    # a breaker-open no-op sweep would churn request
                    # traces out of the ring
                    tctx.sampled = False
                tctx.tag(purged=report.get("purged", 0),
                         demoted=report.get("demoted", 0),
                         spilled=report.get("spilled", 0))
                tracer.finish(tctx)
            self._sweep_lock.release()

    def _sweep_inner(self, now_ms: int, report: dict) -> None:
        t = self.tsdb
        faults = getattr(t, "faults", None)
        if faults is not None:
            faults.check("lifecycle.sweep")
        store = t.store
        changed = False
        uids = t.uids
        # the work list covers every metric ANY store knows: a metric
        # written only through the rollup API (external jobs, no raw
        # series) still needs its tier retention applied
        mids = set(store.metric_ids())
        if t.rollup_store is not None:
            rs = t.rollup_store
            with rs._tiers_lock:
                tier_stores = list(rs._tiers.values())
            tier_stores.append(rs.preagg_store())
            for ts_store in tier_stores:
                mids.update(ts_store.metric_ids())
        # histogram-only metrics need their arena TTL applied too
        with t._histogram_lock:
            mids.update(t._histogram_arenas.keys())
        name_of = {}
        for mid in mids:
            try:
                name_of[mid] = uids.metrics.get_name(mid)
            except LookupError:
                continue  # orphan metric id: fsck's problem
        work = self.policies.metrics_with_policies(name_of.values())
        by_name = {v: k for k, v in name_of.items()}
        for metric, pol in work:
            mid = by_name[metric]
            sids = np.asarray(store.series_ids_for_metric(mid),
                              dtype=np.int64)
            report["metrics"] += 1
            if pol.retention_ms:
                changed |= self._retention(mid, metric, sids, pol,
                                           now_ms, report)
            if pol.demote_after_ms and t.rollup_store is not None:
                changed |= self._demote(mid, metric, sids, pol,
                                        now_ms, report)
            if pol.spill_after_ms:
                with trace_span("coldstore.spill", metric=metric):
                    if t.rollup_store is not None:
                        changed |= self._spill(mid, metric, pol, now_ms,
                                               report)
                    changed |= self._spill_histograms(mid, metric, pol,
                                                      now_ms, report)
            # merge-compaction of accumulated per-sweep cold segments
            # (runs under coldstore.write via the store, so an armed
            # fault degrades it like a failed spill — loud, harmless)
            if self.cold_compact_segments > 0 and \
                    self.coldstore is not None:
                merged = self.coldstore.compact_segments(
                    metric, self.cold_compact_segments)
                if merged:
                    report["coldCompacted"] += merged
                    changed = True
        if changed:
            # belt over the per-op epoch bumps: one extra bump per
            # sweep guarantees every read-side cache (result cache,
            # grid/prep pools, streaming plans) rebuilds rather than
            # serving purged points
            store.mutation_epoch += 1
            if self.flush_after_sweep and getattr(t, "data_dir", ""):
                # the WAL has no delete records: the snapshot (+ WAL
                # truncation inside flush) is what makes the purge
                # durable — without it, replay-on-restart would
                # resurrect expired points
                t.flush()

    def _tier_interval_ms(self, interval: str) -> int:
        """Tier interval string -> ms span (0 when unknown): the cold
        trim keeps cells whose aggregation window spans the cutoff,
        same rule as the RAM tier purge below."""
        try:
            return self.tsdb.rollup_config.get_interval(
                interval).interval_ms
        except ValueError:
            return 0

    def _retention(self, mid: int, metric: str, sids: np.ndarray,
                   pol: LifecyclePolicy, now_ms: int,
                   report: dict) -> bool:
        cutoff = now_ms - pol.retention_ms
        if cutoff <= 0:
            return False
        t = self.tsdb
        store = t.store
        purged = store.delete_range(sids, 1, cutoff - 1)
        # histogram arenas share the metric's TTL;
        # own fault site so a broken arena purge is observable —
        # the sweep's never-raise contract keeps ingest unaffected
        faults = getattr(t, "faults", None)
        if faults is not None:
            faults.check("lifecycle.histogram")
        hist_purged = t.purge_histograms_before(mid, cutoff)
        if hist_purged:
            self.histogram_points_purged += hist_purged
            report["histogramPurged"] += hist_purged
        # sketch cells share the metric's TTL (cell-window rule, like
        # the tier purge below); a dropped cell re-persists at once so
        # a restart cannot resurrect expired percentile history
        if self.sketches is not None and \
                self.sketches.delete_before(metric, cutoff):
            self.sketches.save()
        # cold segments are retention-managed too: whole-expired
        # segments drop cheaply (end_ms < cutoff matches the inclusive
        # raw purge of [1, cutoff-1]), then still-live segments
        # STRADDLING the cutoff get their expired prefix trimmed off
        # through the delete-rewrite path — without the trim a single
        # long-lived segment pins its whole range on disk until its
        # newest cell expires
        if self.coldstore is not None:
            purged += self.coldstore.drop_segments_before(
                metric, cutoff, self._tier_interval_ms)
            purged += self.coldstore.trim_segments_before(
                metric, cutoff, self._tier_interval_ms)
        rs = self.tsdb.rollup_store
        if rs is not None:
            config = self.tsdb.rollup_config
            tiers: list[tuple] = [(rs.preagg_store(), 0)]
            with rs._tiers_lock:
                items = list(rs._tiers.items())
            for (interval, _agg), ts_store in items:
                try:
                    iv_ms = config.get_interval(interval).interval_ms
                except ValueError:
                    iv_ms = 0
                tiers.append((ts_store, iv_ms))
            for ts_store, iv_ms in tiers:
                tsids = ts_store.series_ids_for_metric(mid)
                if len(tsids) == 0:
                    continue
                # a tier cell stamped T aggregates [T, T+iv): purge
                # only cells whose WHOLE window expired (T+iv <=
                # cutoff), or unexpired aggregated history would be
                # lost with its cell
                end = cutoff - 1 - iv_ms
                if end >= 1:
                    purged += ts_store.delete_range(tsids, 1, end)
        if purged:
            self.points_purged += purged
            report["purged"] += purged
        return purged > 0 or hist_purged > 0

    def _demote(self, mid: int, metric: str, sids: np.ndarray,
                pol: LifecyclePolicy, now_ms: int,
                report: dict) -> bool:
        t = self.tsdb
        config = t.rollup_config
        tiers = [config.get_interval(iv) for iv in pol.demote_tiers] \
            if pol.demote_tiers else list(config.intervals)
        if not tiers:
            return False
        coarse_ms = max(iv.interval_ms for iv in tiers)
        target = now_ms - pol.demote_after_ms
        boundary = target - target % coarse_ms
        prev = self.demote_boundary(mid)
        if boundary <= prev:
            return False
        counts = t.store.count_range(sids, 1, boundary - 1)
        old_sids = sids[counts > 0]
        total_old = int(counts.sum())
        if total_old == 0:
            # nothing raw to fold: leave the boundary where it is —
            # publishing a boundary no demotion backs would flip
            # externally-rolled-up metrics from plain tier serving to
            # a stitched view whose tier half is clipped for no reason
            return False
        faults = getattr(t, "faults", None)
        if faults is not None:
            faults.check("lifecycle.demote")
        start_ms = self._oldest_ts(t.store, old_sids, max(prev, 1))
        if prev == 0:
            # first demotion: tier cells are about to appear with no
            # boundary to stitch against — pin tier selection to raw
            # until the boundary publishes (cleared only on success;
            # a failed first demotion leaves partial tier data that
            # must keep losing tier selection)
            with self._lock:
                self._first_demotions.add(mid)
        from opentsdb_tpu_torch.rollup.job import run_rollup_job
        written = run_rollup_job(
            t, start_ms, boundary - 1,
            intervals=[iv.interval for iv in tiers],
            series_ids=old_sids)
        wrote = sum(written.values())
        self.tier_points_written += wrote
        report["tierPointsWritten"] += wrote
        # fifth stat: fold the SAME raw window into per-cell quantile
        # sketches (cells at the finest demote tier) BEFORE the
        # boundary publishes and the raw purge runs — a raise here
        # aborts the demotion with raw intact, same as a rollup
        # failure. The sidecar save lands before the purge too
        # (durable-first, like the spill's manifest ordering).
        if self.sketches is not None:
            with trace_span("sketch.fold", metric=metric):
                self._fold_sketches(mid, metric, old_sids, tiers,
                                    start_ms, boundary, faults)
        # tiers hold the history now: move the boundary BEFORE the raw
        # purge so stitched reads clip raw to the tail (no double
        # count while the stale raw points still exist), THEN purge.
        # The purge starts at the FOLD window, never before the
        # previous boundary: points backfilled behind it were not
        # re-folded, so deleting them would lose data the tiers never
        # received (they age out via retention instead).
        self._publish_boundary(mid, boundary)
        with self._lock:
            self._first_demotions.discard(mid)
        dropped = t.store.delete_range(old_sids, start_ms,
                                       boundary - 1)
        self.points_demoted += dropped
        report["demoted"] += dropped
        LOG.info("demoted %d raw points of %s into %s (boundary %d)",
                 dropped, metric,
                 "/".join(iv.interval for iv in tiers), boundary)
        return True

    def _fold_sketches(self, mid: int, metric: str,
                       old_sids: np.ndarray, tiers, start_ms: int,
                       boundary: int, faults) -> None:
        """Fold the demoting raw window into the sketch tier: one
        vectorized pass over the materialized batch, cells at the
        finest demote-tier interval keyed by the series' tag NAMES
        (restart-stable, and the identity the cold segment's series
        table uses)."""
        t = self.tsdb
        batch = t.store.materialize(old_sids, start_ms, boundary - 1)
        if not batch.num_points:
            return
        from opentsdb_tpu_torch.ops import sketch_fold
        fine_ms = min(iv.interval_ms for iv in tiers)
        folded = sketch_fold.fold_series_cells(
            batch.series_idx, batch.ts_ms, batch.values, fine_ms,
            self.sketches.alpha, self.sketches.max_buckets,
            faults=faults)
        uids = t.uids
        names_of: dict[int, tuple | None] = {}
        items = []
        for (si, cell_ts), sk in folded.items():
            if si not in names_of:
                rec = t.store.series(int(batch.series_ids[si]))
                try:
                    names_of[si] = tuple(sorted(
                        (uids.tag_names.get_name(k),
                         uids.tag_values.get_name(v))
                        for k, v in rec.tags))
                except LookupError:
                    names_of[si] = None  # unresolvable: skip
            names = names_of[si]
            if names is not None:
                items.append((names, cell_ts, sk))
        if items:
            self.sketches.merge_cells(metric, fine_ms, items)
            self.sketches.save()

    def _spill(self, mid: int, metric: str, pol: LifecyclePolicy,
               now_ms: int, report: dict) -> bool:
        """Mechanism 4: spill demoted tier history older than the
        spill horizon into cold segment files, then release the RAM
        (see module docstring for the crash ordering)."""
        cold = self.coldstore
        t = self.tsdb
        if cold is None:
            return False
        boundary = self.demote_boundary(mid)
        if not boundary:
            return False  # only demoted history spills
        config = t.rollup_config
        tiers = [config.get_interval(iv) for iv in pol.demote_tiers] \
            if pol.demote_tiers else list(config.intervals)
        if not tiers:
            return False
        prev = cold.spill_boundary(metric)
        changed = False
        if prev:
            # reconciliation: RAM duplicates of already-spilled ranges
            # (crash between manifest commit and tier purge, or WAL
            # replay resurrection) are invisible to stitched reads —
            # the clip at the spill boundary hides them — but still
            # hold RAM; purge them here so restarts converge. Only
            # ranges COVERED by cold segments are purged: a tier
            # newly added to the policy has un-spilled history below
            # the boundary that must not be deleted without a disk
            # copy.
            changed = self._purge_spilled_ranges(mid, metric,
                                                 tiers) > 0
        coarse_ms = max(iv.interval_ms for iv in tiers)
        target = now_ms - pol.spill_after_ms
        new_b = min(target - target % coarse_ms, boundary)
        if new_b <= prev:
            return changed
        entries: list[dict] = []
        spilled_rows = 0
        for iv in tiers:
            # a tier with no cold segments yet (first spill, or newly
            # added to the policy after spills began) spills its WHOLE
            # history below the new boundary — starting at prev would
            # strand its older cells behind the clip, unservable and
            # never written to disk
            lo = max(prev, 1) \
                if cold.has_segments(metric, iv.interval) else 1
            data = self._gather_tier_history(mid, iv.interval, lo,
                                             new_b - 1)
            if data is None:
                continue
            series_entries, ts_ms, cols = data
            # the sketch column rides the tier whose grid matches the
            # sketch cells (the finest demote tier at fold time) —
            # rows without a folded cell get a zero-length blob
            sketch = self._gather_sketch_column(metric, iv,
                                                series_entries, ts_ms)
            try:
                # runs under the coldstore.write fault site; a raise
                # here aborts the spill with the RAM copies intact
                # (nothing committed to the manifest yet) and is
                # counted by the sweep's error handler
                entry = cold.write_segment(metric, iv.interval,
                                           series_entries, ts_ms,
                                           cols, sketch=sketch)
            except Exception:
                cold.spill_errors += 1
                raise
            entries.append(entry)
            spilled_rows += len(ts_ms)
        if not entries:
            # nothing cold yet: leave the boundary so a later backlog
            # spill isn't clipped away by an empty range
            return changed
        # segments are durable: publish them + the moved boundary in
        # one atomic manifest write, THEN release the RAM copies
        cold.commit_spill(metric, new_b, entries)
        with self._lock:
            for key in [k for k in self._stitched if k[0] == mid]:
                del self._stitched[key]
        # release the RAM copies — only of ranges the (now committed)
        # segments actually cover
        self._purge_spilled_ranges(mid, metric, tiers)
        # the segments (and their sketch column) are committed: the
        # RAM sketch cells below the boundary are now disk duplicates
        if self.sketches is not None:
            if self.sketches.delete_before(metric, new_b,
                                           spilled=True):
                self.sketches.save()
        self.points_spilled += spilled_rows
        report["spilled"] += spilled_rows
        LOG.info("spilled %d tier points of %s to cold segments "
                 "(spill boundary %d)", spilled_rows, metric, new_b)
        return True

    def _gather_sketch_column(self, metric: str, iv,
                              series_entries: list, ts_ms
                              ) -> tuple | None:
        """The spill payload's fifth column: per-row serialized
        sketches aligned with the gathered tier rows, or None when
        this tier's grid is not the sketch cell grid (coarser tiers
        spill stat columns only) or no cells exist. Rows demoted
        before sketches were enabled blob as zero-length (readers
        treat those cells as percentile-less)."""
        if self.sketches is None:
            return None
        if iv.interval_ms != self.sketches.cell_ms(metric):
            return None
        blobs: list[bytes] = []
        have = 0
        for e in series_entries:
            names = tuple(tuple(p) for p in e["tags"])
            lo = int(e["off"])
            for ts in np.asarray(ts_ms[lo:lo + int(e["cnt"])]) \
                    .tolist():
                blob = self.sketches.blob_for(metric, names, int(ts))
                blobs.append(blob or b"")
                have += blob is not None
        if not have:
            return None
        off = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=off[1:])
        return off, b"".join(blobs)

    def _spill_histograms(self, mid: int, metric: str,
                          pol: LifecyclePolicy, now_ms: int,
                          report: dict) -> bool:
        """Mechanism 4b: spill live histogram arena rows older than
        the spill horizon into cold sketch segments (interval label
        ``"histogram"``), then purge them from the arena. Each row's
        bucket counts fold at bucket midpoints — the same convention
        the arena engine's percentile extraction and the cluster
        partials path use — so a cold percentile read answers within
        alpha of what the live arena would have said. Crash ordering
        matches the tier spill: segment durable, manifest + boundary
        committed atomically, THEN the RAM rows purge."""
        cold = self.coldstore
        t = self.tsdb
        if cold is None or self.sketches is None:
            return False
        with t._histogram_lock:
            arena = t._histogram_arenas.get(mid)
            snaps = [(s.bounds, *s.snapshot())
                     for s in arena.groups.values()] if arena else []
        if not snaps:
            return False
        prev = cold.spill_boundary(metric)
        target = now_ms - pol.spill_after_ms
        rs = t.rollup_store
        if rs is not None:
            # a mixed metric (tier history + arenas) shares ONE spill
            # boundary: never advance it past the demote boundary, or
            # stitched tier reads would clip un-spilled tier RAM
            with rs._tiers_lock:
                tier_stores = list(rs._tiers.values())
            if any(len(st.series_ids_for_metric(mid))
                   for st in tier_stores):
                target = min(target, self.demote_boundary(mid))
        if target <= prev:
            return False
        # first spill of this metric's arenas takes the WHOLE history
        # below the boundary (tier-spill rule); afterwards rows below
        # prev are crash-window disk duplicates the purge clears
        lo = max(prev, 1) \
            if cold.has_segments(metric, "histogram") else 1
        cfg = t.config
        alpha = cfg.get_float("tsd.sketch.alpha", 0.01)
        max_buckets = cfg.get_int("tsd.sketch.max_buckets", 4096)
        from opentsdb_tpu_torch.sketch.ddsketch import DDSketch
        uids = t.uids
        store = t.histogram_store
        names_of: dict[int, tuple | None] = {}
        rows_of: dict[tuple, list] = {}
        for bounds, ts_a, sid_a, rows in snaps:
            b = np.asarray(bounds, dtype=np.float64)
            mids = (b[:-1] + b[1:]) / 2.0
            m = (ts_a >= lo) & (ts_a < target)
            if not m.any():
                continue
            for ts, sid, counts in zip(ts_a[m].tolist(),
                                       sid_a[m].tolist(),
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
                    continue  # unresolvable identity stays in RAM
                counts = np.asarray(counts, dtype=np.float64)
                total = float(counts.sum())
                if total <= 0:
                    continue
                sk = DDSketch(alpha)
                sk.add_weighted(mids, counts)
                if max_buckets:
                    sk.collapse(max_buckets)
                nz = np.nonzero(counts)[0]
                rows_of.setdefault(names, []).append(
                    (int(ts), total, float((mids * counts).sum()),
                     float(mids[nz[0]]), float(mids[nz[-1]]),
                     sk.to_bytes()))
        if not rows_of:
            return False
        series_entries: list[dict] = []
        ts_parts: list[int] = []
        cols: dict[str, list] = {s: [] for s in
                                 ("sum", "count", "min", "max")}
        blobs: list[bytes] = []
        off = 0
        for names in sorted(rows_of):
            srows = sorted(rows_of[names])
            series_entries.append({"tags": [list(p) for p in names],
                                   "off": off, "cnt": len(srows)})
            off += len(srows)
            for ts, cnt, vsum, vmin, vmax, blob in srows:
                ts_parts.append(ts)
                cols["count"].append(cnt)
                cols["sum"].append(vsum)
                cols["min"].append(vmin)
                cols["max"].append(vmax)
                blobs.append(blob)
        ts_ms = np.asarray(ts_parts, dtype=np.int64)
        col_arr = {s: np.asarray(v, dtype=np.float64)
                   for s, v in cols.items()}
        sk_off = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(bb) for bb in blobs], out=sk_off[1:])
        try:
            entry = cold.write_segment(
                metric, "histogram", series_entries, ts_ms, col_arr,
                sketch=(sk_off, b"".join(blobs)))
        except Exception:
            cold.spill_errors += 1
            raise
        cold.commit_spill(metric, target, [entry])
        t.purge_histograms_before(mid, target)
        self.histogram_points_spilled += len(ts_ms)
        report["histogramSpilled"] += len(ts_ms)
        LOG.info("spilled %d histogram rows of %s to a cold sketch "
                 "segment (spill boundary %d)", len(ts_ms), metric,
                 target)
        return True

    def _purge_spilled_ranges(self, mid: int, metric: str,
                              tiers) -> int:
        """Delete one metric's in-RAM tier cells wherever cold
        segments cover them: per tier interval, [1, max segment
        end_ms]. Strictly safe — only RAM that is duplicated on disk
        is ever released (a tier backfilled after its spill loses the
        backfill here, the same documented divergence as writes
        backfilled behind the demotion boundary: the clip already
        hides them). Returns points removed."""
        cold = self.coldstore
        rs = self.tsdb.rollup_store
        purged = 0
        for iv in tiers:
            handles = cold._handles(metric, iv.interval)
            if not handles:
                continue
            hi = max(h.entry["end_ms"] for h in handles)
            for agg in _TIER_AGGS:
                st = rs._tiers.get((iv.interval, agg))
                if st is None:
                    continue
                tsids = st.series_ids_for_metric(mid)
                if len(tsids):
                    purged += st.delete_range(tsids, 1, hi)
        return purged

    def _gather_tier_history(self, mid: int, interval: str,
                             start_ms: int, end_ms: int):
        """Columnar spill payload for one (metric, tier interval) (ref:
        ``_gather_tier_history``): ``(series_entries, ts_ms, {stat:
        column})`` over [start_ms, end_ms], series in sorted tag-UID
        order, or None when the window holds nothing. Per series, the
        timestamp set is the union across the four stat stores (the
        rollup job writes all four for every cell, but external writers
        may not) with missing stats as NaN, which every read path skips.
        One range read per stat store."""
        t = self.tsdb
        rs = t.rollup_store
        stores = {agg: st for agg in _TIER_AGGS
                  if (st := rs._tiers.get((interval, agg)))
                  is not None}
        if not stores:
            return None
        reads = {}
        for agg, st in stores.items():
            tsids = np.asarray(st.series_ids_for_metric(mid),
                               dtype=np.int64)
            if not len(tsids):
                continue
            batch = st.materialize(tsids, start_ms, end_ms)
            if not batch.num_points:
                continue
            counts = np.bincount(batch.series_idx, minlength=len(tsids))
            keep = np.nonzero(counts)[0]
            tags = [st.series(int(tsids[i])).tags for i in keep.tolist()]
            reads[agg] = (tags, counts[keep], batch.ts_ms, batch.values)
        if not reads:
            return None
        return self._tier_columns(reads)

    def _series_names(self, tags) -> list | None:
        """Sorted (tagk, tagv) name pairs of a UID identity, or None
        when a UID no longer resolves (that series stays in RAM)."""
        uids = self.tsdb.uids
        try:
            return sorted((uids.tag_names.get_name(k),
                           uids.tag_values.get_name(v)) for k, v in tags)
        except LookupError:
            return None

    def _tier_columns(self, reads):
        """The payload from the four reads: every (series, timestamp)
        cell that any stat holds, in sorted identity then time order,
        found by one lexsort over all rows, and each stat scattered into
        a NaN column over those cells."""
        keys = sorted({k for tags, _, _, _ in reads.values()
                       for k in tags})
        names = [self._series_names(k) for k in keys]
        rank = {k: i for i, k in enumerate(keys)}
        sid_parts, ts_parts, spans = [], [], {}
        at = 0
        for agg, (tags, counts, ts_ms, _) in reads.items():
            sid_parts.append(np.repeat(
                np.asarray([rank[k] for k in tags], dtype=np.int64),
                counts))
            ts_parts.append(np.asarray(ts_ms, dtype=np.int64))
            spans[agg] = (at, at + len(ts_ms))
            at += len(ts_ms)
        sid = np.concatenate(sid_parts)
        ts = np.concatenate(ts_parts)
        # an identity whose UIDs no longer resolve stays in RAM
        ok = np.asarray([n is not None for n in names], dtype=bool)
        order = np.lexsort((ts, sid))
        order = order[ok[sid[order]]]
        if not len(order):
            return None
        s_o, t_o = sid[order], ts[order]
        new = np.ones(len(order), dtype=bool)
        new[1:] = (s_o[1:] != s_o[:-1]) | (t_o[1:] != t_o[:-1])
        cell = np.full(len(ts), -1, dtype=np.int64)
        cell[order] = np.cumsum(new) - 1
        n_cells = int(new.sum())
        cols = {}
        for agg in _TIER_AGGS:
            col = np.full(n_cells, np.nan)
            if agg in spans:
                lo, hi = spans[agg]
                c = cell[lo:hi]
                keep = c >= 0
                col[c[keep]] = reads[agg][3][keep]
            cols[agg] = col
        cell_sid = s_o[new]
        counts = np.bincount(cell_sid, minlength=len(keys))
        series_entries = []
        off = 0
        for i in np.nonzero(counts)[0].tolist():
            n = int(counts[i])
            series_entries.append({"tags": [list(p) for p in names[i]],
                                   "off": off, "cnt": n})
            off += n
        return series_entries, t_o[new], cols

    def _publish_boundary(self, mid: int, boundary: int) -> None:
        with self._lock:
            self._boundaries[mid] = boundary
            # stale stitched views die here; the next query mints
            # fresh instances (new instance_id => new cache keys)
            for key in [k for k in self._stitched if k[0] == mid]:
                del self._stitched[key]
        self._save_boundaries()

    def _save_boundaries(self) -> None:
        """Persist metric-name -> boundary so restarts keep stitching
        (names, not ids: they are stable across UID reloads).
        Best-effort — a failed save means one sweep's boundary move is
        re-derived by the next sweep, never a serve-path error."""
        if not self._boundary_path:
            return
        import json
        with self._lock:
            boundaries = dict(self._boundaries)
        doc: dict[str, int] = {}
        for mid, b in boundaries.items():
            try:
                doc[self.tsdb.uids.metrics.get_name(mid)] = b
            except LookupError:
                continue
        try:
            from opentsdb_tpu_torch.core.persist import atomic_write
            atomic_write(self._boundary_path,
                         json.dumps({"boundaries": doc}).encode())
        except OSError as exc:  # pragma: no cover - disk trouble
            LOG.warning("could not persist lifecycle boundaries: %s",
                        exc)

    def _load_boundaries(self) -> None:
        import json
        import os
        if not os.path.isfile(self._boundary_path):
            return
        try:
            with open(self._boundary_path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as exc:
            LOG.warning("could not load lifecycle boundaries: %s", exc)
            return
        for name, b in (doc.get("boundaries") or {}).items():
            try:
                mid = self.tsdb.uids.metrics.get_id(name)
            except LookupError:
                continue
            self._boundaries[mid] = int(b)

    @staticmethod
    def _oldest_ts(store, sids: np.ndarray, floor_ms: int) -> int:
        """The oldest timestamp of any of ``sids`` (but never below
        ``floor_ms``; ref: ``_oldest_ts``): it bounds the rollup job's
        window so its bucket grid does not span from epoch zero."""
        first = store.first_timestamps(sids)
        first = first[first != FIRST_TS_NONE]
        if not len(first):
            return floor_ms
        return max(int(first.min()), floor_ms)

    # ------------------------------------------------------------------
    # fsck surface
    # ------------------------------------------------------------------

    def scan_expired(self, now_ms: int | None = None
                     ) -> dict[str, int]:
        """Expired-but-present raw point counts per metric (read-only;
        the reference's fsck reports these and ``--fix`` purges them
        through :meth:`sweep`)."""
        now_ms = int(now_ms if now_ms is not None
                     else time.time() * 1000)
        t = self.tsdb
        out: dict[str, int] = {}
        store = t.store
        for mid in store.metric_ids():
            try:
                metric = t.uids.metrics.get_name(mid)
            except LookupError:
                continue
            pol = self.policies.for_metric(metric)
            if pol is None or not pol.retention_ms:
                continue
            cutoff = now_ms - pol.retention_ms
            if cutoff <= 0:
                continue
            sids = store.series_ids_for_metric(mid)
            if len(sids) == 0:
                continue
            n = int(store.count_range(sids, 1, cutoff - 1).sum())
            if n:
                out[metric] = n
        return out

    # ------------------------------------------------------------------
    # admin / observability
    # ------------------------------------------------------------------

    def update_policies(self, obj: dict) -> None:
        """``POST /api/lifecycle`` body: wholesale policy replacement
        (``{"policies": [...]}``; validation failures leave the table
        untouched)."""
        from opentsdb_tpu_torch.query.model import BadRequestError
        if not isinstance(obj, dict):
            raise BadRequestError("body must be an object")
        raw = obj.get("policies")
        if not isinstance(raw, list):
            raise BadRequestError("body needs a 'policies' array")
        self.policies.replace(
            [LifecyclePolicy.from_json(p) for p in raw])

    def describe(self) -> dict[str, Any]:
        with self._lock:
            boundaries = dict(self._boundaries)
        names = {}
        for mid, b in boundaries.items():
            try:
                names[self.tsdb.uids.metrics.get_name(mid)] = b
            except LookupError:
                names[f"#{mid}"] = b
        doc = {
            "enabled": True,
            "intervalS": self.interval_s,
            "policies": self.policies.to_json(),
            "demoteBoundaries": names,
            "counters": self._counters(),
        }
        if self.breaker is not None:
            doc["breaker"] = self.breaker.health_info()
        if self.coldstore is not None:
            doc["coldstore"] = self.coldstore.health_info()
            doc["spillBoundaries"] = self.coldstore.spill_boundaries()
        if self.sketches is not None:
            doc["sketches"] = self.sketches.describe()
        return doc

    def health_info(self) -> dict[str, Any]:
        """The ``lifecycle`` section of ``/api/health`` (ref:
        ``health_info``)."""
        doc = {"enabled": True, **self._counters()}
        if self.breaker is not None:
            doc["breaker"] = self.breaker.health_info()
        if self.coldstore is not None:
            doc["coldstore"] = self.coldstore.health_info()
        return doc

    def _counters(self) -> dict[str, Any]:
        return {
            "sweeps": self.sweeps,
            "sweepErrors": self.sweep_errors,
            "pointsPurged": self.points_purged,
            "pointsDemoted": self.points_demoted,
            "tierPointsWritten": self.tier_points_written,
            "bytesReclaimed": self.bytes_reclaimed,
            "seriesReleased": self.series_released,
            "pointsSpilled": self.points_spilled,
            "histogramPointsPurged": self.histogram_points_purged,
            "histogramPointsSpilled": self.histogram_points_spilled,
            "lastSweepDurationMs": round(self.last_sweep_duration_ms,
                                         1),
            "lastSweepTime": int(self.last_sweep_time),
            "lastError": self.last_error,
        }

    def collect_stats(self, collector) -> None:
        collector.record("lifecycle.sweeps", self.sweeps)
        collector.record("lifecycle.sweep_errors", self.sweep_errors)
        collector.record("lifecycle.points.purged", self.points_purged)
        collector.record("lifecycle.points.demoted",
                         self.points_demoted)
        collector.record("lifecycle.tier_points.written",
                         self.tier_points_written)
        collector.record("lifecycle.bytes.reclaimed",
                         self.bytes_reclaimed)
        collector.record("lifecycle.series.released",
                         self.series_released)
        collector.record("lifecycle.points.spilled",
                         self.points_spilled)
        collector.record("lifecycle.histogram_points.purged",
                         self.histogram_points_purged)
        collector.record("lifecycle.histogram_points.spilled",
                         self.histogram_points_spilled)
        collector.record("lifecycle.sweep.duration_ms",
                         self.last_sweep_duration_ms)
        if self.sketches is not None:
            collector.record("sketch.points.folded",
                             self.sketches.points_folded)
            collector.record("sketch.cells.folded",
                             self.sketches.cells_folded)
            collector.record("sketch.cells.spilled",
                             self.sketches.cells_spilled)
        if self.coldstore is not None:
            self.coldstore.collect_stats(collector)
