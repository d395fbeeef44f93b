"""Continuous-query registry: standing TSQueries maintained by shared
off-path fold workers and served three ways (ref:
``opentsdb_tpu/streaming/registry.py``).

Clients register a standing TSQuery (``POST /api/query/continuous``,
optionally with a ``window`` object — tumbling by default, sliding or
session-gap). Each sub-query compiles into a
:class:`~opentsdb_tpu_torch.streaming.plan.PlanView` attached to a
:class:`~opentsdb_tpu_torch.streaming.plan.SharedPartial` keyed by the
canonical sub-plan identity ``(metric, membership filters, base
downsample interval)`` — N continuous queries over the same
sub-expression share ONE partial array and one fold
(multi-query plan sharing; a divisible coarser interval derives by
stride combine).

The ingest tap (every raw write path of ``TSDB``: ``add_point``,
``add_points``, ``add_point_groups``, ``add_series_points`` and
``import_buffer``, through :meth:`offer` / :meth:`offer_lines`) is an
O(1) columnar append per partial — folds NEVER run on the write path.
A partial's bootstrap seals the TSDB's ``tap_gate`` while it scans, so
a point is either in the scan or in a later offer, never both.
When a partial's backlog crosses ``tsd.streaming.buffer_points`` it is
handed to the shared fold-worker pool
(:mod:`opentsdb_tpu_torch.streaming.workers`); a
backlog past ``tsd.streaming.workers.max_pending_points`` degrades
the lagging partial to rebuild-on-serve (backlog dropped, counted)
instead of blocking or failing the acknowledged write.

Results serve three ways:

- **pull** — the query engine consults :meth:`try_serve` before the
  result cache: a live-window request matching a registered tumbling
  query is answered from the maintained partials (synchronous drain +
  pipeline tail, never a store scan — and never stale: the serve path
  drains pending folds itself, whatever the workers' lag).
- **push** — Server-Sent Events (``GET /api/query/continuous/<id>/
  stream``) emitting incremental window updates, with bounded
  per-subscription queues and slow-consumer shedding
  (:mod:`opentsdb_tpu_torch.streaming.sse`).
- **fetch** — ``GET /api/query/continuous/<id>/result`` returns the
  current windowed results (the only pull surface for sliding /
  session windows, which no plain TSQuery can express).

Bootstrap seeds partials from the raw store, and demoted history from
the lifecycle's stitched tier views where a tier nests in the base
interval; a partial that cannot be tier-seeded sheds windows before
the demotion boundary to the batch engine.

Degradation: serve-path folds/rebuilds run under the ``stream.fold``
fault site, worker drains additionally under ``stream.worker``, both
behind one :class:`CircuitBreaker`; a failed fold marks the partial for
rebuild (one batch re-scan), a tripped breaker sheds pulls to the batch
engine (a return of None from :meth:`try_serve`, counted in
``serve_fallbacks``) until the reset-window probe heals it, and
``/result`` answers 503. An exception out of a view's serve (the tail
on the card failing, say) is not such a shed: it propagates to the
caller. Counters export through ``/api/stats`` (``health_info`` has no
endpoint until ``/api/health`` is ported).

Knobs (``tsd.streaming.*``): ``enable``, ``serve``, ``max_queries``,
``max_windows``, ``buffer_points``, ``queue_events``,
``heartbeat_s``, ``publish_min_interval_ms``, ``resume_events``,
``workers.count``, ``workers.max_pending_points``,
``breaker.failure_threshold``, ``breaker.reset_timeout_ms``.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any

import numpy as np

from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.query.result_cache import _is_relative
from opentsdb_tpu_torch.streaming import sse
from opentsdb_tpu_torch.streaming.eventtime import (SessionPartial,
                                                    WatermarkPolicy,
                                                    completeness_marker)
from opentsdb_tpu_torch.streaming.plan import (DECOMPOSABLE_DS, PlanView,
                                               SharedPartial, WindowSpec,
                                               filter_identity)
from opentsdb_tpu_torch.streaming.workers import FoldWorkerPool
from opentsdb_tpu_torch.utils.faults import CircuitBreaker, DegradedError

LOG = logging.getLogger("streaming.registry")


class ContinuousQuery:
    """One registered standing query: the validated TSQuery plus one
    plan view per sub-query and the SSE subscriber set."""

    def __init__(self, cid: str, raw: dict, tsq: TSQuery,
                 plans: list[PlanView],
                 policy: WatermarkPolicy | None = None):
        self.id = cid
        self.raw = raw          # original JSON body (re-resolved per emit)
        self.tsq = tsq
        self.plans = plans
        # event-time watermark/lateness policy (None = legacy
        # processing-time contract, no completeness markers)
        self.policy = policy
        self.created = time.time()
        self.lock = threading.Lock()
        self.subscribers: list = []
        self.emit_seq = 0
        self.last_publish = 0.0
        self.closed = False
        # bounded replay history for SSE resume (Last-Event-ID): the
        # last N published `windows` frames, each tagged with its emit
        # seq. evicted_seq = the newest frame pushed out — a reconnect
        # older than it has missed un-replayable events and falls back
        # to a snapshot.
        self.history: list[tuple[int, bytes]] = []
        self.evicted_seq = 0
        # the tenant that registered it under tenant QoS (control/qos.py)
        self.tenant: str | None = None

    def fold_bytes(self) -> int:
        """Resident ring bytes this query's views hold (distinct
        shared partials counted once)."""
        seen: set[int] = set()
        total = 0
        for p in self.plans:
            g = p.shared
            if id(g) in seen:
                continue
            seen.add(id(g))
            total += g.ring_bytes()
        return total

    def describe(self, verbose: bool = False) -> dict[str, Any]:
        out: dict[str, Any] = {
            "id": self.id,
            "query": self.tsq.to_json(),
            "intervalMs": [p.interval_ms for p in self.plans],
            "windows": [p.n_windows for p in self.plans],
            "series": sum(len(p._sids) for p in self.plans),
            "subscribers": len(self.subscribers),
            "emitSeq": self.emit_seq,
            "foldBytes": self.fold_bytes(),
        }
        if self.plans:
            out["windowSpec"] = self.plans[0].window.to_json()
            out["sharedPlan"] = [len(p.shared.views) > 1
                                 for p in self.plans]
        if self.policy is not None:
            out["watermark"] = self.policy.to_json()
        if verbose:
            out["plans"] = [p.info() for p in self.plans]
        return out


class ContinuousQueryRegistry:
    """(see module docstring)"""

    def __init__(self, tsdb):
        self.tsdb = tsdb
        cfg = tsdb.config
        self._lock = threading.Lock()
        # registrations serialize here (control-plane; the ingest tap
        # and publish paths never take it) so two concurrent registers
        # cannot mint duplicate shared partials for one identity
        self._register_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._queries: dict[str, ContinuousQuery] = {}
        # every live shared partial (fold state the tap feeds)
        self._partials: list[SharedPartial] = []
        # metric_id -> partials watching it (the tap's fast path);
        # partials whose metric has no UID yet park in _unresolved
        # until a write materializes the metric
        self._by_mid: dict[int, list[SharedPartial]] = {}
        self._unresolved: list[SharedPartial] = []
        # (metric, sub identity) -> tumbling view for the pull path
        # (sliding/session views are push/fetch-only: a plain TSQuery
        # cannot express their combine)
        self._by_identity: dict[tuple, PlanView] = {}
        self.max_queries = cfg.get_int("tsd.streaming.max_queries", 64)
        self.max_windows = cfg.get_int("tsd.streaming.max_windows",
                                       2880)
        self.buffer_points = cfg.get_int("tsd.streaming.buffer_points",
                                         4096)
        self.max_pending_points = cfg.get_int(
            "tsd.streaming.workers.max_pending_points", 262144)
        self.queue_events = cfg.get_int("tsd.streaming.queue_events",
                                        256)
        self.heartbeat_s = cfg.get_float("tsd.streaming.heartbeat_s",
                                         5.0)
        self.publish_min_interval_ms = cfg.get_float(
            "tsd.streaming.publish_min_interval_ms", 200.0)
        # SSE resume replay depth (0 disables Last-Event-ID resume)
        self.resume_events = cfg.get_int(
            "tsd.streaming.resume_events", 64)
        threshold = cfg.get_int(
            "tsd.streaming.breaker.failure_threshold", 3)
        self.breaker = CircuitBreaker(
            "stream.fold", failure_threshold=threshold,
            reset_timeout_ms=cfg.get_float(
                "tsd.streaming.breaker.reset_timeout_ms", 30000.0)) \
            if threshold > 0 else None
        if self.breaker is not None:
            tsdb.stats.register(self.breaker)
        self.workers = FoldWorkerPool(
            self, cfg.get_int("tsd.streaming.workers.count", 2))
        # live SSE subscriber count, maintained so the ingest tap's
        # publish check is one integer read (never a registry walk)
        self._active_subs = 0
        # counters
        self.serve_hits = 0
        self.serve_fallbacks = 0
        self.fold_errors = 0
        self.rebuilds = 0
        self.backpressure_drops = 0
        self.backpressure_events = 0
        # bootstraps seeded from the lifecycle's tiers
        self.tier_seeded_bootstraps = 0
        self.sse_shed = 0
        self.sse_events = 0
        self.sse_resumes = 0
        self.sse_resume_snapshots = 0
        self.sse_events_delivered = 0  # frames on CLOSED streams
        self.publishes = 0

    # ------------------------------------------------------------------
    # registration surface
    # ------------------------------------------------------------------

    def register(self, obj: dict, now_ms: int | None = None
                 ) -> ContinuousQuery:
        """Validate + compile one standing TSQuery; raises
        :class:`BadRequestError` on anything the incremental engine
        cannot maintain (the client should run it as a plain query)."""
        if not isinstance(obj, dict):
            raise BadRequestError("continuous query must be an object")
        cid = obj.get("id")
        window_obj = obj.get("window")
        policy = WatermarkPolicy.from_json(obj.get("watermark"))
        body = {k: v for k, v in obj.items() if k != "id"}
        tsq = TSQuery.from_json(body).validate(now_ms)
        if tsq.delete:
            raise BadRequestError(
                "delete=true cannot be a continuous query")
        if tsq.timezone or tsq.use_calendar:
            raise BadRequestError(
                "continuous queries do not support timezone/calendar "
                "downsampling")
        specs: list[tuple] = []
        for sub in tsq.queries:
            if sub.tsuids or not sub.metric:
                raise BadRequestError(
                    "continuous queries require a metric (tsuids are "
                    "not supported)")
            if sub.explicit_tags:
                raise BadRequestError(
                    "continuous queries do not support explicitTags")
            spec = sub.ds_spec
            if spec is None or spec.run_all or spec.use_calendar \
                    or spec.unit in ("n", "y") or spec.interval_ms <= 0:
                raise BadRequestError(
                    "continuous queries require a fixed-interval "
                    "downsample (e.g. 1m-avg)")
            if spec.function not in DECOMPOSABLE_DS:
                raise BadRequestError(
                    f"downsample function {spec.function!r} is not "
                    f"decomposable into streaming partials "
                    f"(supported: {', '.join(sorted(DECOMPOSABLE_DS))})")
            window = WindowSpec.from_json(window_obj, spec.interval_ms)
            if window.by_tag:
                # per-tag session rows ARE the tag's values: grouping
                # by any other key has no per-row answer, and the
                # sketch channel is per-series — both refuse loudly
                # instead of answering wrong
                bad_gb = sorted({f.tagk for f in sub.filters
                                 if f.group_by} - {window.by_tag})
                if bad_gb:
                    raise BadRequestError(
                        f"session window by={window.by_tag!r} cannot "
                        f"group by other tags ({', '.join(bad_gb)})")
                if sub.percentiles:
                    raise BadRequestError(
                        "per-tag session windows do not support "
                        "percentiles (the sketch channel is "
                        "per-series)")
            if sub.percentiles:
                # percentile CQs serve from the shared ring's sketch
                # channel; only tumbling windows extract exactly
                # (sliding/session would need per-window sketch
                # re-merges the channel does not maintain)
                if not self.tsdb.config.get_bool(
                        "tsd.sketch.enable", True):
                    raise BadRequestError(
                        "continuous percentile queries need the "
                        "sketch subsystem (tsd.sketch.enable)")
                if window.kind != "tumbling":
                    raise BadRequestError(
                        "continuous percentile queries support "
                        "tumbling windows only")
            lat_b = policy.lateness_buckets(spec.interval_ms) \
                if policy is not None else 0
            windows = int((tsq.end_ms - tsq.start_ms)
                          // spec.interval_ms) + 2 \
                + window.lead_for(spec.interval_ms) + lat_b
            if windows > self.max_windows:
                raise BadRequestError(
                    f"window range needs {windows} tumbling windows; "
                    f"tsd.streaming.max_windows={self.max_windows}")
            specs.append((sub, window, windows))
        # the horizon anchors at the query's RESOLVED end: now for the
        # live-dashboard shape (end=now), the window's own end for an
        # absolute registration — either way the ring covers exactly
        # the window the standing query answers, and tumbles forward
        # with ingest from there
        anchor_ms = tsq.end_ms
        with self._register_lock:
            with self._lock:
                if len(self._queries) >= self.max_queries:
                    raise BadRequestError(
                        f"too many continuous queries (tsd.streaming."
                        f"max_queries={self.max_queries})")
                if cid is None:
                    cid = f"cq{next(self._ids)}"
                cid = str(cid)
                if cid in self._queries:
                    raise BadRequestError(
                        f"continuous query {cid!r} already exists")
                # reserve the id; the bootstrap scans below run
                # OUTSIDE the registry lock (the ingest tap takes it —
                # a wide bootstrap must not stall every write)
                self._queries[cid] = cq = ContinuousQuery(
                    cid, body, tsq, [], policy=policy)
            new_groups: list[SharedPartial] = []
            views: list[PlanView] = []
            try:
                for sub, window, need_w in specs:
                    fid = filter_identity(sub)
                    # a lateness policy (strict drops) or per-tag
                    # session keying (rows are tag values) changes
                    # fold SEMANTICS, not just the view combine —
                    # such partials only share with identical twins
                    if policy is not None:
                        fid = fid + (
                            f"lateness={policy.lateness_ms}",)
                    if window.by_tag:
                        fid = fid + (f"session_by={window.by_tag}",)
                    view_iv = int(sub.ds_spec.interval_ms)
                    with self._lock:
                        group = self._find_group_locked(
                            sub.metric, fid, view_iv)
                    if group is not None:
                        # the shared ring must cover BOTH its current
                        # span and this view's (lead-extended) range
                        # from the joint anchor; if stretching over
                        # both would exceed max_windows (e.g. a live
                        # dashboard attaching to a partial anchored
                        # on an old absolute range), the view gets
                        # its own partial instead of silently never
                        # being covered
                        base_iv = group.interval_ms
                        with group.lock:
                            newest = int(group.win_ts.max())
                            covered = group.covered_from_ms
                        anchor = max(anchor_ms,
                                     newest if newest > 0 else 0)
                        anchor_edge = anchor - anchor % base_iv
                        lat_v = policy.lateness_buckets(view_iv) \
                            if policy is not None else 0
                        start_edge = (
                            tsq.start_ms - tsq.start_ms % view_iv
                            - (window.lead_for(view_iv) + lat_v)
                            * view_iv)
                        # a view's own sizing from its start (the
                        # registration's +2), and the ring's current
                        # span, which already covers [covered, anchor]
                        # in (anchor - covered) // iv + 1 columns. The
                        # reference adds 2 to that span too, so every
                        # attach grows a shared ring by a column and
                        # re-scans it (ROADMAP Queue 3)
                        needed = int(
                            (anchor_edge - start_edge) // base_iv) + 2
                        if covered:
                            needed = max(needed, int(
                                (anchor_edge - covered) // base_iv) + 1)
                        if needed > self.max_windows:
                            group = None
                        else:
                            if sub.percentiles:
                                # a ring that predates its first
                                # percentile view seeds the sketch
                                # channel on the rebuild below (or
                                # lazily at first serve)
                                group.enable_sketch()
                            if group.ensure_horizon(needed, anchor_ms) \
                                    and group.tier_seeded:
                                self.tier_seeded_bootstraps += 1
                    if group is None:
                        if window.by_tag:
                            group = SessionPartial(
                                self.tsdb, sub.metric, sub.filters,
                                view_iv, need_w, window.by_tag)
                        else:
                            group = SharedPartial(
                                self.tsdb, sub.metric, sub.filters,
                                view_iv, need_w)
                        group.filter_key = fid
                        if policy is not None:
                            group.lateness_ms = policy.lateness_ms
                        if sub.percentiles:
                            group.want_sketch = True
                        group.bootstrap(anchor_ms)
                        if group.tier_seeded:
                            self.tier_seeded_bootstraps += 1
                        new_groups.append(group)
                    view = PlanView(group, sub, need_w, window)
                    views.append(view)
                for view in views:
                    view.shared.attach(view)
                cq.plans = views
                with self._lock:
                    for group in new_groups:
                        self._partials.append(group)
                        self._index_group_locked(group)
                    for view in views:
                        # policy views drop late points the raw store
                        # accepted, so they can no longer answer
                        # /api/query value-identically — pull through
                        # .../result, where the marker says what you
                        # got
                        if view.window.kind == "tumbling" \
                                and policy is None:
                            key = (view.metric,
                                   view.sub.identity_key())
                            self._by_identity.setdefault(key, view)
            except BaseException:
                for view in views:
                    view.shared.detach(view)
                with self._lock:
                    self._queries.pop(cid, None)
                raise
        LOG.info("registered continuous query %s (%d sub-plans, "
                 "%d new shared partials)", cid, len(views),
                 len(new_groups))
        return cq

    def _find_group_locked(self, metric: str, fid: tuple,
                           interval_ms: int) -> SharedPartial | None:
        """The best existing shared partial this sub-expression can
        attach to: same metric, same membership filters, base
        interval dividing the sub's interval (coarsest such base
        wins — least stride work per serve)."""
        best = None
        for g in self._partials:
            if g.metric == metric \
                    and getattr(g, "filter_key", None) == fid \
                    and interval_ms % g.interval_ms == 0:
                if best is None or g.interval_ms > best.interval_ms:
                    best = g
        return best

    def _index_group_locked(self, group: SharedPartial) -> None:
        if group.metric_id is not None:
            self._by_mid.setdefault(group.metric_id, []).append(group)
        else:
            self._unresolved.append(group)

    def _drop_group_locked(self, group: SharedPartial) -> None:
        if group in self._partials:
            self._partials.remove(group)
        if group.metric_id is not None:
            lst = self._by_mid.get(group.metric_id, [])
            if group in lst:
                lst.remove(group)
            if not lst:
                self._by_mid.pop(group.metric_id, None)
        if group in self._unresolved:
            self._unresolved.remove(group)

    def delete(self, cid: str) -> bool:
        with self._lock:
            cq = self._queries.pop(cid, None)
            if cq is None:
                return False
            cq.closed = True
            for view in cq.plans:
                if view.shared.detach(view):
                    self._drop_group_locked(view.shared)
                if view.window.kind != "tumbling":
                    continue
                key = (view.metric, view.sub.identity_key())
                if self._by_identity.get(key) is view:
                    del self._by_identity[key]
                    # a surviving query with the same identity takes
                    # over the pull path instead of silently falling
                    # back to batch scans (policy queries stay out of
                    # it: strict lateness breaks batch exactness)
                    for other in self._queries.values():
                        if other.policy is not None:
                            continue
                        for p in other.plans:
                            if p.window.kind == "tumbling" and \
                                    (p.metric,
                                     p.sub.identity_key()) == key:
                                self._by_identity[key] = p
                                break
                        if key in self._by_identity:
                            break
            subs = list(cq.subscribers)
        for sub in subs:
            sse.offer_frame(sub, sse.frame(
                "deleted", {"id": cid}))
        return True

    def get(self, cid: str) -> ContinuousQuery | None:
        with self._lock:
            return self._queries.get(cid)

    def list(self) -> list[ContinuousQuery]:
        with self._lock:
            return [self._queries[k] for k in sorted(self._queries)]

    def invalidate(self) -> None:
        """Mark every partial for rebuild (the ``/api/dropcaches``
        escape hatch: the next serve/pump re-seeds from the store)."""
        with self._lock:
            groups = list(self._partials)
        for group in groups:
            group.needs_rebuild = True

    def shutdown(self) -> None:
        for cq in self.list():
            self.delete(cq.id)
        self.workers.stop()

    # ------------------------------------------------------------------
    # ingest tap (called from TSDB under the write-hook guard):
    # O(1) columnar enqueue per shared partial — never a fold
    # ------------------------------------------------------------------

    def _groups_for(self, metric_id: int
                    ) -> list[SharedPartial] | None:
        groups = self._by_mid.get(metric_id)
        if groups is not None or not self._unresolved:
            return groups
        # a parked partial's metric may have just been minted by this
        # very write: resolve by name once, then the fast path hits
        with self._lock:
            if not self._unresolved:
                return self._by_mid.get(metric_id)
            try:
                name = self.tsdb.uids.metrics.get_name(metric_id)
            except LookupError:
                return None
            for group in list(self._unresolved):
                if group.metric == name:
                    group.metric_id = metric_id
                    self._unresolved.remove(group)
                    self._by_mid.setdefault(metric_id,
                                            []).append(group)
            return self._by_mid.get(metric_id)

    def offer(self, metric_id: int, sid: int, ts_ms: int,
              value: float) -> None:
        groups = self._groups_for(metric_id)
        if not groups:
            return
        for group in groups:
            self._post_offer(group,
                             group.offer_one(sid, ts_ms, value))
        self._notify_publish()

    def offer_lines(self, metric_id: int, sids: np.ndarray,
                    ts_ms: np.ndarray, values: np.ndarray) -> None:
        """The columnar tap: points of one metric, of any of its
        series, as one chunk per shared partial (``add_points`` offers
        one series, the port's bulk paths ``add_series_points`` and
        ``import_buffer`` many; the reference's ``offer_many`` is the
        one-series case)."""
        groups = self._groups_for(metric_id)
        if not groups:
            return
        sids = np.asarray(sids, dtype=np.int64)
        for group in groups:
            self._post_offer(group, group.offer(sids, ts_ms, values))
        self._notify_publish()

    def _post_offer(self, group: SharedPartial, pending: int) -> None:
        """Post-enqueue policy, still on the write path so it must be
        O(1): hand a full buffer to the workers; DEGRADE a partial
        whose backlog says the workers cannot keep up — drop the
        backlog, rebuild on the next serve, never block the write."""
        if pending > self.max_pending_points:
            dropped = group.drop_pending()
            group.needs_rebuild = True
            self.backpressure_drops += dropped
            self.backpressure_events += 1
            LOG.warning(
                "streaming partial for %s lagging (%d pending "
                "points > tsd.streaming.workers.max_pending_points);"
                " degraded to rebuild-on-serve", group.metric,
                dropped)
        elif pending >= self.buffer_points:
            if self.workers.enabled:
                self.workers.submit(group)
            else:
                # workers disabled (tsd.streaming.workers.count=0):
                # the v1 inline drain is the explicit opt-back-in
                self._drain_group(group)

    def _notify_publish(self) -> None:
        if self._active_subs <= 0:
            return
        if self.workers.enabled:
            self.workers.notify_publish()
        else:
            self._maybe_publish()

    # ------------------------------------------------------------------
    # folds: off-path (workers) or serve-path (synchronous freshness)
    # ------------------------------------------------------------------

    def _drain_group(self, group: SharedPartial) -> None:
        """Fold a partial's pending chunks under the ``stream.fold``
        fault site + breaker. Drains serialize per partial
        (``_drain_lock``) so worker and serve-path drains fold chunks
        in arrival order. A failed fold loses the chunks, so the
        partial is marked for rebuild (one batch re-scan) —
        correctness is restored by the rebuild, availability by the
        batch-engine fallback in the meantime."""
        with group._drain_lock:
            pending = group.take_pending()
            if not pending:
                return
            br = self.breaker
            if br is not None and br.blocking():
                # folds while open would be wasted against a failing
                # dependency; the rebuild after reset covers the gap
                group.needs_rebuild = True
                return
            try:
                faults = getattr(self.tsdb, "faults", None)
                if faults is not None:
                    faults.check("stream.fold")
                if len(pending) > 1:
                    # per-point ingest taps one 1-point chunk each —
                    # folding those one at a time pays the full
                    # lock/admit/scatter overhead per POINT. fold()
                    # resolves sids per element, so a pass's chunks
                    # concatenate (arrival order preserved) into one
                    # columnar scatter; the per-pass watermark commit
                    # already treats the pass as one batch
                    group.fold(
                        np.concatenate([p[0] for p in pending]),
                        np.concatenate([p[1] for p in pending]),
                        np.concatenate([p[2] for p in pending]))
                else:
                    group.fold(*pending[0])
            except Exception as exc:  # noqa: BLE001 - degrade
                self.fold_errors += 1
                group.needs_rebuild = True
                if br is not None:
                    br.record_failure()
                LOG.warning("stream.fold failed for %s (%s: %s); "
                            "partial will rebuild", group.metric,
                            type(exc).__name__, exc)
            else:
                if br is not None and br.state != br.CLOSED:
                    br.record_success()
            finally:
                # event-time watermark advances once per PASS, not
                # per chunk: a batch the tap chunked per series must
                # fold wholly against the pre-batch watermark
                group.commit_watermark()

    def worker_drain(self, group: SharedPartial) -> None:
        """One worker-pool drain: the ``stream.worker`` fault site
        wraps the hand-off so worker faults degrade exactly like fold
        faults (rebuild-on-serve, breaker, counters) without ever
        touching the write path or a serve."""
        try:
            faults = getattr(self.tsdb, "faults", None)
            if faults is not None:
                faults.check("stream.worker")
        except Exception as exc:  # noqa: BLE001 - degrade
            self.fold_errors += 1
            group.needs_rebuild = True
            if self.breaker is not None:
                self.breaker.record_failure()
            LOG.warning("stream.worker failed for %s (%s: %s); "
                        "partial will rebuild", group.metric,
                        type(exc).__name__, exc)
            return
        self._drain_group(group)

    def _rebuild_group(self, group: SharedPartial,
                       now_ms: int) -> bool:
        """Re-seed a failed partial from the store, gated by the
        breaker (a rebuild IS the half-open probe when the breaker
        is open)."""
        if self.tsdb.tap_gate.in_write():
            # a write's own publish pass (workers off) cannot seal the
            # gate it holds: the partial stays marked for the next pull
            return False
        br = self.breaker
        if br is not None and not br.allow():
            return False
        try:
            faults = getattr(self.tsdb, "faults", None)
            if faults is not None:
                faults.check("stream.fold")
            group.bootstrap(now_ms)
        except Exception as exc:  # noqa: BLE001
            if br is not None:
                br.record_failure()
            LOG.warning("stream rebuild failed for %s (%s: %s)",
                        group.metric, type(exc).__name__, exc)
            return False
        group.needs_rebuild = False
        self.rebuilds += 1
        if group.tier_seeded:
            self.tier_seeded_bootstraps += 1
        if br is not None:
            br.record_success()
        return True

    # ------------------------------------------------------------------
    # pull path: serve /api/query from the maintained windows
    # ------------------------------------------------------------------

    def try_serve(self, tsq: TSQuery, sub, engine) -> list | None:
        """Results for one sub-query when a registered tumbling view
        covers the requested window, else None (caller falls through
        to the result cache / batch engine).

        Exactness contract: bucket-aligned absolute windows (and any
        window whose end is past the newest folded point) are
        value-identical to the batch engine; relative dashboard
        windows (``1h-ago`` .. now) share the result cache's
        GraphHandler staleness rule — the first bucket may cover up to
        one extra downsample interval."""
        if not self.tsdb.config.get_bool("tsd.streaming.serve", True):
            return None
        if tsq.delete or tsq.timezone or tsq.use_calendar:
            return None
        view = self._by_identity.get((sub.metric, sub.identity_key()))
        if view is None:
            return None
        group = view.shared
        iv = view.interval_ms
        relative = _is_relative(tsq.start) or _is_relative(tsq.end)
        if not relative and tsq.start_ms % iv:
            return None
        # a partial seeded from the stitched tiers covers history
        # before the demotion boundary exactly; one that is NOT
        # tier-seeded (no nesting tier) never saw it: shed those
        # windows to the batch engine, whose stitched store serves them
        # (percentile views carry their own coverage boundary,
        # sketch_from_ms, checked inside the serve)
        lc = self.tsdb.lifecycle
        if lc is not None and not sub.percentiles \
                and not group.tier_seeded and \
                tsq.start_ms < lc.demote_boundary_for(sub.metric):
            self.serve_fallbacks += 1
            return None
        # deletes/repairs/sweeps bump the read-set's mutation epochs;
        # partials cannot unfold removed points, so a mismatch forces
        # a rebuild before anything is served (this also covers
        # delete=true queries and fsck repairs the registry never
        # sees directly)
        if group.epoch_changed():
            group.needs_rebuild = True
        if group.needs_rebuild and not self._rebuild_group(
                group, tsq.end_ms):
            self.serve_fallbacks += 1
            return None
        # synchronous drain: freshness never depends on worker lag
        self._drain_group(group)
        if group.needs_rebuild:  # the drain itself just failed
            self.serve_fallbacks += 1
            return None
        if not relative and (tsq.end_ms + 1) % iv \
                and tsq.end_ms < group.max_ts_ms:
            # checked AFTER the drain: points past the unaligned end
            # may have just folded into the final bucket — the batch
            # engine would exclude them, so exactness is gone
            self.serve_fallbacks += 1
            return None
        out = view.serve(tsq, sub, engine)
        if out is None:
            self.serve_fallbacks += 1
            return None
        self.serve_hits += 1
        return out

    # ------------------------------------------------------------------
    # push path: SSE publication
    # ------------------------------------------------------------------

    def subscribe(self, cq: ContinuousQuery,
                  last_event_id: int | None = None):
        sub = sse.Subscription(self.queue_events)
        # resume (Last-Event-ID): replay only the `windows` frames
        # published since the client's last seen event instead of the
        # full snapshot; an id that aged out of the bounded history
        # (or is unknown) falls back to the snapshot. Registration +
        # replay happen in ONE cq.lock section so a concurrent
        # publish (which snapshots targets and appends history under
        # the same lock) can neither interleave a newer frame ahead
        # of the replay nor slip a frame past both paths.
        resumed = False
        with cq.lock:
            cq.subscribers.append(sub)
            self._active_subs += 1
            if last_event_id is not None:
                resumed = self._resume_locked(cq, sub,
                                              int(last_event_id))
        if resumed:
            self.sse_resumes += 1
            return sub
        # initial snapshot so a dashboard renders before the first
        # incremental update arrives
        try:
            self._publish(cq, snapshot=True, only=[sub])
        except Exception:  # noqa: BLE001 - snapshot is best-effort
            # the stream stays open and its next pump publishes
            LOG.exception("initial snapshot failed for %s", cq.id)
        return sub

    def _resume_locked(self, cq: ContinuousQuery, sub,
                       last_id: int) -> bool:
        """Replay the frames the reconnecting client missed (caller
        holds ``cq.lock``); False when only a snapshot can catch it
        up."""
        if self.resume_events <= 0:
            return False
        if last_id > cq.emit_seq or last_id < cq.evicted_seq:
            # future/bogus id, or a `windows` frame newer than the
            # client's position was already evicted: the gap is not
            # replayable
            self.sse_resume_snapshots += 1
            return False
        for seq, fr in cq.history:
            if seq > last_id and not sse.offer_frame(sub, fr):
                return False  # overflowed mid-replay: sub is shed
        return True

    def unsubscribe(self, cq: ContinuousQuery, sub) -> None:
        with cq.lock:
            if sub in cq.subscribers:
                cq.subscribers.remove(sub)
                self._active_subs -= 1
                # fold the stream's delivered-frame count into the
                # registry total (per-sub counts die with the sub)
                self.sse_events_delivered += sub.events

    def _maybe_publish(self) -> None:
        """Rate-limited push pass: at most one publish per
        ``tsd.streaming.publish_min_interval_ms`` per query, and only
        when someone is listening. v1 ran this on the write path; v2
        runs it on the worker pool (the tap just sets a flag)."""
        if self._active_subs <= 0:
            return
        now = time.monotonic()
        for cq in self.list():
            if not cq.subscribers or cq.closed:
                continue
            if (now - cq.last_publish) * 1000.0 \
                    < self.publish_min_interval_ms:
                continue
            if any(p.changed_ts or p.shared.pending_points
                   for p in cq.plans):
                self.pump(cq)

    def _pump_groups(self, cq: ContinuousQuery) -> bool:
        """Rebuild-if-needed + drain every distinct partial under one
        query (shared partials drain once however many views ride
        them). Returns False when any partial is STILL marked for
        rebuild afterwards — its state is known-stale (breaker open,
        rebuild/drain failure) and exactness-requiring callers must
        not serve from it."""
        anchor = None
        seen: set[int] = set()
        clean = True
        for view in cq.plans:
            group = view.shared
            if id(group) in seen:
                continue
            seen.add(id(group))
            if group.epoch_changed():
                # a delete/repair/sweep happened: partials cannot
                # unfold removed points — re-seed before publishing
                group.needs_rebuild = True
            if group.needs_rebuild:
                if anchor is None:
                    try:
                        anchor = self._emit_tsq(
                            cq, int(time.time() * 1000)).end_ms
                    except BadRequestError:
                        anchor = int(time.time() * 1000)
                self._rebuild_group(group, anchor)
            self._drain_group(group)
            clean &= not group.needs_rebuild
        return clean

    def pump(self, cq: ContinuousQuery, force: bool = False) -> bool:
        """Drain + publish one query's incremental updates to every
        subscriber. Returns True when an event was published. Called
        from the SSE generator's heartbeat loop and from the worker
        pool's publish pass (rate-limited)."""
        self._pump_groups(cq)
        if not force and not any(p.changed_ts for p in cq.plans):
            return False
        return self._publish(cq, snapshot=False)

    def flush(self) -> None:
        """Drain + publish everything now (tests, benchmarks, and the
        admin surface)."""
        for cq in self.list():
            self.pump(cq, force=True)

    def _emit_tsq(self, cq: ContinuousQuery, now_ms: int) -> TSQuery:
        """The registration query re-resolved against *now* so emitted
        windows track the live horizon."""
        tsq = TSQuery.from_json(cq.raw)
        return tsq.validate(now_ms)

    def current_results(self, cq: ContinuousQuery,
                        now_ms: int | None = None) -> list[dict]:
        """The query's CURRENT windowed results as row dicts (the
        ``GET .../result`` fetch surface — the only pull path for
        sliding/session windows). Drains pending folds first, so the
        answer reflects every acknowledged write — and REFUSES with a
        structured 503 (DegradedError) when a partial is known-stale
        (rebuild failed / breaker open): unlike /api/query there is
        no batch engine to shed a windowed result to, and serving
        stale data silently would break the freshness contract."""
        from opentsdb_tpu_torch.query.engine import QueryEngine
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        tsq = self._emit_tsq(cq, now_ms)
        if not self._pump_groups(cq):
            raise DegradedError(
                f"continuous query {cq.id!r}: partials are "
                f"rebuilding (fold failure or open stream.fold "
                f"breaker); retry shortly")
        engine = QueryEngine(self.tsdb)
        rows: list[dict] = []
        for view, sub in zip(cq.plans, tsq.queries):
            results = view.serve(tsq, sub, engine) or []
            for r in results:
                rows.append({
                    "metric": r.metric, "tags": r.tags,
                    "aggregateTags": r.aggregated_tags,
                    "index": r.sub_query_index,
                    "dps": {str(ts): (None if v != v else v)
                            for ts, v in r.dps}})
        if cq.policy is not None:
            # trailing completeness marker (the shardsDegraded idiom:
            # the row array keeps its shape for result consumers, the
            # marker rides at the end). A failed marker build — e.g.
            # an armed stream.watermark fault — degrades the WHOLE
            # pull: results without their completeness contract must
            # not pass as complete.
            try:
                marker = completeness_marker(self, cq, tsq.end_ms)
            except Exception as exc:  # noqa: BLE001 - degrade to 503
                raise DegradedError(
                    f"continuous query {cq.id!r}: completeness "
                    f"marker unavailable ({type(exc).__name__}); "
                    f"retry shortly") from exc
            rows.append({"completeness": marker})
        return rows

    def _collect_updates(self, cq: ContinuousQuery, tsq: TSQuery,
                         engine, snapshot: bool) -> list[dict]:
        """The incremental update rows for one publish/delta pass:
        per view, CONSUME the fold-dirty buckets, map them through
        the window's publish fan-out, and serve only the dps that
        changed (snapshot=True serves everything). Shared by the SSE
        publish path and the router's delta-drain pull
        (:meth:`delta_updates`) so a drained batch carries exactly
        what a local subscriber would have seen."""
        from opentsdb_tpu_torch.query.model import effective_pixels
        updates: list[dict] = []
        for view, sub in zip(cq.plans, tsq.queries):
            changed = None if snapshot else set(view.take_changed())
            if changed is not None and not changed:
                continue
            if changed is not None and effective_pixels(tsq, sub)[0]:
                # a pixel-budgeted standing query (ref): a fold can move
                # the M4/LTTB selection (a new point displaces a pixel's
                # min or max), so dirty-window deltas cannot describe
                # the reduced series; publish the whole reduced frame
                changed = None
            if changed is not None:
                # map fold-dirty base buckets to the output buckets
                # this view's window re-emits (sliding fans each fold
                # into its k trailing outputs; session publishes the
                # whole frame — a fold can move a session's start)
                changed = view.publish_buckets(changed)
            if changed is not None:
                # result timestamps are second-rounded unless
                # ms_resolution; changed buckets are ms edges
                changed |= {c // 1000 * 1000 for c in changed}
            results = view.serve(tsq, sub, engine)
            if not results:
                continue
            for r in results:
                dps = {str(ts): (None if v != v else v)
                       for ts, v in r.dps
                       if changed is None or ts in changed}
                if not dps:
                    continue
                updates.append({
                    "metric": r.metric, "tags": r.tags,
                    "aggregateTags": r.aggregated_tags,
                    "index": r.sub_query_index, "dps": dps})
        return updates

    def delta_updates(self, cq: ContinuousQuery,
                      now_ms: int | None = None) -> dict:
        """Drain + return one incremental update batch WITHOUT an SSE
        subscriber (``GET .../<id>/deltas``; the reference's cluster
        router pulls it from each shard and merges the rows)."""
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        from opentsdb_tpu_torch.query.engine import QueryEngine
        tsq = self._emit_tsq(cq, now_ms)
        clean = self._pump_groups(cq)
        engine = QueryEngine(self.tsdb)
        updates = self._collect_updates(cq, tsq, engine,
                                        snapshot=False)
        with cq.lock:
            cq.emit_seq += 1
            seq = cq.emit_seq
        out = {"id": cq.id, "seq": seq, "ts": now_ms,
               "updates": updates, "clean": clean}
        if cq.policy is not None:
            try:
                out["completeness"] = completeness_marker(
                    self, cq, tsq.end_ms)
            except Exception:  # noqa: BLE001 - flag, never fail the drain
                out["completeness"] = {"degraded": True}
        cq.last_publish = time.monotonic()
        return out

    def _publish(self, cq: ContinuousQuery, snapshot: bool,
                 only: list | None = None) -> bool:
        from opentsdb_tpu_torch.query.engine import QueryEngine
        now_ms = int(time.time() * 1000)
        try:
            tsq = self._emit_tsq(cq, now_ms)
        except BadRequestError:
            return False
        engine = QueryEngine(self.tsdb)
        updates = self._collect_updates(cq, tsq, engine, snapshot)
        # ONE critical section for seq + target snapshot + history
        # append: a subscriber resuming concurrently either appears in
        # `targets` (gets the frame live) or subscribes after — and
        # then its replay reads a history that already holds this
        # frame. Split sections would let a frame slip between its
        # target snapshot and its history append, lost to both paths.
        completeness = None
        if cq.policy is not None:
            try:
                completeness = completeness_marker(self, cq,
                                                   tsq.end_ms)
            except Exception:  # noqa: BLE001 - push degrades, never dies
                # the frame still ships (subscribers keep their data
                # feed) but is FLAGGED: no silent "complete" claim
                completeness = {"degraded": True}
        with cq.lock:
            cq.emit_seq += 1
            seq = cq.emit_seq
            targets = list(only if only is not None
                           else cq.subscribers)
            if not updates and not snapshot:
                return False
            payload = {"id": cq.id, "seq": seq, "ts": now_ms,
                       "updates": updates}
            if completeness is not None:
                payload["completeness"] = completeness
            fr = sse.frame("snapshot" if snapshot else "windows",
                           payload, event_id=seq)
            if not snapshot and self.resume_events > 0:
                cq.history.append((seq, fr))
                while len(cq.history) > self.resume_events:
                    cq.evicted_seq = cq.history.pop(0)[0]
        shed = 0
        for s in targets:
            if not sse.offer_frame(s, fr):
                shed += 1
                with cq.lock:
                    if s in cq.subscribers:
                        cq.subscribers.remove(s)
                        self._active_subs -= 1
                        # shed bypasses unsubscribe: fold the
                        # stream's delivered-frame count here too
                        self.sse_events_delivered += s.events
        self.sse_shed += shed
        self.sse_events += len(targets) - shed
        self.publishes += 1
        cq.last_publish = time.monotonic()
        return True

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def _totals(self) -> dict[str, int]:
        t = {"points_folded": 0, "folds": 0, "late_dropped": 0,
             "late_refolded": 0, "preboundary_dropped": 0,
             "pending_points": 0, "series": 0, "plans": 0,
             "groups": 0, "ring_bytes": 0}
        with self._lock:
            groups = list(self._partials)
            t["plans"] = sum(len(cq.plans)
                             for cq in self._queries.values())
        for g in groups:
            t["points_folded"] += g.points_folded
            t["folds"] += g.folds
            t["late_dropped"] += g.late_dropped
            t["late_refolded"] += g.late_refolded
            t["preboundary_dropped"] += g.preboundary_dropped
            t["pending_points"] += g.pending_points
            t["series"] += len(g._sids)
            t["groups"] += 1
            t["ring_bytes"] += g.ring_bytes()
        return t

    def fold_bytes(self) -> int:
        """Actual resident fold memory across every shared partial: what
        the control plane's miner and the tenant fold budget account
        against."""
        with self._lock:
            groups = list(self._partials)
        return sum(g.ring_bytes() for g in groups)

    def tenant_fold_bytes(self, tenant: str) -> int:
        """Resident fold memory of one tenant's registrations (a shared
        partial counts once per query riding it, as in the reference)."""
        return sum(cq.fold_bytes() for cq in self.list()
                   if cq.tenant == tenant)

    def projected_fold_bytes(self, obj: dict) -> int:
        """Resident ring bytes registering ``obj`` would add (ref:
        ``projected_fold_bytes``): per sub-query, the window count
        registration would size (range, pipeline lead and lateness
        columns) times a per-window row estimate, the row count of the
        live partials of the same metric (one row for a cold metric).
        0 for a body that cannot register, which fails its own 400 at
        registration."""
        try:
            tsq = TSQuery.from_json(
                {k: v for k, v in obj.items()
                 if k not in ("id", "window", "watermark")})
            tsq.validate()
            policy = WatermarkPolicy.from_json(obj.get("watermark"))
        except (BadRequestError, ValueError, TypeError, KeyError):
            return 0
        total = 0
        for sub in tsq.queries:
            spec = sub.ds_spec
            if spec is None or spec.interval_ms <= 0:
                continue
            try:
                window = WindowSpec.from_json(obj.get("window"),
                                              spec.interval_ms)
            except BadRequestError:
                return 0
            lat_b = policy.lateness_buckets(spec.interval_ms) \
                if policy is not None else 0
            windows = int((tsq.end_ms - tsq.start_ms)
                          // spec.interval_ms) + 2 \
                + window.lead_for(spec.interval_ms) + lat_b
            rows = 1
            with self._lock:
                for g in self._partials:
                    if g.metric == sub.metric:
                        rows = max(rows, len(g._sids))
            # 4 f8 channels and the shared win_ts row
            total += windows * (rows * 32 + 8)
        return total

    def collect_stats(self, collector) -> None:
        t = self._totals()
        with self._lock:
            n = len(self._queries)
            subs = sum(len(cq.subscribers)
                       for cq in self._queries.values())
        collector.record("streaming.queries", n)
        collector.record("streaming.plans", t["plans"])
        # shared partials actually folding: plans/groups is the plan-
        # sharing ratio (N dashboards per fold)
        collector.record("streaming.groups", t["groups"])
        collector.record("streaming.series", t["series"])
        collector.record("streaming.points.folded", t["points_folded"])
        collector.record("streaming.folds", t["folds"])
        collector.record("streaming.points.pending",
                         t["pending_points"])
        collector.record("streaming.points.late_dropped",
                         t["late_dropped"])
        collector.record("streaming.points.late_refolded",
                         t["late_refolded"])
        collector.record("streaming.points.preboundary_dropped",
                         t["preboundary_dropped"])
        collector.record("streaming.fold.bytes", t["ring_bytes"])
        collector.record("streaming.serve.hits", self.serve_hits)
        collector.record("streaming.serve.fallbacks",
                         self.serve_fallbacks)
        collector.record("streaming.fold.errors", self.fold_errors)
        collector.record("streaming.rebuilds", self.rebuilds)
        collector.record("streaming.rebuilds.tier_seeded",
                         self.tier_seeded_bootstraps)
        collector.record("streaming.backpressure.dropped_points",
                         self.backpressure_drops)
        collector.record("streaming.backpressure.events",
                         self.backpressure_events)
        collector.record("streaming.worker.drains",
                         self.workers.drains)
        collector.record("streaming.worker.errors",
                         self.workers.errors)
        collector.record("streaming.worker.publish_runs",
                         self.workers.publish_runs)
        collector.record("streaming.sse.subscribers", subs)
        collector.record("streaming.sse.events", self.sse_events)
        # delivery-side twin of sse.events: frames that actually
        # landed in subscriber queues (resume replays + snapshots
        # included, queue-full sheds excluded); live streams' counts
        # fold in when they unsubscribe
        collector.record("streaming.sse.events_delivered",
                         self.sse_events_delivered)
        collector.record("streaming.sse.shed", self.sse_shed)
        collector.record("streaming.sse.resumes", self.sse_resumes)
        collector.record("streaming.sse.resume_snapshots",
                         self.sse_resume_snapshots)
        collector.record("streaming.publishes", self.publishes)

    def health_info(self) -> dict[str, Any]:
        """The reference's ``/api/health`` section (no endpoint in the
        port until ``/api/health`` is ported: ROADMAP Queue 1, the
        rest)."""
        t = self._totals()
        with self._lock:
            n = len(self._queries)
            subs = sum(len(cq.subscribers)
                       for cq in self._queries.values())
        out = {
            "enabled": True,
            "queries": n,
            "plans": t["plans"],
            "groups": t["groups"],
            "series": t["series"],
            "points_folded": t["points_folded"],
            "pending_points": t["pending_points"],
            "late_dropped": t["late_dropped"],
            "late_refolded": t["late_refolded"],
            "preboundary_dropped": t["preboundary_dropped"],
            "fold_bytes": t["ring_bytes"],
            "serve_hits": self.serve_hits,
            "serve_fallbacks": self.serve_fallbacks,
            "fold_errors": self.fold_errors,
            "rebuilds": self.rebuilds,
            "tier_seeded_bootstraps": self.tier_seeded_bootstraps,
            "backpressure_dropped_points": self.backpressure_drops,
            "backpressure_events": self.backpressure_events,
            "workers": self.workers.health_info(),
            "subscribers": subs,
            "sse_events": self.sse_events,
            "sse_events_delivered": self.sse_events_delivered,
            "sse_shed": self.sse_shed,
            "sse_resumes": self.sse_resumes,
            "sse_resume_snapshots": self.sse_resume_snapshots,
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.health_info()
        return out
