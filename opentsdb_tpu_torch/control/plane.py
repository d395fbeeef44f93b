"""Self-driving control plane: one background loop, three actuators
(ref: ``opentsdb_tpu/control/plane.py``).

Each tick is a background trace root (``control.loop``) gated by its
own circuit breaker, and runs three independent actuators:

* **materialize** (fault site ``control.materialize``) — mine the
  query-shape log for hot decomposable shapes and keep the top
  scorers registered as auto continuous queries (``auto-*`` ids)
  through the streaming registry; retire them after
  ``tsd.control.materialize.hysteresis`` consecutive cold scans.
* **qos** (fault site ``control.qos``) — recompute tenant burn
  penalties and reset per-interval byte windows on the
  :class:`~opentsdb_tpu.control.qos.TenantGovernor`. Admission itself
  never runs here: a dead loop means stale penalties, not closed
  doors.
* **placement** (fault site ``control.placement``) — on a cluster
  router, rebuild the hot-shard assessment and proposed ring spec. The
  port has no router yet (``cluster/``, ROADMAP Queue 1), so here, as
  on the reference's TSDs that are not routers, it passes its fault
  site and assesses nothing: ``GET /api/control/plan`` shows no
  proposal and a confirm is refused.

Failure semantics follow the lifecycle sweeper to the letter: an
actuator that throws is counted, trips the shared breaker, tags the
trace — and the data plane never notices. A broken control loop can
park every actuator and writes still ack, queries still answer.

The plane holds its TSDB by a weak reference; ``TSDB.shutdown`` stops
its thread first.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any

from opentsdb_tpu_torch.control import shapes as shapes_mod
from opentsdb_tpu_torch.control.miner import mine_shapes
from opentsdb_tpu_torch.control.qos import TenantGovernor
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.query.model import BadRequestError
from opentsdb_tpu_torch.utils.faults import CircuitBreaker

LOG = logging.getLogger(__name__)


class ControlPlane:
    """(see module docstring)"""

    def __init__(self, tsdb):
        self._tsdb_ref = weakref.ref(tsdb)
        cfg = tsdb.config
        self.interval_s = cfg.get_float("tsd.control.interval_s",
                                        15.0)
        self.breaker = CircuitBreaker(
            "control.loop",
            failure_threshold=cfg.get_int(
                "tsd.control.breaker.failure_threshold", 3),
            reset_timeout_ms=cfg.get_float(
                "tsd.control.breaker.reset_timeout_ms", 60000.0))
        # actuator 1: adaptive materialization
        self.mat_enable = cfg.get_bool(
            "tsd.control.materialize.enable", True)
        self.mat_max = cfg.get_int("tsd.control.materialize.max", 8)
        self.mat_min_score = cfg.get_float(
            "tsd.control.materialize.min_score", 1.0)
        self.mat_hysteresis = max(cfg.get_int(
            "tsd.control.materialize.hysteresis", 3), 1)
        # fold-memory pressure knob (ROADMAP 4a follow-through): a
        # mined shape's score is divided by (1 + projected_bytes /
        # this), so between two equally hot shapes the cheaper ring
        # materializes first; shapes projecting past the tenant fold
        # budget are refused outright
        self.mat_mem_penalty_bytes = max(int(cfg.get_float(
            "tsd.control.materialize.mem_penalty_mb", 64.0)
            * (1 << 20)), 1)
        self.fold_budget_skips = 0
        # actuator 2: multi-tenant QoS
        self.qos = TenantGovernor(tsdb)
        # actuator 3: placement
        self.place_enable = cfg.get_bool(
            "tsd.control.placement.enable", True)
        self.place_auto = cfg.get_bool("tsd.control.placement.auto",
                                       False)
        self.hot_ratio = max(cfg.get_float(
            "tsd.control.placement.hot_ratio", 2.0), 1.0)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._tick_lock = threading.Lock()
        self._lock = threading.Lock()
        # candidate -> {"id", "score", "registeredMs", "coldScans"}:
        # capped by mat_max live entries; retired entries are deleted
        self._materialized: dict[str, dict[str, Any]] = {}
        # candidates the registry rejected, never retried: bounded by
        # the distinct shapes of one shape-log generation
        self._blacklist: set[str] = set()
        # counters
        self.ticks = 0
        self.tick_errors = 0
        self.materialized_total = 0
        self.retired_total = 0
        self.plans_applied = 0
        self.last_error = ""
        self.last_tick_time = 0.0
        self.last_tick_duration_ms = 0.0

    @property
    def tsdb(self):
        return self._tsdb_ref()

    def wire(self) -> None:
        """Attach the per-tenant result-cache insert gate. Idempotent;
        the TSDB accessor calls this OUTSIDE its lazy-build lock —
        ``result_cache`` is itself lazy behind the same lock, so the
        attach cannot happen inside the constructor."""
        if not self.qos.enabled or self.qos.cache_budget_bytes <= 0:
            return
        cache = self.tsdb.result_cache
        if cache is not None and cache.insert_gate is None:
            # the gate consults the worker-thread tenant binding at
            # insert time
            cache.insert_gate = self.qos.cache_gate

    # ------------------------------------------------------------------
    # scheduler surface (started by TSDServer, stopped on shutdown)
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="tsd-control",
                             daemon=True)
        self._thread = t
        t.start()
        LOG.info("control plane ticking every %.0fs", self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.tsdb is None:
                return  # the TSDB was dropped without a shutdown
            self.tick()  # never raises

    # ------------------------------------------------------------------
    # one tick
    # ------------------------------------------------------------------

    def tick(self, now_ms: int | None = None) -> dict[str, Any]:
        """Run every actuator once; returns a report. Never raises —
        this loop observes and steers, it must not be able to fail
        the data plane it steers."""
        if not self._tick_lock.acquire(blocking=False):
            return {"skipped": "tick already running"}
        t0 = time.monotonic()
        now = int(now_ms if now_ms is not None else
                  time.time() * 1000)
        report: dict[str, Any] = {"errors": {}}
        tracer = self.tsdb.tracer
        tctx = tracer.start_background("control.loop")
        try:
            if not self.breaker.allow():
                report["skipped"] = "breaker open"
                return report
            with trace_mod.use(tctx):
                for name, actuator in (
                        ("materialize", self._materialize_tick),
                        ("qos", self._qos_tick),
                        ("placement", self._placement_tick)):
                    try:
                        actuator(now, report)
                    except Exception as exc:  # noqa: BLE001 - park loudly
                        msg = f"{type(exc).__name__}: {exc}"
                        report["errors"][name] = msg
                        self.last_error = f"{name}: {msg}"
                        LOG.warning(
                            "control actuator %s failed (%s); the "
                            "data plane is unaffected", name, msg)
            if report["errors"]:
                self.tick_errors += 1
                self.breaker.record_failure()
                if tctx is not None:
                    tctx.set_error(RuntimeError(self.last_error))
            else:
                self.breaker.record_success()
            return report
        finally:
            self.ticks += 1
            self.last_tick_time = time.time()
            self.last_tick_duration_ms = \
                (time.monotonic() - t0) * 1e3
            report["durationMs"] = round(self.last_tick_duration_ms,
                                         1)
            if tctx is not None:
                if report.get("skipped"):
                    # breaker-open no-op ticks would churn request
                    # traces out of the ring (lifecycle-sweep rule)
                    tctx.sampled = False
                tctx.tag(materialized=len(self._materialized),
                         errors=len(report["errors"]))
                tracer.finish(tctx)
            self._tick_lock.release()

    # ------------------------------------------------------------------
    # actuator 1: adaptive materialization
    # ------------------------------------------------------------------

    def _materialize_tick(self, now_ms: int, report: dict) -> None:
        self.tsdb.faults.check("control.materialize")
        if not self.mat_enable:
            return
        registry = self.tsdb.streaming
        shape_path = self.tsdb.tracer.shape_path
        if registry is None or not shape_path:
            return
        scores = mine_shapes(shape_path)
        with self._lock:
            blacklist = set(self._blacklist)
        # streaming partial-size accounting (ROADMAP 4a): project
        # each candidate's standing ring cost from the live partials'
        # membership, penalize the score by it, and refuse shapes the
        # tenant fold budget could never admit — the miner must not
        # materialize a ring the QoS gate would have refused a tenant
        budget = 0
        if self.qos.enabled and self.qos.fold_budget_bytes > 0:
            budget = self.qos.fold_budget_bytes
        eligible = []
        over_budget = 0
        for s in scores:
            if s.candidate in blacklist:
                continue
            proj = registry.projected_fold_bytes(
                shapes_mod.candidate_body(s.candidate))
            if budget and proj > budget:
                over_budget += 1
                self.fold_budget_skips += 1
                continue
            adj = s.score / (1.0 + proj / self.mat_mem_penalty_bytes)
            if adj >= self.mat_min_score:
                eligible.append((adj, s))
        eligible.sort(key=lambda p: -p[0])
        want = [s for _adj, s in eligible[:self.mat_max]]
        want_set = {s.candidate for s in want}
        registered = retired = 0
        for s in want:
            with self._lock:
                entry = self._materialized.get(s.candidate)
                if entry is not None:
                    entry["score"] = s.score
                    entry["coldScans"] = 0
                    continue
            cid = shapes_mod.auto_id(s.candidate)
            if registry.get(cid) is None:
                body = shapes_mod.candidate_body(s.candidate)
                body["id"] = cid
                try:
                    registry.register(body, now_ms=now_ms)
                except BadRequestError as exc:
                    # the registry is the authority on what can stand;
                    # a shape it rejects is never retried
                    with self._lock:
                        self._blacklist.add(s.candidate)
                    LOG.info("control: registry rejected mined shape "
                             "(%s); blacklisted", exc)
                    continue
            with self._lock:
                self._materialized[s.candidate] = {
                    "id": cid, "score": s.score,
                    "missCount": s.miss_count,
                    "registeredMs": now_ms, "coldScans": 0,
                }
            self.materialized_total += 1
            registered += 1
        # hysteresis retirement: a standing auto-CQ must score cold on
        # mat_hysteresis CONSECUTIVE scans before its ring memory is
        # released — one quiet scan must not thrash a hot dashboard
        with self._lock:
            cold = [(cand, entry) for cand, entry
                    in self._materialized.items()
                    if cand not in want_set]
        for cand, entry in cold:
            entry["coldScans"] += 1
            if entry["coldScans"] < self.mat_hysteresis:
                continue
            registry.delete(entry["id"])
            with self._lock:
                self._materialized.pop(cand, None)
            self.retired_total += 1
            retired += 1
        report["materialize"] = {
            "mined": len(scores), "standing": len(self._materialized),
            "registered": registered, "retired": retired,
            "overBudget": over_budget,
        }

    # ------------------------------------------------------------------
    # actuator 2: multi-tenant QoS
    # ------------------------------------------------------------------

    def _qos_tick(self, now_ms: int, report: dict) -> None:
        self.tsdb.faults.check("control.qos")
        if not self.qos.enabled:
            return
        penalties = self.qos.refresh(now_s=now_ms / 1000.0)
        report["qos"] = {
            "tenants": len(penalties),
            "penalized": sorted(t for t, p in penalties.items()
                                if p < 1.0),
        }

    # ------------------------------------------------------------------
    # actuator 3: placement
    # ------------------------------------------------------------------

    def _placement_tick(self, now_ms: int, report: dict) -> None:
        """The reference's actuator on a TSD that is not a cluster
        router (``control/plane.py``'s ``router is None`` return): its
        fault site, then nothing to assess. The router's side comes
        with the port of ``cluster/``."""
        self.tsdb.faults.check("control.placement")

    def apply_plan(self, pid: str) -> dict[str, Any]:
        """Confirm the standing reshard proposal (ref: ``apply_plan``).
        No proposal stands on a TSD that is not a router, so this
        refuses with the reference's 400 whatever ``pid`` is."""
        raise BadRequestError("no reshard proposal is standing")

    # ------------------------------------------------------------------
    # exposition
    # ------------------------------------------------------------------

    def materialized_info(self) -> list[dict[str, Any]]:
        registry = self.tsdb.streaming
        with self._lock:
            entries = sorted(self._materialized.items(),
                             key=lambda kv: kv[1]["id"])
        out = []
        for cand, entry in entries:
            doc = {"id": entry["id"], "score": entry["score"],
                   "missCount": entry.get("missCount", 0),
                   "registeredMs": entry["registeredMs"],
                   "coldScans": entry["coldScans"],
                   "body": shapes_mod.candidate_body(cand)}
            cq = registry.get(entry["id"]) \
                if registry is not None else None
            if cq is not None:
                doc["emitSeq"] = cq.emit_seq
            out.append(doc)
        return out

    def plan_info(self) -> dict[str, Any]:
        """(ref: ``plan_info``) No assessment is made on a TSD that is
        not a router."""
        return {"reason": "no assessment yet", "proposal": None,
                "auto": self.place_auto}

    def describe(self) -> dict[str, Any]:
        with self._lock:
            standing = len(self._materialized)
            blacklisted = len(self._blacklist)
        return {
            "intervalS": self.interval_s,
            "running": self._thread is not None,
            "ticks": self.ticks,
            "tickErrors": self.tick_errors,
            "lastError": self.last_error,
            "lastTickDurationMs": round(self.last_tick_duration_ms,
                                        1),
            "breaker": self.breaker.state,
            "materialize": {
                "enabled": self.mat_enable, "max": self.mat_max,
                "minScore": self.mat_min_score,
                "hysteresis": self.mat_hysteresis,
                "standing": standing, "blacklisted": blacklisted,
                "total": self.materialized_total,
                "retired": self.retired_total,
                "foldBudgetSkips": self.fold_budget_skips,
            },
            "qos": self.qos.describe(),
            "placement": {
                "enabled": self.place_enable, "auto": self.place_auto,
                "hotRatio": self.hot_ratio,
                "plansApplied": self.plans_applied,
            },
        }

    def collect_stats(self, collector) -> None:
        collector.record("control.ticks", self.ticks)
        collector.record("control.tick_errors", self.tick_errors)
        with self._lock:
            collector.record("control.materialized",
                             len(self._materialized))
        collector.record("control.materialized.total",
                         self.materialized_total)
        collector.record("control.retired.total", self.retired_total)
        collector.record("control.plans_applied", self.plans_applied)
        collector.record("control.fold_budget_skips",
                         self.fold_budget_skips)
        self.qos.collect_stats(collector)


__all__ = ["ControlPlane"]
