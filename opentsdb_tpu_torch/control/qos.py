"""Multi-tenant QoS: weighted fair shares over the admission idiom
(ref: ``opentsdb_tpu/control/qos.py``).

Tenant identity comes from a configured HTTP header
(``tsd.control.tenant.header``) at the server's admission seam. (The
reference also reads ``tsd.control.tenant.tag`` for a tag-derived
identity that none of its callers uses; the port shows the key in
:meth:`TenantGovernor.describe` only.) The governor turns the server's single in-flight budget
(``tsd.query.admission.max_inflight``) into weighted fair shares over
the tenants seen recently: a tenant at or past its share sheds with
the existing structured 503 + ``Retry-After`` (cause ``tenant``)
while under-share tenants keep being admitted — which is exactly the
noisy-dashboard-farm isolation the north star's multi-user traffic
needs.

SLO burn closes the loop: each tenant feeds its own
:class:`~opentsdb_tpu.obs.slo.SloTracker`, and the control loop's QoS
actuator (fault site ``control.qos``) multiplies the weight of any
tenant burning its availability budget by ``burn_penalty`` — burn
rate decides who sheds first. The actuator only ever updates
*penalties and windows*; admission decisions themselves are plain
locked dict arithmetic with no fault site and no I/O, so a broken (or
killed) control loop leaves admission running on the last computed
penalties — degraded staleness, never a failed request.

Byte budgets: ``tenant_cache_mb`` bounds how many result-cache bytes
one tenant may insert per control interval (the gate is consulted by
the cache's ``_put``; over-budget results still serve, they just
don't cache), and ``tenant_fold_mb`` bounds a tenant's standing
continuous-query ring bytes at registration time.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any

from opentsdb_tpu_torch.obs.slo import SloTracker

#: catch-all bucket once max_tenants distinct identities were seen
OVERFLOW_TENANT = "other"

#: a tenant is "active" (counted in the fair-share split) when seen
#: within this many seconds
ACTIVE_WINDOW_S = 30.0


class _Tenant:
    __slots__ = ("name", "inflight", "requests", "shed", "errors",
                 "last_seen_s", "cache_bytes", "slo", "penalty")

    def __init__(self, name: str, slo: SloTracker | None):
        self.name = name
        self.inflight = 0
        self.requests = 0
        self.shed = 0
        self.errors = 0
        self.last_seen_s = 0.0
        self.cache_bytes = 0       # result-cache inserts this window
        self.slo = slo
        self.penalty = 1.0         # burn-rate weight multiplier


class TenantGovernor:
    """(see module docstring)"""

    def __init__(self, tsdb):
        # weak: the TSDB holds the plane that holds this governor
        self._tsdb_ref = weakref.ref(tsdb)
        cfg = tsdb.config
        self.enabled = cfg.get_bool("tsd.control.qos.enable", False)
        self.header = cfg.get_string("tsd.control.tenant.header",
                                     "x-tsd-tenant").lower()
        self.tag = cfg.get_string("tsd.control.tenant.tag", "")
        self.max_tenants = cfg.get_int("tsd.control.qos.max_tenants",
                                       32)
        self.burn_penalty = min(max(cfg.get_float(
            "tsd.control.qos.burn_penalty", 0.5), 0.01), 1.0)
        self.cache_budget_bytes = cfg.get_int(
            "tsd.control.qos.tenant_cache_mb", 0) << 20
        self.fold_budget_bytes = cfg.get_int(
            "tsd.control.qos.tenant_fold_mb", 0) << 20
        self.weights: dict[str, float] = {}
        for part in cfg.get_string("tsd.control.qos.weights",
                                   "").split(","):
            part = part.strip()
            if not part or ":" not in part:
                continue
            name, _, w = part.rpartition(":")
            try:
                self.weights[name.strip()] = max(float(w), 0.01)
            except ValueError:
                continue
        self._lock = threading.Lock()
        # capped at max_tenants entries: the (max_tenants+1)th identity
        # collapses into the OVERFLOW_TENANT bucket (_get)
        self._tenants: dict[str, _Tenant] = {}
        self._local = threading.local()
        # counters
        self.shed_total = 0
        self.cache_gate_rejects = 0
        self.fold_budget_rejects = 0
        self.refreshes = 0

    @property
    def tsdb(self):
        return self._tsdb_ref()

    # -- identity ------------------------------------------------------

    def tenant_of(self, headers) -> str | None:
        """Header-derived tenant identity, or None (untenanted
        requests ride plain global admission)."""
        if not self.enabled or not self.header:
            return None
        value = headers.get(self.header, "") if headers else ""
        if not value:
            return None
        return str(value)[:64]

    # -- request-scoped binding (result-cache gate) --------------------

    def bind(self, tenant: str) -> None:
        self._local.tenant = tenant

    def unbind(self) -> None:
        self._local.tenant = None

    def bound_tenant(self) -> str | None:
        return getattr(self._local, "tenant", None)

    # -- admission -----------------------------------------------------

    def _get(self, name: str, now_s: float) -> _Tenant:
        """Caller holds the lock."""
        t = self._tenants.get(name)
        if t is None:
            if len(self._tenants) >= self.max_tenants and \
                    name != OVERFLOW_TENANT:
                return self._get(OVERFLOW_TENANT, now_s)
            slo = None
            if self.tsdb.slo.enabled:
                slo = SloTracker(self.tsdb.config)
            t = self._tenants[name] = _Tenant(name, slo)
        t.last_seen_s = now_s
        return t

    def _share(self, tenant: _Tenant, max_inflight: int,
               now_s: float) -> int:
        """This tenant's fair in-flight share: its (penalty-adjusted)
        weight's fraction of ``max_inflight`` over the recently-seen
        tenants. Caller holds the lock."""
        w_self = 0.0
        w_total = 0.0
        for t in self._tenants.values():
            if now_s - t.last_seen_s > ACTIVE_WINDOW_S:
                continue
            w = self.weights.get(t.name, 1.0) * t.penalty
            w_total += w
            if t is tenant:
                w_self = w
        if w_total <= 0.0 or w_self <= 0.0:
            return max_inflight
        return max(int(max_inflight * w_self / w_total), 1)

    def try_admit(self, tenant_name: str, max_inflight: int,
                  now_s: float | None = None) -> str | None:
        """``"tenant"`` when this tenant is at/past its fair share of
        the in-flight budget, else None. With no global in-flight
        limit configured there is nothing to share — every tenant is
        admitted (attribution still updates)."""
        now = now_s if now_s is not None else time.time()
        with self._lock:
            t = self._get(tenant_name, now)
            t.requests += 1
            if max_inflight <= 0:
                return None
            if t.inflight >= self._share(t, max_inflight, now):
                t.shed += 1
                self.shed_total += 1
                return "tenant"
            return None

    def started(self, tenant_name: str) -> None:
        with self._lock:
            t = self._tenants.get(tenant_name)
            if t is not None:
                t.inflight += 1

    def finished(self, tenant_name: str) -> None:
        with self._lock:
            t = self._tenants.get(tenant_name)
            if t is not None and t.inflight > 0:
                t.inflight -= 1

    # -- SLO attribution ----------------------------------------------

    def record(self, tenant_name: str, latency_ms: float,
               errored: bool, now_s: float | None = None) -> None:
        now = now_s if now_s is not None else time.time()
        with self._lock:
            t = self._get(tenant_name, now)
            if errored:
                t.errors += 1
            slo = t.slo
        if slo is not None:
            slo.record("query", latency_ms, errored, now_s=now)

    # -- byte budgets --------------------------------------------------

    def cache_gate(self, nbytes: int) -> bool:
        """Result-cache insert gate: False when the bound tenant has
        already inserted its per-interval byte budget (the result
        still serves; it just isn't retained on this tenant's dime).
        Untenanted inserts always pass."""
        if not self.enabled or self.cache_budget_bytes <= 0:
            return True
        tenant = self.bound_tenant()
        if tenant is None:
            return True
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                return True
            if t.cache_bytes + nbytes > self.cache_budget_bytes:
                self.cache_gate_rejects += 1
                return False
            t.cache_bytes += nbytes
            return True

    def fold_budget_allows(self, tenant: str | None, registry,
                           body: dict | None = None) -> bool:
        """Whether this tenant may register another continuous query
        under its standing ring-byte budget. Accounts the ACTUAL
        resident ring bytes of the tenant's registrations
        (``registry.tenant_fold_bytes`` — the streaming partial-size
        surface, not the old windows-x-series guess) plus, when the
        candidate ``body`` is given, the projected fold memory the
        new registration would add — so one oversized shape is
        refused up front instead of landing and starving the tenant's
        next register. Auto-materialized CQs (owned by the control
        plane) are capped by ``tsd.control.materialize.max`` and the
        miner's memory penalty instead."""
        if not self.enabled or self.fold_budget_bytes <= 0 \
                or tenant is None:
            return True
        held = registry.tenant_fold_bytes(tenant)
        projected = 0
        if body is not None and held > 0:
            # a tenant holding nothing may always register once (the
            # quota's first-use contract); after that the projection
            # refuses shapes that would blow through the budget
            # instead of letting them land first
            projected = registry.projected_fold_bytes(body)
        if held >= self.fold_budget_bytes \
                or (held > 0
                    and held + projected > self.fold_budget_bytes):
            self.fold_budget_rejects += 1
            return False
        return True

    # -- the control-loop actuator ------------------------------------

    def refresh(self, now_s: float | None = None) -> dict[str, float]:
        """One QoS tick: derive each tenant's burn penalty from its
        short-window availability burn and reset the per-interval
        cache-byte windows. Returns {tenant: penalty} for the tick
        report. Runs under the ``control.qos`` fault site (armed =
        penalties go stale; admission keeps running)."""
        now = now_s if now_s is not None else time.time()
        with self._lock:
            tenants = list(self._tenants.values())
        penalties: dict[str, float] = {}
        for t in tenants:
            penalty = 1.0
            if t.slo is not None:
                burns = t.slo.burn_rates(now_s=now)
                avail = burns.get("query", {}).get("availability", {})
                worst = max(avail.values(), default=0.0)
                if worst > 1.0:
                    penalty = self.burn_penalty
            penalties[t.name] = penalty
        with self._lock:
            for t in tenants:
                t.penalty = penalties.get(t.name, 1.0)
                t.cache_bytes = 0
            self.refreshes += 1
        return penalties

    # -- exposition ----------------------------------------------------

    def describe(self, now_s: float | None = None) -> dict[str, Any]:
        now = now_s if now_s is not None else time.time()
        with self._lock:
            tenants = list(self._tenants.values())
            doc: dict[str, Any] = {
                "enabled": self.enabled,
                "header": self.header,
                "tag": self.tag,
                "shedTotal": self.shed_total,
                "cacheGateRejects": self.cache_gate_rejects,
                "foldBudgetRejects": self.fold_budget_rejects,
                "refreshes": self.refreshes,
            }
        per: dict[str, Any] = {}
        for t in sorted(tenants, key=lambda x: x.name):
            entry: dict[str, Any] = {
                "inflight": t.inflight,
                "requests": t.requests,
                "shed": t.shed,
                "errors": t.errors,
                "weight": self.weights.get(t.name, 1.0),
                "penalty": t.penalty,
                "activeAgeS": round(max(now - t.last_seen_s, 0.0), 1),
            }
            if t.slo is not None:
                burns = t.slo.burn_rates(now_s=now)
                entry["burn"] = burns.get("query", {})
            per[t.name] = entry
        doc["tenants"] = per
        return doc

    def collect_stats(self, collector) -> None:
        if not self.enabled:
            return
        collector.record("control.qos.shed", self.shed_total)
        collector.record("control.qos.cache_gate_rejects",
                         self.cache_gate_rejects)
        with self._lock:
            tenants = list(self._tenants.values())
        for t in sorted(tenants, key=lambda x: x.name):
            collector.record("control.tenant.requests", t.requests,
                             tenant=t.name)
            collector.record("control.tenant.shed", t.shed,
                             tenant=t.name)
            collector.record("control.tenant.inflight", t.inflight,
                             tenant=t.name)
            if t.slo is not None:
                burns = t.slo.burn_rates()
                avail = burns.get("query", {}).get("availability", {})
                for label, burn in avail.items():
                    collector.record("control.tenant.burn_rate", burn,
                                     tenant=t.name, window=label)


__all__ = ["ACTIVE_WINDOW_S", "OVERFLOW_TENANT", "TenantGovernor"]
