"""Router gossip/version bus: N front doors, one coherent cache (ref:
``opentsdb_tpu/cluster/gossip.py``).

A single router owns every invalidation signal its result cache
needs: its own ``_bump_versions`` calls happen-after the writes they
describe. Behind a load balancer that stops being true — a write (or
delete, or reshard) forwarded by router A changes shard data that
router B's epoch-qualified cache still considers current. Every router
names its sibling routers (``tsd.cluster.routers``) and exchanges
**version deltas** — the per-metric write-counter bumps and global
bumps the local cache machinery already produces — plus the
reshard-epoch topology, so a sibling's cache invalidates within one
gossip interval of the write. The push body and its ack are the
reference's JSON field for field, so a router of either package can be
the other's sibling.

Delta semantics (why not merge counters by max): version counters are
LOCAL monotone clocks, not replicated state. Router A at version 5
for metric m must not ``max`` in router B's 1 — B's bump 0→1 names a
NEW write A has never seen, and max(5, 1) = 5 would leave A's cached
entry servable. Instead B ships the *event* ("m changed, my seq 41")
and A applies it by bumping A's OWN counter — strictly monotone, so
it always invalidates. Gossip-applied bumps are never re-logged
(``announce=False``), so a delta crosses each edge once and the
A↔B exchange cannot loop.

Failure discipline:

- per-sibling :class:`CircuitBreaker` + the ``cluster.gossip`` fault
  site on every push;
- the delta log is bounded (``tsd.cluster.gossip.log_max``): a
  sibling that lagged past the trim sees a **seq gap** and covers the
  lost window with ONE conservative global bump (the bounded O(1)
  "anti-entropy full-sync" — every cached entry goes stale at once,
  which is exactly what an unknown invalidation window deserves);
- a restarted sibling arrives with a fresh instance **nonce**: the
  join is the same conservative bump, then deltas apply from the new
  position;
- a sibling unreachable past ``tsd.cluster.gossip.stale_ms``
  **degrades this router** — `degraded()` turns true and the router
  serves cache-bypassed (conservative: never a stale serve, never a
  5xx) until a push lands again. Heartbeats flow every interval even
  with no writes, so a healthy-but-idle fleet never degrades.

Topology rides the same bus: each push carries the persisted reshard
epoch + ring specs. A sibling seeing a HIGHER epoch (or the finalize
of its own open epoch) adopts it — creating peers, swapping rings,
persisting its own ``reshard.json`` and running its own idempotent
backfill — so killing the router that initiated a reshard leaves a
sibling that resumes and finalizes the cutover (duplicated copy units
dedupe last-write-wins on the shards).
"""

from __future__ import annotations

import collections
import json
import logging
import secrets
import threading
import time
from typing import Any

from opentsdb_tpu_torch.cluster.client import PeerClient, parse_peer_spec
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.utils.faults import CircuitBreaker

LOG = logging.getLogger("cluster.gossip")


class Sibling:
    """One peer router on the gossip bus (NOT a shard: no spool — a
    missed delta is covered by the gap rule, never replayed)."""

    def __init__(self, name: str, host: str, port: int, config):
        self.name = name
        self.client = PeerClient(
            host, port,
            timeout_ms=config.get_float(
                "tsd.cluster.gossip.timeout_ms", 2000.0))
        self.breaker = CircuitBreaker(
            f"cluster.gossip.{name}",
            failure_threshold=config.get_int(
                "tsd.cluster.breaker.failure_threshold", 3),
            reset_timeout_ms=config.get_float(
                "tsd.cluster.breaker.reset_timeout_ms", 5000.0))
        # highest local seq this sibling has acknowledged
        self.acked_seq = 0
        # wall-clock of the last successful push (seed = construction:
        # a just-booted router gets one stale window of grace before
        # an unreachable sibling degrades it)
        self.last_ok = time.time()
        self.pushes = 0
        self.push_failures = 0
        self.deltas_sent = 0

    def health_info(self) -> dict[str, Any]:
        return {
            "address": self.client.address,
            "breaker": self.breaker.health_info(),
            "acked_seq": self.acked_seq,
            "last_ok_age_s": round(
                max(time.time() - self.last_ok, 0.0), 1),
            "pushes": self.pushes,
            "push_failures": self.push_failures,
            "deltas_sent": self.deltas_sent,
        }


class GossipBus:
    """The per-router delta log + push loop + receive/apply side."""

    def __init__(self, router, spec: str):
        self.router = router
        config = router.config
        self.siblings: dict[str, Sibling] = {}
        for name, host, port in parse_peer_spec(spec):
            self.siblings[name] = Sibling(name, host, port, config)
        if not self.siblings:
            raise ValueError(
                "tsd.cluster.routers parsed to no siblings")
        # instance identity: a restart mints a new nonce, and a
        # receiver treats the unknown nonce as a join (conservative
        # global bump) — no persisted gossip state to mis-trust
        self.nonce = secrets.token_hex(8)
        self._lock = threading.Lock()
        self._seq = 0
        # bounded delta log: (seq, frozenset-of-metrics | None) where
        # None = a global bump. Trimmed entries are covered by the
        # receiver's seq-gap rule.
        self._log: collections.deque = collections.deque()
        self.log_max = max(config.get_int(
            "tsd.cluster.gossip.log_max", 4096), 16)
        self.interval_s = config.get_float(
            "tsd.cluster.gossip.interval_ms", 250.0) / 1000.0
        self.stale_s = config.get_float(
            "tsd.cluster.gossip.stale_ms", 5000.0) / 1000.0
        # receive side: sender nonce -> applied seq, bounded (an
        # unknown nonce is a join; evicting a stale nonce merely
        # costs the evicted sender one conservative re-join)
        self._applied: collections.OrderedDict = \
            collections.OrderedDict()
        self._applied_max = 4 * max(len(self.siblings), 1) + 8
        # counters (health/stats/status surfaces)
        self.deltas_logged = 0
        self.deltas_applied = 0
        self.heartbeats_in = 0
        self.full_syncs = 0        # join/gap conservative bumps taken
        self.topology_adoptions = 0
        self.cache_bypasses = 0    # reads served around the cache
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        t = threading.Thread(target=self._push_loop,
                             name="cluster-gossip", daemon=True)
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)

    # -- producer side (local bumps enter the log) ---------------------

    def record_writes(self, metrics) -> None:
        """Log one per-metric delta for a LOCAL version bump (called
        after ``_bump_versions``; never for gossip-applied bumps —
        that would loop the delta back forever)."""
        names = frozenset(m for m in metrics if m)
        if not names:
            return
        with self._lock:
            self._seq += 1
            self._log.append((self._seq, names))
            self.deltas_logged += 1
            self._trim_locked()
        self._wake.set()

    def record_global(self) -> None:
        """Log one global-bump delta (spool replay landed, repair
        completed, reshard epoch moved — any every-entry-stale
        event)."""
        with self._lock:
            self._seq += 1
            self._log.append((self._seq, None))
            self.deltas_logged += 1
            self._trim_locked()
        self._wake.set()

    def _trim_locked(self) -> None:
        # drop what every sibling acked; then enforce the hard cap
        # (a lagging sibling recovers via the seq-gap rule)
        min_acked = min((s.acked_seq for s in
                         self.siblings.values()), default=0)
        while self._log and self._log[0][0] <= min_acked:
            self._log.popleft()
        while len(self._log) > self.log_max:
            self._log.popleft()

    # -- degradation verdict -------------------------------------------

    def degraded(self) -> bool:
        """True while ANY sibling has not acknowledged a push within
        the stale window: a partitioned sibling may be forwarding
        writes this router cannot see, so serving from cache could be
        stale — the router serves cache-bypassed instead (conservative
        global-version semantics: correct, never a 5xx)."""
        now = time.time()
        return any(now - s.last_ok > self.stale_s
                   for s in self.siblings.values())

    def stale_siblings(self) -> list[str]:
        now = time.time()
        return sorted(n for n, s in self.siblings.items()
                      if now - s.last_ok > self.stale_s)

    # -- push loop ------------------------------------------------------

    def _push_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.push_once()
            except Exception:  # noqa: BLE001 - keep the loop alive
                LOG.exception("gossip push round failed")

    def _topology_doc(self) -> dict[str, Any]:
        state = self.router.state
        with state._lock:
            doc = {"epoch": state.epoch,
                   "peers": state.peers_spec,
                   "vnodes": state.vnodes,
                   "active": bool(state.old_spec),
                   "old_peers": state.old_spec,
                   "old_vnodes": state.old_vnodes,
                   "fence_ms": state.fence_ms}
        if not doc["peers"]:
            # epoch 0: config still names the ring — ship the spec a
            # sibling would need to adopt a LATER epoch against
            doc["peers"] = self.router.config.get_string(
                "tsd.cluster.peers", "")
            doc["vnodes"] = self.router.ring.vnodes
        return doc

    def push_once(self) -> int:
        """One push round to every sibling whose breaker admits a
        dispatch. Returns the number of siblings that acknowledged.
        Tests drive this directly for deterministic propagation.
        Rounds are high-frequency (every interval even when idle), so
        the background trace root takes the sampled retention."""
        topo = self._topology_doc()
        tracer = getattr(self.router.tsdb, "tracer", None)
        tctx = tracer.start_background("cluster.gossip.push",
                                       sample=True) \
            if tracer is not None and tracer.enabled else None
        ok = 0
        try:
            with trace_mod.use(tctx):
                for name in sorted(self.siblings):
                    if self._push_sibling(self.siblings[name], topo):
                        ok += 1
            if tctx is not None:
                tctx.tag(acked=ok, siblings=len(self.siblings))
        finally:
            if tracer is not None and tctx is not None:
                tracer.finish(tctx)
        return ok

    def _push_sibling(self, sib: Sibling, topo: dict) -> bool:
        if not sib.breaker.allow():
            return False
        with self._lock:
            seq = self._seq
            deltas = [{"seq": s,
                       **({"metrics": sorted(ms)} if ms is not None
                          else {"global": True})}
                      for s, ms in self._log
                      if s > sib.acked_seq]
        body = json.dumps({
            "nonce": self.nonce,
            "seq": seq,
            "deltas": deltas,
            "topology": topo,
        }).encode()
        sp = trace_mod.trace_begin("cluster.peer", peer=sib.name,
                                   deltas=len(deltas))
        try:
            faults = getattr(self.router.tsdb, "faults", None)
            if faults is not None:
                faults.check("cluster.gossip")
                faults.check(f"cluster.gossip.{sib.name}")
            status, data = sib.client.request(
                "POST", "/api/cluster/gossip", body)
            if status != 200:
                raise OSError(f"gossip answered {status}")
            ack = json.loads(data)
            if not isinstance(ack, dict):
                raise OSError("gossip ack is not an object")
        except (OSError, ValueError) as exc:
            sib.breaker.record_failure()
            sib.push_failures += 1
            trace_mod.trace_end(sp, error=exc)
            LOG.debug("gossip push to %s failed (%s)",
                      sib.name, exc)
            return False
        sib.breaker.record_success()
        sib.pushes += 1
        sib.deltas_sent += len(deltas)
        sib.last_ok = time.time()
        with self._lock:
            sib.acked_seq = max(sib.acked_seq, seq)
            self._trim_locked()
        trace_mod.trace_end(sp)
        return True

    # -- receive side ---------------------------------------------------

    def apply_remote(self, doc: dict) -> dict[str, Any]:
        """Apply one sibling's push (the ``POST /api/cluster/gossip``
        body). Bumps are applied with ``announce=False`` so they are
        never re-logged. Returns the ack document."""
        if not isinstance(doc, dict):
            raise ValueError("gossip body must be an object")
        nonce = str(doc.get("nonce", ""))
        seq = int(doc.get("seq", 0))
        deltas = doc.get("deltas") or []
        if not nonce or not isinstance(deltas, list):
            raise ValueError("gossip body needs nonce + deltas")
        router = self.router
        with self._lock:
            applied = self._applied.get(nonce)
            if applied is not None:
                self._applied.move_to_end(nonce)
        full_sync = False
        if applied is None:
            # unknown instance (sibling joined or restarted): one
            # conservative global bump covers every write it may have
            # forwarded before this exchange existed
            full_sync = True
            applied = seq - len(deltas)
        else:
            first = min((int(d.get("seq", 0)) for d in deltas
                         if isinstance(d, dict)), default=seq + 1)
            if first > applied + 1:
                # the sender trimmed deltas this router never saw
                # (lag past log_max): the lost window is unknowable —
                # cover it with one global bump
                full_sync = True
        metrics: set[str] = set()
        global_bumps = 0
        for d in deltas:
            if not isinstance(d, dict) or \
                    int(d.get("seq", 0)) <= applied:
                continue
            if d.get("global"):
                global_bumps += 1
            else:
                metrics.update(str(m) for m in
                               (d.get("metrics") or ()))
            self.deltas_applied += 1
        if full_sync:
            self.full_syncs += 1
            router._bump_global_version(announce=False)
        if metrics:
            router._bump_versions(metrics, announce=False)
        if global_bumps:
            router._bump_global_version(announce=False)
        if not deltas:
            self.heartbeats_in += 1
        with self._lock:
            self._applied[nonce] = max(
                seq, self._applied.get(nonce, 0))
            self._applied.move_to_end(nonce)
            while len(self._applied) > self._applied_max:
                self._applied.popitem(last=False)
        topo = doc.get("topology")
        if isinstance(topo, dict):
            try:
                if router.adopt_topology(topo):
                    self.topology_adoptions += 1
            except Exception:  # noqa: BLE001 - adoption must never 5xx
                LOG.exception("gossip topology adoption failed")
        return {"nonce": self.nonce, "applied_seq": seq,
                "epoch": router.state.epoch,
                "fullSync": full_sync}

    # -- observability --------------------------------------------------

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            log_len = len(self._log)
            seq = self._seq
        return {
            "nonce": self.nonce,
            "seq": seq,
            "log_entries": log_len,
            "degraded": self.degraded(),
            "stale_siblings": self.stale_siblings(),
            "deltas_logged": self.deltas_logged,
            "deltas_applied": self.deltas_applied,
            "heartbeats_in": self.heartbeats_in,
            "full_syncs": self.full_syncs,
            "topology_adoptions": self.topology_adoptions,
            "cache_bypasses": self.cache_bypasses,
            "siblings": {n: s.health_info()
                         for n, s in sorted(self.siblings.items())},
        }

    def collect_stats(self, collector) -> None:
        collector.record("cluster.gossip.deltas_logged",
                         self.deltas_logged)
        collector.record("cluster.gossip.deltas_applied",
                         self.deltas_applied)
        collector.record("cluster.gossip.full_syncs",
                         self.full_syncs)
        collector.record("cluster.gossip.topology_adoptions",
                         self.topology_adoptions)
        collector.record("cluster.gossip.cache_bypasses",
                         self.cache_bypasses)
        collector.record("cluster.gossip.degraded",
                         1 if self.degraded() else 0)
        for name, s in sorted(self.siblings.items()):
            collector.record("cluster.gossip.pushes", s.pushes,
                             sibling=name)
            collector.record("cluster.gossip.push_failures",
                             s.push_failures, sibling=name)
            s.breaker.collect_stats(collector)


__all__ = ["GossipBus", "Sibling"]
