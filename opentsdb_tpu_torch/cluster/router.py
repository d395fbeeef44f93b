"""The cluster router: consistent-hash writes, scatter-gather reads
(ref: ``opentsdb_tpu/cluster/router.py``).

``tsd.cluster.role = router`` turns a TSDServer into a stateless
serving tier in front of ``tsd.cluster.peers`` shard TSDs (the
reference's "many TSDs behind a load balancer", with the salt-bucket
fan-out of ``SaltScanner.java:70`` lifted to the network):

- **writes** partition by the consistent-hash series key and forward
  one series-grouped body per shard — the peer's ``/api/put`` commits
  it through ``TSDB.add_point_groups`` as ONE WAL write + one
  group-committed fsync, so a client body costs one fsync per shard,
  not per point. An unreachable shard's batches land in its durable
  spool (:mod:`opentsdb_tpu_torch.cluster.spool`) and the client is
  still acknowledged: no acknowledged point is ever lost to a peer
  outage. Replay drains in FIFO order when the peer's breaker lets a
  probe through.
- **reads** scatter the (absolutized, ms-resolution) TSQuery to every
  shard and merge per-shard group partials
  (:mod:`opentsdb_tpu_torch.cluster.merge`). Each shard answers
  through its own query engine, so its kernels run there. Failures
  flow through the per-peer :class:`CircuitBreaker`, per-peer
  timeouts, the ``cluster.peer`` fault site and optional tail-latency
  hedging, and a dead/hung/tripped peer yields a **200 partial**
  carrying a ``shardsDegraded`` marker (never a 5xx). Degraded
  partials are never retained by the result cache; a later complete
  answer repopulates the entry.

At ``tsd.cluster.rf`` > 1 every point is written to rf distinct shards
(its replica set, a clockwise walk of the ring), a read assigns each
replica set to one live member (``replicaSel``, so every series is
read once) and falls back to the next member when a reader fails, and
an anti-entropy pass re-copies a window one replica missed from a
sibling. Federated continuous queries (:mod:`.cq`) stand on every
shard and merge at the router.

``POST /api/cluster/reshard`` installs a new ring at a fenced epoch
(:mod:`.reshard`): writes go to the old and the new owners while the
window is open, reads stay on the old ring, a background backfill
copies the moved series, and the window finalizes when every unit is
copied. Past epoch 0 every read carries a ``replicaSel``, so each
shard masks the stale copies it still holds before its kernels run,
and the stale-copy retire pass (:mod:`.retire`) deletes them.

Sibling routers behind one load balancer (``tsd.cluster.routers``)
exchange their cache-version bumps and the reshard topology over the
gossip bus (:mod:`.gossip`): a write forwarded by one router
invalidates every sibling's result cache after one push, a router
whose sibling went quiet past the stale window serves around its
cache, and a sibling adopts a reshard another router began and
finishes it if that router dies.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import logging
import queue as queue_mod
import re
import threading
import time
from typing import Any

import numpy as np

from opentsdb_tpu_torch.cluster import merge as merge_mod
from opentsdb_tpu_torch.cluster import replica as replica_mod
from opentsdb_tpu_torch.cluster import wire as wire_mod
from opentsdb_tpu_torch.cluster.client import (PeerClient, PeerError,
                                               parse_peer_spec)
from opentsdb_tpu_torch.cluster.hashring import HashRing, series_shard_key
from opentsdb_tpu_torch.cluster.reshard import (HORIZON_MS, Backfiller,
                                                ReshardState)
from opentsdb_tpu_torch.cluster.spool import PeerSpool, SpoolFull
from opentsdb_tpu_torch.core.tags import (check_metric_and_tags,
                                          check_metric_and_tags_batch,
                                          parse_put_value)
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.obs.trace import (TRACE_HEADER, trace_begin,
                                          trace_end)
from opentsdb_tpu_torch.query.model import BadRequestError
from opentsdb_tpu_torch.utils.faults import (CircuitBreaker,
                                             DegradedError, RetryPolicy,
                                             call_with_retries)

LOG = logging.getLogger("cluster.router")


class PeerUnavailable(OSError):
    """The peer's breaker refused the dispatch (open, or half-open
    with the probe already in flight): degrade WITHOUT touching the
    peer — and without recording a failure the peer didn't commit."""


class Peer:
    """One shard TSD: address, health machinery, handoff spool."""

    def __init__(self, name: str, host: str, port: int, config,
                 spool_dir: str | None):
        self.name = name
        self.client = PeerClient(
            host, port,
            timeout_ms=config.get_float("tsd.cluster.timeout_ms",
                                        5000.0))
        self.breaker = CircuitBreaker(
            f"cluster.peer.{name}",
            failure_threshold=config.get_int(
                "tsd.cluster.breaker.failure_threshold", 3),
            reset_timeout_ms=config.get_float(
                "tsd.cluster.breaker.reset_timeout_ms", 5000.0))
        self.spool = PeerSpool(
            spool_dir, name,
            max_bytes=config.get_int("tsd.cluster.spool.max_mb",
                                     256) << 20,
            compact_bytes=config.get_int(
                "tsd.cluster.spool.compact_mb", 4) << 20)
        self.lock = threading.Lock()  # FIFO spool-vs-forward decision
        # counters (exported via /api/stats + /api/health)
        self.forwarded_batches = 0
        self.forwarded_points = 0
        self.spooled_batches = 0
        self.spooled_points = 0
        self.replayed_batches = 0
        self.replay_point_errors = 0
        self.query_failures = 0
        self.hedges = 0
        # binary wire transport counters (cluster/wire.py): frames
        # and bytes on the persistent links, pipelining depth, and
        # how often this peer fell back to JSON HTTP / shed into the
        # spool under pipeline backpressure
        self.wire_connects = 0
        self.wire_frames_out = 0
        self.wire_frames_in = 0
        self.wire_bytes_out = 0
        self.wire_bytes_in = 0
        self.wire_pipeline_depth = 0   # gauge: acks in flight now
        self.wire_pipeline_max = 0
        self.wire_fallbacks = 0        # negotiation said HTTP
        self.wire_backpressure_sheds = 0
        # (best-effort, in-memory) trace ids of recently spooled
        # batches, FIFO-aligned with the spool: a later replay root
        # links back to the writes it finally delivered. Lost on
        # restart — the durable spool format stays trace-agnostic.
        self.spool_trace_links: collections.deque = \
            collections.deque(maxlen=512)

    def health_info(self) -> dict[str, Any]:
        return {
            "address": self.client.address,
            "breaker": self.breaker.health_info(),
            "spool": self.spool.health_info(),
            "forwarded_batches": self.forwarded_batches,
            "forwarded_points": self.forwarded_points,
            "spooled_batches": self.spooled_batches,
            "spooled_points": self.spooled_points,
            "replayed_batches": self.replayed_batches,
            "replay_point_errors": self.replay_point_errors,
            "query_failures": self.query_failures,
            "hedges": self.hedges,
            "wire": {
                "connects": self.wire_connects,
                "frames_out": self.wire_frames_out,
                "frames_in": self.wire_frames_in,
                "bytes_out": self.wire_bytes_out,
                "bytes_in": self.wire_bytes_in,
                "pipeline_depth": self.wire_pipeline_depth,
                "pipeline_max": self.wire_pipeline_max,
                "fallbacks": self.wire_fallbacks,
                "backpressure_sheds": self.wire_backpressure_sheds,
            },
        }


class ClusterRouter:
    """Owns the shard map, the peers and the failure machinery."""

    def __init__(self, tsdb):
        self.tsdb = tsdb
        config = tsdb.config
        self.config = config
        config_spec = config.get_string("tsd.cluster.peers", "")
        if not parse_peer_spec(config_spec):
            raise ValueError(
                "tsd.cluster.role=router needs tsd.cluster.peers")
        spool_dir = config.get_string("tsd.cluster.spool.dir", "")
        if not spool_dir and getattr(tsdb, "data_dir", ""):
            import os
            spool_dir = os.path.join(tsdb.data_dir, "cluster_spool")
        # persisted topology (``reshard.json``): after a finalized
        # reshard the INSTALLED ring differs from config (which still
        # names the boot ring); a mid-reshard kill also restores the
        # old ring and the backfill's done-markers, so the cutover
        # resumes where it stopped
        self.state = ReshardState(spool_dir or None)
        spec_str = self.state.peers_spec or config_spec
        vnodes = self.state.vnodes \
            or config.get_int("tsd.cluster.vnodes", 64)
        specs = parse_peer_spec(spec_str)
        self.rf = max(config.get_int("tsd.cluster.rf", 1), 1)
        self.peers: dict[str, Peer] = {}
        for name, host, port in specs:
            self.peers[name] = Peer(name, host, port, config,
                                    spool_dir or None)
        self.ring = HashRing([name for name, _, _ in specs],
                             vnodes=vnodes)
        self.old_ring: HashRing | None = None
        if self.state.active:
            old_specs = parse_peer_spec(self.state.old_spec)
            for name, host, port in old_specs:
                if name not in self.peers:
                    self.peers[name] = Peer(name, host, port, config,
                                            spool_dir or None)
            self.old_ring = HashRing(
                [name for name, _, _ in old_specs],
                vnodes=self.state.old_vnodes or vnodes)
        # anti-entropy: per-(peer, metric) divergence windows the
        # spool cannot replay (lost or refused records), repaired from
        # a surviving replica when the peer returns
        self.dirty = replica_mod.DirtyTracker(spool_dir or None)
        self.repair_enabled = config.get_bool(
            "tsd.cluster.replica.repair", True)
        self.backfiller = Backfiller(self)
        # points per backfill (and repair) delivery
        self.backfill_batch = config.get_int(
            "tsd.cluster.reshard.backfill_batch", 4000)
        self.reshard_interval_s = config.get_float(
            "tsd.cluster.reshard.interval_ms", 250.0) / 1000.0
        # stale-copy retire pass (cluster/retire.py): after a
        # finalized reshard, delete the moved series the backfill left
        # on former owners (reads already hide them through
        # replicaSel; this reclaims the bytes), one unit per wake
        from opentsdb_tpu_torch.cluster.retire import StaleCopyRetirer
        self.retirer = StaleCopyRetirer(self)
        self.retire_enabled = config.get_bool(
            "tsd.cluster.retire.enable", True)
        self.retire_interval_s = config.get_float(
            "tsd.cluster.retire.interval_ms", 1000.0) / 1000.0
        self._spool_dir = spool_dir or None
        workers = config.get_int("tsd.cluster.fanout_workers", 0) \
            or max(2 * len(self.peers), 4)
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="tsd-cluster")
        self.retry = RetryPolicy.from_config(
            config, "tsd.cluster.retry", attempts=2, base_ms=25,
            deadline_ms=2000)
        self.timeout_s = config.get_float("tsd.cluster.timeout_ms",
                                          5000.0) / 1000.0
        self.hedge_after_s = config.get_float(
            "tsd.cluster.hedge_after_ms", 0.0) / 1000.0
        self.replay_interval_s = config.get_float(
            "tsd.cluster.spool.replay_interval_ms", 500.0) / 1000.0
        self.replay_batch = config.get_int(
            "tsd.cluster.spool.replay_batch", 64)
        # binary columnar wire transport (cluster/wire.py): persistent
        # framed links per peer, JSON HTTP as negotiated fallback
        self.wire = wire_mod.WireManager(self)
        # federated continuous queries (cluster/cq.py): per-shard
        # shared partials, the merge view held here
        from opentsdb_tpu_torch.cluster.cq import FederatedCQRegistry
        self.cqs = FederatedCQRegistry(self)
        # per-sub retry amplification bound: a multi-sub 400 re-asks
        # per rejected metric — cap how many of those singles run
        # concurrently against ONE peer so a wide dashboard query
        # can't monopolize the fan-out pool on a partially-known shard
        self.sub_retry_max_concurrent = max(config.get_int(
            "tsd.cluster.sub_retry.max_concurrent", 4), 1)
        self.sub_retry_rounds = 0    # metric-elimination rounds run
        self.sub_retry_singles = 0   # single-sub re-asks dispatched
        self.sub_retry_capped = 0    # dispatches that hit the cap
        # router-level counters
        self.queries = 0
        self.degraded_queries = 0
        self.cache_hits = 0
        self.cache_stores = 0
        self.cache_degraded_skips = 0
        self.repairs = 0             # completed anti-entropy passes
        self.repair_points = 0       # points re-forwarded by repair
        self.read_fallbacks = 0      # tuples re-read from a fallback
        self.scatter_name_queries = 0  # suggest/search fan-outs
        # per-(peer, metric) known/unknown memo: a shard that 400'd
        # "no such name" for a metric is not re-asked about it on
        # every later query — its sub is pre-filtered out of the
        # scatter (and of the per-sub retry), so the steady state for
        # a multi-sub query over partially-known shards is ONE
        # request per shard. Invalidated when a write for the metric
        # is forwarded to that peer (UID creation happens on the
        # shard's write path) and peer-wide when a spool replay lands
        # (spooled writes create UIDs long after their ack); a TTL
        # knob covers deployments where writes can bypass this router.
        self._sub_memo_lock = threading.Lock()
        # (peer, metric) -> (cached no-such-name 400 body, stamp);
        # holds ONLY unknown outcomes — absence means "known or
        # never asked", so the dict is bounded by actual negative
        # knowledge, not by peers x all metrics. Negative knowledge
        # still grows without bound under a probing workload (every
        # typo'd dashboard metric mints an entry that nothing ever
        # reads again — TTL eviction used to run only on a re-read of
        # the SAME key), so the replay loop sweeps expired entries
        # and a hard cap drops the oldest stamps first.
        self._sub_memo: dict[tuple[str, str], tuple] = {}
        self.sub_memo_ttl_s = config.get_float(
            "tsd.cluster.sub_memo.ttl_ms", 0.0) / 1000.0
        self.sub_memo_max = max(config.get_int(
            "tsd.cluster.sub_memo.max_entries", 4096), 1)
        self.sub_memo_skips = 0        # subs pre-filtered from scatters
        self.sub_memo_invalidations = 0
        self.sub_memo_evictions = 0    # TTL sweeps + cap overflow
        # per-metric invalidation versions for the result cache (see
        # write_version): bumped AFTER a write/delete lands so a
        # racing query can never cache pre-write data under the
        # post-write version
        self._version_lock = threading.Lock()
        # bounded: past max_entries the whole map folds into ONE
        # global bump (conservative — every cached entry goes stale
        # at once) and restarts empty, so an ever-new-metrics ingest
        # stream cannot grow router memory without bound
        self._metric_versions: dict[str, int] = {}
        self.metric_versions_max = max(config.get_int(
            "tsd.cluster.metric_versions.max_entries", 100000), 1)
        self._global_version = 0
        # query-path read-repair: divergence a READ observed (failed
        # reader re-covered by a fallback round; replicas disagreeing
        # whether a metric exists) stages here and drains into the
        # DirtyTracker off the read path — mark() fsyncs under its
        # lock, which a serve path must never wait on
        self.read_repair_enabled = config.get_bool(
            "tsd.cluster.read_repair.enable", True)
        self.read_repair = replica_mod.ReadRepairQueue(
            config.get_int("tsd.cluster.read_repair.max_pending",
                           1024))
        # the sibling routers named by tsd.cluster.routers exchange
        # write-version and reshard-epoch deltas (cluster/gossip.py), so
        # every front door's result cache invalidates on writes any of
        # them forwarded
        self.gossip = None
        routers_spec = config.get_string("tsd.cluster.routers", "")
        if routers_spec.strip():
            from opentsdb_tpu_torch.cluster.gossip import GossipBus
            self.gossip = GossipBus(self, routers_spec)
        # TTL cache for the /api/health fleet section (see
        # fleet_health): (doc, monotonic stamp)
        self._fleet_health_lock = threading.Lock()
        self._fleet_health_cache: tuple = (None, 0.0)
        self._stop = threading.Event()
        self._replay_thread: threading.Thread | None = None
        self._backfill_thread: threading.Thread | None = None
        self._retire_thread: threading.Thread | None = None
        self._reshard_lock = threading.Lock()  # begin/finalize fence
        self._started = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Start the spool replay thread and the gossip push loop, and
        resume a persisted cutover's backfill or an unfinished retire
        pass (idempotent)."""
        if self._started:
            return
        self._started = True
        t = threading.Thread(target=self._replay_loop,
                             name="cluster-replay", daemon=True)
        self._replay_thread = t
        t.start()
        if self.gossip is not None:
            self.gossip.start()
        if self.state.active:
            self._start_backfill()
        elif self.retire_enabled and self.retirer.pending():
            # a restart across an un-retired epoch resumes the pass
            self._start_retire()

    def _start_backfill(self) -> None:
        t = self._backfill_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._backfill_loop,
                             name="cluster-backfill", daemon=True)
        self._backfill_thread = t
        t.start()

    def _start_retire(self) -> None:
        t = self._retire_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._retire_loop,
                             name="cluster-retire", daemon=True)
        self._retire_thread = t
        t.start()

    def stop(self) -> None:
        """Join the gossip, replay, backfill and retire threads, drop
        the federated registrations (the shards keep theirs), close the
        wire links (which wakes every leg waiting on one), join the
        fan-out pool and close the spools: no thread of the router
        outlives this call."""
        self._stop.set()
        if self.gossip is not None:
            self.gossip.stop()
        for t in (self._replay_thread, self._backfill_thread,
                  self._retire_thread):
            if t is not None and t.is_alive():
                t.join(timeout=5)
        self.cqs.close()
        self.wire.close_all()
        self.pool.shutdown(wait=True, cancel_futures=True)
        for peer in self.peers.values():
            peer.spool.close()

    # ------------------------------------------------------------------
    # shared peer dispatch (fault site + breaker + retry)
    # ------------------------------------------------------------------

    def _check_faults(self, peer: Peer) -> None:
        faults = getattr(self.tsdb, "faults", None)
        if faults is not None:
            faults.check("cluster.peer")
            faults.check(f"cluster.peer.{peer.name}")

    def _fetch(self, peer: Peer, method: str, path: str,
               body: bytes | None,
               headers: dict[str, str] | None = None
               ) -> tuple[int, bytes]:
        """One request with optional tail-latency hedging: after
        ``tsd.cluster.hedge_after_ms`` without an answer, a duplicate
        request races the first — first completion wins (Monarch /
        Dean & Barroso "The Tail at Scale"). Hedge threads are
        bounded by the peer socket timeout."""
        if self.hedge_after_s <= 0:
            return peer.client.request(method, path, body,
                                       headers=headers)
        results: queue_mod.Queue = queue_mod.Queue()

        def attempt() -> None:
            try:
                results.put(("ok",
                             peer.client.request(method, path, body,
                                                 headers=headers)))
            except Exception as exc:  # noqa: BLE001 - carried across
                results.put(("err", exc))

        # hedge attempt: lifetime is
        # bounded by the peer client's socket timeout — the request
        # call cannot outlive timeout_s, so no join handle is kept
        threading.Thread(target=attempt, daemon=True).start()
        deadline = time.monotonic() + self.timeout_s + 1.0
        launched = 1
        errors = 0
        first_err: Exception | None = None
        wait_s = self.hedge_after_s
        while True:
            try:
                kind, payload = results.get(
                    timeout=max(min(wait_s,
                                    deadline - time.monotonic()),
                                0.001))
            except queue_mod.Empty:
                if launched == 1 and time.monotonic() < deadline:
                    peer.hedges += 1
                    # hedge twin —
                    # socket-timeout-bounded like the primary above
                    threading.Thread(target=attempt,
                                     daemon=True).start()
                    launched = 2
                    wait_s = deadline - time.monotonic()
                    continue
                raise PeerError(
                    f"peer {peer.name}: hedged request timed out"
                ) from first_err
            if kind == "ok":
                return payload
            errors += 1
            first_err = first_err or payload
            if errors >= launched and launched == 2:
                raise payload
            if errors >= launched:
                # primary failed before the hedge fired: launch the
                # backup immediately, it is the only hope left
                peer.hedges += 1
                # hedge backup —
                # socket-timeout-bounded like the primary above
                threading.Thread(target=attempt, daemon=True).start()
                launched = 2
                wait_s = deadline - time.monotonic()

    def fetch_guarded(self, peer: Peer, method: str, path: str,
                      body: bytes | None = None) -> tuple[int, bytes]:
        """One breaker-guarded exchange on an arbitrary path (the
        suggest, lookup, last-point and fleet scatters, the copy
        scans): same failure
        accounting as a query leg — a refusal or transport failure
        raises."""
        if not peer.breaker.allow():
            raise PeerUnavailable(
                f"breaker for {peer.name} is {peer.breaker.state}")
        try:
            self._check_faults(peer)
            status, data = self._fetch(peer, method, path, body)
        except OSError:
            peer.breaker.record_failure()
            raise
        peer.breaker.record_success()
        return status, data

    def scan_series_pages(self, peer: Peer, metric: str,
                          start_ms: int, end_ms: int,
                          sel: dict | None = None,
                          _depth: int = 0):
        """Yield pages of raw per-series rows (aggregator ``none``,
        ms resolution) of one metric's window on one peer — the
        backfill/repair copy source, with the same breaker +
        fault-site discipline as a scatter leg. A **413 scan-budget
        refusal bisects the window**: a budgeted shard refuses a
        whole history in one piece, and without paging the copy
        would retry the identical over-budget query forever. A
        generator so callers forward each slice as it arrives
        instead of materializing the whole history (one page is
        bounded by the shard's scan budget when one is configured).
        Unknown metric yields nothing; any other failure raises
        ``OSError`` (the caller retries the unit later)."""
        obj = {
            # explicit ms suffix: a bare sub-13-digit number parses
            # as SECONDS (reference numeric heuristic), which would
            # silently widen early bisect slices to contain all data
            "start": f"{max(start_ms, 1)}ms", "end": f"{end_ms}ms",
            "msResolution": True,
            "queries": [{"metric": metric, "aggregator": "none"}],
        }
        if sel is not None:
            obj["replicaSel"] = sel
        status, data = self._query_peer(peer,
                                        json.dumps(obj).encode())
        if status == 400 and b"no such name" in data.lower():
            return
        # depth 48 halves any ms window down to ~1s slices — the
        # copy scans start at epoch-begin, so ~25 levels are routine
        if status == 413 and _depth < 48 \
                and end_ms - max(start_ms, 1) > 1000:
            mid = (max(start_ms, 1) + end_ms) // 2
            yield from self.scan_series_pages(peer, metric, start_ms,
                                              mid, sel, _depth + 1)
            yield from self.scan_series_pages(peer, metric, mid + 1,
                                              end_ms, sel,
                                              _depth + 1)
            return
        if status != 200:
            raise PeerUnavailable(
                f"peer {peer.name} answered {status} to a "
                f"{metric!r} copy scan")
        try:
            yield data if isinstance(data, list) else json.loads(data)
        except ValueError as exc:
            raise PeerUnavailable(
                f"peer {peer.name} sent an unparseable copy-scan "
                f"body") from exc

    def deliver_backfill(self, peer: Peer, dps: list[dict]) -> None:
        """Forward one backfill batch through the normal deliver/spool
        path: an unreachable new owner spools, and the moved keyspace
        still lands, so a kill during a reshard loses nothing."""
        self._deliver(peer, dps)

    # ------------------------------------------------------------------
    # per-(peer, metric) known/unknown memo (see __init__)
    # ------------------------------------------------------------------

    def _memo_lookup(self, peer_name: str, metric: str):
        """The cached no-such-name 400 body for (peer, metric), or
        None when the peer is not known-unknown for it. The memo
        holds ONLY unknown entries (a known metric simply has no
        entry — storing positives would grow the dict by peers x
        all-metrics with nothing ever reading them); expired entries
        evict on read when a TTL is configured."""
        key = (peer_name, metric)
        with self._sub_memo_lock:
            ent = self._sub_memo.get(key)
            if ent is None:
                return None
            body, stamp = ent
            if self.sub_memo_ttl_s > 0 and \
                    time.monotonic() - stamp > self.sub_memo_ttl_s:
                del self._sub_memo[key]
                return None
            return body

    def _memo_known(self, peer_name: str, metrics) -> None:
        """A definite 200 disproves any cached unknown — drop it
        (no positive entry is stored; absence IS 'known')."""
        with self._sub_memo_lock:
            for m in metrics:
                self._sub_memo.pop((peer_name, m), None)

    def _memo_unknown(self, peer_name: str, metric: str,
                      body: bytes) -> None:
        """Cache one peer's metric-unknown 400 — ONLY when the body
        is the engine's no-such-name rejection: any other 400 is a
        query-shape error that must not poison later,
        differently-shaped queries over the same metric."""
        if not metric or b"no such name" not in body.lower():
            return
        with self._sub_memo_lock:
            self._sub_memo[(peer_name, metric)] = \
                (body, time.monotonic())

    def sweep_sub_memo(self) -> int:
        """Evict expired and over-cap memo entries (called from the
        replay loop each wake, and directly by tests/ops). Read-time
        eviction alone only covers keys that are probed AGAIN — a
        typo'd metric nobody re-queries would pin its entry forever.
        Over the cap, oldest stamps evict first (they are the least
        likely to be re-probed). Returns entries dropped."""
        now = time.monotonic()
        dropped = 0
        with self._sub_memo_lock:
            if self.sub_memo_ttl_s > 0:
                stale = [k for k, (_b, stamp)
                         in self._sub_memo.items()
                         if now - stamp > self.sub_memo_ttl_s]
                for k in stale:
                    del self._sub_memo[k]
                dropped += len(stale)
            over = len(self._sub_memo) - self.sub_memo_max
            if over > 0:
                oldest = sorted(self._sub_memo,
                                key=lambda k:
                                self._sub_memo[k][1])[:over]
                for k in oldest:
                    del self._sub_memo[k]
                dropped += over
            self.sub_memo_evictions += dropped
        return dropped

    def invalidate_sub_memo(self, peer_name: str,
                            metrics=None) -> None:
        """Drop UNKNOWN entries for a peer (all of them, or just the
        given metrics): called when a write batch is dispatched to
        the peer (the shard's write path mints the UID — the metric
        is about to be known) and peer-wide when a spool replay
        lands (spooled writes create UIDs long after their ack).
        Known entries never invalidate — a metric that vanishes
        server-side (UID reclamation) re-404s through the normal
        per-sub retry and re-memoizes."""
        with self._sub_memo_lock:
            if metrics is not None:
                stale = [(peer_name, m) for m in set(metrics)
                         if (peer_name, m) in self._sub_memo]
            else:
                stale = [k for k in self._sub_memo
                         if k[0] == peer_name]
            for k in stale:
                del self._sub_memo[k]
            self.sub_memo_invalidations += len(stale)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def write_owners(self, metric: str, tags: dict[str, str]
                     ) -> tuple[str, ...]:
        """Every shard one point must reach: the current ring's
        replica set (rf distinct owners, primary first), plus, while a
        reshard cutover is open, the OLD ring's set (dual-write: reads
        stay on the old ring during the window, so its owners must
        keep seeing every accepted write; an unmoved series resolves
        to the same set and pays nothing)."""
        owners = list(self.ring.shards_for(metric, tags, self.rf))
        old_ring = self.old_ring
        if old_ring is not None:
            for n in old_ring.shards_for(metric, tags, self.rf):
                if n not in owners:
                    owners.append(n)
        return tuple(owners)

    @staticmethod
    def _dp_key(dp: dict) -> tuple:
        """Content identity of one datapoint, stable across the JSON
        round-trip through a peer's error echo — replica deliveries
        report per-point outcomes against parsed copies, not the
        router's original objects."""
        tags = dp.get("tags") or {}
        return (dp.get("metric"), str(dp.get("timestamp")),
                str(dp.get("value")),
                tuple(sorted((str(k), str(v))
                             for k, v in tags.items())))

    def partition_points(self, points: list[dict]
                         ) -> tuple[dict[str, list[dict]],
                                    list[dict], list[dict]]:
        """Shard each datapoint by its series key onto EVERY replica
        owner. Returns (shard -> points, local error entries for
        unshardable dps, valid dps in input order): at RF > 1, or
        during a reshard window, the same dp object appears in several
        shards' batches.

        The per-point validation mirrors the peer's write path BEFORE
        acking: a bad point bound for a dead shard would be acked into
        the spool now and rejected at replay — the same body a
        HEALTHY shard 400s, so ack semantics would depend on peer
        liveness. Same helpers the shard's write path calls, so the
        accept sets cannot drift. Checks keep the scalar loop's
        precedence per point (timestamp, then metric/tags, then
        value), but the timestamp range check runs as ONE vectorized
        pass over the numeric common case, metric/tag validation runs
        as one columnar charset pass over the batch's distinct series
        (``check_metric_and_tags_batch``), and ring ownership resolves
        through one ``searchsorted`` over all series keys — a bulk put
        of many points on few series hashes the ring once per series,
        not once per point."""
        n = len(points)
        # index -> error entry; None = accepted (or still undecided).
        # Assembling errors from this at the end preserves the scalar
        # loop's input-order interleaving of structural and
        # validation failures.
        entries: list[dict | None] = [None] * n
        batches: dict[str, list[dict]] = {}
        valid: list[dict] = []

        # pass 1 — structural shape (pure python object dispatch) +
        # timestamp extraction for the vector check
        cand: list[tuple[int, dict, str, dict]] = []
        ts_idx: list[int] = []
        ts_orig: list[Any] = []
        for i, dp in enumerate(points):
            if not isinstance(dp, dict):
                entries[i] = {"datapoint": dp,
                              "error": "not a datapoint object"}
                continue
            metric = dp.get("metric")
            tags = dp.get("tags") or {}
            if not isinstance(metric, str) or not metric or \
                    not isinstance(tags, dict):
                entries[i] = {"datapoint": dp,
                              "error": "missing metric or tags"}
                continue
            cand.append((i, dp, metric, tags))
            ts = dp.get("timestamp")
            if isinstance(ts, (int, float)):
                ts_idx.append(i)
                ts_orig.append(ts)

        # vectorized timestamp verdicts for numeric timestamps.
        # int(ts) truncates toward zero — np.trunc matches. Anything
        # past 2**47 (or non-finite) needs _check_timestamp's exact
        # bit test and falls back to the scalar path; below that the
        # range check is just 0 < ts <= 2**47.
        ts_ok: set[int] = set()
        ts_err: dict[int, str] = {}
        if ts_idx:
            t = np.trunc(np.asarray(ts_orig, dtype=np.float64))
            hi = float(1 << 47)
            ok = (t > 0.0) & (t <= hi)
            bad = np.isfinite(t) & (t <= 0.0)
            for j in np.nonzero(ok)[0]:
                ts_ok.add(ts_idx[j])
            for j in np.nonzero(bad)[0]:
                # format from the ORIGINAL value: the float64 trunc
                # of a huge int is approximate, int() is not
                ts_err[ts_idx[j]] = \
                    f"invalid timestamp {int(ts_orig[j])}"

        # distinct-series batch: validate every hashable series in
        # one columnar charset pass and hash the ring once per series
        # via searchsorted over the whole batch — pass 2 below then
        # reduces to memo lookups for the common case. Unhashable tag
        # values (TypeError on the key) keep the scalar path.
        series_memo: dict[Any, tuple[str, Any]] = {}
        for i, dp, metric, tags in cand:
            try:
                series_memo.setdefault((metric, tuple(tags.items())),
                                       (metric, tags))
            except TypeError:
                pass
        if series_memo:
            skeys = list(series_memo)
            pairs = list(series_memo.values())
            verrs = check_metric_and_tags_batch(pairs)
            ok_pos = [j for j, e in enumerate(verrs) if e is None]
            ring_keys = [series_shard_key(pairs[j][0], pairs[j][1])
                         for j in ok_pos]
            new_sets = self.ring.shards_for_keys(ring_keys, self.rf)
            old_ring = self.old_ring
            old_sets = old_ring.shards_for_keys(ring_keys, self.rf) \
                if old_ring is not None else None
            for slot, j in enumerate(ok_pos):
                owners = new_sets[slot]
                if old_sets is not None:
                    owners = tuple(owners) + tuple(
                        nm for nm in old_sets[slot] if nm not in owners)
                series_memo[skeys[j]] = ("ok", owners)
            for j, e in enumerate(verrs):
                if e is not None:
                    series_memo[skeys[j]] = ("err", e)

        # pass 2 — per-point verdicts in input order, series-memoized
        for i, dp, metric, tags in cand:
            if i in ts_err:
                entries[i] = {"datapoint": dp, "error": ts_err[i]}
                continue
            if i not in ts_ok:
                # non-numeric, non-finite or >2**47: exact scalar
                # check (missing key raises the same KeyError the
                # scalar loop reported)
                try:
                    self.tsdb._check_timestamp(int(dp["timestamp"]))
                except (KeyError, TypeError, ValueError) as exc:
                    entries[i] = {"datapoint": dp, "error": str(exc)}
                    continue
            try:
                # insertion-ordered items: validate_string reports
                # the FIRST offending tag, so two dps with the same
                # tag set in different orders stay distinct entries
                skey = (metric, tuple(tags.items()))
                cached = series_memo.get(skey)
            except TypeError:  # unhashable tag value: no memo
                skey = None
                cached = None
            if cached is None:
                try:
                    check_metric_and_tags(metric, tags)
                except (KeyError, TypeError, ValueError) as exc:
                    cached = ("err", str(exc))
                else:
                    cached = ("ok", self.write_owners(metric, tags))
                if skey is not None:
                    series_memo[skey] = cached
            if cached[0] == "err":
                entries[i] = {"datapoint": dp, "error": cached[1]}
                continue
            value = dp.get("value")
            if isinstance(value, str):
                try:
                    parse_put_value(value)
                except (KeyError, TypeError, ValueError) as exc:
                    entries[i] = {"datapoint": dp, "error": str(exc)}
                    continue
            elif value is None or isinstance(value, bool) or \
                    not isinstance(value, (int, float)):
                entries[i] = {"datapoint": dp,
                              "error": f"invalid value: {value!r}"}
                continue
            valid.append(dp)
            for shard in cached[1]:
                batches.setdefault(shard, []).append(dp)
        errors = [e for e in entries if e is not None]
        return batches, errors, valid

    def forward_writes(self, points: list[dict]
                       ) -> tuple[int, int, list[dict]]:
        """Partition + deliver one put body to every replica owner.
        Returns (success, failed, error entries). Spooled points count
        as success — they are durably accepted and will replay; a
        point is acked only when EVERY owner accepted (forwarded or
        spooled) its copy, so an ack always implies eventual presence
        on the full replica set.

        At-least-once, never at-most-once: a delivery that outlives
        the ``fut.result`` cap below is reported failed even though
        the in-flight worker may still land (or spool) it — the safe
        direction, since a re-sent point dedupes last-write-wins on
        the shard, while the reverse (acking a loss) cannot be
        repaired. The same rule covers a replica split (one owner
        stored, another refused): reported failed, and the divergence
        is marked dirty for anti-entropy."""
        batches, errors, valid = self.partition_points(points)
        tctx = trace_mod.current()
        # .get: a reshard finalize may pop a departed old owner
        # between partitioning and here; skipping its batch IS the
        # post-finalize write plan (the union included the new owners,
        # which still receive their copies)
        futures = {
            self.pool.submit(self._deliver_traced, tctx, peer, dps):
            (name, dps) for name, dps in batches.items()
            if (peer := self.peers.get(name)) is not None}
        # per-point outcomes merge across replica deliveries by
        # CONTENT key: the first error entry per failed point is
        # reported; a point missing from every delivery's error set
        # was accepted by all its owners
        failed_entries: dict[tuple, dict] = {}
        unattributed = 0
        for fut, (name, dps) in futures.items():
            try:
                _ok, bad, errs = fut.result(
                    timeout=self.timeout_s * 4 + 5)
            except Exception as exc:  # noqa: BLE001 - per-shard
                LOG.exception("forward to %s failed unexpectedly",
                              name)
                bad = len(dps)
                errs = [{"datapoint": dp, "error": str(exc)}
                        for dp in dps]
            attributed = 0
            refused_dps: list[dict] = []
            for e in errs:
                dp = e.get("datapoint")
                if isinstance(dp, dict):
                    failed_entries.setdefault(self._dp_key(dp), e)
                    refused_dps.append(dp)
                    attributed += 1
            if refused_dps and (self.rf > 1
                                or self.old_ring is not None):
                # a point one replica refused may have landed on its
                # siblings (a replica SPLIT): mark the window dirty so
                # anti-entropy re-levels it when the peer is willing;
                # a refusal that was the same everywhere repairs to a
                # no-op and clears (ref)
                self.dirty.mark(
                    name,
                    {dp.get("metric") for dp in refused_dps
                     if dp.get("metric")},
                    self._min_ts_ms(refused_dps))
            # a peer that counted failures it did not echo (odd
            # summary body): charge them without attribution — the
            # over-report direction is the safe one
            unattributed += max(int(bad) - attributed, 0)
        failed_keys = set(failed_entries)
        success = sum(1 for dp in valid
                      if self._dp_key(dp) not in failed_keys)
        success = max(success - unattributed, 0)
        failed = len(errors) + (len(valid) - success)
        errors.extend(failed_entries.values())
        # AFTER delivery/spool: a racing query that read the new
        # version has already seen (or will re-read) the landed data
        self._bump_versions(dp["metric"] for dp in valid)
        return success, failed, errors

    def _deliver_traced(self, tctx, peer: Peer, dps: list[dict]
                        ) -> tuple[int, int, list[dict]]:
        """One shard's write leg under its ``cluster.forward`` span
        (pool thread): the context re-binds thread-locally so the
        spool handoff inside records its ``cluster.spool.append``
        span, and the trace header lets the shard root its ingest
        subtree under this leg."""
        if tctx is None:
            return self._deliver(peer, dps)
        sp = trace_begin("cluster.forward", ctx=tctx,
                         peer=peer.name, points=len(dps))
        headers = {TRACE_HEADER: tctx.tracer.header_for(tctx, sp)} \
            if sp is not None else None
        try:
            with trace_mod.use(tctx):
                out = self._deliver(peer, dps, headers=headers)
        except BaseException as exc:
            trace_end(sp, error=exc)
            raise
        trace_end(sp)
        return out

    def _deliver(self, peer: Peer, dps: list[dict],
                 headers: dict[str, str] | None = None
                 ) -> tuple[int, int, list[dict]]:
        """One shard's batch: forward, or spool when the peer is
        backlogged/unhealthy (FIFO: a non-empty spool means new
        writes enqueue BEHIND it, so replayed history and causally
        LATER traffic keep arrival order — an ack always precedes
        the next dependent write's dispatch; batches concurrently in
        flight during the failure window are unordered, as
        concurrent writes always are)."""
        # whether this batch forwards or spools, the shard's write
        # path will mint these metrics' UIDs (now, or at replay —
        # which invalidates peer-wide again): the scatter may ask
        # about them from here on
        self.invalidate_sub_memo(peer.name,
                                 {dp["metric"] for dp in dps})
        # the wire path never materializes a JSON body at all — that
        # deferral IS much of the ingest win. Spool records stay JSON
        # (the durable format is transport-agnostic), built lazily
        # only when a batch actually sheds.
        use_wire = self.wire.usable(peer)
        body: bytes | None = None if use_wire \
            else json.dumps(dps).encode()

        def spool_body() -> bytes:
            nonlocal body
            if body is None:
                body = json.dumps(dps).encode()
            return body

        with peer.lock:
            direct = (peer.spool.pending_records == 0
                      and peer.breaker.state == CircuitBreaker.CLOSED)
            if not direct:
                return self._spool_batch(peer, spool_body(), dps)
        try:
            self._check_faults(peer)
            if use_wire:
                try:
                    status, data = call_with_retries(
                        lambda: self.wire.put_batch(
                            peer, dps=dps, headers=headers),
                        self.retry, retryable=(OSError,))
                except (wire_mod.WireUnsupported,
                        wire_mod.WireEncodeError):
                    # negotiation said HTTP, or the batch is not
                    # canonically columnar: same delivery, JSON body
                    use_wire = False
            if not use_wire:
                status, data = call_with_retries(
                    lambda: self._fetch(
                        peer, "POST",
                        "/api/put?summary=true&details=true",
                        spool_body(), headers=headers),
                    self.retry, retryable=(OSError,))
        except wire_mod.WireBacklogged:
            # pipeline at max_inflight: shed to the durable spool
            # WITHOUT touching the breaker — backpressure is not
            # peer damage, and the spool replay drains in FIFO order
            peer.wire_backpressure_sheds += 1
            with peer.lock:
                return self._spool_batch(peer, spool_body(), dps)
        except OSError as exc:
            peer.breaker.record_failure()
            LOG.warning("shard %s unreachable (%s); spooling %d "
                        "point(s)", peer.name, exc, len(dps))
            with peer.lock:
                return self._spool_batch(peer, spool_body(), dps)
        doc = self._put_summary_doc(data)
        if doc is None and not 200 <= status < 300:
            # a 4xx with no put summary did NOT come from a TSD put
            # handler (reverse proxy, auth wall, wrong address):
            # nothing was stored, so acking here would lose the batch
            peer.breaker.record_failure()
            LOG.warning("shard %s answered %d without a put summary; "
                        "spooling %d point(s)", peer.name, status,
                        len(dps))
            with peer.lock:
                return self._spool_batch(peer, body, dps)
        peer.breaker.record_success()
        peer.forwarded_batches += 1
        if doc is None:  # 2xx with an odd body: stored per the status
            ok, bad, errs = len(dps), 0, []
        else:
            ok = int(doc.get("success", 0))
            bad = int(doc.get("failed", 0))
            errs = list(doc.get("errors") or ())
        peer.forwarded_points += ok
        return ok, bad, errs

    @staticmethod
    def _put_summary_doc(data: bytes) -> dict | None:
        """The peer's ``/api/put?summary`` body, or None when the
        response is not a put summary at all."""
        try:
            doc = json.loads(data)
        except Exception:  # noqa: BLE001 - defensive: odd peer body
            return None
        if isinstance(doc, dict) and ("success" in doc
                                      or "failed" in doc):
            return doc
        return None

    @staticmethod
    def _min_ts_ms(dps: list[dict]) -> int:
        """Earliest DATA timestamp of one batch in ms (the dirty-epoch
        a later anti-entropy repair reads the replica from)."""
        out = 0
        for dp in dps:
            try:
                ts = int(dp["timestamp"])
            except (KeyError, TypeError, ValueError):
                continue
            ms = ts * 1000 if ts < 10 ** 11 else ts
            if out == 0 or ms < out:
                out = ms
        return out

    def _spool_batch(self, peer: Peer, body: bytes, dps: list[dict]
                     ) -> tuple[int, int, list[dict]]:
        """Durable handoff (caller holds ``peer.lock``): the ack
        rides on the spool fsync. A FULL spool refuses the points
        loudly (per-point errors) — dropping the oldest record would
        break the no-loss guarantee. The trace records the handoff
        as a ``cluster.spool.append`` span, and the trace id is
        remembered so the eventual replay root links back to it.

        Divergence bookkeeping: a handoff the spool cannot replay
        durably (refused full, or an in-memory spool a router restart
        would lose) marks the (peer, metric) window dirty — when the
        peer returns, anti-entropy re-copies it from a surviving
        replica instead of trusting records that may be gone."""
        sp = trace_begin("cluster.spool.append", peer=peer.name,
                         points=len(dps))
        try:
            peer.spool.append(body)
        except SpoolFull as exc:
            trace_end(sp, error=exc)
            self.dirty.mark(peer.name, {dp["metric"] for dp in dps},
                            self._min_ts_ms(dps))
            return 0, len(dps), [
                {"datapoint": dp,
                 "error": f"shard {peer.name} unreachable and its "
                          f"spool is full: {exc}"} for dp in dps]
        tctx = trace_mod.current()
        if tctx is not None:
            peer.spool_trace_links.append(tctx.trace_id)
        trace_end(sp)
        if not peer.spool.durable:
            # the ack is only as durable as this process: mark the
            # window so a restart that loses the queue still heals
            self.dirty.mark(peer.name, {dp["metric"] for dp in dps},
                            self._min_ts_ms(dps))
        peer.spooled_batches += 1
        peer.spooled_points += len(dps)
        return len(dps), 0, []

    # ------------------------------------------------------------------
    # spool replay
    # ------------------------------------------------------------------

    def _replay_loop(self) -> None:
        while not self._stop.wait(self.replay_interval_s):
            self.sweep_sub_memo()
            try:
                self.drain_read_repair()
            except Exception:  # noqa: BLE001 - keep the loop alive
                LOG.exception("read-repair drain failed")
            for peer in list(self.peers.values()):
                try:
                    self.drain_spool(peer)
                except Exception:  # noqa: BLE001 - keep the loop alive
                    LOG.exception("spool replay for %s failed",
                                  peer.name)
                try:
                    self.maybe_repair(peer)
                except Exception:  # noqa: BLE001 - keep the loop alive
                    LOG.exception("replica repair for %s failed",
                                  peer.name)

    def drain_spool(self, peer: Peer) -> int:
        """Catch-up drain: keep replaying batches while progress is
        made. One fixed-size batch per wake would cap the drain at
        replay_batch/interval records per second — sustained ingest
        above that rate (new writes enqueue FIFO behind a non-empty
        spool) would grow a recovering peer's backlog to SpoolFull
        even though the peer is healthy. Stops on the first
        zero-progress pass (drained, breaker refused, or a failure
        re-opened the breaker)."""
        if peer.spool.pending_records == 0:
            return 0
        # one background trace roots the catch-up drain; it links
        # back to the (still-remembered) traces whose writes were
        # spooled, so "where did my acked write actually land" is
        # answerable end to end
        tracer = getattr(self.tsdb, "tracer", None)
        tctx = tracer.start_background("cluster.spool.replay",
                                       peer=peer.name) \
            if tracer is not None and tracer.enabled else None
        total = 0
        links: list[str] = []
        try:
            with trace_mod.use(tctx):
                while not self._stop.is_set():
                    n = self.try_replay(peer, links_out=links)
                    total += n
                    if n == 0:
                        break
            if tctx is not None:
                tctx.tag(batches=total,
                         pending=peer.spool.pending_records,
                         trace_links=links)
        finally:
            if tracer is not None and tctx is not None:
                if total == 0:
                    # a zero-progress probe is not worth a retained
                    # trace; mark it sampled-out
                    tctx.sampled = False
                tracer.finish(tctx)
        return total

    def try_replay(self, peer: Peer, max_records: int = 0,
                   links_out: list | None = None) -> int:
        """Drain up to ``max_records`` (0 = one configured batch) of
        the peer's spool if its breaker admits a dispatch. The replay
        IS the half-open probe: first success closes the breaker,
        failure re-opens it and keeps the spool position.

        Trace links are consumed per APPLIED record (inside the
        callback) so a pass that fails partway keeps the unapplied
        records' links aligned with the spool — popping by the pass
        total would desynchronize forever after one partial failure.
        """
        if peer.spool.pending_records == 0:
            return 0
        if not peer.breaker.allow():
            return 0
        limit = max_records or self.replay_batch

        def apply(body: bytes) -> None:
            self._replay_one(peer, body)
            # this record is delivered: retire its (best-effort,
            # FIFO-aligned) trace link
            if peer.spool_trace_links:
                link = peer.spool_trace_links.popleft()
                if links_out is not None:
                    links_out.append(link)

        before = peer.spool.replayed_records
        try:
            n = peer.spool.replay(apply, limit)
        except OSError as exc:
            if peer.spool.replayed_records > before:
                # the records applied BEFORE the failure are readable
                # on the shard now: cached entries must go stale even
                # though this pass did not finish
                self._bump_global_version()
            peer.breaker.record_failure()
            LOG.info("spool replay to %s stopped (%s); %d record(s) "
                     "still pending", peer.name, exc,
                     peer.spool.pending_records)
            return 0
        if n:
            peer.breaker.record_success()
            # replayed history just LANDED on the shard, long after
            # its ack: a complete answer cached while the backlog was
            # pending is stale NOW (the write-time bump happened at
            # spool time, before this data was readable) — and the
            # shard may know metrics it 400'd while the backlog was
            # pending (replay-created UIDs), so unknown memos go too
            self._bump_global_version()
            self.invalidate_sub_memo(peer.name)
            LOG.info("replayed %d spooled batch(es) to %s (%d "
                     "pending)", n, peer.name,
                     peer.spool.pending_records)
        elif peer.breaker.state != CircuitBreaker.CLOSED:
            # zero records applied WITHOUT touching the peer (the
            # spool head was unreadable and got dropped): no evidence
            # of peer health, so the half-open probe this call
            # consumed must not close the breaker — release it as a
            # failure and let the next reset window retry
            peer.breaker.record_failure()
        return n

    def _replay_one(self, peer: Peer, body: bytes) -> None:
        self._check_faults(peer)
        status = None
        if self.wire.usable(peer):
            try:
                status, data = self.wire.put_batch(peer, body=body)
            except (wire_mod.WireUnsupported,
                    wire_mod.WireEncodeError,
                    wire_mod.WireBacklogged):
                # replay traffic never waits on pipeline room and
                # never re-spools (it IS the spool): deliver this
                # record over plain HTTP instead
                status = None
        if status is None:
            status, data = self._fetch(
                peer, "POST", "/api/put?summary=true&details=true",
                body)
        doc = self._put_summary_doc(data)
        if doc is None and not 200 <= status < 300:
            # not a TSD put answer: the record was NOT applied — keep
            # it spooled (raising stops the replay pass and records a
            # breaker failure in try_replay)
            raise PeerUnavailable(
                f"peer {peer.name} answered {status} without a put "
                f"summary during replay")
        peer.replayed_batches += 1
        bad = int(doc.get("failed", 0)) if doc else 0
        if bad:
            # per-point rejections (bad data) are terminal: the peer
            # is healthy and will reject them identically forever —
            # count them loudly instead of wedging the spool
            peer.replay_point_errors += bad
            LOG.warning("spool replay to %s: peer rejected %d "
                        "point(s): %s", peer.name, bad, data[:200])

    # ------------------------------------------------------------------
    # anti-entropy: repair a returned replica from a surviving one
    # ------------------------------------------------------------------

    def drain_read_repair(self) -> int:
        """Move read-observed divergence hints from the bounded
        staging queue into the :class:`DirtyTracker` (whose ``mark``
        fsyncs — never acceptable on the read path that staged them).
        The marked windows then heal through the normal
        ``maybe_repair`` machinery in this same loop; completion is
        counted back via ``read_repair.note_repaired``. Returns how
        many hints were marked."""
        staged = self.read_repair.drain()
        if not staged:
            return 0
        tracer = getattr(self.tsdb, "tracer", None)
        tctx = tracer.start_background("cluster.read_repair",
                                       entries=len(staged)) \
            if tracer is not None and tracer.enabled else None
        marked = 0
        try:
            with trace_mod.use(tctx):
                for peer_name, metric, since_ms in staged:
                    if peer_name in self.peers:
                        self.dirty.mark(peer_name, [metric],
                                        since_ms)
                        marked += 1
                    else:
                        # the peer left the ring between the read and
                        # this drain: its debt is void
                        self.read_repair.drop_peer(peer_name)
        finally:
            if tracer is not None and tctx is not None:
                tracer.finish(tctx)
        return marked

    def maybe_repair(self, peer: Peer) -> bool:
        """Run one anti-entropy pass for a peer with dirty windows,
        once its spool is drained (replay covers everything the spool
        still holds — repair exists for what it lost). Gated by the
        peer's breaker like any dispatch: on a non-closed breaker the
        repair IS the half-open probe. Returns True when the peer has
        no remaining debt."""
        if not self.repair_enabled:
            return False
        if not self.dirty.peek(peer.name):
            return True
        if peer.spool.pending_records:
            return False  # replay first; repair covers the remainder
        if peer.breaker.state != CircuitBreaker.CLOSED:
            if not peer.breaker.allow():
                return False
            probe = True
        else:
            probe = False
        tracer = self.tsdb.tracer
        tctx = tracer.start_background("cluster.replica.repair",
                                       peer=peer.name) \
            if tracer.enabled else None
        try:
            with trace_mod.use(tctx):
                done = self.repair_peer(peer)
            if probe:
                if done:
                    peer.breaker.record_success()
                else:
                    # the remaining debt is SOURCE-side trouble (a
                    # sibling was down or refused the scan) — the
                    # peer under probe may be perfectly healthy, and
                    # punishing it would quarantine it for as long as
                    # the source stays down. Decide the probe by
                    # touching the peer itself.
                    try:
                        self._check_faults(peer)
                        self._fetch(peer, "GET", "/api/version",
                                    None)
                        peer.breaker.record_success()
                    except OSError:
                        peer.breaker.record_failure()
            return done
        except OSError as exc:  # the cluster.replica fault site
            if tctx is not None:
                tctx.set_error(exc)
            peer.breaker.record_failure()
            LOG.info("replica repair for %s stopped (%s)",
                     peer.name, exc)
            return False
        finally:
            if tctx is not None:
                tracer.finish(tctx)

    def repair_peer(self, peer: Peer) -> bool:
        """Re-copy every dirty (peer, metric) window from a surviving
        replica: for each replica set containing the peer, ONE alive
        sibling is asked for the window (``replicaSel``-filtered to
        exactly those sets, so nothing is copied twice) and the rows
        re-forward through the normal deliver path. Duplicates dedupe
        last-write-wins on the shard — repair is idempotent. Returns
        True when every dirty metric was repaired (False leaves the
        remaining debt for the next pass)."""
        self.tsdb.faults.check("cluster.replica")
        dirty = self.dirty.peek(peer.name)
        if not dirty:
            return True
        ring = self.ring
        rf = min(self.rf, len(ring.names))
        sets_with = [t for t in ring.replica_sets(rf)
                     if peer.name in t]
        if rf <= 1 or not sets_with:
            # no second copy exists (RF=1), or the peer no longer
            # owns anything on this ring: there is nothing to repair
            # FROM (or for) — the debt is void
            self.dirty.clear(peer.name)
            self.read_repair.drop_peer(peer.name)
            return True
        now_ms = int(time.time() * 1000)
        all_done = True
        for metric, since_ms in sorted(dirty.items()):
            per_source: dict[str, list[tuple]] = {}
            uncovered = False
            for t in sets_with:
                src = next(
                    (n for n in t if n != peer.name
                     and not self.peers[n].breaker.blocking()), None)
                if src is None:
                    uncovered = True  # no alive sibling: retry later
                else:
                    per_source.setdefault(src, []).append(t)
            copied = 0
            metric_ok = not uncovered
            for src, sets in per_source.items():
                pages = self.scan_series_pages(
                    self.peers[src], metric,
                    max(since_ms - 1, 1), now_ms + HORIZON_MS,
                    sel=replica_mod.sel_doc(
                        ring.names, ring.vnodes, rf, sets))
                while True:
                    # SOURCE failures (advancing the scan) only keep
                    # the metric dirty; PEER-side delivery failures
                    # propagate out of repair_peer — the debt stays
                    # (the data still lives on the source, so there
                    # is no ack to protect) and maybe_repair's
                    # breaker accounting sees a failure the peer
                    # actually caused
                    try:
                        rows = next(pages)
                    except StopIteration:
                        break
                    except OSError:
                        metric_ok = False
                        break
                    dps: list[dict] = []
                    for row in rows:
                        tags = row.get("tags") or {}
                        for ts, val in (row.get("dps") or ()):
                            dps.append({"metric": metric,
                                        "timestamp": int(ts),
                                        "value": val, "tags": tags})
                    for i in range(0, len(dps), self.backfill_batch):
                        copied += self._repair_deliver(
                            peer, dps[i:i + self.backfill_batch])
            if metric_ok:
                self.repair_points += copied
                self.dirty.clear(peer.name, [metric])
                self.read_repair.note_repaired(peer.name, [metric])
            else:
                all_done = False
        if all_done:
            self.repairs += 1
            # repaired history just became readable on the peer: any
            # cached complete answer over it is stale now
            self._bump_global_version()
            self.invalidate_sub_memo(peer.name)
        return all_done

    def _repair_deliver(self, peer: Peer, dps: list[dict]) -> int:
        """One repair chunk, delivered DIRECTLY (the ``_replay_one``
        shape): a repair pass often runs as the peer's half-open
        probe, when ``_deliver`` would divert to the spool — which
        would both defeat the probe (nothing touches the peer) and
        turn repair data into spool backlog. Failure raises; the
        dirty debt stays and the data still lives on the source
        replica, so there is no ack to protect."""
        self._check_faults(peer)
        self.invalidate_sub_memo(peer.name,
                                 {dp["metric"] for dp in dps})
        status, data = self._fetch(
            peer, "POST", "/api/put?summary=true&details=true",
            json.dumps(dps).encode())
        doc = self._put_summary_doc(data)
        if doc is None and not 200 <= status < 300:
            raise PeerUnavailable(
                f"peer {peer.name} answered {status} without a put "
                f"summary during repair")
        if doc is not None and int(doc.get("failed", 0)):
            raise PeerUnavailable(
                f"peer {peer.name} rejected "
                f"{doc.get('failed')} repair point(s)")
        return len(dps)

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------

    def _read_view(self, delete: bool = False
                   ) -> tuple[HashRing, list[str]]:
        """The ring reads scatter over, and the peer names involved.
        During a reshard cutover reads stay on the OLD ring: its
        owners hold the complete history AND (through dual-write)
        every in-window write, so answers are complete without merging
        across rings, the one shape where two copies of a moved series
        could double-sum. Deletes must purge EVERY copy, so they cover
        the union of both rings."""
        old_ring = self.old_ring
        if delete:
            names = list(self.ring.names)
            if old_ring is not None:
                names += [n for n in old_ring.names
                          if n not in names]
            return self.ring, names
        if old_ring is not None:
            return old_ring, list(old_ring.names)
        return self.ring, list(self.ring.names)

    def execute_query(self, tsq) -> tuple[list, list[str]]:
        """Scatter one validated TSQuery, merge partials. Returns
        (results, degraded shard names). Raises ``BadRequestError``
        for non-decomposable aggregators; peer failures NEVER raise —
        they degrade.

        At RF > 1 the scatter is a replica-set READ PLAN: every
        distinct ordered replica set is assigned to one member (the
        first whose breaker isn't blocking), the request carries the
        assignment as a ``replicaSel`` series filter, and a failed
        reader's sets re-assign to the next replica in further rounds
        — so a single shard death yields a COMPLETE marker-less 200,
        and the ``shardsDegraded`` marker appears only when an entire
        replica set is down (ref)."""
        self.queries += 1
        for sub in tsq.queries:
            if sub.tsuids:
                # UIDs are assigned independently per shard: the same
                # TSUID bytes name a DIFFERENT series on each shard,
                # so a scattered tsuid sub would merge unrelated
                # series into one plausible-looking answer
                raise BadRequestError(
                    "tsuid sub-queries are not supported in router "
                    "mode: UIDs are assigned per shard — query by "
                    "metric and tags instead")
        plans = [merge_mod.decompose_plan(sub) for sub in tsq.queries]
        # expanded peer-side sub list: avg fans out as sum+count twins
        peer_subs: list[dict] = []
        slots: list[tuple[int, int | None]] = []  # (primary, secondary)
        for sub, plan in zip(tsq.queries, plans):
            sj = sub.to_json()
            sj.pop("pixels", None)  # reduce AFTER the merge
            sj.pop("pixelFn", None)
            sj.pop("index", None)
            if plan == "avg":
                s1 = dict(sj, aggregator="sum")
                s2 = dict(sj, aggregator="count")
                slots.append((len(peer_subs), len(peer_subs) + 1))
                peer_subs.extend([s1, s2])
            elif plan == "sketch_agg":
                # percentile aggregator: each shard emits its raw
                # per-series downsampled values; the router folds
                # them into per-(group, bucket) sketches
                slots.append((len(peer_subs), None))
                peer_subs.append(dict(sj, aggregator="none"))
            else:
                slots.append((len(peer_subs), None))
                peer_subs.append(sj)
        peer_obj = {
            # absolute window: every shard must grid the SAME range,
            # or downsample buckets stop aligning across partials
            "start": str(tsq.start_ms), "end": str(tsq.end_ms),
            "msResolution": True, "showQuery": True,
            "queries": peer_subs,
            "showTSUIDs": tsq.show_tsuids,
            "noAnnotations": tsq.no_annotations,
            "globalAnnotations": tsq.global_annotations,
            "timezone": tsq.timezone,
            "useCalendar": tsq.use_calendar,
            "delete": tsq.delete,
        }
        if any(p == "sketch" for p in plans):
            # percentile subs: shards answer with serialized
            # per-bucket sketch partials instead of extracted
            # quantiles (quantiles of partials don't merge; sketches
            # do, exactly)
            peer_obj["sketchPartials"] = True
        # per-peer scatter plan through the known/unknown memo: subs
        # whose metric a peer has already 400'd "no such name" for
        # are pre-filtered out of that peer's request (their cached
        # 400 still joins the all-shards-agree check), so the steady
        # state over partially-known shards is one request per shard.
        # Deletes bypass the memo: a stale unknown entry must never
        # silently skip a purge.
        use_memo = not tsq.delete
        ring, ring_names = self._read_view(tsq.delete)
        rf = min(self.rf, len(ring.names))
        # the replica filter is needed at RF > 1 (each series has RF
        # live copies) and on ANY resharded cluster (epoch > 0: moved
        # series leave stale copies on their former owners, since the
        # backfill copies and does not purge); deletes go unfiltered
        # because they must reach every copy, stale ones included
        use_sel = (rf > 1 or self.state.epoch > 0) and not tsq.delete
        # read assignment: replica tuple -> reader. sel=None means
        # "everything you own" (one replica at epoch 0, and deletes)
        if use_sel:
            def takes_reads(n: str) -> bool:
                # .get: a reshard finalize may pop a departed peer
                # between the ring snapshot and here; route around it
                # like any unhealthy replica
                peer = self.peers.get(n)
                return peer is not None and \
                    not peer.breaker.blocking()

            pending: dict[str, list[tuple] | None] = {}
            for t in ring.replica_sets(rf):
                reader = next((n for n in t if takes_reads(n)), t[0])
                pending.setdefault(reader, []).append(t)
        else:
            pending = {name: None for name in ring_names}
        # trace the fan-out: one cluster.scatter stage, one
        # cluster.peer leg per shard (error-tagged when degraded)
        tctx = trace_mod.current()
        sp_scatter = trace_begin("cluster.scatter", ctx=tctx,
                                 shards=len(pending))
        scatter_id = sp_scatter.span_id if sp_scatter is not None \
            else None
        # expanded-sub index -> 4xx bodies, one per rejecting peer;
        # answered/unknown peer sets drive the all-shards-agree check
        sub_400: dict[int, list[bytes]] = {}
        sub_answered: dict[int, set] = \
            {k: set() for k in range(len(peer_subs))}
        sub_unknown: dict[int, set] = \
            {k: set() for k in range(len(peer_subs))}
        # unknown outcomes served from the memo (vs a FRESH 400 this
        # scatter): the read-repair divergence hook ignores them, or
        # every repeat query of a legitimately shard-unknown metric
        # would re-stage the same no-op repair
        sub_memo_unknown: dict[int, set] = {}
        # incremental merge: every COMPLETE leg folds the moment its
        # future resolves (wire legs additionally decode frame-by-
        # frame), instead of gathering all partials and merging last.
        # Fold order still equals the old partials-list order, so the
        # merged result is bit-identical to the batch path.
        merger = merge_mod.StreamMerger(
            tsq.queries, plans, slots,
            sketch_alpha=self.config.get_float(
                "tsd.sketch.alpha", 0.01))
        failed_peers: set[str] = set()
        degraded_set: set[str] = set()

        def mark_trouble() -> None:
            if tctx is not None:
                # force retention the moment trouble is KNOWN —
                # before later legs stamp their headers, so those
                # legs (header_for reads ctx.forced at call time)
                # carry keep=1 and their shard subtrees survive
                # sampling. Legs already dispatched with keep=0
                # cannot be retro-retained.
                tctx.forced = True

        while pending:
            futures = {}
            round_req: dict[str, tuple] = {}
            round_failed: list[str] = []
            for name in sorted(pending):
                sel = pending[name]
                peer = self.peers.get(name)
                if peer is None:
                    # popped by a concurrent reshard finalize: fail
                    # the leg so its sets fall back (or degrade)
                    round_failed.append(name)
                    mark_trouble()
                    continue
                req_obj = peer_obj if sel is None else dict(
                    peer_obj, replicaSel=replica_mod.sel_doc(
                        ring.names, ring.vnodes, rf, sel))
                skip: dict[int, bytes] = {}
                if use_memo:
                    for k, sj in enumerate(peer_subs):
                        cached = self._memo_lookup(
                            name, sj.get("metric") or "")
                        if cached is not None:
                            skip[k] = cached
                sent = [k for k in range(len(peer_subs))
                        if k not in skip]
                if skip:
                    self.sub_memo_skips += len(skip)
                    for k, cached in skip.items():
                        sub_400.setdefault(k, []).append(cached)
                        sub_unknown[k].add(name)
                        sub_answered[k].add(name)
                        sub_memo_unknown.setdefault(k, set()) \
                            .add(name)
                round_req[name] = (peer, sel, sent, req_obj)
                if not sent:
                    continue  # nothing this shard knows
                pbody = json.dumps(dict(
                    req_obj,
                    queries=[peer_subs[k] for k in sent])).encode()
                futures[name] = self.pool.submit(
                    self._query_peer_traced, tctx, scatter_id, peer,
                    pbody)
            for name, fut in futures.items():
                peer, sel, sent, req_obj = round_req[name]
                try:
                    status, data = fut.result(
                        timeout=self.timeout_s * 2 + 5)
                except (OSError,
                        concurrent.futures.TimeoutError) as exc:
                    peer.query_failures += 1
                    round_failed.append(name)
                    mark_trouble()
                    LOG.warning("shard %s failed this scatter round "
                                "(%s: %s)", name,
                                type(exc).__name__, exc)
                    continue
                if status == 200:
                    try:
                        # a wire leg arrives already decoded (list);
                        # an HTTP leg is a JSON body
                        rows = data if isinstance(data, list) \
                            else json.loads(data)
                    except ValueError:
                        peer.query_failures += 1
                        round_failed.append(name)
                        mark_trouble()
                        continue
                    if len(sent) != len(peer_subs):
                        # trimmed request: peer-local sub indexes map
                        # back to the expanded scatter's
                        for r in rows:
                            q = r.get("query")
                            if isinstance(q, dict) and \
                                    isinstance(q.get("index"), int) \
                                    and 0 <= q["index"] < len(sent):
                                q["index"] = sent[q["index"]]
                    merger.add_leg(rows)
                    for k in sent:
                        sub_answered[k].add(name)
                    if use_memo:
                        self._memo_known(
                            name, {peer_subs[k].get("metric")
                                   for k in sent})
                    continue
                if status != 400:
                    # 413 (scan budget), 404/405 (not a TSD query
                    # endpoint — proxy / auth wall / misroute), 5xx
                    # passed through: NOT the no-such-name empty
                    # partial. Treating it as one would silently
                    # blank this shard's series in a cacheable
                    # "complete" answer; fail the leg loudly instead
                    # (fallback, else marker — never cached).
                    peer.query_failures += 1
                    round_failed.append(name)
                    mark_trouble()
                    LOG.warning("shard %s answered %d to the "
                                "scatter; failing it for this query",
                                name, status)
                    continue
                # 400 from a HEALTHY peer: a shard that owns no
                # series of the metric 400s with "no such name" — an
                # empty partial, not peer damage and not a client
                # error (other shards may own it). Kept for the
                # all-shards-agree check below.
                if len(sent) == 1:
                    sub_400.setdefault(sent[0], []).append(data)
                    sub_unknown[sent[0]].add(name)
                    sub_answered[sent[0]].add(name)
                    merger.add_leg([])
                    if use_memo:
                        self._memo_unknown(
                            name,
                            peer_subs[sent[0]].get("metric") or "",
                            data)
                    continue
                # multi-sub scatter: the request-level 400 hides
                # WHICH sub the peer rejected — and blanks subs it
                # DOES own series for. Re-ask in metric-elimination
                # rounds (one request per rejected metric, not one
                # per sub) and memoize every definite outcome so the
                # NEXT query scatters once.
                rows, died = self._per_sub_retry(
                    peer, req_obj,
                    [(k, peer_subs[k]) for k in sent], data,
                    sub_400, sub_answered, sub_unknown,
                    memoize=use_memo, tctx=tctx,
                    parent_id=scatter_id)
                if died:
                    peer.query_failures += 1
                    round_failed.append(name)
                    mark_trouble()
                else:
                    merger.add_leg(rows)
            # re-assign a failed reader's replica sets to the next
            # member that hasn't failed this query; a set with no
            # member left is DOWN — the only case that degrades
            next_pending: dict[str, list] = {}
            for name in round_failed:
                failed_peers.add(name)
            for name in round_failed:
                sel = pending[name]
                if sel is None:
                    degraded_set.add(name)  # no replica to fall to
                    continue
                for t in sel:
                    cand = next((n for n in t
                                 if n not in failed_peers), None)
                    if cand is None:
                        degraded_set.update(t)
                    else:
                        next_pending.setdefault(cand, []).append(t)
            if next_pending:
                self.read_fallbacks += sum(
                    len(v) for v in next_pending.values())
            pending = next_pending
        degraded = sorted(degraded_set)
        if failed_peers and self.read_repair_enabled and rf > 1 \
                and not tsq.delete:
            # a reader that died mid-scatter may be missing writes in
            # the window this read wanted (a fallback round covered
            # its sets, but the replica itself stays suspect): stage
            # the window for repair — idempotent, so a reader that
            # merely timed out heals to a no-op
            metrics = {s.metric for s in tsq.queries if s.metric}
            since = max(int(tsq.start_ms), 1)
            for name in sorted(failed_peers):
                if metrics and name in self.peers:
                    self.read_repair.enqueue(name, metrics, since)
        if tsq.delete:
            # the shards already purged whatever rows they own during
            # the scatter (and per-sub retries): any cached entry
            # over these metrics is stale NOW, on EVERY exit path
            # below — including the all-shards-agree 400 (a multi-sub
            # delete can purge one sub's metric everywhere and still
            # 400 on a nowhere-known sibling sub)
            metrics = [s.metric for s in tsq.queries if s.metric]
            if len(metrics) < len(tsq.queries):
                self._bump_global_version()
            self._bump_versions(metrics)
        if sp_scatter is not None:
            if degraded:
                sp_scatter.tag(degraded=",".join(degraded))
            trace_end(sp_scatter)
        if not degraded_set:
            for idx in sorted(sub_unknown):
                unknown = sub_unknown[idx]
                if unknown and unknown == sub_answered[idx]:
                    # every peer that definitively answered this sub
                    # rejected it, and every replica set was covered
                    # (no degradation): surface the real client error
                    # (single-node parity: an unknown metric in ANY
                    # sub fails the whole query)
                    errs = sub_400.get(idx) or [b""]
                    try:
                        msg = json.loads(
                            errs[0])["error"]["message"]
                    except Exception:  # noqa: BLE001
                        msg = errs[0].decode("utf-8", "replace")[:200]
                    raise BadRequestError(msg)
        if self.read_repair_enabled and rf > 1 and not tsq.delete:
            # replica-divergence detection: replicas DISAGREED about
            # a metric's existence this scatter (some answered series,
            # others freshly 400'd "no such name"). The unknown side
            # may have lost the series' writes — or may legitimately
            # be assigned none of them; staging is cheap and a clean
            # window repairs to a no-op. Memo-served unknowns are
            # excluded (nothing new was observed about them).
            for idx, unknown in sub_unknown.items():
                fresh = unknown - sub_memo_unknown.get(idx, set())
                if not fresh or unknown == sub_answered[idx]:
                    continue
                metric = peer_subs[idx].get("metric") or ""
                if not metric:
                    continue
                since = max(int(tsq.start_ms), 1)
                for name in sorted(fresh):
                    if name in self.peers:
                        self.read_repair.enqueue(name, [metric],
                                                 since)
        if degraded:
            self.degraded_queries += 1
            if tctx is not None:
                # a degraded partial IS what an operator goes looking
                # for after seeing the shardsDegraded marker: force
                # retention so 1-in-N sampling can never discard the
                # trace carrying the error-tagged peer span
                tctx.forced = True
        if tsq.delete and degraded:
            # unlike writes, deletes have no spool/replay story (only
            # put bodies replay): a 200 here would ack a purge the
            # degraded shard never saw, and its rows would survive
            # FOREVER. Loud structured 503 instead — delete is
            # idempotent, so retrying once the shard returns
            # completes the purge.
            raise DegradedError(
                "delete partially applied: shard(s) "
                f"{', '.join(degraded)} unreachable — "
                "retry to complete the purge")
        with trace_mod.trace_span("cluster.merge", ctx=tctx,
                                  shards=merger.legs):
            # per-leg folding already happened as legs completed;
            # this finishes the accumulated groups (avg division,
            # grid sort) and applies post-merge pixel budgets
            results = merger.results()
            results = self._apply_pixels(tsq, results)
        return results, degraded

    _NO_SUCH_NAME_RE = re.compile(
        r"No such name for '[^']+': '([^']*)'")

    @classmethod
    def _unknown_metric_from_400(cls, data: bytes) -> str | None:
        """The metric a peer's no-such-name 400 body rejects, or None
        when the body is some other 400 shape."""
        try:
            msg = json.loads(data)["error"]["message"]
        except Exception:  # noqa: BLE001 - defensive: odd peer body
            return None
        m = cls._NO_SUCH_NAME_RE.search(str(msg))
        return m.group(1) if m else None

    def _per_sub_retry(self, peer: Peer, req_obj: dict,
                       indexed_subs: list[tuple[int, dict]],
                       first_400: bytes,
                       sub_400: dict[int, list[bytes]],
                       sub_answered: dict[int, set],
                       sub_unknown: dict[int, set],
                       memoize: bool = True, tctx=None,
                       parent_id=None) -> tuple[list[dict], bool]:
        """Re-ask a peer that 400'd the combined request in
        METRIC-ELIMINATION rounds: a no-such-name body names the
        rejected metric, so each 400 — starting with the scatter's
        own (``first_400``) — drops that metric's subs (recording
        their rejection) and re-issues the remainder as ONE request.
        The amplification is one round trip per unknown metric, not
        one per expanded sub (a 12-sub dashboard with one cold
        metric used to pay 12 re-asks). A 400 the body cannot
        attribute falls back to the one-request-per-sub sweep, so no
        peer answer shape loses correctness.

        Returns (result rows with their sub index restored,
        peer-died flag). A peer that dies partway contributes
        NOTHING — not the rows it already answered: an avg expands to
        sum+count twins, and merging a shard's sum partial without
        its count twin would make every merged value WRONG
        (inflated), not merely incomplete."""
        remaining = list(indexed_subs)
        data = first_400
        for _round in range(len(indexed_subs) + 1):
            metric = self._unknown_metric_from_400(data)
            hit = [(k, sj) for k, sj in remaining
                   if (sj.get("metric") or "") == metric] \
                if metric else []
            if not hit:
                # unattributable 400 (not the engine's no-such-name
                # shape, or naming a metric we didn't send): the
                # conservative one-request-per-sub sweep still
                # resolves every sub individually
                return self._per_sub_retry_singles(
                    peer, req_obj, remaining, sub_400, sub_answered,
                    sub_unknown, memoize=memoize, tctx=tctx,
                    parent_id=parent_id)
            for k, sj in hit:
                sub_400.setdefault(k, []).append(data)
                sub_unknown[k].add(peer.name)
                sub_answered[k].add(peer.name)
                if memoize:
                    self._memo_unknown(peer.name, metric or "", data)
            remaining = [(k, sj) for k, sj in remaining
                         if (sj.get("metric") or "") != metric]
            if not remaining:
                return [], False
            body = json.dumps(dict(
                req_obj,
                queries=[sj for _k, sj in remaining])).encode()
            self.sub_retry_rounds += 1
            try:
                status, data = self._query_peer_traced(
                    tctx, parent_id, peer, body)
            except OSError:
                return [], True
            if status == 200:
                try:
                    part = data if isinstance(data, list) \
                        else json.loads(data)
                except ValueError:
                    return [], True
                for r in part:
                    q = r.get("query")
                    if isinstance(q, dict) and \
                            isinstance(q.get("index"), int) \
                            and 0 <= q["index"] < len(remaining):
                        q["index"] = remaining[q["index"]][0]
                for k, sj in remaining:
                    sub_answered[k].add(peer.name)
                if memoize:
                    self._memo_known(
                        peer.name,
                        {sj.get("metric") for _k, sj in remaining})
                return part, False
            if status != 400:
                # same rule as the combined scatter: a non-400
                # rejection is peer damage, not an empty partial
                return [], True
        return [], True  # cannot converge: treat as peer damage

    def _per_sub_retry_singles(self, peer: Peer, req_obj: dict,
                               indexed_subs: list[tuple[int, dict]],
                               sub_400: dict[int, list[bytes]],
                               sub_answered: dict[int, set],
                               sub_unknown: dict[int, set],
                               memoize: bool = True, tctx=None,
                               parent_id=None
                               ) -> tuple[list[dict], bool]:
        """One request per expanded sub: the fallback when a 400 body
        cannot name the rejected metric (see ``_per_sub_retry``).

        Submission runs in WAVES of at most
        ``tsd.cluster.sub_retry.max_concurrent`` against this one
        peer: the sweep's amplification is per-sub, and uncapped it
        could monopolize the shared fan-out pool (and the peer) on a
        wide dashboard query. A wave that observes peer death stops
        submitting further waves — the peer contributes nothing
        anyway (see ``_per_sub_retry`` on avg twins)."""
        self.sub_retry_singles += len(indexed_subs)
        cap = self.sub_retry_max_concurrent
        if len(indexed_subs) > cap:
            self.sub_retry_capped += 1
        rows: list[dict] = []
        died = False
        for w0 in range(0, len(indexed_subs), cap):
            if died:
                break  # don't hammer a dead peer with more waves
            futs = [(k, sj, self.pool.submit(
                        self._query_peer_traced, tctx, parent_id,
                        peer,
                        json.dumps(dict(req_obj,
                                        queries=[sj])).encode()))
                    for k, sj in indexed_subs[w0:w0 + cap]]
            for k, sj, fut in futs:
                try:
                    status, data = fut.result(
                        timeout=self.timeout_s * 2 + 5)
                except (OSError, concurrent.futures.TimeoutError):
                    died = True
                    continue  # keep draining the in-flight futures
                if died:
                    continue
                if status == 400:
                    sub_400.setdefault(k, []).append(data)
                    sub_unknown[k].add(peer.name)
                    sub_answered[k].add(peer.name)
                    if memoize:
                        self._memo_unknown(peer.name,
                                           sj.get("metric") or "",
                                           data)
                    continue
                if status != 200:
                    # same rule as the combined scatter: a non-400
                    # rejection is peer damage, not an empty partial
                    died = True
                    continue
                try:
                    part = data if isinstance(data, list) \
                        else json.loads(data)
                except ValueError:
                    died = True
                    continue
                sub_answered[k].add(peer.name)
                if memoize:
                    self._memo_known(peer.name, {sj.get("metric")})
                for r in part:
                    q = r.get("query")
                    if isinstance(q, dict):
                        # single-sub answers say index 0
                        q["index"] = k
                rows.extend(part)
        return ([], True) if died else (rows, False)

    @staticmethod
    def _sub_results(peer_results: list[dict], sub_idx: int
                     ) -> list[dict]:
        """One peer's partials for one expanded sub: the scatter sets
        ``showQuery`` so every result row names its sub index."""
        return [r for r in peer_results
                if (r.get("query") or {}).get("index") == sub_idx]

    def _query_peer(self, peer: Peer, body: bytes,
                    headers: dict[str, str] | None = None
                    ) -> tuple[int, Any]:
        if not peer.breaker.allow():
            raise PeerUnavailable(
                f"breaker for {peer.name} is "
                f"{peer.breaker.state}")
        if self.wire.usable(peer):
            # streamed columnar leg: partial grids decode as frames
            # arrive. Returns decoded ROWS on 200 (callers treat a
            # list as already-parsed) and body bytes on non-200, so
            # the 400-body checks work identically on either
            # transport. WireUnsupported falls through to HTTP.
            try:
                self._check_faults(peer)
                status, data = self.wire.query(peer, body,
                                               headers=headers)
            except (wire_mod.WireUnsupported,
                    wire_mod.WireBacklogged):
                pass
            except OSError:
                peer.breaker.record_failure()
                raise
            else:
                peer.breaker.record_success()
                return status, data
        try:
            # fault site inside the recorded section: an injected
            # cluster.peer fault must trip the breaker exactly like a
            # real peer failure, or the chaos battery could not drive
            # the breaker deterministically
            self._check_faults(peer)
            status, data = self._fetch(peer, "POST",
                                       "/api/query?arrays=true", body,
                                       headers=headers)
        except OSError:
            peer.breaker.record_failure()
            raise
        peer.breaker.record_success()
        return status, data

    def _query_peer_traced(self, tctx, parent_id, peer: Peer,
                           body: bytes) -> tuple[int, Any]:
        """One scatter leg under its ``cluster.peer`` span (runs on a
        pool thread): the span id rides the ``X-TSD-Trace`` header so
        the shard roots its subtree under THIS leg, and a failed leg
        — dead, hung, tripped — is the error-tagged span the stitched
        tree shows for a degraded shard."""
        if tctx is None:
            return self._query_peer(peer, body)
        sp = trace_begin("cluster.peer", ctx=tctx, parent=parent_id,
                         peer=peer.name)
        headers = {TRACE_HEADER: tctx.tracer.header_for(tctx, sp)} \
            if sp is not None else None
        try:
            status, data = self._query_peer(peer, body,
                                            headers=headers)
        except BaseException as exc:
            trace_end(sp, error=exc)
            raise
        if sp is not None:
            sp.tag(status=status)
        trace_end(sp)
        return status, data

    def _apply_pixels(self, tsq, results: list) -> list:
        """Pixel budgets apply AFTER the merge (a per-shard reduction
        would select subset points before partials combine — wrong
        values, wrong extremes). Same kernels, same semantics as the
        engine's result assembly."""
        from opentsdb_tpu_torch.ops import visual_downsample as vd
        from opentsdb_tpu_torch.query.model import effective_pixels
        if tsq.delete:
            return results
        by_sub: dict[int, tuple[int, str]] = {}
        for sub in tsq.queries:
            by_sub[sub.index] = effective_pixels(tsq, sub)
        for r in results:
            px, fn = by_sub.get(r.sub_query_index, (0, ""))
            ts_arr, vals = r.dps_arrays
            if not px or not len(ts_arr):
                continue
            # merged rows carry only EMITTED points (NaN = an emitted
            # fill gap), so the emit mask is all-True — matching the
            # engine, where NaN fill points are emitted too
            emit = np.ones((1, len(ts_arr)), dtype=bool)
            keep = vd.keep_mask(vals[None, :], emit, ts_arr,
                                tsq.start_ms, tsq.end_ms, px, fn)
            if keep is not None:
                r.dps_arrays = (ts_arr[keep[0]], vals[keep[0]])
        return results

    # ------------------------------------------------------------------
    # result cache integration
    # ------------------------------------------------------------------

    def _bump_versions(self, metrics, announce: bool = True) -> None:
        names = set(metrics)
        with self._version_lock:
            for m in names:
                self._metric_versions[m] = \
                    self._metric_versions.get(m, 0) + 1
            if len(self._metric_versions) > self.metric_versions_max:
                # fold the per-metric knowledge into the global
                # component: strictly conservative (any entry cached
                # under the old tuple mismatches the new one), and
                # the map restarts bounded
                self._metric_versions.clear()
                self._global_version += 1
        # to the bus only after the version lock is released (the bus
        # has its own lock; never hold both). announce=False is the
        # receive side applying a sibling's delta: logging it again
        # would bounce the same invalidation between routers forever
        if announce and names and self.gossip is not None:
            self.gossip.record_writes(names)

    def _bump_global_version(self, announce: bool = True) -> None:
        with self._version_lock:
            self._global_version += 1
        if announce and self.gossip is not None:
            self.gossip.record_global()

    def write_version(self, tsq=None) -> tuple:
        """Invalidation version of the router's view of the cluster
        as ``tsq`` reads it: per-METRIC write/delete counters (so
        steady ingest of unrelated metrics leaves dashboard entries
        hitting — the cluster twin of the engine's per-sub store
        versions) plus a global component bumped by spool replays
        (replayed history lands on shards long after its ack; any
        entry could be affected). Without ``tsq`` (or for tsuid subs
        that name no metric) the conservative whole-cluster version.
        Writes landing on shards directly (bypassing the router) are
        invisible — relative-window entries stay bounded by the same
        TTL rule as single-node serving. Writes a sibling router
        forwarded arrive as gossip deltas that bump these counters.

        Every version is EPOCH-QUALIFIED (the persisted ring-change
        epoch of ``reshard.json`` leads the tuple): a ring install
        mismatches every cached entry at once."""
        epoch = self.state.epoch
        with self._version_lock:
            whole = (epoch, self._global_version,
                     sum(self._metric_versions.values()))
            if tsq is None:
                return whole
            metrics = set()
            for sub in tsq.queries:
                if not sub.metric:
                    return whole
                metrics.add(sub.metric)
            return (epoch, self._global_version) + tuple(
                self._metric_versions.get(m, 0)
                for m in sorted(metrics))

    def cache_plan(self, tsq) -> tuple[tuple, float] | None:
        from opentsdb_tpu_torch.query import result_cache as rc_mod
        if tsq.delete:
            return None
        keys = []
        ttl_ms = 0.0
        for sub in tsq.queries:
            plan = rc_mod.cache_plan(tsq, sub, self.config)
            if plan is None:
                return None
            key, ttl = plan
            keys.append(key)
            if ttl:
                ttl_ms = ttl if ttl_ms == 0 else min(ttl_ms, ttl)
        return ("cluster", tuple(keys)), ttl_ms

    def run_cached(self, tsq) -> tuple[list, list[str]]:
        """Execute through the serve-path result cache. A degraded
        partial is NEVER retained (the marker must never outlive the
        outage it reports); a later complete answer repopulates."""
        cache = self.tsdb.result_cache
        if self.gossip is not None and self.gossip.degraded():
            # a partitioned sibling router may be forwarding writes
            # whose invalidations this router cannot see: any hit could
            # be stale and any store could cache around an unseen
            # write. Bypass the cache (exact answers, the shards'
            # kernels run on every call) until a push lands again.
            self.gossip.cache_bypasses += 1
            if cache is not None:
                cache.count_bypass()
            return self.execute_query(tsq)
        plan = self.cache_plan(tsq) if cache is not None else None
        if plan is None:
            if cache is not None:
                cache.count_bypass()
            return self.execute_query(tsq)
        key, ttl_ms = plan
        version = self.write_version(tsq)
        hit = cache.lookup(key, version, ttl_ms)
        if hit is not None:
            self.cache_hits += 1
            return hit, []
        results, degraded = self.execute_query(tsq)
        if degraded:
            self.cache_degraded_skips += 1
        else:
            cache.store(key, version, results)
            self.cache_stores += 1
        return results, degraded

    # ------------------------------------------------------------------
    # online resharding (ring-change epochs)
    # ------------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.state.epoch

    @property
    def resharding(self) -> bool:
        return self.old_ring is not None

    def begin_reshard(self, new_spec: str, vnodes: int = 0) -> dict:
        """Install a new ring at a fenced epoch and open the cutover
        window (``POST /api/cluster/reshard``): joining shards get
        peers + spools, the epoch/rings persist for kill-during-
        reshard recovery, every write starts dual-delivering to
        old∪new owners, reads stay on the old ring, and the backfill
        starts streaming moved keyspace. Raises ``BadRequestError``
        on a bad spec or while a cutover is already open."""
        specs = parse_peer_spec(new_spec)
        if not specs:
            raise BadRequestError(
                "reshard needs a non-empty peers spec")
        with self._reshard_lock:
            if self.old_ring is not None:
                raise BadRequestError(
                    "a reshard is already in progress (epoch "
                    f"{self.state.epoch}); wait for it to finalize")
            for name, host, port in specs:
                cur = self.peers.get(name)
                if cur is not None and (cur.client.host != host or
                                        cur.client.port != port):
                    raise BadRequestError(
                        f"shard {name!r} changes address in the new "
                        f"ring ({cur.client.address} -> {host}:"
                        f"{port}); rename it instead")
            old_spec = ",".join(
                f"{n}={self.peers[n].client.host}:"
                f"{self.peers[n].client.port}"
                for n in self.ring.names)
            new_vnodes = int(vnodes) or self.ring.vnodes
            for name, host, port in specs:
                if name not in self.peers:
                    self.peers[name] = Peer(name, host, port,
                                            self.config,
                                            self._spool_dir)
            # order matters for racing writers (no lock on the write
            # path): old_ring fills first, so the worst interleaving
            # writes to the OLD owners only — which the backfill scan
            # (running strictly later) still moves
            prev = self.ring
            self.old_ring = prev
            self.ring = HashRing([n for n, _, _ in specs],
                                 vnodes=new_vnodes)
            epoch = self.state.begin(new_spec, new_vnodes, old_spec,
                                     prev.vnodes)
            self.backfiller.reset()
            # the epoch leads every cache version: installing it
            # atomically mismatches every cached entry
            self._bump_global_version()
        LOG.info("reshard installed at epoch %d: %s -> %s", epoch,
                 old_spec, new_spec)
        if self._started:
            self._start_backfill()
        return self.reshard_info()

    def backfill_step(self) -> dict[str, Any]:
        """Copy one backfill unit and finalize when the copy is
        complete (the background loop drives this; tests/ops may call
        it directly for deterministic cutovers)."""
        if self.old_ring is None:
            return {"phase": "idle"}
        info = self.backfiller.step()
        if info.get("phase") == "done":
            self.finalize_reshard()
        return info

    def finalize_reshard(self) -> None:
        """Close the cutover window: the new ring is the only ring.
        Shards that left are dropped — dual-write already placed
        everything they were owed on the new owners, so their
        remaining spool backlog (if any) is void."""
        with self._reshard_lock:
            old_ring = self.old_ring
            if old_ring is None:
                return
            self.old_ring = None
            removed = [n for n in old_ring.names
                       if n not in self.ring.names]
            self.state.finish()
            for n in removed:
                peer = self.peers.pop(n, None)
                if peer is not None:
                    pending = peer.spool.pending_records
                    if pending:
                        LOG.warning(
                            "dropping departed shard %s with %d "
                            "spooled record(s): dual-write already "
                            "delivered them to the new owners", n,
                            pending)
                    peer.spool.close()
                self.dirty.drop_peer(n)
                self.read_repair.drop_peer(n)
                self.invalidate_sub_memo(n)
            self._bump_global_version()
            # the ownership map just changed: re-arm the stale-copy
            # retire pass for this epoch (former owners still in the
            # ring hold moved series replicaSel now hides)
            self.retirer.reset()
        LOG.info("reshard finalized at epoch %d; ring: %s",
                 self.state.epoch, ",".join(self.ring.names))
        if self._started and self.retire_enabled:
            self._start_retire()

    def adopt_topology(self, doc: dict) -> bool:
        """Adopt a sibling router's gossiped ring topology. Three
        shapes: the remote epoch is BEHIND (or equal with the same
        phase) — no-op; the remote FINALIZED the epoch this router
        still holds open — finalize here; the remote epoch is AHEAD —
        install its ring, and when its cutover window is still open,
        adopt the dual-write window and run a local idempotent
        backfill. The last shape lets a sibling resume a reshard whose
        initiating router died mid-window: duplicated copy units dedupe
        last-write-wins on the shards. Version bumps here are not
        announced (the initiator announced the epoch change to every
        sibling). Returns True when anything changed."""
        try:
            epoch = int(doc.get("epoch", 0))
            spec = str(doc.get("peers", "") or "")
            vnodes = int(doc.get("vnodes", 0) or 0)
            active = bool(doc.get("active"))
            old_spec = str(doc.get("old_peers", "") or "")
            old_vnodes = int(doc.get("old_vnodes", 0) or 0)
            fence_ms = int(doc.get("fence_ms", 0) or 0)
        except (TypeError, ValueError):
            return False
        if epoch < self.state.epoch or not spec:
            return False
        if epoch == self.state.epoch:
            if active or not self.state.active:
                return False  # same epoch, same phase: in agreement
            # the sibling finalized the window this router still holds
            # open (its backfill finished first): finalize here,
            # idempotent under _reshard_lock
            self.finalize_reshard()
            return True
        specs = parse_peer_spec(spec)
        if not specs:
            return False
        resumed = False
        with self._reshard_lock:
            if epoch <= self.state.epoch:
                return False  # raced with another adoption
            vn = int(vnodes) or self.ring.vnodes
            for name, host, port in specs:
                cur = self.peers.get(name)
                if cur is not None and (cur.client.host != host or
                                        cur.client.port != port):
                    LOG.warning(
                        "gossiped topology renames shard %s (%s -> "
                        "%s:%d); refusing adoption", name,
                        cur.client.address, host, port)
                    return False
                if cur is None:
                    self.peers[name] = Peer(name, host, port,
                                            self.config,
                                            self._spool_dir)
            if active and old_spec:
                old_specs = parse_peer_spec(old_spec)
                for name, host, port in old_specs:
                    if name not in self.peers:
                        self.peers[name] = Peer(name, host, port,
                                                self.config,
                                                self._spool_dir)
                if not self.state.adopt(epoch, spec, vn, old_spec,
                                        old_vnodes or vn, fence_ms):
                    return False
                # begin_reshard's order: old_ring fills first, so a
                # racing writer's worst case is the old owners only,
                # which the backfill still moves
                self.old_ring = HashRing(
                    [n for n, _, _ in old_specs],
                    vnodes=old_vnodes or vn)
                self.ring = HashRing([n for n, _, _ in specs],
                                     vnodes=vn)
                self.backfiller.reset()
                resumed = True
            else:
                if not self.state.adopt_final(epoch, spec, vn):
                    return False
                self.old_ring = None
                self.ring = HashRing([n for n, _, _ in specs],
                                     vnodes=vn)
                for n in [n for n in self.peers
                          if n not in self.ring.names]:
                    peer = self.peers.pop(n, None)
                    if peer is not None:
                        peer.spool.close()
                    self.dirty.drop_peer(n)
                    self.read_repair.drop_peer(n)
                    self.invalidate_sub_memo(n)
                self.retirer.reset()
            self._bump_global_version(announce=False)
        LOG.info("adopted gossiped topology at epoch %d (cutover %s); "
                 "ring: %s", epoch, "open" if resumed else "final",
                 ",".join(self.ring.names))
        if self._started:
            if resumed:
                self._start_backfill()
            elif self.retire_enabled and self.retirer.pending():
                self._start_retire()
        return True

    def _backfill_loop(self) -> None:
        tracer = getattr(self.tsdb, "tracer", None)
        while not self._stop.wait(self.reshard_interval_s):
            if self.old_ring is None:
                return
            tctx = tracer.start_background(
                "cluster.reshard.backfill") \
                if tracer is not None and tracer.enabled else None
            info: dict[str, Any] = {}
            try:
                with trace_mod.use(tctx):
                    info = self.backfill_step()
                if tctx is not None:
                    tctx.tag(phase=str(info.get("phase", "")),
                             metric=str(info.get("metric", "")))
                    if info.get("phase") == "blocked":
                        # an idle/blocked poll is not worth a
                        # retained trace
                        tctx.sampled = False
            except Exception:  # noqa: BLE001 - keep the loop alive
                LOG.exception("backfill step failed")
            finally:
                if tracer is not None and tctx is not None:
                    tracer.finish(tctx)
            if info.get("phase") in ("done", "idle"):
                return

    def _retire_loop(self) -> None:
        tracer = getattr(self.tsdb, "tracer", None)
        while not self._stop.wait(self.retire_interval_s):
            if self.old_ring is not None:
                return  # a NEW cutover opened: finalize re-arms us
            tctx = tracer.start_background("cluster.retire") \
                if tracer is not None and tracer.enabled else None
            info: dict[str, Any] = {}
            try:
                with trace_mod.use(tctx):
                    info = self.retirer.step()
                if tctx is not None:
                    tctx.tag(phase=str(info.get("phase", "")),
                             metric=str(info.get("metric", "")))
                    if info.get("phase") in ("blocked", "idle"):
                        # an idle/blocked poll is not worth a
                        # retained trace
                        tctx.sampled = False
            except Exception:  # noqa: BLE001 - keep the loop alive
                LOG.exception("retire step failed")
            finally:
                if tracer is not None and tctx is not None:
                    tracer.finish(tctx)
            if info.get("phase") in ("done", "idle", "disabled"):
                return

    def retire_step(self) -> dict[str, Any]:
        """One deterministic stale-copy retire unit (tests/ops; the
        background loop drives the same step)."""
        return self.retirer.step()

    def reshard_info(self) -> dict[str, Any]:
        out = self.state.describe()
        out["rf"] = self.rf
        out["ring"] = {"peers": list(self.ring.names),
                       "vnodes": self.ring.vnodes}
        if self.old_ring is not None:
            out["old_ring"] = {"peers": list(self.old_ring.names),
                               "vnodes": self.old_ring.vnodes}
            out["backfill"] = self.backfiller.health_info()
        out["retire"] = self.retirer.health_info()
        return out

    # ------------------------------------------------------------------
    # suggest/search scatter (the router owns no names of its own)
    # ------------------------------------------------------------------

    def _name_scatter_degraded(self, ring: HashRing,
                               failed: set[str]) -> list[str]:
        """A failed peer degrades a name scatter only when NO member
        of some replica set survived: every name hangs off >= 1
        series, and every series has a live replica otherwise."""
        if not failed:
            return []
        rf = min(self.rf, len(ring.names))
        if rf <= 1:
            return sorted(failed)
        degraded: set[str] = set()
        for t in ring.replica_sets(rf):
            if all(n in failed for n in t):
                degraded.update(t)
        return sorted(degraded)

    def scatter_suggest(self, stype: str, q: str, max_results: int
                        ) -> tuple[list[str], list[str]]:
        """Union one suggest over every read-ring shard (names live
        wherever their series landed, so the union IS the cluster's
        answer).
        Returns (sorted names capped at ``max_results``, degraded
        shard names, per the replica-coverage rule)."""
        self.scatter_name_queries += 1
        import urllib.parse
        ring, names = self._read_view()
        path = ("/api/suggest?type=" + urllib.parse.quote(stype)
                + "&q=" + urllib.parse.quote(q or "")
                + "&max=" + str(int(max_results)))
        futs = {name: self.pool.submit(
                    self.fetch_guarded, peer, "GET", path)
                for name in names
                if (peer := self.peers.get(name)) is not None}
        out: set[str] = set()
        failed: set[str] = {n for n in names if n not in futs}
        for name, fut in futs.items():
            try:
                status, data = fut.result(
                    timeout=self.timeout_s * 2 + 5)
                if status != 200:
                    raise PeerError(
                        f"suggest answered {status}")
                doc = json.loads(data)
                if not isinstance(doc, list):
                    raise PeerError("suggest body is not a list")
            except (OSError, ValueError,
                    concurrent.futures.TimeoutError):
                peer = self.peers.get(name)
                if peer is not None:
                    peer.query_failures += 1
                failed.add(name)
                continue
            out.update(str(x) for x in doc)
        return (sorted(out)[:max(int(max_results), 0)],
                self._name_scatter_degraded(ring, failed))

    def scatter_lookup(self, metric: str, tags: list[tuple],
                       limit: int, use_meta: bool
                       ) -> tuple[dict[str, Any], list[str]]:
        """Scatter ``/api/search/lookup`` and union the per-shard
        results, deduplicated on (metric, tags): at RF > 1 every
        series answers from each replica, and per-shard TSUIDs are
        not cluster identities. ``totalResults`` counts the deduped
        union (shards cap their own lists at ``limit``, so it is a
        floor, exactly as the reference's scanner-capped counts
        are)."""
        self.scatter_name_queries += 1
        ring, names = self._read_view()
        body = json.dumps({
            "metric": metric or "",
            "tags": [{"key": k, "value": v} for k, v in tags],
            "limit": int(limit), "useMeta": bool(use_meta),
        }).encode()
        futs = {name: self.pool.submit(
                    self.fetch_guarded, peer, "POST",
                    "/api/search/lookup", body)
                for name in names
                if (peer := self.peers.get(name)) is not None}
        rows: dict[tuple, dict] = {}
        failed: set[str] = {n for n in names if n not in futs}
        for name, fut in futs.items():
            try:
                status, data = fut.result(
                    timeout=self.timeout_s * 2 + 5)
                if status != 200:
                    raise PeerError(f"lookup answered {status}")
                doc = json.loads(data)
                results = doc.get("results") \
                    if isinstance(doc, dict) else None
                if not isinstance(results, list):
                    raise PeerError("lookup body has no results")
            except (OSError, ValueError,
                    concurrent.futures.TimeoutError):
                peer = self.peers.get(name)
                if peer is not None:
                    peer.query_failures += 1
                failed.add(name)
                continue
            for r in results:
                if not isinstance(r, dict):
                    continue
                tags_doc = r.get("tags") or {}
                key = (r.get("metric"),
                       tuple(sorted(tags_doc.items())))
                rows.setdefault(key, r)
        merged = [rows[k] for k in sorted(rows)][:max(int(limit), 0)]
        doc = {"type": "LOOKUP", "metric": metric or "*",
               "limit": int(limit), "time": 0, "results": merged,
               "totalResults": len(rows)}
        return doc, self._name_scatter_degraded(ring, failed)

    def scatter_last(self, specs: list[dict], back_scan: int,
                     resolve: bool
                     ) -> tuple[list[dict], list[str]]:
        """Scatter ``/api/query/last`` over every shard and keep the
        NEWEST point per series (metric + tags), the reference's merge
        (which dedupes replicas' and stale copies' answers). Shards are
        always asked to resolve names — the merge key must be the one
        cluster-wide spelling, never the per-shard TSUID bytes — and
        metric/tags are stripped back out when the client didn't ask
        for them. Returns (points, degraded shard names, per the
        replica-coverage rule)."""
        self.scatter_name_queries += 1
        ring, names = self._read_view()
        body = json.dumps({"queries": specs,
                           "backScan": int(back_scan),
                           "resolveNames": True}).encode()
        futs = {name: self.pool.submit(
                    self.fetch_guarded, peer, "POST",
                    "/api/query/last", body)
                for name in names
                if (peer := self.peers.get(name)) is not None}
        best: dict[tuple, dict] = {}
        failed: set[str] = {n for n in names if n not in futs}
        refused: list[bytes] = []
        for name, fut in futs.items():
            try:
                status, data = fut.result(
                    timeout=self.timeout_s * 2 + 5)
                if status == 400:
                    # a shard that owns no series of a spec'd metric
                    # 400s "no such name": an empty partial from a
                    # healthy shard, kept for the all-shards-agree
                    # parity check below
                    refused.append(data)
                    continue
                if status != 200:
                    raise PeerError(f"query/last answered {status}")
                doc = json.loads(data)
                if not isinstance(doc, list):
                    raise PeerError("query/last body is not a list")
            except (OSError, ValueError,
                    concurrent.futures.TimeoutError):
                peer = self.peers.get(name)
                if peer is not None:
                    peer.query_failures += 1
                failed.add(name)
                continue
            for r in doc:
                if not isinstance(r, dict) or not r.get("metric"):
                    continue
                tags_doc = r.get("tags") or {}
                key = (str(r.get("metric")),
                       tuple(sorted(tags_doc.items())))
                cur = best.get(key)
                if cur is None or int(r.get("timestamp", 0)) \
                        > int(cur.get("timestamp", 0)):
                    best[key] = r
        if refused and not best and not failed \
                and len(refused) == len(futs):
            # single-node parity: every shard that answered rejected
            # every spec — surface the real client error
            try:
                msg = json.loads(refused[0])["error"]["message"]
            except Exception:  # noqa: BLE001
                msg = refused[0].decode("utf-8", "replace")[:200]
            raise BadRequestError(msg)
        points = [best[k] for k in sorted(best)]
        if not resolve:
            points = [{k: v for k, v in r.items()
                       if k not in ("metric", "tags")}
                      for r in points]
        return points, self._name_scatter_degraded(ring, failed)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def fetch_peer_trace(self, trace_id: str
                         ) -> tuple[list[dict], list[str]]:
        """Stitch support for ``GET /api/trace/<id>``: ask every
        shard for its subtree of the trace (``?local=true`` so the
        request can never recurse). Returns (flat span docs from all
        reachable shards, names of shards that could not answer) —
        an unreachable shard's scatter leg already carries the error
        span from query time, so the stitched tree stays truthful
        without it."""
        spans: list[dict] = []
        incomplete: list[str] = []
        futs = {}
        for name, peer in self.peers.items():
            if peer.breaker.blocking():
                # known-dead peer: don't burn a scatter-pool thread
                # on a guaranteed socket timeout per poll of this
                # endpoint (the error-tagged leg from query time
                # already tells the tree's story)
                incomplete.append(name)
                continue
            futs[name] = self.pool.submit(
                peer.client.request, "GET",
                f"/api/trace/{trace_id}?local=true")
        for name, fut in futs.items():
            try:
                status, data = fut.result(
                    timeout=self.timeout_s + 2)
            except (OSError, concurrent.futures.TimeoutError):
                incomplete.append(name)
                continue
            if status == 404:
                # the shard never saw (or already evicted) the
                # trace: nothing to stitch, not an outage
                continue
            if status != 200:
                # 400 (shard tracing disabled), 5xx, ...: the shard
                # could not answer — the tree is INCOMPLETE, not
                # "this shard recorded nothing"
                incomplete.append(name)
                continue
            try:
                doc = json.loads(data)
            except ValueError:
                incomplete.append(name)
                continue
            spans.extend(doc.get("spans") or [])
        return spans, sorted(incomplete)

    def fleet_stats(self) -> dict[str, Any]:
        """Fleet-merged stats (``GET /api/stats/fleet``): counters
        summed, gauges per-node + min/max, histograms bucket-summed
        at full resolution so a fleet p99 is exact."""
        from opentsdb_tpu_torch.cluster import fleet
        return fleet.fleet_stats(self)

    def fleet_health(self) -> dict[str, Any]:
        """Per-shard health summary for the router's ``/api/health``
        ``fleet`` section (never raises — an unreachable shard is a
        row, not a failure). TTL-cached
        (``tsd.cluster.fleet_health_ttl_ms``): /api/health is a
        probe surface polled every second or two by load balancers —
        without the cache every poll would fan out a network scatter
        per shard, and one hung-but-not-yet-tripped shard would
        stall the probe long enough for the checker to eject a
        healthy router."""
        from opentsdb_tpu_torch.cluster import fleet
        ttl_s = self.config.get_float(
            "tsd.cluster.fleet_health_ttl_ms", 5000.0) / 1000.0
        now = time.monotonic()
        with self._fleet_health_lock:
            doc, stamp = self._fleet_health_cache
            if doc is not None and now - stamp < ttl_s:
                return doc
        doc = fleet.fleet_health(self)
        with self._fleet_health_lock:
            self._fleet_health_cache = (doc, now)
        return doc

    def cluster_status(self) -> dict[str, Any]:
        """The consolidated operator progress surface behind
        ``GET /api/cluster/status``."""
        from opentsdb_tpu_torch.cluster import fleet
        return fleet.cluster_status(self)

    def health_info(self) -> dict[str, Any]:
        return {
            "role": "router",
            "shards": len(self.peers),
            "vnodes": self.ring.vnodes,
            "rf": self.rf,
            "epoch": self.state.epoch,
            "reshard": self.reshard_info(),
            "replica_dirty": self.dirty.health_info(),
            "read_repair": self.read_repair.health_info(),
            "gossip": self.gossip.health_info()
            if self.gossip is not None else None,
            "read_fallbacks": self.read_fallbacks,
            "repairs": self.repairs,
            "repair_points": self.repair_points,
            "queries": self.queries,
            "degraded_queries": self.degraded_queries,
            "cache_hits": self.cache_hits,
            "cache_stores": self.cache_stores,
            "cache_degraded_skips": self.cache_degraded_skips,
            "sub_memo_entries": len(self._sub_memo),
            "sub_memo_skips": self.sub_memo_skips,
            "sub_memo_invalidations": self.sub_memo_invalidations,
            "sub_memo_evictions": self.sub_memo_evictions,
            "sub_retry": {
                "max_concurrent": self.sub_retry_max_concurrent,
                "rounds": self.sub_retry_rounds,
                "singles": self.sub_retry_singles,
                "capped": self.sub_retry_capped,
            },
            "spool_backlog_records": sum(
                p.spool.pending_records for p in self.peers.values()),
            "peers": {name: peer.health_info()
                      for name, peer in sorted(self.peers.items())},
        }

    def collect_stats(self, collector) -> None:
        collector.record("cluster.queries", self.queries)
        collector.record("cluster.queries_degraded",
                         self.degraded_queries)
        collector.record("cluster.epoch", self.state.epoch)
        collector.record("cluster.rf", self.rf)
        collector.record("cluster.read_fallbacks",
                         self.read_fallbacks)
        collector.record("cluster.replica.repairs", self.repairs)
        collector.record("cluster.replica.repair_points",
                         self.repair_points)
        collector.record("cluster.replica.dirty_entries",
                         self.dirty.total_entries)
        rr = self.read_repair.health_info()
        collector.record("cluster.read_repair.depth", rr["depth"])
        collector.record("cluster.read_repair.enqueued",
                         rr["enqueued"])
        collector.record("cluster.read_repair.shed", rr["shed"])
        collector.record("cluster.read_repair.completed",
                         rr["completed"])
        if self.gossip is not None:
            self.gossip.collect_stats(collector)
        collector.record("cluster.name_scatters",
                         self.scatter_name_queries)
        collector.record("cluster.reshard.backfilled_points",
                         self.backfiller.backfilled_points)
        collector.record("cluster.reshard.backfilled_series",
                         self.backfiller.backfilled_series)
        collector.record("cluster.retire.retired_series",
                         self.retirer.retired_series)
        collector.record("cluster.retire.queries",
                         self.retirer.retire_queries)
        collector.record("cluster.retire.failed_steps",
                         self.retirer.failed_steps)
        collector.record("cluster.cache_degraded_skips",
                         self.cache_degraded_skips)
        collector.record("cluster.sub_memo.skips",
                         self.sub_memo_skips)
        collector.record("cluster.sub_memo.invalidations",
                         self.sub_memo_invalidations)
        collector.record("cluster.sub_memo.evictions",
                         self.sub_memo_evictions)
        collector.record("cluster.sub_retry.rounds",
                         self.sub_retry_rounds)
        collector.record("cluster.sub_retry.singles",
                         self.sub_retry_singles)
        collector.record("cluster.sub_retry.capped",
                         self.sub_retry_capped)
        for name, p in sorted(self.peers.items()):
            collector.record("cluster.forwarded_points",
                             p.forwarded_points, peer=name)
            collector.record("cluster.spooled_points",
                             p.spooled_points, peer=name)
            collector.record("cluster.spool_pending",
                             p.spool.pending_records, peer=name)
            collector.record("cluster.replayed_batches",
                             p.replayed_batches, peer=name)
            collector.record("cluster.query_failures",
                             p.query_failures, peer=name)
            collector.record("cluster.hedges", p.hedges, peer=name)
            collector.record("cluster.wire.bytes_out",
                             p.wire_bytes_out, peer=name)
            collector.record("cluster.wire.bytes_in",
                             p.wire_bytes_in, peer=name)
            collector.record("cluster.wire.frames_out",
                             p.wire_frames_out, peer=name)
            collector.record("cluster.wire.frames_in",
                             p.wire_frames_in, peer=name)
            collector.record("cluster.wire.pipeline_depth",
                             p.wire_pipeline_depth, peer=name)
            collector.record("cluster.wire.fallbacks",
                             p.wire_fallbacks, peer=name)
            collector.record("cluster.wire.backpressure_sheds",
                             p.wire_backpressure_sheds, peer=name)
            p.breaker.collect_stats(collector)
        self.cqs.collect_stats(collector)
