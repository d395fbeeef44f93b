"""Cross-shard federated continuous queries (router mode; ref:
``opentsdb_tpu/cluster/cq.py``).

A single-node CQ folds every write of its metric into one shared
partial (:mod:`opentsdb_tpu_torch.streaming`). Under the router each shard
sees only ITS series, so a standing query must become N standing
queries — one per shard, each folding the shard's local writes into
its own shared partial — with the router holding the merge view:

- **register** scatters the registration (with an explicit id) to
  every ring shard; any shard's 400 rolls the others back and
  surfaces verbatim (the shard registry stays the authority on what
  can stand). RF must be 1 — at RF > 1 every replica folds every
  write, so a cross-shard sum would count each point rf times.
- **pull** (``GET .../result``) fans out, strips each leg's trailing
  completeness marker, and folds the per-shard rows with the SAME
  dict-fold combine machinery the batch scatter uses
  (:mod:`opentsdb_tpu_torch.cluster.merge`) — series never span shards, so
  ``none`` concatenates and decomposable aggregators combine, and an
  integer-valued workload merges bit-identically to the single-node
  oracle. Dead shards degrade into the merged marker
  (``shardsDegraded`` + ``complete: false``), never a 5xx.
- **push** (``GET .../stream``) duck-types the SSE contract
  (:func:`opentsdb_tpu_torch.streaming.sse.sse_stream` pumps THIS registry):
  each pump drains every shard's dirty windows through the
  ``GET .../deltas`` surface and publishes ONE merged ``windows``
  frame. A router-registered CQ has no shard-local subscribers, so
  the per-shard dirty sets accumulate exclusively for this drain.
- **session windows** federate with a shard-affinity contract: one
  session key value's timeline is exact when every series carrying
  that value lands on one shard — true by construction for the
  canonical user-scale shape, where the session tag is the series'
  only tag (one ``user`` = one series = one ring position). A key
  whose member series span shards gets per-shard session timelines
  (each shard gap-closes over its own points); the merge groups rows
  by the session tag so such splits surface as per-shard rows of one
  key, never silently summed across different session boundaries.
- **transport**: ops ride the persistent binary wire as
  ``T_CQ``/``T_CQ_RES`` frames when the peer speaks it, falling back
  to JSON HTTP exactly like the write path (non-OSError reroutes);
  both paths replay through the shard's real HTTP handler, so fault
  sites and chaos hangs cover them identically.
- **restart survival**: every op that 404s ("no continuous query" —
  the shard restarted with an empty registry) re-registers from the
  stored body and retries once, so a router-registered CQ outlives
  any shard restart without operator action.

Fault site: ``cluster.cq`` (+ ``cluster.cq.<peer>``); trace spans:
``cluster.cq`` per exchange, ``cluster.cq.pump`` per merged drain.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import threading
import time
from typing import Any

from opentsdb_tpu_torch.cluster import merge as merge_mod
from opentsdb_tpu_torch.cluster import wire as wire_mod
from opentsdb_tpu_torch.obs.trace import trace_begin, trace_end
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.streaming import sse
from opentsdb_tpu_torch.streaming.eventtime import WatermarkPolicy
from opentsdb_tpu_torch.utils.faults import DegradedError

LOG = logging.getLogger("cluster.cq")

_CQ_BASE = "/api/query/continuous"


class FedCQ:
    """Router-side handle of one federated continuous query."""

    def __init__(self, cid: str, raw: dict, tsq: TSQuery,
                 policy: WatermarkPolicy | None,
                 sub_plans: list[tuple]):
        self.id = cid
        self.raw = raw            # registration body incl. explicit id
        self.tsq = tsq
        self.policy = policy
        #: per sub index: (plan, combine-or-None, group-by tag keys)
        self.sub_plans = sub_plans
        self.closed = False
        self.created = time.time()
        self.tenant: str | None = None
        self.lock = threading.Lock()
        self.subscribers: list[sse.Subscription] = []
        self.emit_seq = 0
        #: shards holding a live shard-local registration
        # keyed by ring shard name
        self.shards: set[str] = set()
        #: per-shard resident ring bytes, from register/pull describes
        # keyed by ring shard name
        self.shard_fold_bytes: dict[str, int] = {}

    def fold_bytes(self) -> int:
        return sum(self.shard_fold_bytes.values())

    def describe(self, verbose: bool = False) -> dict[str, Any]:
        out: dict[str, Any] = {
            "id": self.id,
            "query": self.tsq.to_json(),
            "federated": True,
            "shards": sorted(self.shards),
            "subscribers": len(self.subscribers),
            "emitSeq": self.emit_seq,
            "foldBytes": self.fold_bytes(),
        }
        if self.raw.get("window"):
            out["windowSpec"] = self.raw["window"]
        if self.policy is not None:
            out["watermark"] = self.policy.to_json()
        return out


class FederatedCQRegistry:
    """(see module docstring) Duck-types the surface
    :func:`~opentsdb_tpu_torch.streaming.sse.sse_stream` and the HTTP
    handler consume: ``register/get/list/delete``, ``subscribe/pump/
    unsubscribe``, ``current_results``, ``heartbeat_s``."""

    def __init__(self, router):
        self.router = router
        self.tsdb = router.tsdb
        cfg = self.tsdb.config
        self.heartbeat_s = cfg.get_float("tsd.streaming.heartbeat_s",
                                         5.0)
        self.queue_events = cfg.get_int("tsd.streaming.queue_events",
                                        256)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._queries: dict[str, FedCQ] = {}
        # counters (collect_stats + tests)
        self.registrations = 0
        self.deletes = 0
        self.pumps = 0
        self.merged_pulls = 0
        self.wire_ops = 0
        self.http_fallbacks = 0
        self.reregisters = 0
        self.sse_events = 0
        self.sse_shed = 0

    # -- shard transport -----------------------------------------------

    def _check_faults(self, peer) -> None:
        faults = getattr(self.tsdb, "faults", None)
        if faults is not None:
            faults.check("cluster.cq")
            faults.check(f"cluster.cq.{peer.name}")

    def _exchange(self, peer, method: str, path: str,
                  body: bytes = b"") -> tuple[int, bytes]:
        """One raw shard exchange: wire first (persistent framed
        transport), JSON HTTP on wire refusal; ``OSError`` means the
        shard is down (degrade territory)."""
        sp = trace_begin("cluster.cq", peer=peer.name, op=method)
        try:
            self._check_faults(peer)
            wire = self.router.wire
            sent = None
            if wire is not None and wire.usable(peer):
                try:
                    sent = wire.cq(peer, method, path, body)
                    self.wire_ops += 1
                except (wire_mod.WireUnsupported,
                        wire_mod.WireBacklogged,
                        wire_mod.WireEncodeError):
                    self.http_fallbacks += 1
            if sent is None:
                sent = peer.client.request(method, path,
                                           body or None)
        except BaseException as exc:
            trace_end(sp, error=exc)
            raise
        trace_end(sp)
        return sent

    def _cq_op(self, fcq: FedCQ, peer, method: str, path: str,
               body: bytes = b"") -> tuple[int, bytes]:
        """One shard op with restart survival: a 404 means the shard
        lost its registry (restart) — re-register from the stored
        body and retry the op once."""
        status, data = self._exchange(peer, method, path, body)
        if status == 404 and not fcq.closed:
            reg_status, reg_body = self._exchange(
                peer, "POST", _CQ_BASE,
                json.dumps(fcq.raw).encode())
            if reg_status == 200:
                self.reregisters += 1
                self._note_register(fcq, peer.name, reg_body)
                status, data = self._exchange(peer, method, path,
                                              body)
        return status, data

    def _note_register(self, fcq: FedCQ, name: str,
                       body: bytes) -> None:
        with fcq.lock:
            fcq.shards.add(name)
            try:
                fcq.shard_fold_bytes[name] = int(
                    json.loads(body).get("foldBytes", 0))
            except Exception:  # noqa: BLE001
                # fold-byte accounting is advisory (QoS scoring): a
                # torn describe body must not fail the registration
                # that carried it
                pass

    def _fan_out(self, op) -> list[tuple[str, Any]]:
        """Run ``op(peer)`` on every ring shard concurrently (the
        router's scatter pool); returns ``[(name, result-or-exc)]``
        in ring order."""
        peers = [self.router.peers[n] for n in self.router.ring.names]
        futs = [(p.name, self.router.pool.submit(op, p))
                for p in peers]
        out: list[tuple[str, Any]] = []
        for name, fut in futs:
            try:
                out.append((name, fut.result(
                    timeout=self.router.timeout_s * 2 + 1)))
            except Exception as exc:  # noqa: BLE001 - per-leg degrade
                out.append((name, exc))
        return out

    # -- registration lifecycle ----------------------------------------

    def register(self, obj: dict) -> FedCQ:
        if not isinstance(obj, dict):
            raise BadRequestError("continuous query body must be an "
                                  "object")
        if self.router.resharding:
            raise BadRequestError(
                "cannot register a continuous query while a reshard "
                "is in progress; retry after cutover")
        if self.router.rf > 1:
            raise BadRequestError(
                "federated continuous queries need tsd.cluster.rf=1: "
                "every replica folds every write, so a cross-shard "
                "merge would count each point rf times")
        cid = str(obj.get("id") or "")
        with self._lock:
            if not cid:
                cid = f"cq-{next(self._ids)}"
                while cid in self._queries:
                    cid = f"cq-{next(self._ids)}"
            elif cid in self._queries:
                raise BadRequestError(
                    f"continuous query id {cid!r} already registered")
        tsq = TSQuery.from_json(
            {k: v for k, v in obj.items()
             if k not in ("id", "window", "watermark")})
        tsq.validate()
        policy = WatermarkPolicy.from_json(obj.get("watermark"))
        win = obj.get("window")
        session_by = win.get("by") if isinstance(win, dict) else None
        sub_plans: list[tuple] = []
        for sub in tsq.queries:
            plan = merge_mod.decompose_plan(sub)
            if plan not in ("direct", "concat"):
                raise BadRequestError(
                    f"aggregator {sub.aggregator!r} does not merge "
                    "across shard partials incrementally (federated "
                    "CQs support none, sum, count, min, max, zimsum, "
                    "mimmin, mimmax)")
            combine = merge_mod._COMBINE.get(
                (sub.aggregator or "").lower())
            gbk = merge_mod.gb_tag_keys(sub)
            if session_by:
                # session rows are keyed by the session tag's value:
                # the merge must group per key value, never fold two
                # users' timelines into one (module docstring)
                gbk = sorted(set(gbk) | {str(session_by)})
            sub_plans.append((plan, combine, gbk))
        raw = dict(obj, id=cid)
        fcq = FedCQ(cid, raw, tsq, policy, sub_plans)
        body = json.dumps(raw).encode()
        legs = self._fan_out(
            lambda p: self._exchange(p, "POST", _CQ_BASE, body))
        refusal: tuple[str, bytes] | None = None
        for name, res in legs:
            if isinstance(res, Exception):
                # down shard: tolerated — the 404 path re-registers
                # on first contact after it returns
                continue
            status, data = res
            if status == 200:
                self._note_register(fcq, name, data)
            elif refusal is None:
                refusal = (name, data)
        if refusal is not None or not fcq.shards:
            # roll back the shards that accepted: a half-registered
            # standing query would silently fold a subset of writes
            for name in list(fcq.shards):
                try:
                    self._exchange(self.router.peers[name], "DELETE",
                                   f"{_CQ_BASE}/{cid}")
                except Exception:  # noqa: BLE001
                    # best-effort rollback of a refused registration:
                    # an unreachable shard 404s the leftover on first
                    # contact anyway
                    pass
            if refusal is not None:
                name, data = refusal
                try:
                    msg = json.loads(data)["error"]["message"]
                except Exception:  # noqa: BLE001 - opaque shard body
                    msg = data.decode("utf-8", "replace")
                raise BadRequestError(f"shard {name}: {msg}")
            raise DegradedError(
                f"continuous query {cid!r}: no shard reachable to "
                "hold the registration; retry shortly")
        with self._lock:
            self._queries[cid] = fcq
        self.registrations += 1
        return fcq

    def get(self, cid: str) -> FedCQ | None:
        with self._lock:
            return self._queries.get(cid)

    def list(self) -> list[FedCQ]:
        with self._lock:
            return list(self._queries.values())

    def delete(self, cid: str) -> bool:
        with self._lock:
            fcq = self._queries.pop(cid, None)
        if fcq is None:
            return False
        fcq.closed = True
        self._fan_out(
            lambda p: self._exchange(p, "DELETE",
                                     f"{_CQ_BASE}/{cid}"))
        self.deletes += 1
        return True

    def close(self) -> None:
        """Router shutdown: drop local state only (shard-side
        registrations belong to explicit DELETEs; a restarting router
        must not tear down standing queries it will re-learn)."""
        with self._lock:
            queries = list(self._queries.values())
            self._queries.clear()
        for fcq in queries:
            fcq.closed = True

    # -- fold-budget surface (QoS duck-typing) -------------------------

    def tenant_fold_bytes(self, tenant: str) -> int:
        return sum(fcq.fold_bytes() for fcq in self.list()
                   if fcq.tenant == tenant)

    def projected_fold_bytes(self, obj: dict) -> int:
        reg = self.tsdb.streaming
        if reg is None:
            return 0
        return reg.projected_fold_bytes(obj)

    # -- merged pull ---------------------------------------------------

    @staticmethod
    def _split_marker(rows: list) -> tuple[list, dict | None]:
        """Strip one shard leg's trailing completeness marker row."""
        if rows and isinstance(rows[-1], dict) \
                and "completeness" in rows[-1] \
                and "metric" not in rows[-1]:
            return rows[:-1], rows[-1]["completeness"]
        return rows, None

    def _merge_rows(self, fcq: FedCQ,
                    legs: list[list[dict]]) -> list[dict]:
        """Fold per-shard row dicts into merged rows with the batch
        scatter's dict-fold machinery — the same pairwise combines in
        the same leg order, which is what makes an integer workload
        bit-identical to the single-node oracle. Output rows sort by
        (sub index, metric, tags) for a deterministic surface."""
        merged: dict[tuple, merge_mod.MergedGroup] = {}
        idx_of: dict[int, int] = {}
        concat: list[tuple[int, merge_mod.MergedGroup]] = []
        for rows in legs:
            for r in rows:
                idx = int(r.get("index") or 0)
                plan, combine, gbk = fcq.sub_plans[
                    min(idx, len(fcq.sub_plans) - 1)]
                dps = [(int(ts), (math.nan if v is None else v))
                       for ts, v in (r.get("dps") or {}).items()]
                dps.sort()
                if plan == "concat":
                    g = merge_mod.MergedGroup(r)
                    g.fold_dps(dps, merge_mod._COMBINE["sum"])
                    concat.append((idx, g))
                    continue
                key = (idx,) + merge_mod.group_key(r, gbk)
                g = merged.get(key)
                if g is None:
                    g = merged[key] = merge_mod.MergedGroup(r)
                    idx_of[id(g)] = idx
                else:
                    g.fold_tags(r)
                g.fold_dps(dps, combine)
        out = []
        for key, g in merged.items():
            out.append((key[0], g))
        out.extend(concat)
        rows_out = []
        for idx, g in out:
            rows_out.append({
                "metric": g.metric, "tags": g.tags,
                "aggregateTags": sorted(g.agg_tags), "index": idx,
                "dps": {str(ts): (None if v != v else v)
                        for ts, v in sorted(g.dps.items())}})
        rows_out.sort(key=lambda r: (r["index"], r["metric"],
                                     sorted(r["tags"].items())))
        return rows_out

    @staticmethod
    def _merge_markers(markers: list[dict],
                       degraded: list[str]) -> dict:
        """Join per-shard completeness markers: the merged range is
        only as final as the LEAST-advanced shard, counters sum, and
        a missing shard forces ``complete: false``."""
        out: dict[str, Any] = {
            "watermarkMs": min((m.get("watermarkMs", 0)
                                for m in markers), default=0),
            "lateRefolded": sum(m.get("lateRefolded", 0)
                                for m in markers),
            "lateDropped": sum(m.get("lateDropped", 0)
                               for m in markers),
            "complete": bool(markers)
            and all(m.get("complete") for m in markers)
            and not degraded,
        }
        lat = [m.get("latenessMs") for m in markers
               if m.get("latenessMs") is not None]
        if lat:
            out["latenessMs"] = lat[0]
        if any("sessionsOpen" in m for m in markers):
            out["sessionsOpen"] = sum(m.get("sessionsOpen", 0)
                                      for m in markers)
            out["sessionsClosed"] = sum(m.get("sessionsClosed", 0)
                                        for m in markers)
        if any(m.get("degraded") for m in markers):
            out["degraded"] = True
        if degraded:
            out["shardsDegraded"] = sorted(degraded)
        return out

    def current_results(self, fcq: FedCQ,
                        now_ms: int | None = None) -> list[dict]:
        """The merged pull: every reachable shard's current rows
        folded into one answer; unreachable shards degrade into the
        trailing marker (never a 5xx, the /api/query idiom)."""
        self.merged_pulls += 1
        path = f"{_CQ_BASE}/{fcq.id}/result"
        res = self._fan_out(
            lambda p: self._cq_op(fcq, p, "GET", path))
        legs: list[list[dict]] = []
        markers: list[dict] = []
        degraded: list[str] = []
        for name, r in res:
            if isinstance(r, Exception) or r[0] != 200:
                degraded.append(name)
                continue
            try:
                rows = json.loads(r[1])
            except Exception:  # noqa: BLE001 - torn shard body
                degraded.append(name)
                continue
            rows, marker = self._split_marker(rows)
            legs.append(rows)
            if marker is not None:
                markers.append(marker)
        if len(degraded) == len(res):
            raise DegradedError(
                f"continuous query {fcq.id!r}: every shard leg "
                "failed; retry shortly")
        rows_out = self._merge_rows(fcq, legs)
        if fcq.policy is not None or degraded:
            rows_out.append({"completeness": self._merge_markers(
                markers, degraded)})
        return rows_out

    # -- merged push (SSE duck-type surface) ---------------------------

    def subscribe(self, fcq: FedCQ,
                  last_event_id: int | None = None
                  ) -> sse.Subscription:
        sub = sse.Subscription(self.queue_events)
        with fcq.lock:
            fcq.subscribers.append(sub)
            seq = fcq.emit_seq
        # initial snapshot: the merged current rows (resume replay is
        # a shard-local luxury; federated reconnects re-snapshot)
        try:
            rows = self.current_results(fcq)
        except DegradedError:
            rows = [{"completeness": {
                "degraded": True, "complete": False}}]
        rows, marker = self._split_marker(rows)
        payload: dict[str, Any] = {
            "id": fcq.id, "seq": seq,
            "ts": int(time.time() * 1000),
            "updates": rows}
        if marker is not None:
            payload["completeness"] = marker
        sse.offer_frame(sub, sse.frame("snapshot", payload,
                                       event_id=seq))
        return sub

    def unsubscribe(self, fcq: FedCQ, sub: sse.Subscription) -> None:
        with fcq.lock:
            if sub in fcq.subscribers:
                fcq.subscribers.remove(sub)
                self.sse_events += sub.events

    def pump(self, fcq: FedCQ, force: bool = False) -> bool:
        """One merged delta drain: fan the dirty-window pull to every
        shard, fold the per-shard updates, publish one ``windows``
        frame to every subscriber. Called from the SSE generator's
        heartbeat loop (the shard-local registry's pump contract)."""
        sp = trace_begin("cluster.cq.pump", cq=fcq.id)
        try:
            self.pumps += 1
            path = f"{_CQ_BASE}/{fcq.id}/deltas"
            res = self._fan_out(
                lambda p: self._cq_op(fcq, p, "GET", path))
            legs: list[list[dict]] = []
            markers: list[dict] = []
            degraded: list[str] = []
            for name, r in res:
                if isinstance(r, Exception) or r[0] != 200:
                    degraded.append(name)
                    continue
                try:
                    doc = json.loads(r[1])
                except Exception:  # noqa: BLE001 - torn shard body
                    degraded.append(name)
                    continue
                legs.append(doc.get("updates") or [])
                if doc.get("completeness") is not None:
                    markers.append(doc["completeness"])
            updates = self._merge_rows(fcq, legs)
            if not updates and not force and not degraded:
                trace_end(sp)
                return False
            payload: dict[str, Any] = {
                "id": fcq.id, "ts": int(time.time() * 1000),
                "updates": updates}
            if fcq.policy is not None or degraded:
                payload["completeness"] = self._merge_markers(
                    markers, degraded)
            with fcq.lock:
                fcq.emit_seq += 1
                payload["seq"] = fcq.emit_seq
                targets = list(fcq.subscribers)
                fr = sse.frame("windows", payload,
                               event_id=fcq.emit_seq)
            shed = 0
            for s in targets:
                if not sse.offer_frame(s, fr):
                    shed += 1
                    with fcq.lock:
                        if s in fcq.subscribers:
                            fcq.subscribers.remove(s)
                            self.sse_events += s.events
            self.sse_shed += shed
            self.sse_events += len(targets) - shed
        except BaseException as exc:
            trace_end(sp, error=exc)
            raise
        trace_end(sp)
        return True

    # -- observability -------------------------------------------------

    def collect_stats(self, collector) -> None:
        with self._lock:
            n = len(self._queries)
        collector.record("cluster.cq.queries", n)
        collector.record("cluster.cq.registrations",
                         self.registrations)
        collector.record("cluster.cq.deletes", self.deletes)
        collector.record("cluster.cq.pumps", self.pumps)
        collector.record("cluster.cq.merged_pulls", self.merged_pulls)
        collector.record("cluster.cq.wire_ops", self.wire_ops)
        collector.record("cluster.cq.http_fallbacks",
                         self.http_fallbacks)
        collector.record("cluster.cq.reregisters", self.reregisters)
        collector.record("cluster.cq.sse_shed", self.sse_shed)


__all__ = ["FedCQ", "FederatedCQRegistry"]
