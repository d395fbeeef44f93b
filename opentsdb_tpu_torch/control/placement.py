"""Placement control: SLO-fed hot-shard detection and reshard plans
(ref: ``opentsdb_tpu/control/placement.py``).

The planner reads the per-peer load counters the router already
keeps (forwarded + spooled points — the write traffic each shard
absorbed) plus breaker state, flags peers carrying more than
``hot_ratio`` x the mean load, and folds that into a *proposed* ring
spec: the same peer set with the vnode count stepped up, which
re-spreads the hot shard's hash ranges without moving the membership.

The proposal is exactly that — a proposal. ``GET /api/control/plan``
shows it (with a content-addressed ``planId``). A confirmed plan, by
``POST /api/control/plan`` or by ``tsd.control.placement.auto=true``,
goes to the router's reshard, as ``POST /api/cluster/reshard`` does.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any

#: vnode step applied by a rebalance proposal (bounded so repeated
#: auto-applies converge instead of doubling forever)
VNODE_STEP = 16
MAX_VNODES = 512


def shard_loads(router) -> dict[str, dict[str, Any]]:
    """Per-peer load signal out of the router's own counters."""
    loads: dict[str, dict[str, Any]] = {}
    for name, peer in router.peers.items():
        loads[name] = {
            "points": int(peer.forwarded_points +
                          peer.spooled_points),
            "spooledPoints": int(peer.spooled_points),
            "queryFailures": int(peer.query_failures),
            "breakerOpen": bool(peer.breaker.blocking()),
        }
    return loads


def build_plan(router, hot_ratio: float,
               now_ms: int | None = None) -> dict[str, Any]:
    """One placement assessment: loads, hot shards, and (when any
    shard is hot) a proposed reshard spec. Pure function of the
    router's counters — no I/O, no mutation."""
    loads = shard_loads(router)
    plan: dict[str, Any] = {
        "ts": int(now_ms if now_ms is not None else
                  time.time() * 1000),
        "vnodes": int(router.ring.vnodes),
        "loads": loads,
        "hotShards": [],
        "proposal": None,
        "reason": "balanced",
    }
    if len(loads) < 2:
        plan["reason"] = "single shard: nothing to rebalance"
        return plan
    points = [entry["points"] for entry in loads.values()]
    total = sum(points)
    if total <= 0:
        plan["reason"] = "no traffic observed"
        return plan
    mean = total / len(points)
    hot = sorted(name for name, entry in loads.items()
                 if entry["points"] > hot_ratio * mean)
    plan["hotShards"] = hot
    if not hot:
        return plan
    vnodes = min(int(router.ring.vnodes) + VNODE_STEP, MAX_VNODES)
    if vnodes <= router.ring.vnodes:
        plan["reason"] = ("hot shards %s but vnodes already at the "
                          "%d cap" % (",".join(hot), MAX_VNODES))
        return plan
    peers = ",".join(
        "%s=%s:%d" % (name, peer.client.host, peer.client.port)
        for name, peer in sorted(router.peers.items()))
    plan["proposal"] = {"peers": peers, "vnodes": vnodes}
    plan["reason"] = ("shards %s exceed %.1fx mean load; re-spread "
                      "hash ranges at vnodes=%d"
                      % (",".join(hot), hot_ratio, vnodes))
    plan["planId"] = plan_id(plan)
    return plan


def plan_id(plan: dict[str, Any]) -> str:
    """Content address of the actionable part of a plan. Confirming a
    planId that no longer matches the current proposal is rejected —
    the operator approved a different world."""
    doc = json.dumps({"proposal": plan.get("proposal"),
                      "hotShards": plan.get("hotShards")},
                     sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


__all__ = ["MAX_VNODES", "VNODE_STEP", "build_plan", "plan_id",
           "shard_loads"]
