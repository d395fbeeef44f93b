"""Fleet-wide stats aggregation: the router as the one scrape point
(ref: ``opentsdb_tpu/cluster/fleet.py``).

Per-node ``/api/stats`` counters multiply by shard count; nothing
aggregated them. This module scatters the per-node raw-stats document
(``GET /api/stats/raw`` — counters/gauges plus full-resolution
histogram snapshots) over the existing peer client with the same
failure discipline as a read scatter (breaker-aware, degraded peers
marked, never a 5xx) and merges:

- **counters** sum across nodes (a fleet total);
- **gauges** (levels — :func:`opentsdb_tpu_torch.stats.stats.is_gauge`)
  list per-node values plus min/max/sum — summing a level is shown,
  never silently substituted for the distribution;
- **histograms** BUCKET-sum at full internal resolution
  (:func:`merge_histogram_snapshots`), so a fleet p99 is computed
  from the merged distribution — exact, not an average of per-node
  percentiles (averaging percentiles is the classic observability
  lie this module exists to avoid). Every snapshot also carries a
  DDSketch companion (``sketch`` field): when bucket tables differ
  across nodes (a mixed-build fleet) the bucket sum refuses, and the
  sketches — whose merge is exact regardless of each node's ladder —
  take over the percentile columns (``merge: "sketch"``). When the
  buckets DO merge, the sketch percentiles ride along under a
  ``sketch`` sub-document as the higher-resolution companion view
  (relative-error buckets vs the 1ms-linear ladder's absolute bins).

Also here: the consolidated operator progress surface behind
``GET /api/cluster/status`` — the ring epoch, per-peer spool backlog
and dirty-debt AGE, and the backfill window, with coarse ETA estimates,
and on a router that names siblings its gossip bus.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import time
from typing import Any

from opentsdb_tpu_torch.stats.stats import (LATENCY_PCTS, is_gauge,
                                      merge_histogram_snapshots,
                                      percentiles_from_buckets)

LOG = logging.getLogger("cluster.fleet")


def _tag_suffix(tags: dict[str, Any]) -> str:
    if not tags:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in
                          sorted(tags.items())) + "}"


def scatter_json(router, path: str
                 ) -> tuple[dict[str, dict], list[str]]:
    """One GET of ``path`` per reachable peer, JSON-object bodies
    only. Returns ``(name -> parsed doc, failed peer names)`` — a
    breaker-blocked peer fails WITHOUT being touched (same rule as a
    read scatter), and any per-peer trouble lands in the failed list,
    never out of this function."""
    futs: dict[str, Any] = {}
    failed: list[str] = []
    for name, peer in sorted(router.peers.items()):
        if peer.breaker.blocking():
            failed.append(name)
            continue
        futs[name] = router.pool.submit(
            router.fetch_guarded, peer, "GET", path)
    docs: dict[str, dict] = {}
    for name, fut in futs.items():
        try:
            status, data = fut.result(
                timeout=router.timeout_s * 2 + 5)
            if status != 200:
                raise OSError(f"{path} answered {status}")
            doc = json.loads(data)
            if not isinstance(doc, dict):
                raise OSError(f"{path} body is not an object")
        except (OSError, ValueError,
                concurrent.futures.TimeoutError) as exc:
            # named in the log as a read scatter names a failed leg:
            # the doc itself only lists the shard
            LOG.warning("shard %s failed the %s scatter (%s: %s)", name,
                        path, type(exc).__name__, exc)
            peer = router.peers.get(name)
            if peer is not None:
                peer.query_failures += 1
            failed.append(name)
            continue
        docs[name] = doc
    return docs, sorted(failed)


def _merge_snapshot_sketches(snaps: "list[dict]"):
    """Merge the base64 ``sketch`` companions of histogram snapshot
    documents. Returns the merged DDSketch only when EVERY snapshot
    carries a parseable, alpha-compatible sketch — a partial merge
    would silently drop some nodes' observations from the fleet
    distribution, which is exactly the lie this module refuses."""
    from opentsdb_tpu_torch.sketch.ddsketch import DDSketch, SketchError
    merged = None
    for s in snaps:
        blob = s.get("sketch")
        if not isinstance(blob, str):
            return None
        try:
            sk = DDSketch.from_b64(blob)
        except (SketchError, ValueError):
            return None
        if merged is None:
            merged = sk
        else:
            try:
                merged.merge(sk)
            except SketchError:
                return None
    return merged


def merge_fleet(docs: dict[str, dict]) -> dict[str, Any]:
    """Merge per-node raw-stats documents into the fleet view."""
    counters: dict[str, float] = {}
    gauges: dict[str, dict[str, Any]] = {}
    hists: dict[str, dict[str, Any]] = {}
    for node, doc in sorted(docs.items()):
        for rec in doc.get("records") or []:
            name = str(rec.get("metric", ""))
            tags = rec.get("tags") or {}
            try:
                value = float(rec.get("value", 0.0))
            except (TypeError, ValueError):
                continue
            key = name + _tag_suffix(tags)
            bare = name.split(".", 1)[1] if "." in name else name
            if is_gauge(bare):
                g = gauges.setdefault(key, {"nodes": {}})
                g["nodes"][node] = value
            else:
                counters[key] = counters.get(key, 0.0) + value
        for h in doc.get("histograms") or []:
            name = str(h.get("name", ""))
            labels = h.get("labels") or {}
            key = name + _tag_suffix(labels)
            entry = hists.setdefault(
                key, {"name": name, "labels": dict(labels),
                      "snaps": [], "nodes": []})
            entry["snaps"].append(h)
            entry["nodes"].append(node)
    for g in gauges.values():
        vals = list(g["nodes"].values())
        g["min"] = min(vals)
        g["max"] = max(vals)
        g["sum"] = sum(vals)
    hist_out: dict[str, dict[str, Any]] = {}
    for key, entry in sorted(hists.items()):
        merged = merge_histogram_snapshots(entry["snaps"])
        sketch = _merge_snapshot_sketches(entry["snaps"])
        if merged is None and sketch is None:
            hist_out[key] = {"error": "bucket tables do not merge",
                             "nodes": entry["nodes"]}
            continue
        sk_pcts = None
        if sketch is not None:
            vals = (sketch.quantiles([q for _l, q in LATENCY_PCTS])
                    if sketch.count else [0.0] * len(LATENCY_PCTS))
            sk_pcts = {label: float(v)
                       for (label, _q), v in zip(LATENCY_PCTS, vals)}
        doc: dict[str, Any]
        if merged is not None:
            # bucket sum is the primary path: bit-identical to the
            # same observations landing in one histogram
            pcts = percentiles_from_buckets(
                merged["bounds"], merged["buckets"], merged["count"],
                [q for _l, q in LATENCY_PCTS])
            doc = {label: v
                   for (label, _q), v in zip(LATENCY_PCTS, pcts)}
            doc["count"] = merged["count"]
            doc["sum"] = round(merged["sum"], 3)
            doc["merge"] = "buckets"
            if sk_pcts is not None:
                doc["sketch"] = sk_pcts
        else:
            # mixed bucket ladders: the sketches still merge exactly,
            # so the fleet percentiles come from the merged sketch —
            # never from averaging per-node percentiles
            doc = dict(sk_pcts)
            doc["count"] = int(sketch.count)
            doc["sum"] = round(sum(float(s.get("sum") or 0.0)
                                   for s in entry["snaps"]), 3)
            doc["merge"] = "sketch"
        doc["nodes"] = entry["nodes"]
        hist_out[key] = doc
    return {"counters": {k: counters[k] for k in sorted(counters)},
            "gauges": {k: gauges[k] for k in sorted(gauges)},
            "histograms": hist_out}


def fleet_stats(router) -> dict[str, Any]:
    """The ``GET /api/stats/fleet`` document."""
    docs, degraded = scatter_json(router, "/api/stats/raw")
    out = merge_fleet(docs)
    out["nodes"] = {name: "ok" for name in sorted(docs)}
    out["nodes"].update({name: "degraded" for name in degraded})
    out["shardsDegraded"] = degraded
    out["ts"] = int(time.time())
    return out


def fleet_health(router) -> dict[str, Any]:
    """The ``fleet`` section of a router's ``/api/health``: one
    status line per shard (scattered ``/api/health``), never a 5xx —
    an unreachable shard is a ``"unreachable"`` row, not a failure."""
    docs, failed = scatter_json(router, "/api/health")
    nodes: dict[str, dict[str, Any]] = {
        name: {"status": "unreachable"} for name in failed}
    for name, doc in docs.items():
        nodes[name] = {
            "status": doc.get("status", "unknown"),
            "causes": doc.get("causes") or [],
            "uptime_seconds": doc.get("uptime_seconds"),
        }
    ok = sum(1 for n in nodes.values() if n["status"] == "ok")
    return {
        "shards": len(nodes),
        "ok": ok,
        "degraded": sorted(n for n, d in nodes.items()
                           if d["status"] != "ok"),
        "nodes": nodes,
    }


def cluster_status(router) -> dict[str, Any]:
    """The ``GET /api/cluster/status`` consolidated progress doc."""
    now_ms = int(time.time() * 1000)
    state = router.state
    doc: dict[str, Any] = {
        "epoch": state.epoch,
        "rf": router.rf,
        "ring": {"peers": list(router.ring.names),
                 "vnodes": router.ring.vnodes},
        "ts": now_ms // 1000,
    }
    # -- reshard / backfill window -------------------------------------
    reshard = state.describe()
    doc["reshard"] = reshard
    if reshard.get("active"):
        bf = router.backfiller.health_info()
        bf.update(router.backfiller.progress())
        done = bf.get("done_units") or 0
        total = bf.get("total_units") or 0
        fence = reshard.get("fence_ms") or 0
        if done and total and fence:
            elapsed_s = max((now_ms - fence) / 1000.0, 0.001)
            rate = done / elapsed_s
            bf["eta_s"] = round((total - done) / rate, 1) \
                if rate > 0 and total > done else 0.0
        else:
            bf["eta_s"] = None  # no progress yet: no honest estimate
        doc["backfill"] = bf
    doc["retire"] = router.retirer.health_info()
    # -- per-peer spool backlog + divergence debt ----------------------
    # drain floor: one replay batch per interval wake is the
    # guaranteed minimum (the catch-up drain usually clears faster),
    # so the ETA is an upper bound, not a promise
    drain_floor = router.replay_batch / max(
        router.replay_interval_s, 0.001)
    peers: dict[str, dict[str, Any]] = {}
    worst_age_s = 0.0
    backlog_total = 0
    for name, peer in sorted(router.peers.items()):
        pending = peer.spool.pending_records
        backlog_total += pending
        age = router.dirty.age_info(name, now_ms)
        if age["age_s"] > worst_age_s:
            worst_age_s = age["age_s"]
        peers[name] = {
            "breaker": peer.breaker.state,
            "spool_pending_records": pending,
            "spool_drain_eta_s": round(pending / drain_floor, 3)
            if pending else 0.0,
            "dirty_metrics": age["entries"],
            "dirty_oldest_age_s": age["age_s"],
        }
    doc["peers"] = peers
    doc["spool_backlog_records"] = backlog_total
    doc["dirty_oldest_age_s"] = worst_age_s
    # -- query-path read-repair (source-side work maybe_repair does
    # on behalf of reads — queue depth/shed/completions were
    # invisible here before) ------------------------------------------
    doc["read_repair"] = router.read_repair.health_info()
    # -- sibling-router gossip bus -------------------------------------
    if router.gossip is not None:
        doc["gossip"] = router.gossip.health_info()
    return doc


__all__ = ["cluster_status", "fleet_health", "fleet_stats",
           "merge_fleet", "scatter_json"]
