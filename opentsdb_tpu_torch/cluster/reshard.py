"""Online resharding: ring-change epochs, dual-write cutover, backfill
(ref: ``opentsdb_tpu/cluster/reshard.py``).

``POST /api/cluster/reshard`` installs a NEW consistent-hash ring at a
fenced epoch. The cutover protocol is the classic live-migration
triple, chosen so the existing scatter/merge machinery stays exactly
correct (no point is ever double-counted, no acked point is ever
lost):

1. **Dual-write.** While the window is open every accepted point is
   delivered to the union of its OLD-ring and NEW-ring replica sets
   (unmoved series: same set, zero extra cost). Unreachable owners
   spool durably exactly like steady-state writes.
2. **Read-old.** Reads keep scattering over the OLD ring: its owners
   hold complete history *and* (via dual-write) every in-window
   write, so answers are complete without cross-ring merging — the
   one shape where merging two copies of a moved series could
   double-sum.
3. **Backfill.** A background pass streams moved keyspace from old
   owners to their new owners through the normal forward/spool path
   (duplicates dedupe last-write-wins on the shard). Progress is
   persisted per (old shard, metric) next to the spool, so a router
   killed mid-reshard resumes where it stopped instead of restarting
   the copy.

When every (old shard, metric) unit is marked done the epoch
**finalizes**: reads and writes flip to the new ring, shards that
left the ring are dropped (their spools closed — dual-write already
placed everything they were owed on the new owners), and the epoch
survives in ``reshard.json`` so result-cache versions stay
epoch-qualified across restarts.

``reshard.json`` is the reference's format in every state it holds, so
a spool directory moves between the two packages' routers mid-cutover
as well as at rest. :meth:`ReshardState.adopt` and
:meth:`~ReshardState.adopt_final` are the sibling routers' hand-off;
their caller is the sibling routers' gossip (:mod:`.gossip`).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any

LOG = logging.getLogger("cluster.reshard")

#: the copy paths' read-window end (ref: ``HORIZON_MS``): far enough
#: past the fence that points with future timestamps still move — the
#: backfill and the repair share it so neither drops a horizon the
#: other covers
HORIZON_MS = 10 * 366 * 24 * 3600 * 1000


class ReshardState:
    """Persisted cluster-topology state (``<dir>/reshard.json``): the
    installed ring epoch, the current peer spec (overrides config
    after a finalized reshard — config still names the boot-time
    ring), and during a cutover the old spec + fence + backfill
    done-markers."""

    FILE = "reshard.json"

    def __init__(self, directory: str | None):
        self._lock = threading.Lock()
        self.path = os.path.join(directory, self.FILE) \
            if directory else ""
        self.epoch = 0
        self.peers_spec = ""     # "" = use tsd.cluster.peers
        self.vnodes = 0          # 0 = use tsd.cluster.vnodes
        self.old_spec = ""       # non-empty => cutover window open
        self.old_vnodes = 0
        self.fence_ms = 0
        # highest epoch whose stale-copy retire pass COMPLETED: while
        # retired_epoch < epoch (and no cutover is open), former
        # owners may still hold moved series that replicaSel hides —
        # the retire pass deletes them and then marks the epoch
        self.retired_epoch = 0
        # old-shard name -> metrics whose moved keyspace fully copied
        self.done: dict[str, list[str]] = {}
        if self.path:
            try:
                try:
                    fh = open(self.path, "r", encoding="utf-8")
                except FileNotFoundError:
                    return  # first boot: epoch 0, no cutover
                with fh:
                    doc = json.load(fh)
                self.epoch = int(doc.get("epoch", 0))
                self.peers_spec = str(doc.get("peers", "") or "")
                self.vnodes = int(doc.get("vnodes", 0) or 0)
                self.retired_epoch = int(
                    doc.get("retired_epoch", 0) or 0)
                rs = doc.get("reshard") or {}
                self.old_spec = str(rs.get("old_peers", "") or "")
                self.old_vnodes = int(rs.get("old_vnodes", 0) or 0)
                self.fence_ms = int(rs.get("fence_ms", 0) or 0)
                done = rs.get("done") or {}
                if isinstance(done, dict):
                    self.done = {str(k): [str(m) for m in v]
                                 for k, v in done.items()
                                 if isinstance(v, list)}
            except (OSError, ValueError):
                LOG.exception("cannot load reshard state %s; "
                              "starting at epoch 0", self.path)

    # -- persistence ---------------------------------------------------

    def _save_locked(self) -> None:
        if not self.path:
            return
        doc: dict[str, Any] = {"epoch": self.epoch,
                               "peers": self.peers_spec,
                               "vnodes": self.vnodes,
                               "retired_epoch": self.retired_epoch}
        if self.old_spec:
            doc["reshard"] = {"old_peers": self.old_spec,
                              "old_vnodes": self.old_vnodes,
                              "fence_ms": self.fence_ms,
                              "done": self.done}
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
                fh.flush()
                # the epoch fence and
                # backfill progress must be durable before the install
                # (or a done-marker) is acted on — kill-during-reshard
                # recovery hangs on this file; the doc is tiny
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError:  # pragma: no cover - disk trouble
            LOG.exception("cannot persist reshard state to %s",
                          self.path)

    # -- transitions ---------------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            return bool(self.old_spec)

    def begin(self, new_spec: str, new_vnodes: int, old_spec: str,
              old_vnodes: int) -> int:
        """Open the cutover window; returns the new epoch."""
        with self._lock:
            self.epoch += 1
            self.peers_spec = new_spec
            self.vnodes = int(new_vnodes)
            self.old_spec = old_spec
            self.old_vnodes = int(old_vnodes)
            self.fence_ms = int(time.time() * 1000)
            self.done = {}
            self._save_locked()
            return self.epoch

    def finish(self) -> None:
        """Close the window: the new ring is the only ring."""
        with self._lock:
            self.old_spec = ""
            self.old_vnodes = 0
            self.fence_ms = 0
            self.done = {}
            self._save_locked()

    def adopt(self, epoch: int, new_spec: str, new_vnodes: int,
              old_spec: str, old_vnodes: int, fence_ms: int) -> bool:
        """Adopt a sibling router's OPEN cutover window at ``epoch``
        (gossip topology hand-off). Unlike :meth:`begin` the epoch and
        fence come from the initiator — every router must agree on
        them or their epoch-qualified caches diverge. Done-markers
        start empty: this router runs its own backfill (idempotent —
        duplicated copy units dedupe last-write-wins on the shards),
        which is exactly what lets a sibling resume a reshard whose
        initiator died mid-flight. Returns False when ``epoch`` is not
        ahead of the local one."""
        with self._lock:
            if epoch <= self.epoch:
                return False
            self.epoch = int(epoch)
            self.peers_spec = new_spec
            self.vnodes = int(new_vnodes)
            self.old_spec = old_spec
            self.old_vnodes = int(old_vnodes)
            self.fence_ms = int(fence_ms)
            self.done = {}
            self._save_locked()
            return True

    def adopt_final(self, epoch: int, spec: str, vnodes: int) -> bool:
        """Adopt a sibling's FINALIZED ring: either the close of this
        router's own open window at the same epoch, or a whole
        already-finalized epoch this router never saw begin. Returns
        False when nothing changed."""
        with self._lock:
            if epoch < self.epoch or (
                    epoch == self.epoch and not self.old_spec):
                return False
            self.epoch = int(epoch)
            self.peers_spec = spec
            self.vnodes = int(vnodes)
            self.old_spec = ""
            self.old_vnodes = 0
            self.fence_ms = 0
            self.done = {}
            self._save_locked()
            return True

    def mark_done(self, old_peer: str, metric: str) -> None:
        with self._lock:
            per = self.done.setdefault(old_peer, [])
            if metric not in per:
                per.append(metric)
                self._save_locked()

    def mark_retired(self, epoch: int) -> None:
        """The stale-copy retire pass that ran against ``epoch``
        finished: no former owner still holds a moved series.
        Compare-and-set on purpose — if a NEWER reshard began while
        the pass was finishing, stamping the current epoch would
        silently skip that epoch's reclaim forever; the stale mark is
        simply dropped and the re-armed pass covers the new epoch.
        Persisted so a router restart doesn't re-run a completed pass
        (re-running is harmless — the deletes match nothing — just
        wasted scans)."""
        with self._lock:
            if self.epoch == epoch and self.retired_epoch != epoch:
                self.retired_epoch = epoch
                self._save_locked()

    def reset_done(self) -> None:
        """Invalidate every done-marker: the responsibility snapshot
        changed (a shard was declared dead), so completed passes may
        have skipped series they must now claim. Re-copies are
        duplicates, and duplicates dedupe."""
        with self._lock:
            if self.done:
                self.done = {}
                self._save_locked()

    def is_done(self, old_peer: str, metric: str) -> bool:
        with self._lock:
            return metric in self.done.get(old_peer, ())

    def describe(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {"epoch": self.epoch,
                                   "active": bool(self.old_spec),
                                   "retired_epoch": self.retired_epoch}
            if self.old_spec:
                out["fence_ms"] = self.fence_ms
                out["old_peers"] = self.old_spec
                out["new_peers"] = self.peers_spec
                out["backfilled_metrics"] = sum(
                    len(v) for v in self.done.values())
            return out


class Backfiller:
    """Streams moved keyspace old → new owners, one (old shard,
    metric) unit per :meth:`step` — small enough that kill-during-
    reshard loses at most one unit of progress (the unit re-copies on
    resume; duplicates dedupe on the shard)."""

    def __init__(self, router):
        self.router = router
        # per-old-peer metric lists, fetched lazily per cutover (NOT
        # persisted: a resumed backfill re-asks, so metrics created
        # moments before the kill are still enumerated)
        self._metrics: dict[str, list[str]] = {}
        # old shards declared DEAD for this cutover: the deterministic
        # responsibility snapshot (first old replica NOT in this set
        # copies a series). Entering the set resets every done-marker
        # — completed passes skipped series the dead shard was
        # responsible for and must re-claim them. Leaving it (the
        # shard answered again) needs no reset: its own units then
        # copy, and any double-claimed series dedupe.
        self.dead: set[str] = set()
        self._scanning = ""   # old shard whose pass is in flight
        self._moved_last = 0  # series moved by the last page
        self.backfilled_points = 0
        self.backfilled_series = 0
        self.failed_steps = 0

    def reset(self) -> None:
        self._metrics = {}
        self.dead = set()

    def _declare_dead(self, old_name: str) -> None:
        if old_name not in self.dead:
            self.dead.add(old_name)
            LOG.warning(
                "backfill: old shard %s is unreachable; its series "
                "re-assign to their surviving replicas (done-markers "
                "reset)", old_name)
            self.router.state.reset_done()

    def _revive(self, old_name: str) -> None:
        self.dead.discard(old_name)

    # -- enumeration ---------------------------------------------------

    def _metrics_of(self, old_name: str) -> list[str] | None:
        """This old shard's metric names (suggest with a huge max), or
        None while the shard can't answer (retry next pass)."""
        got = self._metrics.get(old_name)
        if got is not None:
            return got
        router = self.router
        peer = router.peers[old_name]
        try:
            status, data = router.fetch_guarded(
                peer, "GET", "/api/suggest?type=metrics&max=1000000")
            if status != 200:
                raise OSError(f"suggest answered {status}")
            names = json.loads(data)
            if not isinstance(names, list):
                raise OSError("suggest body is not a list")
        except (OSError, ValueError) as exc:
            LOG.info("backfill: cannot enumerate metrics on %s (%s)",
                     old_name, exc)
            return None
        got = sorted(str(n) for n in names)
        self._metrics[old_name] = got
        return got

    def next_unit(self) -> tuple[str, str] | None | str:
        """The next pending (old shard, metric) unit, ``"blocked"``
        when a remaining unit's shard is unreachable, or None when
        the backfill is complete.

        At RF >= 2 an unreachable old shard does NOT block: it is
        declared dead (resetting every done-marker, so completed
        passes re-run) and the deterministic responsibility rule in
        ``_copy_metric`` hands its series to their first surviving
        replica. Shrinking a ring to drop a dead shard — the
        canonical reason to shrink — therefore still finalizes. At
        RF = 1 the dead shard's series exist nowhere else, so the
        window stays open (visible via ``failed_steps`` and the
        reshard status) until it returns."""
        router = self.router
        state = router.state
        blocked = False
        for old_name in sorted(router.old_ring.names):
            metrics = self._metrics_of(old_name)
            if metrics is None:
                if router.rf > 1:
                    self._declare_dead(old_name)
                    continue
                blocked = True
                continue
            self._revive(old_name)
            for metric in metrics:
                if not state.is_done(old_name, metric):
                    return old_name, metric
        return "blocked" if blocked else None

    # -- one unit ------------------------------------------------------

    def step(self) -> dict[str, Any]:
        """Copy one (old shard, metric) unit's moved series. Returns a
        progress doc; ``phase`` is ``copied`` / ``blocked`` / ``done``.
        """
        router = self.router
        unit = self.next_unit()
        if unit is None:
            return {"phase": "done"}
        if unit == "blocked":
            return {"phase": "blocked"}
        old_name, metric = unit
        faults = getattr(router.tsdb, "faults", None)
        if faults is not None:
            faults.check("cluster.reshard")
        try:
            moved = self._copy_metric(old_name, metric)
        except (OSError, ValueError) as exc:
            self.failed_steps += 1
            peer = self.router.peers.get(old_name)
            if self.router.rf > 1 and peer is not None \
                    and peer.breaker.blocking():
                # the shard died mid-pass: drop its cached metric
                # list (revival requires a FRESH enumeration) and
                # hand its series to their surviving replicas
                self._metrics.pop(old_name, None)
                self._declare_dead(old_name)
            LOG.info("backfill of %r from %s failed (%s); will retry",
                     metric, old_name, exc)
            return {"phase": "blocked", "peer": old_name,
                    "metric": metric, "error": str(exc)}
        router.state.mark_done(old_name, metric)
        return {"phase": "copied", "peer": old_name, "metric": metric,
                "series": moved}

    def _copy_metric(self, old_name: str, metric: str) -> int:
        """Scan one old shard's series of one metric and forward the
        rows it is responsible for to their new owners. Raises on a
        transport failure (the unit stays pending)."""
        router = self.router
        state = router.state
        peer = router.peers[old_name]
        batch_size = router.backfill_batch
        self._scanning = old_name
        moved = 0
        per_target: dict[str, list[dict]] = {}

        def flush(target: str) -> None:
            dps = per_target.pop(target, None)
            if dps:
                router.deliver_backfill(router.peers[target], dps)

        # page-wise: scan_series_pages bisects on 413 (a scan-
        # budgeted shard refuses a whole history in one piece, and
        # without paging the copy would block forever) and each page
        # forwards before the next is fetched, so the router never
        # materializes a metric's whole history
        for rows in router.scan_series_pages(
                peer, metric, 1, state.fence_ms + HORIZON_MS):
            self._copy_rows(rows, metric, per_target, flush,
                            batch_size)
            moved += self._moved_last
        for target in list(per_target):
            flush(target)
        self.backfilled_series += moved
        return moved

    def _copy_rows(self, rows, metric, per_target, flush,
                   batch_size) -> None:
        router = self.router
        old_ring, new_ring = router.old_ring, router.ring
        rf = router.rf
        self._moved_last = 0
        for row in rows:
            tags = row.get("tags") or {}
            old_set = old_ring.shards_for(metric, tags, rf)
            # deterministic responsibility: the first old replica NOT
            # declared dead copies the series. The snapshot is the
            # sticky ``self.dead`` set — never the racy instantaneous
            # breaker state, which could let two passes EACH believe
            # the other was responsible and mark their units done
            # with the series never copied. All replicas dead → no
            # source exists; the row waits for a revival.
            responsible = next(
                (n for n in old_set if n not in self.dead), None)
            if responsible != self._scanning:
                continue
            new_set = new_ring.shards_for(metric, tags, rf)
            targets = [n for n in new_set if n not in old_set]
            if not targets:
                continue
            self._moved_last += 1
            for ts, val in (row.get("dps") or ()):
                v = float(val)
                if math.isnan(v):
                    continue  # raw rows carry no fill; be defensive
                dp = {"metric": metric, "timestamp": int(ts),
                      "value": val, "tags": tags}
                self.backfilled_points += 1
                for target in targets:
                    per_target.setdefault(target, []).append(dp)
                    if len(per_target[target]) >= batch_size:
                        flush(target)

    def health_info(self) -> dict[str, Any]:
        return {
            "backfilled_series": self.backfilled_series,
            "backfilled_points": self.backfilled_points,
            "failed_steps": self.failed_steps,
            "dead_old_shards": sorted(self.dead),
        }

    def progress(self) -> dict[str, Any]:
        """Done-marker progress for /api/cluster/status:
        ``total_units`` counts (old shard, metric) units over the
        metric lists enumerated SO FAR (lists are fetched lazily per
        old shard, so early in a pass the total can still grow —
        ``total_known`` says whether every old shard has answered)."""
        state = self.router.state
        with state._lock:
            done_units = sum(len(v) for v in state.done.values())
        old_ring = self.router.old_ring
        names = list(old_ring.names) if old_ring is not None else []
        total = sum(len(self._metrics.get(n, ())) for n in names)
        return {
            "done_units": done_units,
            "total_units": total,
            "total_known": all(n in self._metrics for n in names),
        }


__all__ = ["HORIZON_MS", "Backfiller", "ReshardState"]
