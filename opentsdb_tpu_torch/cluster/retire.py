"""Stale-copy retire pass: reclaim the bytes ``replicaSel`` hides
(ref: ``opentsdb_tpu/cluster/retire.py``).

A finalized reshard leaves MOVED series on their former owners:
backfill copies keyspace to the new owners, it never purges the old
ones — reads stay correct because every post-reshard scatter carries
a ``replicaSel`` that keeps only currently-assigned series, but the
stale copies' RAM/WAL/cold bytes linger forever.

This pass deletes them with a small bounded background job on the
router, one ``(shard, metric)`` unit per step, the Backfiller's
shape. The delete itself is one query per unit with an **inverted**
replica selector::

    replicaSel = {peers, vnodes, rf,
                  sets: [every replica tuple containing this shard],
                  invert: true}

so the shard's engine keeps — and, with ``delete=true``, purges —
exactly the series whose current replica set does NOT include the
shard: the stale copies, and nothing else. No router-side series
enumeration, no per-series requests, and the ownership decision runs
on the shard with the same MD5 ring reads use, so retire can never
delete a series a read could still be assigned.

Lifecycle/safety rules:

- runs only while ``retired_epoch < epoch`` and NO cutover is open
  (during dual-write the "former owner" set is not final); a reshard
  finalize re-arms it for the new epoch;
- one unit per wake (``tsd.cluster.retire.interval_ms``), breaker-
  gated per peer like every dispatch, ``cluster.retire`` fault site,
  ``cluster.retire`` background trace root;
- an unreachable shard leaves its units pending — the pass retries on
  later wakes and only marks ``retired_epoch`` (persisted in
  ``reshard.json``) when EVERY unit completed, so a router restart
  resumes (idempotently — re-deletes match nothing) instead of
  forgetting;
- the retire thread is joined by ``ClusterRouter.stop``, and its
  per-pass state resets every epoch.

The delete launches neither fused kernel: an ``aggregator: none``
query with ``delete=true`` takes the shard's raw-row path.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any

from opentsdb_tpu_torch.cluster import replica as replica_mod
from opentsdb_tpu_torch.cluster.reshard import HORIZON_MS

LOG = logging.getLogger("cluster.retire")


class RetireDisabled(Exception):
    """A shard refused the delete because ``tsd.http.query.
    allow_delete`` is off there — a config condition, not an outage:
    the pass parks (phase ``disabled``) instead of hammering the
    shard with doomed deletes every wake."""


class StaleCopyRetirer:
    """One (shard, metric) delete unit per :meth:`step`."""

    def __init__(self, router):
        self.router = router
        # per-pass state, reset() per epoch: pending metric lists per
        # shard (None = enumeration failed, retry) and finished units
        self._metrics: dict[str, list[str] | None] = {}
        self._done: set[tuple[str, str]] = set()
        self.retired_series = 0
        self.retire_queries = 0
        self.failed_steps = 0
        self.passes = 0

    def reset(self) -> None:
        """A new epoch finalized: the ownership map changed, every
        completed unit must re-check (re-deletes match nothing)."""
        self._metrics = {}
        self._done = set()

    # -- scheduling ----------------------------------------------------

    def pending(self) -> bool:
        """Whether stale copies may exist: a finalized epoch newer
        than the last completed retire pass, with no cutover open."""
        router = self.router
        return (router.old_ring is None
                and router.state.epoch > router.state.retired_epoch)

    # -- one unit ------------------------------------------------------

    def _metrics_of(self, name: str) -> list[str] | None:
        got = self._metrics.get(name)
        if got is not None:
            return got
        router = self.router
        peer = router.peers.get(name)
        if peer is None:
            return []
        try:
            status, data = router.fetch_guarded(
                peer, "GET", "/api/suggest?type=metrics&max=1000000")
            if status != 200:
                raise OSError(f"suggest answered {status}")
            names = json.loads(data)
            if not isinstance(names, list):
                raise OSError("suggest body is not a list")
        except (OSError, ValueError) as exc:
            LOG.info("retire: cannot enumerate metrics on %s (%s)",
                     name, exc)
            return None
        got = sorted(str(n) for n in names)
        self._metrics[name] = got
        return got

    def next_unit(self, ring) -> tuple[str, str] | None | str:
        """The next pending (shard, metric) unit, ``"blocked"`` while
        some shard cannot enumerate, or None when the pass is done."""
        blocked = False
        for name in sorted(ring.names):
            metrics = self._metrics_of(name)
            if metrics is None:
                blocked = True
                continue
            for metric in metrics:
                if (name, metric) not in self._done:
                    return name, metric
        return "blocked" if blocked else None

    def step(self) -> dict[str, Any]:
        """Retire one unit. Returns a progress doc; ``phase`` is
        ``retired`` / ``blocked`` / ``done`` / ``idle``.

        Racing an admin ``begin_reshard`` is the one hazard: a delete
        computed against the NEW ring during a cutover window could
        purge a moved series from its only pre-backfill holder. The
        ring is therefore SNAPSHOT before the cutover check —
        ``begin_reshard`` stores ``old_ring`` before swapping
        ``ring`` (its documented write order), so a ring read that
        still sees ``old_ring is None`` afterwards is provably the
        pre-install ring; a delete built against it only ever names
        copies that were already stale (and replicaSel-hidden) at
        that epoch. The completion mark is epoch-CAS'd for the same
        race (see ``ReshardState.mark_retired``)."""
        router = self.router
        ring = router.ring          # snapshot BEFORE the checks
        epoch = router.state.epoch  # the epoch this pass runs for
        if not self.pending():
            return {"phase": "idle"}
        unit = self.next_unit(ring)
        if unit is None:
            if any(p.spool.pending_records
                   for p in router.peers.values()):
                # an undrained spool can re-materialize a moved
                # series on its former owner (dual-write spooled to
                # old∪new owners) — marking now would leak those
                # bytes forever; let replay drain and retry
                return {"phase": "blocked",
                        "error": "spool backlog pending"}
            # every (shard, metric) unit deleted its stale copies:
            # the epoch is clean — persist so restarts don't re-scan
            router.state.mark_retired(epoch)
            self.passes += 1
            LOG.info("stale-copy retire pass complete at epoch %d "
                     "(%d series reclaimed)", epoch,
                     self.retired_series)
            return {"phase": "done"}
        if unit == "blocked":
            return {"phase": "blocked"}
        name, metric = unit
        faults = getattr(router.tsdb, "faults", None)
        if faults is not None:
            faults.check("cluster.retire")
        try:
            gone = self._retire_unit(ring, name, metric)
        except RetireDisabled as exc:
            self.failed_steps += 1
            LOG.warning(
                "stale-copy retire is parked: %s — set tsd.http."
                "query.allow_delete=true on every shard to let the "
                "router reclaim moved series (epoch %d stays "
                "pending)", exc, router.state.epoch)
            return {"phase": "disabled", "peer": name,
                    "metric": metric, "error": str(exc)}
        except (OSError, ValueError) as exc:
            self.failed_steps += 1
            LOG.info("retire of %r on %s failed (%s); will retry",
                     metric, name, exc)
            return {"phase": "blocked", "peer": name,
                    "metric": metric, "error": str(exc)}
        self._done.add((name, metric))
        return {"phase": "retired", "peer": name, "metric": metric,
                "series": gone}

    def _retire_unit(self, ring, name: str, metric: str) -> int:
        """Delete one metric's stale series on one shard via the
        inverted selector, against the caller's ring SNAPSHOT (see
        :meth:`step` on the begin_reshard race). Raises on transport
        trouble (the unit stays pending); an unknown-metric 400 is a
        clean zero."""
        router = self.router
        peer = router.peers.get(name)
        if peer is None:
            return 0  # popped by a concurrent reshard: next epoch's
            # pass (re-armed by finalize) covers the survivor set
        rf = min(router.rf, len(ring.names))
        owned = [t for t in ring.replica_sets(rf) if name in t]
        end_ms = int(time.time() * 1000) + HORIZON_MS
        body = json.dumps({
            # explicit ms suffixes, like the copy scans: a bare small
            # number would parse as SECONDS and shrink the window,
            # and the far-future horizon covers forecast series like
            # the backfill/repair scans do
            "start": "1ms", "end": f"{end_ms}ms",
            "msResolution": True,
            "delete": True,
            "queries": [{"metric": metric, "aggregator": "none"}],
            "replicaSel": replica_mod.sel_doc(
                list(ring.names), ring.vnodes, rf, owned,
                invert=True),
        }).encode()
        self.retire_queries += 1
        status, data = router._query_peer(peer, body)
        if status == 400 and b"no such name" in data.lower():
            return 0  # the metric has no series here at all
        if status == 400 and b"allow_delete" in data:
            raise RetireDisabled(
                f"shard {name} runs without "
                f"tsd.http.query.allow_delete")
        if status != 200:
            raise OSError(
                f"peer {name} answered {status} to a retire delete")
        try:
            # a wire leg arrives already decoded (list of rows)
            rows = data if isinstance(data, list) else json.loads(data)
        except ValueError as exc:
            raise OSError(
                f"peer {name} sent an unparseable retire body"
            ) from exc
        gone = len(rows) if isinstance(rows, list) else 0
        if gone:
            self.retired_series += gone
            LOG.info("retired %d stale series of %r from %s",
                     gone, metric, name)
        return gone

    # -- observability -------------------------------------------------

    def health_info(self) -> dict[str, Any]:
        return {
            "pending": self.pending(),
            "retired_series": self.retired_series,
            "retire_queries": self.retire_queries,
            "failed_steps": self.failed_steps,
            "passes": self.passes,
        }


__all__ = ["RetireDisabled", "StaleCopyRetirer"]
