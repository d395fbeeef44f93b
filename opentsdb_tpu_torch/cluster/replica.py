"""Anti-entropy bookkeeping of the cluster tier (ref:
``opentsdb_tpu/cluster/replica.py``, its :class:`DirtyTracker` and
:class:`ReadRepairQueue`).

The durable spool replays every acked write to a returned peer — it IS
the first line of anti-entropy. What it cannot cover is the window
where the spool itself failed (a ``SpoolFull`` refusal, an in-memory
spool lost to a router restart): the tracker records a per-(peer,
metric) dirty-epoch (earliest wall-clock ms the divergence could have
begun, persisted next to the spool as ``replica_dirty.json``, the reference's
file), and the router's replay loop runs a repair pass for a peer
with debt once its spool drains. At one replica (``tsd.cluster.rf=1``,
the only factor the port serves) there is no second copy to repair
from, so a pass clears the debt, as the reference's does.

The reference's replica read plan (``replicaSel``: ``ring_for``,
``sel_doc``, ``parse_sel``, ``sel_cache_key``, ``series_mask``) serves
RF > 1 and comes with replication (ROADMAP Queue 1, item 1.6d).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Iterable

LOG = logging.getLogger("cluster.replica")


class DirtyTracker:
    """Per-(peer, metric) divergence windows, persisted as one JSON
    sidecar per router (``<dir>/replica_dirty.json``). An entry maps
    ``peer -> metric -> earliest-dirty wall-clock ms``; repair reads
    the surviving replica from that stamp forward (minus a safety
    margin) and clears the entry on success."""

    def __init__(self, directory: str | None):
        self._lock = threading.Lock()
        self._dirty: dict[str, dict[str, int]] = {}
        self.path = os.path.join(directory, "replica_dirty.json") \
            if directory else ""
        self.marks = 0
        if self.path:
            try:
                with open(self.path, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
                if isinstance(doc, dict):
                    self._dirty = {
                        str(p): {str(m): int(s)
                                 for m, s in v.items()}
                        for p, v in doc.items()
                        if isinstance(v, dict)}
            except (OSError, ValueError):
                self._dirty = {}

    def _save_locked(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self._dirty, fh)
                fh.flush()
                # the dirty mark must be
                # durable before the divergence window it names can be
                # forgotten; the lock serializes mark-vs-clear and the
                # doc is a few KB
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError:  # pragma: no cover - disk trouble
            LOG.exception("cannot persist dirty marks to %s",
                          self.path)

    def mark(self, peer: str, metrics: Iterable[str],
             since_ms: int) -> None:
        """Record that ``peer`` may be missing writes of ``metrics``
        from ``since_ms`` on (earliest stamp wins)."""
        with self._lock:
            per = self._dirty.setdefault(peer, {})
            changed = False
            for m in metrics:
                cur = per.get(m)
                if cur is None or since_ms < cur:
                    per[m] = int(since_ms)
                    changed = True
            if changed:
                self.marks += 1
                self._save_locked()

    def peek(self, peer: str) -> dict[str, int]:
        with self._lock:
            return dict(self._dirty.get(peer, ()))

    def clear(self, peer: str, metrics: Iterable[str] | None = None
              ) -> None:
        with self._lock:
            per = self._dirty.get(peer)
            if per is None:
                return
            if metrics is None:
                per.clear()
            else:
                for m in metrics:
                    per.pop(m, None)
            if not per:
                self._dirty.pop(peer, None)
            self._save_locked()

    def drop_peer(self, peer: str) -> None:
        """A peer left the ring (reshard finalize): its debt is void."""
        with self._lock:
            if self._dirty.pop(peer, None) is not None:
                self._save_locked()

    @property
    def total_entries(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._dirty.values())

    def age_info(self, peer: str, now_ms: int | None = None
                 ) -> dict[str, Any]:
        """This peer's divergence-debt AGE: the oldest unpaired dirty
        epoch as a staleness gauge. A week-old divergence and a
        seconds-old blip carry the same entry COUNT — the age is what
        distinguishes "anti-entropy is keeping up" from "this replica
        has silently diverged for days"."""
        now = int(now_ms if now_ms is not None
                  else time.time() * 1000)
        with self._lock:
            per = self._dirty.get(peer) or {}
            oldest = min(per.values()) if per else 0
            return {
                "entries": len(per),
                "oldest_ms": oldest,
                "age_s": round(max(now - oldest, 0) / 1000.0, 1)
                if oldest else 0.0,
            }

    def health_info(self) -> dict[str, Any]:
        now_ms = int(time.time() * 1000)
        with self._lock:
            peers = sorted(self._dirty)
            entries = sum(len(v) for v in self._dirty.values())
            marks = self.marks
        ages = {p: self.age_info(p, now_ms) for p in peers}
        return {
            "entries": entries,
            "peers": peers,
            "marks": marks,
            # per-peer staleness: oldest unpaired dirty epoch + age
            "ages": ages,
            "oldest_age_s": max(
                (a["age_s"] for a in ages.values()), default=0.0),
        }


class ReadRepairQueue:
    """Query-path read-repair staging: divergence observed BY A READ
    (a fallback round re-read a failed reader's sets; replica answers
    disagreed about a metric's existence) enqueues here, and the
    router's replay loop drains entries into :class:`DirtyTracker` /
    ``maybe_repair`` off the read path — ``DirtyTracker.mark`` fsyncs
    under its lock, which a serve path must never wait on.

    Bounded and dedicated to staging, not truth: the queue dedupes on
    (peer, metric) keeping the EARLIEST suspicion stamp, sheds-and-
    counts past ``max_pending`` (a shed entry is a lost repair hint,
    not a lost write — the next read of the same divergence re-
    enqueues), and tracks drained-but-unrepaired keys in an inflight
    set so ``oldest_pending_age_s`` spans the whole mark→repair
    pipeline, not just the staging dict. False-positive enqueues are
    harmless: repair is idempotent and a clean window clears to a
    no-op."""

    def __init__(self, max_pending: int = 1024):
        self._lock = threading.Lock()
        self.max_pending = max(int(max_pending), 1)
        # (peer, metric) -> (since_ms, enqueued_monotonic)
        self._pending: dict[tuple[str, str], tuple[int, float]] = {}
        # drained into the DirtyTracker but not yet repaired
        self._inflight: dict[tuple[str, str], float] = {}
        self.enqueued = 0
        self.shed = 0
        self.completed = 0

    def enqueue(self, peer: str, metrics: Iterable[str],
                since_ms: int) -> int:
        """Stage suspicion windows; returns how many were accepted
        (the rest shed). Lock-cheap: dict ops only, no IO."""
        accepted = 0
        now = time.monotonic()
        with self._lock:
            for m in metrics:
                key = (peer, m)
                cur = self._pending.get(key)
                if cur is not None:
                    if since_ms < cur[0]:
                        self._pending[key] = (int(since_ms), cur[1])
                    continue
                if key in self._inflight:
                    continue  # already marked; repair will cover it
                if len(self._pending) >= self.max_pending:
                    self.shed += 1
                    continue
                self._pending[key] = (int(since_ms), now)
                self.enqueued += 1
                accepted += 1
        return accepted

    def drain(self) -> list[tuple[str, str, int]]:
        """Move every staged entry to inflight and return
        ``[(peer, metric, since_ms), ...]`` for the caller to mark
        dirty (off the read path)."""
        with self._lock:
            out = [(p, m, s) for (p, m), (s, _) in
                   self._pending.items()]
            for key, (_, stamp) in self._pending.items():
                self._inflight.setdefault(key, stamp)
            self._pending.clear()
        return out

    def note_repaired(self, peer: str, metrics: Iterable[str]
                      ) -> None:
        """The repair pass cleared these dirty windows — retire their
        inflight stamps and count completions."""
        with self._lock:
            for m in metrics:
                if self._inflight.pop((peer, m), None) is not None:
                    self.completed += 1

    def drop_peer(self, peer: str) -> None:
        """The peer left the ring; its staged/inflight debt is void."""
        with self._lock:
            for d in (self._pending, self._inflight):
                for key in [k for k in d if k[0] == peer]:
                    del d[key]

    def oldest_pending_age_s(self) -> float:
        now = time.monotonic()
        with self._lock:
            stamps = [t for _, t in self._pending.values()]
            stamps.extend(self._inflight.values())
        if not stamps:
            return 0.0
        return round(max(now - min(stamps), 0.0), 1)

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            depth = len(self._pending)
            inflight = len(self._inflight)
            enqueued, shed, completed = \
                self.enqueued, self.shed, self.completed
        return {
            "depth": depth,
            "inflight": inflight,
            "enqueued": enqueued,
            "shed": shed,
            "completed": completed,
            "oldest_pending_age_s": self.oldest_pending_age_s(),
        }


__all__ = ["DirtyTracker", "ReadRepairQueue"]
