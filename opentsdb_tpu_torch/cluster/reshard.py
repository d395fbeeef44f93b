"""Persisted cluster topology (ref: ``opentsdb_tpu/cluster/reshard.py``,
its :class:`ReshardState` and ``HORIZON_MS``).

The reference grows or shrinks the ring online behind a fenced epoch
persisted as ``reshard.json`` next to the spool. The port reads and
writes that file in the reference's format, so a spool directory moves
between the two packages' routers, and reports it in ``/api/cluster``.
Resharding itself (``begin``, ``finish``, ``adopt``, the
:class:`Backfiller`) is not ported (ROADMAP Queue 1, item 1.6d(ii)): the
router refuses a directory whose state is past epoch 0 or holds an
open cutover, so the port's state is always idle at epoch 0.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any

LOG = logging.getLogger("cluster.reshard")

#: the copy paths' read-window end (ref: ``HORIZON_MS``): far enough
#: past the fence that points with future timestamps still move
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

    def save(self) -> None:
        """Persist the state as it stands (the reference writes it on
        every transition)."""
        with self._lock:
            self._save_locked()

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


__all__ = ["HORIZON_MS", "ReshardState"]
