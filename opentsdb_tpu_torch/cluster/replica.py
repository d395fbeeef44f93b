"""Replica selection and anti-entropy of the cluster tier (ref:
``opentsdb_tpu/cluster/replica.py``).

**Replica selection** (``replicaSel``). At ``tsd.cluster.rf`` > 1 a
plain scatter would count every series rf times. The router assigns
each distinct ordered replica set (:meth:`HashRing.replica_sets`) to
exactly ONE member and sends that member the assignment in the query
body::

    "replicaSel": {"peers": [...], "vnodes": 64, "rf": 2,
                   "sets": [["s0", "s1"], ["s2", "s0"]]}

The shard rebuilds the same ring (``peers`` and ``vnodes`` pin it; MD5
placement is the same in every process) and keeps a candidate series
only when its replica set is among the assigned ones
(:func:`series_mask`), so every series is read exactly once cluster
wide. The engine reads the mask through :func:`store_series_mask`,
which remembers each series' replica set per store and ring for the
store's life, so a repeat query hashes no series again. The selector
itself is parsed and keyed by ``query.model.parse_sel`` and
``sel_cache_key``, beside the ``TSQuery`` field it fills.

**Anti-entropy** (:class:`DirtyTracker`). The durable spool replays
every acked write to a returned peer — it IS the first line of
anti-entropy. What it cannot cover is the window where the spool
itself failed (a ``SpoolFull`` refusal, an in-memory spool lost to a
router restart, a point one replica refused while its sibling stored
it): the tracker records a per-(peer, metric) dirty-epoch (earliest
wall-clock ms the divergence could have begun, persisted next to the
spool as ``replica_dirty.json``, the reference's file), and the
router's replay loop re-copies the window from a surviving replica
once the peer's spool drains (:meth:`ClusterRouter.repair_peer`).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from typing import Any, Iterable

import numpy as np

from opentsdb_tpu_torch.cluster.hashring import HashRing, series_shard_key
from opentsdb_tpu_torch.query.model import parse_sel, sel_cache_key

LOG = logging.getLogger("cluster.replica")

# process-wide ring memo: shards rebuild the router's ring from the
# replicaSel spec on every filtered query, and construction hashes
# names x vnodes, so identical specs share one instance (ref)
_ring_lock = threading.Lock()
_ring_cache: dict[tuple, HashRing] = {}


def ring_for(peers: Iterable[str], vnodes: int) -> HashRing:
    key = (tuple(peers), int(vnodes))
    with _ring_lock:
        ring = _ring_cache.get(key)
        if ring is None:
            if len(_ring_cache) > 64:
                _ring_cache.clear()  # retired specs: keep no dead rings
            ring = _ring_cache[key] = HashRing(list(key[0]), key[1])
        return ring


def sel_doc(peers: list[str], vnodes: int, rf: int,
            sets: Iterable[tuple[str, ...]],
            invert: bool = False) -> dict[str, Any]:
    """The wire form of one request's replica assignment. ``invert``
    flips the mask: the shard keeps only series whose replica set is
    NOT among ``sets`` (the reference's stale-copy retire pass)."""
    out = {"peers": list(peers), "vnodes": int(vnodes),
           "rf": int(rf), "sets": [list(t) for t in sets]}
    if invert:
        out["invert"] = True
    return out


def _wanted(sel: dict[str, Any], ring: HashRing) -> np.ndarray:
    """[replica sets] bool: which of ``ring.replica_sets(rf)`` the
    request keeps (inverted with ``invert``)."""
    assigned = {tuple(t) for t in sel["sets"]}
    hit = np.asarray([t in assigned for t in ring.replica_sets(sel["rf"])],
                     dtype=bool)
    return ~hit if sel.get("invert", False) else hit


def series_mask(sel: dict[str, Any], metric: str, series_tags,
                name_of_kid, name_of_vid) -> list[bool]:
    """Shard-side filter: which of this store's candidate series this
    request is assigned to read (ref: ``series_mask``). ``series_tags``
    yields one ``[(kid, vid), ...]`` list per series; the resolvers map
    tag UID ints to names (the ring hashes NAMES, the one spelling that
    is the same on every shard; UID ints are per shard). The pairs are
    laid out as a tag matrix and placed as :func:`store_series_mask`
    places a store's series, with no memo."""
    rows = [{int(k): int(v) for k, v in pairs} for pairs in series_tags]
    kids = sorted({k for r in rows for k in r})
    col = {k: j for j, k in enumerate(kids)}
    vids = np.full((len(rows), len(kids)), -1, dtype=np.int64)
    for i, r in enumerate(rows):
        for k, v in r.items():
            vids[i, col[k]] = v
    ring = ring_for(sel["peers"], sel["vnodes"])
    pos = ring.set_indices(_matrix_keys(
        metric, np.asarray(kids), vids,
        lambda ids: [name_of_kid(i) for i in ids],
        lambda ids: [name_of_vid(i) for i in ids]), sel["rf"])
    return _wanted(sel, ring)[pos].tolist()


def _matrix_keys(metric: str, kids: np.ndarray, vids: np.ndarray,
                 names_of_kids, names_of_vids) -> list[bytes]:
    """:func:`series_shard_key` of every row of a tag matrix (``vids``
    [S, K], -1 where a series lacks key ``kids[j]``), built a column at
    a time in the tag names' order: each distinct (key, value) pair is
    named (``names_of_*`` map a list of UID ints to their names) and
    encoded once, and each key joined in one pass."""
    head = metric.encode("utf-8", "surrogatepass")
    names = names_of_kids([int(k) for k in kids])
    cols = []
    for j in sorted(range(len(kids)), key=names.__getitem__):
        uniq, inv = np.unique(vids[:, j], return_inverse=True)
        known = uniq[uniq >= 0].tolist()
        pre = f"\x00{names[j]}="
        piece = [b""] * (len(uniq) - len(known)) + [   # -1 sorts first
            (pre + v).encode("utf-8", "surrogatepass")
            for v in names_of_vids(known)]
        cols.append([piece[i] for i in inv.reshape(-1).tolist()])
    if not cols:
        return [head] * len(vids)
    return [head + b"".join(parts) for parts in zip(*cols)]


class _SetMemo:
    """One store's replica-set positions on one ring at one rf: ``pos``
    indexed by series id, -1 where not yet computed. A store's series
    ids are dense and never reused, and a series' tags never change,
    so an entry stays true for the store's life."""

    __slots__ = ("lock", "pos")

    def __init__(self):
        self.lock = threading.Lock()
        self.pos = np.empty(0, dtype=np.int32)


# store -> {(peers, vnodes, rf): _SetMemo}; a store's memos go with it
_memo_lock = threading.Lock()
_set_memos: "weakref.WeakKeyDictionary[Any, dict]" = \
    weakref.WeakKeyDictionary()


def store_series_mask(sel: dict[str, Any], store, metric: str,
                      sids: np.ndarray, kids: np.ndarray, vids: np.ndarray,
                      names_of_kids, names_of_vids) -> np.ndarray:
    """:func:`series_mask` of the series ``sids`` of ``store`` (their
    tags as a tag matrix; ``names_of_*`` map a list of UID ints to
    their names, as ``UniqueId.get_names``), through a per-(ring, rf)
    memo of each series' replica set that lives as long as the store:
    only series not seen before are named and hashed. Counts its
    calls, the series it hashed and its seconds in
    ``store_series_mask.calls``, ``.hashed`` and ``.seconds`` (set
    them to 0 to reset)."""
    t0 = time.perf_counter()
    ring = ring_for(sel["peers"], sel["vnodes"])
    rf = sel["rf"]
    key = (tuple(sel["peers"]), int(sel["vnodes"]), int(rf))
    with _memo_lock:
        memo = _set_memos.setdefault(store, {}).setdefault(key, _SetMemo())
    sids = np.asarray(sids, dtype=np.int64)
    with memo.lock:
        if len(sids) and int(sids.max()) >= len(memo.pos):
            grown = np.full(int(sids.max()) + 1, -1, dtype=np.int32)
            grown[:len(memo.pos)] = memo.pos
            memo.pos = grown
        pos = memo.pos[sids]
        todo = np.flatnonzero(pos < 0)
        if len(todo):
            keys = _matrix_keys(metric, kids, vids[todo], names_of_kids,
                                names_of_vids)
            pos[todo] = ring.set_indices(keys, rf)
            memo.pos[sids[todo]] = pos[todo]
    keep = _wanted(sel, ring)[pos]
    store_series_mask.calls += 1
    store_series_mask.hashed += len(todo)
    store_series_mask.seconds += time.perf_counter() - t0
    return keep


store_series_mask.calls = 0
store_series_mask.hashed = 0
store_series_mask.seconds = 0.0


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


__all__ = ["DirtyTracker", "ReadRepairQueue", "parse_sel", "ring_for",
           "sel_cache_key", "sel_doc", "series_mask",
           "store_series_mask"]
