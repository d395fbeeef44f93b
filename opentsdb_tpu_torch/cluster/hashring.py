"""Consistent-hash series→shard map (ref:
``opentsdb_tpu/cluster/hashring.py``).

The reference spreads series over storage by prefixing the row key
with ``hash(metric+tags) % 20`` salt buckets (``RowKey.java``,
``Const.SALT_BUCKETS``); this ring lifts the same key to the network
tier. Consistent hashing (vnodes on a ring) instead of plain modulo so
adding or removing a shard remaps only ``~1/N`` of the series — the
property that makes rolling a new shard into a live cluster sane.

Hashes are MD5 of the key bytes: deterministic across processes and
restarts (Python's ``hash()`` is seed-randomized per process, which
would scatter a router restart's writes onto different shards than
the data it already routed).
"""

from __future__ import annotations

import bisect
import hashlib

import numpy as np


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.md5(data).digest()[:8], "big")


def series_shard_key(metric: str, tags: dict[str, str]) -> bytes:
    """The shard key of one series: the reference's salt input —
    metric + sorted tag pairs (``RowKey.prefixKeyWithSalt`` hashes the
    metric+tags portion of the row key). Sorted so ``{a:1,b:2}`` and
    ``{b:2,a:1}`` land on the same shard."""
    parts = [metric]
    for k in sorted(tags):
        parts.append(f"{k}={tags[k]}")
    return "\x00".join(parts).encode("utf-8", "surrogatepass")


class HashRing:
    """Consistent-hash ring over named shards with ``vnodes`` virtual
    points per shard (more vnodes = smoother key distribution).

    Replication (RF ≥ 2) walks the ring clockwise from the key's hash
    point and collects the next R *distinct* shards — the Dynamo
    preference-list construction, which Monarch mirrors by assigning
    each target to 2-3 leaves. The ordered tuple is a series'
    **replica set**: ``[0]`` is the primary, the rest are fallbacks,
    and the set changes for only ``~1/N`` of series when a shard
    joins or leaves (the same property single ownership had)."""

    def __init__(self, names: list[str], vnodes: int = 64):
        if not names:
            raise ValueError("hash ring needs at least one shard")
        self.names = list(names)
        self.vnodes = max(int(vnodes), 1)
        points: list[tuple[int, str]] = []
        for name in self.names:
            for i in range(self.vnodes):
                points.append((_hash64(f"{name}#{i}".encode()), name))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [n for _, n in points]
        # replica tuples are pure functions of (segment start, rf):
        # memoized per rf because reads recompute them per series
        # keyspace is (vnode segment,
        # rf) — at most names*vnodes*rf entries, fixed at construction
        self._sets_cache: dict[int, tuple] = {}
        self._points_arr = np.asarray(self._points, dtype=np.uint64)
        # (rf, vnode idx) -> replica tuple, same bound as _sets_cache
        # keyspace fixed at construction
        self._walk_cache: dict[tuple[int, int], tuple[str, ...]] = {}
        # rf -> [vnode idx] position of its replica set in
        # replica_sets(rf) (set_indices); one array per rf
        self._seg_sets: dict[int, np.ndarray] = {}

    def _walk(self, idx: int, rf: int) -> tuple[str, ...]:
        """Ordered next-``rf``-distinct owners clockwise from vnode
        position ``idx`` (the key's successor point)."""
        out: list[str] = []
        n = len(self._owners)
        for step in range(n):
            owner = self._owners[(idx + step) % n]
            if owner not in out:
                out.append(owner)
                if len(out) == rf:
                    break
        return tuple(out)

    def shards_for_key(self, key: bytes, rf: int = 1
                       ) -> tuple[str, ...]:
        """Ordered replica set (primary first) of one series key,
        clamped to the shard count."""
        rf = max(1, min(int(rf), len(self.names)))
        h = _hash64(key)
        idx = bisect.bisect_right(self._points, h)
        if idx == len(self._points):
            idx = 0  # wrap: the ring is circular
        return self._walk(idx, rf)

    def shards_for_keys(self, keys: list[bytes], rf: int = 1
                        ) -> list[tuple[str, ...]]:
        """Batched :meth:`shards_for_key`: one ``searchsorted`` over
        the vnode array for the whole batch instead of a bisect per
        key, with the clockwise walk memoized per (rf, segment) —
        there are only ``names*vnodes`` segments, so a large put
        batch's walks collapse to dict hits."""
        rf = max(1, min(int(rf), len(self.names)))
        if not keys:
            return []
        out: list[tuple[str, ...]] = []
        cache = self._walk_cache
        for idx in self._segments(keys).tolist():
            ck = (rf, idx)
            owners = cache.get(ck)
            if owners is None:
                owners = self._walk(idx, rf)
                cache[ck] = owners
            out.append(owners)
        return out

    def _segments(self, keys: list[bytes]) -> np.ndarray:
        """Each key's successor vnode position: one ``searchsorted``
        over the vnode array for the whole batch."""
        # _hash64 of every key: each digest's first 8 bytes, big-endian
        md5 = hashlib.md5
        hs = np.frombuffer(b"".join([md5(k).digest() for k in keys]),
                           dtype=">u8")[::2].astype(np.uint64)
        idxs = np.searchsorted(self._points_arr, hs, side="right")
        idxs[idxs == len(self._points)] = 0  # wrap: ring is circular
        return idxs

    def set_indices(self, keys: list[bytes], rf: int = 1) -> np.ndarray:
        """Each key's replica set as its position in
        :meth:`replica_sets` (int32): :meth:`shards_for_keys` with the
        walk resolved per vnode segment once, for masks over many
        series."""
        rf = max(1, min(int(rf), len(self.names)))
        seg = self._seg_sets.get(rf)
        if seg is None:
            pos = {t: i for i, t in enumerate(self.replica_sets(rf))}
            seg = np.asarray([pos[self._walk(i, rf)]
                              for i in range(len(self._points))],
                             dtype=np.int32)
            self._seg_sets[rf] = seg
        if not keys:
            return np.empty(0, dtype=np.int32)
        return seg[self._segments(keys)]

    def shard_for_key(self, key: bytes) -> str:
        """Owning (primary) shard of one pre-computed series key."""
        return self.shards_for_key(key, 1)[0]

    def shard_for(self, metric: str, tags: dict[str, str]) -> str:
        return self.shard_for_key(series_shard_key(metric, tags))

    def shards_for(self, metric: str, tags: dict[str, str],
                   rf: int = 1) -> tuple[str, ...]:
        return self.shards_for_key(series_shard_key(metric, tags), rf)

    def replica_sets(self, rf: int) -> tuple[tuple[str, ...], ...]:
        """Every distinct ordered replica set this ring can assign at
        ``rf`` — one candidate per vnode segment, deduplicated. The
        router's read plan assigns each set to exactly one member, so
        a scatter covers every series exactly once."""
        rf = max(1, min(int(rf), len(self.names)))
        cached = self._sets_cache.get(rf)
        if cached is None:
            seen: dict[tuple[str, ...], None] = {}
            for idx in range(len(self._points)):
                seen.setdefault(self._walk(idx, rf))
            cached = tuple(seen)
            self._sets_cache[rf] = cached
        return cached

    def distribution(self, keys) -> dict[str, int]:
        """Shard -> key count for a sample of keys (tests/ops)."""
        out = {n: 0 for n in self.names}
        for key in keys:
            out[self.shard_for_key(key)] += 1
        return out
