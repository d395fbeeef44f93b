"""UID service: bidirectional name <-> fixed-width-UID dictionary.

(ref: ``src/uid/UniqueId.java``) Monotonically increasing ids per kind,
width-limited, assignment-is-idempotent, on top of a process-local
dictionary guarded by a lock. id 0 is never assigned. With
``random_ids`` (``tsd.core.uid.random_metrics`` for metrics; ref:
``RandomUniqueId.java``) a new name takes a random id instead, from an
RNG seeded as the reference's, so the same names in the same order get
the same ids.
"""

from __future__ import annotations

import bisect
import random
import threading
from typing import Iterable

from opentsdb_tpu_torch.core import const

UID_KINDS = ("metric", "tagk", "tagv")


class NoSuchUniqueName(LookupError):
    """Name has no assigned UID (ref: src/uid/NoSuchUniqueName.java)."""

    def __init__(self, kind: str, name: str):
        super().__init__(f"No such name for '{kind}': '{name}'")
        self.kind = kind
        self.name = name


class NoSuchUniqueId(LookupError):
    """UID has no assigned name (ref: src/uid/NoSuchUniqueId.java)."""

    def __init__(self, kind: str, uid: int):
        super().__init__(f"No such unique ID for '{kind}': {uid}")
        self.kind = kind
        self.uid = uid


class FailedToAssignUniqueIdError(RuntimeError):
    """Assignment rejected: the id space is exhausted
    (ref: src/uid/FailedToAssignUniqueIdException.java)."""


class UniqueId:
    """One UID dictionary for one kind ('metric' | 'tagk' | 'tagv')."""

    def __init__(self, kind: str, width: int = 3,
                 random_ids: bool = False):
        if kind not in UID_KINDS:
            raise ValueError(f"unknown UID kind {kind!r}")
        if not 1 <= width <= 8:
            raise ValueError(f"invalid UID width {width}")
        self.kind = kind
        self.width = width
        self.random_ids = random_ids
        self.max_possible_id = (1 << (8 * width)) - 1
        self._lock = threading.Lock()
        self._name_to_id: dict[str, int] = {}
        self._id_to_name: dict[int, str] = {}
        self._max_id = 0
        # the reference's seed: the same names in the same order get
        # the same random ids
        self._rng = random.Random(0xC0FFEE)
        self.random_id_collisions = 0
        # sorted names for suggest, rebuilt after an assignment
        self._sorted_names: list[str] | None = None

    def get_id(self, name: str) -> int:
        with self._lock:
            uid = self._name_to_id.get(name)
        if uid is None:
            raise NoSuchUniqueName(self.kind, name)
        return uid

    def get_name(self, uid: int) -> str:
        with self._lock:
            name = self._id_to_name.get(uid)
        if name is None:
            raise NoSuchUniqueId(self.kind, uid)
        return name

    def get_or_create_id(self, name: str) -> int:
        """(ref: UniqueId.java:596-625, getOrCreateId :865)"""
        with self._lock:
            uid = self._name_to_id.get(name)
            if uid is not None:
                return uid
            return self._assign_locked(name)

    def get_or_create_ids(self, names: Iterable[str]) -> list[int]:
        """Bulk :meth:`get_or_create_id` under one lock take; new ids
        are assigned in the order the names first appear."""
        out = []
        with self._lock:
            get = self._name_to_id.get
            for name in names:
                uid = get(name)
                out.append(uid if uid is not None
                           else self._assign_locked(name))
        return out

    def assign_id(self, name: str) -> int:
        """Explicit assignment (``/api/uid/assign``, ``tsdb mkmetric``):
        fails when the name already has a UID (ref: UniqueId.assign_id)."""
        with self._lock:
            if name in self._name_to_id:
                raise FailedToAssignUniqueIdError(
                    f"Name already exists with UID: "
                    f"{self.int_to_uid(self._name_to_id[name]).hex()}")
            return self._assign_locked(name)

    def items(self) -> list[tuple[str, int]]:
        """(name, UID) pairs in assignment order."""
        with self._lock:
            return list(self._name_to_id.items())

    def max_id(self) -> int:
        with self._lock:
            return self._max_id

    def load(self, name_to_id: dict[str, int], max_id: int) -> None:
        """Replace the table with a snapshot's (core/persist.py)."""
        with self._lock:
            self._name_to_id = dict(name_to_id)
            self._id_to_name = {i: n for n, i in name_to_id.items()}
            self._max_id = max_id
            self._sorted_names = None

    def _assign_locked(self, name: str) -> int:
        if self.random_ids:
            # ref: RandomUniqueId.java, a random id, retried on a
            # collision
            for _ in range(10):
                cand = self._rng.randint(1, self.max_possible_id)
                if cand not in self._id_to_name:
                    uid = cand
                    break
                self.random_id_collisions += 1
            else:
                raise FailedToAssignUniqueIdError(
                    f"could not find a free random UID for '{name}'")
        else:
            if self._max_id >= self.max_possible_id:
                raise FailedToAssignUniqueIdError(
                    f"all {self.max_possible_id} UIDs of kind "
                    f"{self.kind} are assigned")
            self._max_id += 1
            uid = self._max_id
        self._sorted_names = None
        self._name_to_id[name] = uid
        self._id_to_name[uid] = name
        return uid

    def suggest(self, search: str, max_results: int = 25) -> list[str]:
        """Names starting with ``search``, sorted, at most
        ``max_results`` of them (ref: UniqueId.suggest, a prefix scan
        of the sorted name column family)."""
        with self._lock:
            names = self._sorted_names
            if names is None:
                names = self._sorted_names = sorted(self._name_to_id)
            lo = bisect.bisect_left(names, search)
            out = []
            for n in names[lo:lo + max_results]:
                if not n.startswith(search):
                    break
                out.append(n)
        return out

    def collect_stats(self, collector) -> None:
        """(ref: UniqueId cache-size / ids-used / ids-available)"""
        with self._lock:
            size, used = len(self._name_to_id), self._max_id
        collector.record("uid.random-id-collisions",
                         self.random_id_collisions, kind=self.kind)
        collector.record("uid.cache-size", size, kind=self.kind)
        collector.record("uid.ids-used", used, kind=self.kind)
        collector.record("uid.ids-available",
                         self.max_possible_id - used, kind=self.kind)

    def int_to_uid(self, uid: int) -> bytes:
        return uid.to_bytes(self.width, "big")


class UidRegistry:
    """The three UID dictionaries owned by a TSDB (ref: TSDB.java:125-129)."""

    def __init__(self, metric_width: int = const.METRICS_WIDTH,
                 tagk_width: int = const.TAG_NAME_WIDTH,
                 tagv_width: int = const.TAG_VALUE_WIDTH,
                 random_metrics: bool = False):
        self.metrics = UniqueId("metric", metric_width,
                                random_ids=random_metrics)
        self.tag_names = UniqueId("tagk", tagk_width)
        self.tag_values = UniqueId("tagv", tagv_width)

    def by_kind(self, kind: str) -> UniqueId:
        if kind in ("metric", "metrics"):
            return self.metrics
        if kind == "tagk":
            return self.tag_names
        if kind == "tagv":
            return self.tag_values
        raise ValueError(f"unknown UID kind {kind!r}")

    def tsuid(self, metric_id: int, tags: Iterable[tuple[int, int]]) -> bytes:
        """TSUID bytes = metric uid + (tagk uid + tagv uid) sorted by tagk."""
        out = bytearray(self.metrics.int_to_uid(metric_id))
        for tagk_id, tagv_id in sorted(tags):
            out += self.tag_names.int_to_uid(tagk_id)
            out += self.tag_values.int_to_uid(tagv_id)
        return bytes(out)
