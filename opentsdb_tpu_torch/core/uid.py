"""UID service: bidirectional name <-> fixed-width-UID dictionary.

(ref: ``src/uid/UniqueId.java``) Monotonically increasing ids per kind,
width-limited, assignment-is-idempotent, on top of a process-local
dictionary guarded by a lock. id 0 is never assigned.
"""

from __future__ import annotations

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

    def __init__(self, kind: str, width: int = 3):
        if kind not in UID_KINDS:
            raise ValueError(f"unknown UID kind {kind!r}")
        if not 1 <= width <= 8:
            raise ValueError(f"invalid UID width {width}")
        self.kind = kind
        self.width = width
        self.max_possible_id = (1 << (8 * width)) - 1
        self._lock = threading.Lock()
        self._name_to_id: dict[str, int] = {}
        self._id_to_name: dict[int, str] = {}
        self._max_id = 0

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

    def _assign_locked(self, name: str) -> int:
        if self._max_id >= self.max_possible_id:
            raise FailedToAssignUniqueIdError(
                f"all {self.max_possible_id} UIDs of kind "
                f"{self.kind} are assigned")
        self._max_id += 1
        uid = self._max_id
        self._name_to_id[name] = uid
        self._id_to_name[uid] = name
        return uid

    def int_to_uid(self, uid: int) -> bytes:
        return uid.to_bytes(self.width, "big")


class UidRegistry:
    """The three UID dictionaries owned by a TSDB (ref: TSDB.java:125-129)."""

    def __init__(self, metric_width: int = const.METRICS_WIDTH,
                 tagk_width: int = const.TAG_NAME_WIDTH,
                 tagv_width: int = const.TAG_VALUE_WIDTH):
        self.metrics = UniqueId("metric", metric_width)
        self.tag_names = UniqueId("tagk", tagk_width)
        self.tag_values = UniqueId("tagv", tagv_width)

    def tsuid(self, metric_id: int, tags: Iterable[tuple[int, int]]) -> bytes:
        """TSUID bytes = metric uid + (tagk uid + tagv uid) sorted by tagk."""
        out = bytearray(self.metrics.int_to_uid(metric_id))
        for tagk_id, tagv_id in sorted(tags):
            out += self.tag_names.int_to_uid(tagk_id)
            out += self.tag_values.int_to_uid(tagv_id)
        return bytes(out)
