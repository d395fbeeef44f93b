"""Annotations: notes on one series or global
(ref: ``src/meta/Annotation.java:79``; the JAX package's
``meta/annotation.py``).

The reference stores annotations as 0x01-prefixed cells in the data
table beside the points; here they live in a dict per TSUID keyed by
start time. Global annotations use the empty TSUID, as the reference's
empty row key does. With a WAL, every edit is logged (``T_ANNOT``,
``T_ANNOT_DEL``) and synced before it returns; snapshots hold them in
``annotations.json``. The store's ``version`` moves with every edit:
query results carry annotations, so the result cache keys on it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

GLOBAL_TSUID = ""


@dataclass
class Annotation:
    """(ref: Annotation.java:79) Times in seconds like the JSON API."""
    tsuid: str = GLOBAL_TSUID
    start_time: int = 0
    end_time: int = 0
    description: str = ""
    notes: str = ""
    custom: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "tsuid": self.tsuid,
            "description": self.description,
            "notes": self.notes,
            "custom": self.custom or None,
            "startTime": self.start_time,
            "endTime": self.end_time,
        }
        if not self.tsuid:
            out.pop("tsuid")
        return out

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "Annotation":
        def ts(key: str) -> int:
            v = obj.get(key, 0)
            if v is None:
                return 0
            if isinstance(v, bool) or not isinstance(v, (int, float,
                                                         str)):
                # a ValueError is the router's 400, a TypeError its 500
                raise ValueError(f"{key} must be a unix timestamp")
            return int(v)

        return cls(
            tsuid=str(obj.get("tsuid", "") or ""),
            start_time=ts("startTime"),
            end_time=ts("endTime"),
            description=str(obj.get("description", "") or ""),
            notes=str(obj.get("notes", "") or ""),
            custom=obj.get("custom") or {},
        )


class AnnotationStore:
    """CRUD and range scans (ref: Annotation.java:156-266,
    getGlobalAnnotations)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # tsuid -> {start_time_sec: Annotation}
        self._by_tsuid: dict[str, dict[int, Annotation]] = {}
        # set by the TSDB when a write-ahead log is open: edits are
        # durable before they return
        self.wal = None
        # moves with every edit (the result cache's version)
        self.version = 0

    def store(self, note: Annotation, _wal: bool = True) -> Annotation:
        if not note.start_time:
            raise ValueError("missing or invalid start time")
        with self._lock:
            self._by_tsuid.setdefault(note.tsuid, {})[note.start_time] = note
            self.version += 1
        if _wal and self.wal is not None:
            self.wal.log_annotation(note.to_json() | {"tsuid": note.tsuid})
            self.wal.sync()
        return note

    def has_any(self) -> bool:
        """Whether any annotation is stored: the query path skips the
        per-series lookups when none is."""
        with self._lock:
            return any(self._by_tsuid.values())

    def tsuids(self) -> list[str]:
        """The TSUIDs that hold a note; the global notes' empty TSUID
        is left out."""
        with self._lock:
            return [t for t, d in self._by_tsuid.items() if t and d]

    def get(self, tsuid: str, start_time: int) -> Annotation | None:
        with self._lock:
            return self._by_tsuid.get(tsuid, {}).get(start_time)

    def delete(self, tsuid: str, start_time: int,
               _wal: bool = True) -> bool:
        with self._lock:
            d = self._by_tsuid.get(tsuid, {})
            removed = d.pop(start_time, None) is not None
            if removed:
                self.version += 1
        if removed and _wal and self.wal is not None:
            self.wal.log_annotation_delete(tsuid, start_time)
            self.wal.sync()
        return removed

    def delete_range(self, tsuids: list[str] | None, start_sec: int,
                     end_sec: int) -> int:
        """Bulk delete (ref: AnnotationRpc bulk delete). ``tsuids=None``
        means global annotations only, matching the reference's
        global-flag semantics."""
        count = 0
        removed: list[tuple[str, int]] = []
        with self._lock:
            keys = tsuids if tsuids is not None else [GLOBAL_TSUID]
            for tsuid in keys:
                d = self._by_tsuid.get(tsuid)
                if not d:
                    continue
                doomed = [t for t in d if start_sec <= t <= end_sec]
                for t in doomed:
                    del d[t]
                    removed.append((tsuid, t))
                count += len(doomed)
            if count:
                self.version += 1
        if removed and self.wal is not None:
            for tsuid, t in removed:
                self.wal.log_annotation_delete(tsuid, t)
            self.wal.sync()
        return count

    def global_range(self, start_sec: int, end_sec: int) -> list[Annotation]:
        return self.range(GLOBAL_TSUID, start_sec, end_sec)

    def range(self, tsuid: str, start_sec: int, end_sec: int
              ) -> list[Annotation]:
        with self._lock:
            d = self._by_tsuid.get(tsuid, {})
            return [a for t, a in sorted(d.items())
                    if start_sec <= t <= end_sec]
