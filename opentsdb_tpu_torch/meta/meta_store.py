"""UIDMeta and TSMeta documents (ref: ``src/meta/UIDMeta.java:71``,
``src/meta/TSMeta.java:75``; the JAX package's ``meta/meta_store.py``).

With ``tsd.core.meta.enable_realtime_ts`` or ``enable_tsuid_tracking``
every write's hook (``TSDB._run_hook``) files its series' TSMeta, with
the UIDMeta of its names, at the series' first point, and counts its
points; ``enable_realtime_uid`` also hands new UIDMeta to the search
plugin. A new TSMeta goes through the trees when
``tsd.core.tree.enable_processing`` is set. ``/api/uid/uidmeta`` and
``/api/uid/tsmeta`` edit the documents; snapshots hold them in
``meta.json``.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any


@dataclass
class UIDMeta:
    """(ref: UIDMeta.java:71)"""
    uid: str = ""           # hex string form, like the JSON API
    type: str = ""          # METRIC | TAGK | TAGV
    name: str = ""
    display_name: str = ""
    description: str = ""
    notes: str = ""
    created: int = 0
    custom: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {
            "uid": self.uid, "type": self.type.upper(), "name": self.name,
            "displayName": self.display_name, "description": self.description,
            "notes": self.notes, "created": self.created,
            "custom": self.custom or None,
        }


@dataclass
class TSMeta:
    """(ref: TSMeta.java:75)"""
    tsuid: str = ""
    display_name: str = ""
    description: str = ""
    notes: str = ""
    created: int = 0
    custom: dict[str, str] = field(default_factory=dict)
    units: str = ""
    data_type: str = ""
    retention: int = 0
    max_value: float = float("nan")
    min_value: float = float("nan")
    last_received: int = 0
    total_dps: int = 0
    metric: UIDMeta | None = None
    tags: list[UIDMeta] = field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "tsuid": self.tsuid, "displayName": self.display_name,
            "description": self.description, "notes": self.notes,
            "created": self.created, "custom": self.custom or None,
            "units": self.units, "dataType": self.data_type,
            "retention": self.retention,
            "lastReceived": self.last_received,
            "totalDatapoints": self.total_dps,
        }
        if self.metric:
            out["metric"] = self.metric.to_json()
        if self.tags:
            out["tags"] = [t.to_json() for t in self.tags]
        return out


class MetaStore:
    """Realtime TSMeta/UIDMeta tracking (ref: TSDB.java:1225-1245)."""

    def __init__(self, tsdb) -> None:
        # weak: the TSDB holds this store, and a dropped TSDB must be
        # freed at once, not at the collector's next full pass
        self._tsdb_ref = weakref.ref(tsdb)
        cfg = tsdb.config
        self.track_ts = (cfg.get_bool("tsd.core.meta.enable_realtime_ts")
                         or cfg.get_bool(
                             "tsd.core.meta.enable_tsuid_tracking"))
        self.track_uid = cfg.get_bool("tsd.core.meta.enable_realtime_uid")
        self._lock = threading.Lock()
        self.ts_meta: dict[str, TSMeta] = {}
        self.uid_meta: dict[tuple[str, str], UIDMeta] = {}
        self.ts_counters: dict[str, int] = {}

    @property
    def _tsdb(self):
        return self._tsdb_ref()

    def _check_fault(self) -> None:
        """``meta.store`` fault-injection site: every meta WRITE path
        runs it (realtime tracking + the HTTP sync edits). Ingest is
        insulated by the TSDB hook guard — an armed meta fault counts
        a hook error and the point write still acknowledges."""
        faults = getattr(self._tsdb, "faults", None)
        if faults is not None:
            faults.check("meta.store")

    def on_datapoint(self, metric_id: int, tag_ids, series_id: int,
                     count: int = 1) -> None:
        """Realtime TSMeta tracking; ``count`` lets the bulk write path
        account a whole per-series batch in one call. A newly-created
        TSMeta is also filed through the realtime tree processor when
        ``tsd.core.tree.enable_processing`` is set (ref:
        TSDB.processTSMetaThroughTrees :2033)."""
        if not self.track_ts:
            return
        self._check_fault()
        tsuid = self._tsdb.uids.tsuid(metric_id, tag_ids).hex().upper()
        now = int(time.time())
        created = False
        with self._lock:
            self.ts_counters[tsuid] = (self.ts_counters.get(tsuid, 0)
                                       + count)
            meta = self.ts_meta.get(tsuid)
            if meta is None:
                created = True
                meta = TSMeta(tsuid=tsuid, created=now)
                meta.metric = self._uid_meta_locked(
                    "metric", metric_id, now)
                for kid, vid in sorted(tag_ids):
                    meta.tags.append(self._uid_meta_locked("tagk", kid, now))
                    meta.tags.append(self._uid_meta_locked("tagv", vid, now))
                self.ts_meta[tsuid] = meta
                if self._tsdb.search_plugin is not None:
                    self._tsdb.search_plugin.index_ts_meta(meta)
            meta.last_received = now
            meta.total_dps = self.ts_counters[tsuid]
        if created and self._tsdb.config.get_bool(
                "tsd.core.tree.enable_processing"):
            # outside the meta lock (the tree manager has its own);
            # guarded so a tree failure can neither fail the write nor
            # unwind the meta update above
            from opentsdb_tpu_torch.tree.tree import tree_manager
            mgr = tree_manager(self._tsdb)
            uids = self._tsdb.uids
            tags = {uids.tag_names.get_name(k):
                    uids.tag_values.get_name(v)
                    for k, v in sorted(tag_ids)}
            self._tsdb._run_hook(
                "tree.rt", mgr.process_series, tsuid,
                uids.metrics.get_name(metric_id), tags)

    def _uid_meta_locked(self, kind: str, uid_int: int,
                         now: int) -> UIDMeta:
        registry = self._tsdb.uids.by_kind(kind)
        key = (kind, registry.int_to_uid(uid_int).hex().upper())
        meta = self.uid_meta.get(key)
        if meta is None:
            meta = UIDMeta(uid=key[1],
                           type={"metric": "METRIC", "tagk": "TAGK",
                                 "tagv": "TAGV"}[kind],
                           name=registry.get_name(uid_int), created=now)
            self.uid_meta[key] = meta
            if self.track_uid and self._tsdb.search_plugin is not None:
                self._tsdb.search_plugin.index_uid_meta(meta)
        return meta

    # -- editing RPC surface (ref: UniqueIdRpc.java:179-226,314;
    # merge-on-POST / replace-on-PUT via syncToStorage's overwrite
    # flag, TSMeta.java:222 / UIDMeta CAS sync) ----------------------

    # JSON field -> attribute, the reference's editable field set
    _UID_FIELDS = {"displayName": "display_name",
                   "description": "description", "notes": "notes",
                   "custom": "custom"}
    _TS_FIELDS = {"displayName": "display_name",
                  "description": "description", "notes": "notes",
                  "custom": "custom", "units": "units",
                  "dataType": "data_type", "retention": "retention",
                  "max": "max_value", "min": "min_value"}

    @staticmethod
    def _apply_fields(meta, fields: dict, field_map: dict,
                      overwrite: bool) -> bool:
        """POST merges only the provided fields; PUT resets every
        editable field then applies the provided ones (ref:
        syncToStorage(overwrite)). Returns True when anything
        changed."""

        def same(a, b) -> bool:
            if isinstance(a, float) and isinstance(b, float):
                return a == b or (a != a and b != b)  # NaN == NaN here
            return a == b

        changed = False
        defaults = {"custom": {}, "retention": 0,
                    "max_value": float("nan"),
                    "min_value": float("nan")}
        for json_key, attr in field_map.items():
            if json_key in fields:
                val = fields[json_key]
                if val is None:
                    val = defaults.get(attr, "")
                if attr == "retention":
                    val = int(val)
                elif attr in ("max_value", "min_value"):
                    val = float(val)
                elif attr == "custom":
                    val = dict(val or {})
            elif overwrite:
                val = defaults.get(attr, "")
            else:
                continue
            if not same(getattr(meta, attr), val):
                setattr(meta, attr, val)
                changed = True
        return changed

    class NotModified(Exception):
        """Raised when a sync carries no actual change (ref: the 304
        NOT_MODIFIED reply on IllegalStateException)."""

    def sync_uid_meta(self, kind: str, uid_hex: str, fields: dict,
                      overwrite: bool) -> UIDMeta:
        """Merge (POST) or replace (PUT) a UIDMeta document. The UID
        must exist in the UID table; a missing doc starts from the
        skeleton (ref: UIDMeta.getUIDMeta default docs)."""
        uid_hex = uid_hex.upper()
        self._check_fault()
        registry = self._tsdb.uids.by_kind(kind)
        name = registry.get_name(bytes.fromhex(uid_hex))  # may raise
        with self._lock:
            key = (kind, uid_hex)
            meta = self.uid_meta.get(key)
            if meta is None:
                meta = UIDMeta(uid=uid_hex,
                               type={"metric": "METRIC",
                                     "tagk": "TAGK",
                                     "tagv": "TAGV"}[kind],
                               name=name, created=int(time.time()))
                created = True
            else:
                created = False
            changed = self._apply_fields(meta, fields,
                                         self._UID_FIELDS, overwrite)
            if not changed and not created:
                raise MetaStore.NotModified()
            self.uid_meta[key] = meta
        if self._tsdb.search_plugin is not None:
            self._tsdb.search_plugin.index_uid_meta(meta)
        return meta

    def delete_uid_meta(self, kind: str, uid_hex: str) -> None:
        with self._lock:
            meta = self.uid_meta.pop((kind, uid_hex.upper()), None)
        if meta is not None and self._tsdb.search_plugin is not None:
            self._tsdb.search_plugin.delete_uid_meta(meta)

    def sync_ts_meta(self, tsuid: str, fields: dict, overwrite: bool,
                     create: bool = False) -> TSMeta:
        """Merge/replace a TSMeta document; ``create`` materializes a
        new doc for a known-but-untracked timeseries (ref: the
        create=true counter bootstrap in UniqueIdRpc tsmeta POST)."""
        tsuid = tsuid.upper()
        self._check_fault()
        with self._lock:
            meta = self.ts_meta.get(tsuid)
            created = False
            if meta is None:
                if not create:
                    raise LookupError(
                        f"Could not find Timeseries meta data "
                        f"for {tsuid}")
                meta = TSMeta(tsuid=tsuid, created=int(time.time()))
                self.ts_counters.setdefault(tsuid, 0)
                created = True
            changed = self._apply_fields(meta, fields, self._TS_FIELDS,
                                         overwrite)
            if not changed and not created:
                raise MetaStore.NotModified()
            self.ts_meta[tsuid] = meta
        if self._tsdb.search_plugin is not None:
            self._tsdb.search_plugin.index_ts_meta(meta)
        return meta

    def delete_ts_meta(self, tsuid: str) -> None:
        with self._lock:
            meta = self.ts_meta.pop(tsuid.upper(), None)
        if meta is not None and self._tsdb.search_plugin is not None:
            self._tsdb.search_plugin.delete_ts_meta(meta.tsuid)

    def get_ts_meta(self, tsuid: str) -> TSMeta | None:
        with self._lock:
            return self.ts_meta.get(tsuid.upper())

    def get_uid_meta(self, kind: str, uid_hex: str) -> UIDMeta | None:
        with self._lock:
            return self.uid_meta.get((kind, uid_hex.upper()))

    def all_ts_meta(self) -> list[TSMeta]:
        with self._lock:
            return list(self.ts_meta.values())

    def purge(self) -> tuple[int, int]:
        """Remove every TSMeta/UIDMeta doc and counter
        (ref: src/tools/MetaPurge.java — the `uid metapurge` path).
        Returns (n_tsmeta, n_uidmeta) purged."""
        with self._lock:
            n_ts, n_uid = len(self.ts_meta), len(self.uid_meta)
            self.ts_meta.clear()
            self.uid_meta.clear()
            self.ts_counters.clear()
        return n_ts, n_uid
