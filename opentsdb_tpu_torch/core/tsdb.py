"""The TSDB facade (ref: ``src/core/TSDB.java:87``).

Owns the UID registry and the store, and is where a caller picks the
device: ``tsd.torch.device`` is ``"cuda"`` unless the caller asks for
``"cpu"``, and constructing a TSDB on ``cuda`` raises when no card is
present. Writes go to the in-memory store only: this port has no
write-ahead log yet, so nothing written survives the process.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.store import TimeSeriesStore, pad_mask
from opentsdb_tpu_torch.core.uid import UidRegistry
from opentsdb_tpu_torch.utils.config import Config

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(config: Config) -> torch.device:
    """The compute device named by ``tsd.torch.device``; raises when it
    is ``cuda`` and no card is present (there is no silent CPU
    fallback)."""
    dev = torch.device(config.get_string("tsd.torch.device"))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported tsd.torch.device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tsd.torch.device is 'cuda' but no CUDA device is "
            "available; set tsd.torch.device=cpu to run on the CPU")
    return dev


def resolve_dtype(config: Config) -> torch.dtype:
    name = config.get_string("tsd.torch.dtype")
    if name not in _DTYPES:
        raise ValueError(f"unsupported tsd.torch.dtype {name!r}")
    return _DTYPES[name]


def normalize_timestamps(ts) -> np.ndarray:
    """Validate unix timestamps (seconds or ms) and return int64 ms
    (ref: TSDB.java:1274 checkTimestampAndTags; a value at or above
    2^32 is already in milliseconds)."""
    ts = np.asarray(ts, dtype=np.int64)
    if len(ts) == 0:
        raise ValueError("empty point batch")
    if int(ts.min()) <= 0:
        raise ValueError(f"invalid timestamp {int(ts.min())}")
    is_ms = ts >= (1 << 32)
    if int(ts[is_ms].max(initial=0)) > (1 << 47):
        raise ValueError("timestamp out of range")
    return np.where(is_ms, ts, ts * 1000)


class TSDB:
    """(ref: src/core/TSDB.java:87)"""

    def __init__(self, config: Config | None = None):
        self.config = config or Config()
        self.device = resolve_device(self.config)
        self.dtype = resolve_dtype(self.config)
        self.uids = UidRegistry(
            metric_width=self.config.get_int(
                "tsd.storage.uid.width.metric"),
            tagk_width=self.config.get_int("tsd.storage.uid.width.tagk"),
            tagv_width=self.config.get_int("tsd.storage.uid.width.tagv"))
        self.store = TimeSeriesStore()
        self.mode = self.config.get_string("tsd.mode")
        self.auto_metric = self.config.get_bool(
            "tsd.core.auto_create_metrics")
        self.auto_tagk = self.config.get_bool("tsd.core.auto_create_tagks")
        self.auto_tagv = self.config.get_bool("tsd.core.auto_create_tagvs")
        self.datapoints_added = 0

    # -- write path -------------------------------------------------------

    def _resolve_uids(self, metric: str,
                      tags_list: Sequence[dict[str, str]]
                      ) -> tuple[int, list[list[tuple[int, int]]]]:
        """UIDs of one metric and of many series' tags. New names are
        assigned in the order a per-point write would meet them
        (series order, then each series' tag order)."""
        def ids(registry, names, auto):
            return (registry.get_or_create_ids(names) if auto
                    else [registry.get_id(n) for n in names])

        metric_id = ids(self.uids.metrics, [metric], self.auto_metric)[0]
        keys = [k for tags in tags_list for k in tags]
        vals = [v for tags in tags_list for v in tags.values()]
        kids = ids(self.uids.tag_names, keys, self.auto_tagk)
        vids = ids(self.uids.tag_values, vals, self.auto_tagv)
        pairs = list(zip(kids, vids))
        out, pos = [], 0
        for tags in tags_list:
            out.append(pairs[pos:pos + len(tags)])
            pos += len(tags)
        return metric_id, out

    def _check_writable(self) -> None:
        if self.mode == "ro":
            raise PermissionError("TSD is in read-only mode")

    def add_point(self, metric: str, timestamp: int, value: int | float,
                  tags: dict[str, str]) -> int:
        """Write one datapoint; returns the series id
        (ref: TSDB.addPoint :1012/:1057/:1097)."""
        return self.add_points(metric, [timestamp], [float(value)], tags)

    def add_points(self, metric: str, timestamps, values,
                   tags: dict[str, str]) -> int:
        """Bulk write many points of ONE series; returns the series id.
        The whole batch is validated before anything is written."""
        self._check_writable()
        vals = np.asarray(values, dtype=np.float64)
        if np.shape(timestamps) != vals.shape or vals.ndim != 1:
            raise ValueError("timestamps/values must be equal-length 1-D")
        ts_ms = normalize_timestamps(timestamps)
        tags_mod.check_metric_and_tags(metric, tags)
        metric_id, (tag_ids,) = self._resolve_uids(metric, [tags])
        sid = self.store.get_or_create_series(metric_id, tag_ids)
        self.store.append_many(sid, ts_ms, vals)
        self.datapoints_added += len(ts_ms)
        return sid

    def add_point_groups(self, groups, on_error=None
                         ) -> tuple[int, list[str]]:
        """Columnar bulk write of points already grouped by series:
        ``groups`` yields ``(metric, tags, refs, timestamps, values)``
        where ``refs[i]`` is an opaque per-point handle handed back to
        ``on_error(ref, exc)`` for failing points. A group whose bulk
        write fails replays per point, so every valid point lands and
        errors stay per-point (ref: TSDB.add_point_groups)."""
        errors: list[str] = []
        written = 0
        for metric, tags, refs, ts_list, raw in groups:
            try:
                self.add_points(metric, ts_list, raw, tags)
                written += len(ts_list)
            except (ValueError, TypeError, LookupError, PermissionError):
                for j in range(len(ts_list)):
                    try:
                        self.add_point(metric, ts_list[j], raw[j], tags)
                        written += 1
                    except (ValueError, TypeError, LookupError,
                            PermissionError) as e:
                        errors.append(f"{metric} @{ts_list[j]}: {e}")
                        if on_error is not None:
                            on_error(refs[j], e)
        return written, errors

    def add_series_points(self, metric: str,
                          tags_list: Sequence[dict[str, str]],
                          ts2d: np.ndarray, values2d: np.ndarray,
                          counts: np.ndarray | None = None
                          ) -> np.ndarray:
        """Columnar bulk write of many series of one metric: row i of
        ``ts2d``/``values2d`` (its first ``counts[i]`` cells, or all of
        them) goes to the series tagged ``tags_list[i]``. Each distinct
        tag string is validated once, UIDs resolve in one pass, and the
        store takes one append. Returns the series ids."""
        self._check_writable()
        ts2d = np.asarray(ts2d, dtype=np.int64)
        values2d = np.asarray(values2d, dtype=np.float64)
        if ts2d.shape != values2d.shape or ts2d.ndim != 2 \
                or len(tags_list) != ts2d.shape[0]:
            raise ValueError("ts2d/values2d must be [S, P] with one "
                             "tag set per row")
        tags_mod.validate_string("metric name", metric)
        names: dict[str, set] = {"tag name": set(), "tag value": set()}
        for tags in tags_list:
            tags_mod.check_tag_count(metric, tags)
            names["tag name"].update(tags)
            names["tag value"].update(tags.values())
        for what, distinct in names.items():
            for s in distinct:
                tags_mod.validate_string(what, s)
        if counts is None:
            sids_rows, ts_flat, val_flat = None, ts2d.reshape(-1), \
                values2d.reshape(-1)
        else:
            present = ~pad_mask(np.asarray(counts, dtype=np.int64),
                                ts2d.shape[1])
            ts_flat, val_flat = ts2d[present], values2d[present]
            sids_rows = present
        ts_ms = normalize_timestamps(ts_flat)
        metric_id, tag_ids = self._resolve_uids(metric, tags_list)
        sids = self.store.get_or_create_series_bulk(metric_id, tag_ids)
        if sids_rows is None:
            point_sids = np.repeat(sids, ts2d.shape[1])
        else:
            point_sids = np.broadcast_to(sids[:, None],
                                         ts2d.shape)[sids_rows]
        self.store.append_lines(point_sids, ts_ms, val_flat)
        self.datapoints_added += len(ts_ms)
        return sids

    # -- query path -------------------------------------------------------

    def new_query(self):
        from opentsdb_tpu_torch.query.engine import QueryEngine
        return QueryEngine(self)

    def execute_query(self, ts_query) -> list:
        """Run a validated TSQuery end-to-end, returning result groups
        (the call the reference's ``/api/query`` handler makes)."""
        return self.new_query().run(ts_query)
