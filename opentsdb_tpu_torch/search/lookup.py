"""Series lookup and last data points (ref:
``src/search/TimeSeriesLookup.java:83`` behind ``/api/search/lookup``;
``src/meta/TSUIDQuery.java:51`` behind ``/api/query/last``; the JAX
package's ``search/lookup.py``).

The store's per-metric tag index answers both: its (series, tagk,
tagv) triples select the matching series of a metric in one numpy pass
(the reference walks the series one by one; the answers are the same,
in the same order), with no scan of the points. A series' last point is
the last of its sorted points (``series_points``).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from opentsdb_tpu_torch.core import tags as tags_mod


def _matching(store, metric_id: int, want) -> np.ndarray:
    """The series of ``metric_id`` that carry every ``(kid, vid)`` of
    ``want`` (None on a side matches any), in the index's order."""
    index = store.metric_index(metric_id)
    if index is None:
        return np.empty(0, dtype=np.int64)
    sids, triples = index.arrays()
    keep = np.ones(len(sids), dtype=bool)
    for kid, vid in want:
        if kid is None and vid is None:
            continue
        hit = np.ones(len(triples), dtype=bool)
        if kid is not None:
            hit &= triples[:, 1] == kid
        if vid is not None:
            hit &= triples[:, 2] == vid
        keep &= np.isin(sids, triples[hit, 0])
    return sids[keep]


def time_series_lookup(tsdb, metric: str, tags: list[tuple[str, str]],
                       limit: int = 25, use_meta: bool = False
                       ) -> dict[str, Any]:
    """(ref: TimeSeriesLookup.lookup) The series of ``metric`` (every
    metric for "" or "*") that carry each ``(tagk, tagv)`` pair, where
    "*" or "" on either side matches any; the first ``limit`` of them
    and how many there are."""
    uids = tsdb.uids
    results = []
    if metric and metric != "*":
        try:
            metric_ids = [uids.metrics.get_id(metric)]
        except LookupError:
            metric_ids = []
    else:
        metric_ids = tsdb.store.metric_ids()
    want: list[tuple[int | None, int | None]] = []
    for k, v in tags:
        try:
            kid = uids.tag_names.get_id(k) if k and k != "*" else None
            vid = uids.tag_values.get_id(v) if v and v != "*" else None
        except LookupError:
            return {"type": "LOOKUP", "metric": metric or "*",
                    "limit": limit, "time": 0, "results": [],
                    "totalResults": 0}
        want.append((kid, vid))
    total = 0
    for mid in metric_ids:
        matched = _matching(tsdb.store, mid, want)
        total += len(matched)
        for sid in matched[:max(0, limit - len(results))].tolist():
            rec = tsdb.store.series(sid)
            results.append({
                "tsuid": uids.tsuid(rec.metric_id, rec.tags).hex().upper(),
                "metric": uids.metrics.get_name(rec.metric_id),
                "tags": {uids.tag_names.get_name(k):
                         uids.tag_values.get_name(v) for k, v in rec.tags},
            })
    return {"type": "LOOKUP", "metric": metric or "*", "limit": limit,
            "time": 0, "results": results, "totalResults": total}


def last_data_points(tsdb, specs: list[dict], back_scan: int = 0,
                     resolve: bool = True) -> list[dict]:
    """(ref: TSUIDQuery.getLastPoint :161) The last point of each
    series a spec names, by ``tsuids`` or by ``metric`` (or ``uri``)
    with exact tags; ``back_scan`` hours bound how old a last point may
    be (0: any age)."""
    uids = tsdb.uids
    out = []
    min_ts = 0
    if back_scan > 0:
        min_ts = int((time.time() - back_scan * 3600) * 1000)
    for spec in specs:
        sids = []
        if spec.get("tsuids"):
            for tsuid in spec["tsuids"]:
                sid, _metric = sid_from_tsuid(tsdb, tsuid)
                if sid is not None:
                    sids.append(sid)
        else:
            m = spec.get("metric") or spec.get("uri") or ""
            metric, tag_map = tags_mod.parse_with_metric(m)
            try:
                mid = uids.metrics.get_id(metric)
            except LookupError:
                continue
            try:
                want = [(uids.tag_names.get_id(k), uids.tag_values.get_id(v))
                        for k, v in tag_map.items()]
            except LookupError:
                continue
            sids.extend(_matching(tsdb.store, mid, want).tolist())
        for sid in sids:
            rec = tsdb.store.series(sid)
            ts, vals, _ints = tsdb.store.series_points(sid)
            if len(ts) == 0 or int(ts[-1]) < min_ts:
                continue
            v = float(vals[-1])
            point: dict[str, Any] = {
                "timestamp": int(ts[-1]),
                "value": str(int(v)) if v.is_integer() else str(v),
                "tsuid": uids.tsuid(rec.metric_id,
                                    rec.tags).hex().upper(),
            }
            if resolve:
                point["metric"] = uids.metrics.get_name(rec.metric_id)
                point["tags"] = {uids.tag_names.get_name(k):
                                 uids.tag_values.get_name(v2)
                                 for k, v2 in rec.tags}
            out.append(point)
    return out


def sid_from_tsuid(tsdb, tsuid: str) -> tuple[int | None, str]:
    """The raw store's series id of a hex TSUID (None when it has no
    series) and its metric's name ("" when unknown)."""
    uids = tsdb.uids
    raw = bytes.fromhex(tsuid)
    mw, kw, vw = (uids.metrics.width, uids.tag_names.width,
                  uids.tag_values.width)
    mid = int.from_bytes(raw[:mw], "big")
    tags = []
    pos = mw
    while pos < len(raw):
        tags.append((int.from_bytes(raw[pos:pos + kw], "big"),
                     int.from_bytes(raw[pos + kw:pos + kw + vw], "big")))
        pos += kw + vw
    sid = tsdb.store._key_to_sid.get((mid, tuple(sorted(tags))))
    try:
        metric = uids.metrics.get_name(mid)
    except LookupError:
        metric = ""
    return sid, metric
