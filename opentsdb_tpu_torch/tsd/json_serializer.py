"""HTTP JSON serializer (ref: ``src/tsd/HttpJsonSerializer.java``).

The default wire format. Query results are arrays of
``{metric, tags, aggregateTags, dps, ...}`` with ``dps`` keyed by
epoch-seconds strings (or ms when msResolution), errors wrap in
``{"error": {code, message, details}}``, put responses report
``{success, failed, errors[]}``.

Results of at least ``_NATIVE_FMT_MIN_DPS`` points format their
``dps`` straight from the engine's numpy columns: through the native
store library's formatter (``native.store_backend.format_dps``) when
the TSDB's backend is native and the library formats doubles through
``std::to_chars``, as the reference does, else through
:func:`format_dps_columnar`; smaller ones take the per-point path. The
choice is made once, from the backend (:meth:`HttpJsonSerializer.
for_tsdb`). The columnar and per-point paths emit Python's ``repr``
of each float; the native formatter emits the shortest of its fixed and
exponent forms (``1e-04`` for ``0.0001``, ``12345678901234568.0`` for
``1.2345678901234568e+16``), the same double, and the reference's bytes.
A result's annotations ride its head as ``annotations`` (unless the
query asks ``noAnnotations``) and ``globalAnnotations`` (when it asks
for them), as the reference writes them.
"""

from __future__ import annotations

import base64
import json
import math
from typing import Any

import numpy as np

from opentsdb_tpu_torch.native.store_backend import (format_dps,
                                                     format_dps_is_fast)


class HttpSerializer:
    """Serializer ABI (ref: HttpSerializer.java:93). Content
    negotiation keys off :attr:`shortname` in the request
    (``/api/query?serializer=<shortname>``)."""

    shortname = "json"
    request_content_type = "application/json"
    response_content_type = "application/json; charset=UTF-8"

    def parse_put(self, body: bytes) -> list[dict[str, Any]]:
        raise NotImplementedError

    def parse_query(self, body: bytes) -> dict[str, Any]:
        raise NotImplementedError

    def format_query(self, ts_query, results) -> bytes:
        raise NotImplementedError

    def format_error(self, code: int, message: str,
                     details: str = "") -> bytes:
        raise NotImplementedError


def _format_value(v: float):
    """The reference's number emission: NaN/Inf literal strings,
    integral floats written as ints. Integral floats at or beyond 2^53
    stay floats: a double that large no longer tells adjacent integers
    apart, so bare integer digits would claim a precision the stored
    value does not carry."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return int(v)
    return v


def format_dps_columnar(ts_arr, vals, seconds: bool,
                        as_arrays: bool) -> bytes:
    """Format one series' dps from its numpy columns: comma-joined
    entries without the surrounding braces (the caller owns the
    envelope and, for the map form, the same-second dedupe).

    Every per-point step is a C-driven map: ``repr`` over the float
    list (json emits floats through the same ``float.__repr__``, so
    the bytes match :func:`_format_value`'s), one ``str.format`` map
    and one join, with the rare specials and integral values patched
    by index afterwards. Quoted NaN/Infinity literals, integral floats
    as ints below 2^53, floats at or after it."""
    t = ts_arr // 1000 if seconds else ts_arr
    finite = np.isfinite(vals)
    integral = finite & (np.abs(vals) < 2**53) \
        & (vals == np.floor(np.where(finite, vals, 0.0)))
    if integral.all():
        # an all-integral column (count queries): one vectorized cast
        vtxt = list(map(repr, vals.astype(np.int64).tolist()))
    else:
        vtxt = list(map(repr, vals.tolist()))
        if integral.any():
            idx = np.nonzero(integral)[0]
            for i, iv in zip(idx.tolist(),
                             vals[idx].astype(np.int64).tolist()):
                vtxt[i] = repr(iv)
        if not finite.all():
            for i in np.nonzero(np.isnan(vals))[0].tolist():
                vtxt[i] = '"NaN"'
            for i in np.nonzero(vals == np.inf)[0].tolist():
                vtxt[i] = '"Infinity"'
            for i in np.nonzero(vals == -np.inf)[0].tolist():
                vtxt[i] = '"-Infinity"'
    shape = "[{},{}]" if as_arrays else '"{}":{}'
    return ",".join(map(shape.format, t.tolist(), vtxt)).encode()


def _dedupe_seconds(ts_arr, vals):
    """Map-form output keyed on seconds collapses ms points that floor
    to the same second, the last one winning (the per-point dict's
    behaviour)."""
    secs = ts_arr // 1000
    if len(np.unique(secs)) == len(secs):
        return ts_arr, vals
    keep = np.empty(len(secs), dtype=bool)
    keep[:-1] = secs[1:] != secs[:-1]
    keep[-1] = True
    return ts_arr[keep], vals[keep]


class HttpJsonSerializer(HttpSerializer):
    """(ref: HttpJsonSerializer.java:69)"""

    # results with at least this many points take the bulk formatter
    # (the reference's crossover for its native path)
    _NATIVE_FMT_MIN_DPS = 8
    # dps entries per streamed chunk: bounds the largest in-memory piece
    # even when one aggregated series carries millions of points
    _STREAM_SLAB_DPS = 50_000

    def __init__(self, format_dps=None):
        # the bulk dps formatter: format_dps_columnar's signature
        self._format_dps = format_dps or format_dps_columnar

    @classmethod
    def for_tsdb(cls, tsdb) -> "HttpJsonSerializer":
        """The serializer of ``tsdb``'s front end: the native formatter
        when the TSDB's store is native and the library formats doubles
        through ``std::to_chars`` (ref: ``_native_fmt``), else the
        columnar one."""
        if tsdb.store.backend == "native" and format_dps_is_fast():
            return cls(format_dps)
        return cls()

    def parse_put(self, body: bytes) -> list[dict[str, Any]]:
        """One datapoint object or an array of them (ref: parsePutV1)."""
        if not body:
            raise ValueError("Missing request content")
        data = json.loads(body)
        if isinstance(data, dict):
            return [data]
        if isinstance(data, list):
            return data
        raise ValueError("Invalid datapoint content")

    def parse_query(self, body: bytes) -> dict[str, Any]:
        if not body:
            raise ValueError("Missing request content")
        data = json.loads(body)
        if not isinstance(data, dict):
            raise ValueError("Invalid query content")
        return data

    def _result_head(self, ts_query, r) -> bytes:
        """Everything before "dps", serialized; ends with ``b'}'``."""
        notes = not ts_query.no_annotations and r.annotations
        global_notes = ts_query.global_annotations and r.global_annotations
        if not (ts_query.show_query or r.tsuids or notes or global_notes
                or r.sketches):
            # the common head: metric and tag names pass
            # tags.validate_string, so no JSON escaping is needed and
            # one f-string beats json.dumps per group
            strings = [r.metric, *r.tags.keys(), *r.tags.values(),
                       *r.aggregated_tags]
            if all(s.isascii() and '"' not in s and "\\" not in s
                   and s.isprintable() for s in strings):
                tags = ",".join(f'"{k}":"{v}"'
                                for k, v in r.tags.items())
                aggs = ",".join(f'"{a}"' for a in r.aggregated_tags)
                return (f'{{"metric":"{r.metric}","tags":{{{tags}}},'
                        f'"aggregateTags":[{aggs}]}}').encode()
        obj: dict[str, Any] = {
            "metric": r.metric,
            "tags": r.tags,
            "aggregateTags": r.aggregated_tags,
        }
        if ts_query.show_query:
            obj["query"] = ts_query.queries[r.sub_query_index].to_json()
        if r.tsuids:
            obj["tsuids"] = r.tsuids
        if notes:
            obj["annotations"] = [a.to_json() for a in r.annotations]
        if global_notes:
            obj["globalAnnotations"] = [a.to_json()
                                        for a in r.global_annotations]
        if r.sketches:
            # a shard's sketch partials for a cluster router: the
            # serialized per-bucket sketches ride next to the (empty)
            # dps, so the router merges them exactly (ref)
            obj["sketchDps"] = [
                [int(t), base64.b64encode(b).decode("ascii")]
                for t, b in r.sketches]
        return self._dump(obj)

    def _bulk_columns(self, r, ms: bool, as_arrays: bool):
        """The result's columns for the bulk formatter, same-second
        deduped for the seconds map form; None below the bulk size."""
        if r.num_dps < self._NATIVE_FMT_MIN_DPS:
            return None
        ts_arr, vals = r.dps_arrays
        if not as_arrays and not ms:
            ts_arr, vals = _dedupe_seconds(ts_arr, vals)
        return ts_arr, vals

    def _dps_body(self, r, ms: bool, as_arrays: bool) -> bytes:
        """The dps map or array body."""
        cols = self._bulk_columns(r, ms, as_arrays)
        if cols is not None:
            inner = self._format_dps(*cols, not ms, as_arrays)
            return (b"[" + inner + b"]") if as_arrays else \
                (b"{" + inner + b"}")
        if as_arrays:
            dps: Any = [[ts if ms else ts // 1000, _format_value(v)]
                        for ts, v in r.dps]
        else:
            dps = {str(ts if ms else ts // 1000): _format_value(v)
                   for ts, v in r.dps}
        return self._dump(dps)

    def format_query(self, ts_query, results: list,
                     as_arrays: bool = False,
                     show_summary: bool = False,
                     show_stats: bool = False,
                     summary_extra: dict | None = None,
                     degraded_shards: list | None = None) -> bytes:
        """(ref: formatQueryAsyncV1) ``dps`` as {ts: value} maps, or
        [[ts, value], ...] when the ``arrays`` query param is set.
        ``degraded_shards`` names the cluster shards that could not
        contribute: the 200 is a partial, marked by a trailing
        ``{"shardsDegraded": [...]}`` row (ref)."""
        ms = ts_query.ms_resolution
        pieces = []
        # showStats: a per-result "stats" map (ref:
        # formatQueryAsyncV1wStats), plus the trailing statsSummary row
        stats_blob = (b',"stats":' + self._dump(summary_extra or {})
                      if show_stats else b"")
        for r in results:
            head = self._result_head(ts_query, r)
            pieces.append(head[:-1] + stats_blob + b',"dps":'
                          + self._dps_body(r, ms, as_arrays) + b"}")
        if show_summary:
            # the trailing summary row only for showSummary (ref:
            # formatQueryAsyncV1wStatsWoSummary has row stats, no tail)
            pieces.append(self._dump(
                {"statsSummary": summary_extra or {}}))
        if degraded_shards:
            pieces.append(self._dump(
                {"shardsDegraded": sorted(degraded_shards)}))
        return b"[" + b",".join(pieces) + b"]"

    def stream_query(self, ts_query, results: list,
                     as_arrays: bool = False):
        """Generator twin of :meth:`format_query` without the summary
        and stats rows: yields bounded chunks (slicing within a
        series' dps) so a very large response streams through chunked
        transfer encoding instead of being built whole (ref:
        formatQueryAsyncV1's incremental channel writes). The bytes are
        :meth:`format_query`'s."""
        ms = ts_query.ms_resolution
        open_c, close_c = (b"[", b"]") if as_arrays else (b"{", b"}")
        yield b"["
        for ri, r in enumerate(results):
            head = self._result_head(ts_query, r)
            yield (b"," if ri else b"") + head[:-1] + b',"dps":' + open_c
            cols = self._bulk_columns(r, ms, as_arrays)
            if cols is not None:
                ts_all, val_all = cols
                for lo in range(0, len(ts_all), self._STREAM_SLAB_DPS):
                    hi = lo + self._STREAM_SLAB_DPS
                    yield (b"" if lo == 0 else b",") + \
                        self._format_dps(ts_all[lo:hi], val_all[lo:hi],
                                         not ms, as_arrays)
            else:
                body = self._dps_body(r, ms, as_arrays)
                yield body[1:-1]
            yield close_c + b"}"
        yield b"]"

    def format_put(self, success: int, failed: int,
                   errors: list[dict] | None = None,
                   show_details: bool = False) -> bytes:
        obj: dict[str, Any] = {"success": success, "failed": failed}
        if show_details:
            obj["errors"] = errors or []
        return self._dump(obj)

    def format_error(self, code: int, message: str,
                     details: str = "") -> bytes:
        err: dict[str, Any] = {"code": code, "message": message}
        if details:
            err["details"] = details
        return self._dump({"error": err})

    def format_suggest(self, suggestions: list[str]) -> bytes:
        return self._dump(suggestions)

    def format_aggregators(self, aggs: list[str]) -> bytes:
        return self._dump(aggs)

    def format_version(self, version: dict[str, str]) -> bytes:
        return self._dump(version)

    def format_config(self, config: dict[str, str]) -> bytes:
        return self._dump(config)

    def format_dropcaches(self, response: dict[str, str]) -> bytes:
        return self._dump(response)

    def format_annotation(self, note) -> bytes:
        return self._dump(note.to_json())

    def format_annotations(self, notes: list) -> bytes:
        return self._dump([n.to_json() for n in notes])

    def format_uid_assign(self, response: dict) -> bytes:
        return self._dump(response)

    def format_stats(self, stats: list[dict]) -> bytes:
        return self._dump(stats)

    def format_query_stats(self, obj: dict) -> bytes:
        return self._dump(obj)

    def format_search(self, results: dict) -> bytes:
        return self._dump(results)

    def format_last_points(self, points: list[dict]) -> bytes:
        return self._dump(points)

    def _dump(self, obj: Any) -> bytes:
        return json.dumps(obj, separators=(",", ":")).encode("utf-8")
