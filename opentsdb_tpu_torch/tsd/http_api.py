"""HTTP API of the TSD (ref: ``src/tsd/RpcManager.java:267-360`` routing
table and the individual ``*Rpc.java`` handlers).

Transport-independent: :class:`HttpRpcRouter` maps parsed requests to
responses; :mod:`opentsdb_tpu_torch.tsd.server` feeds it from asyncio
sockets and tests call it directly.

Endpoints (mode-gated rw/ro/wo as RpcManager :274-327): ``/api/put``,
``/api/rollup``, ``/api/histogram``,
``/api/query`` (GET URI form, POST JSON, ``arrays``, tsuids, pixel
budgets, ``delete`` under ``tsd.http.query.allow_delete``),
``/api/query/exp`` and ``/gexp`` (expressions,
``query/expression/``),
``/api/query/continuous`` (standing queries: register, list, inspect,
``/result``, ``/deltas``, the ``/stream`` of Server-Sent Events,
delete), ``/api/suggest``,
``/api/aggregators``, ``/api/config`` (+``/filters``),
``/api/dropcaches``, ``/api/serializers``, ``/api/version``,
``/api/stats`` (+``/query``, ``/jvm``, ``/threads``,
``/region_clients``), ``/diediedie``, and the legacy unversioned
aliases. Every other endpoint of the reference's surface needs a
subsystem the port does not have yet and answers a structured 501
naming the ROADMAP item that ports it (:data:`UNPORTED`); a path the
reference does not know answers 404.

Exceptions map to statuses as the reference's router does: 400 for bad
requests, 413 for a query over its limits, 503 with ``Retry-After`` for
a deliberate degraded refusal (``DegradedError``), 501 for what is not
ported, and 500 (with a stack trace only under
``tsd.http.show_stack_trace``) for anything else, a device error
included. Nothing here retries a failed query on another device.
"""

from __future__ import annotations

import base64
import json
import platform
import re
import resource
import threading
import time
import traceback
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from opentsdb_tpu_torch import __version__
from opentsdb_tpu_torch.core.tags import parse_put_value
from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query.limits import QueryLimitExceeded
from opentsdb_tpu_torch.query.model import (BadRequestError, TSQuery,
                                            effective_pixels,
                                            parse_uri_query)
from opentsdb_tpu_torch.stats.stats import QueryStat, QueryStats
from opentsdb_tpu_torch.streaming.sse import sse_stream
from opentsdb_tpu_torch.tsd.json_serializer import HttpJsonSerializer
from opentsdb_tpu_torch.utils.faults import DegradedError

# the ROADMAP Queue 1 item that ports what is left
_REST = "the rest, with no device compute"

# endpoint -> the ROADMAP Queue 1 item that ports it: /api/<name>, or
# "stats/<name>" and "query/<name>" for sub-endpoints, or "/<name>" for
# paths outside /api
UNPORTED: dict[str, tuple[str, str]] = {
    "query/last": (_REST, "meta/ (last data points)"),
    "search": (_REST, "search/"),
    "uid": (_REST, "meta/ (UID assign, rename, UID and TS meta)"),
    "annotation": (_REST, "meta/ (annotations)"),
    "annotations": (_REST, "meta/ (annotations)"),
    "tree": (_REST, "tree/"),
    "health": (_REST, "obs/ (health)"),
    "trace": (_REST, "obs/ (request tracing)"),
    "profile": (_REST, "obs/ (sampling profiler)"),
    "cluster": (_REST, "cluster/"),
    "control": (_REST, "control/"),
    "lifecycle": (_REST, "lifecycle/ and coldstore/"),
    "stats/raw": (_REST, "obs/ (raw histogram snapshots)"),
    "stats/fleet": (_REST, "cluster/ (fleet stats)"),
    "stats/query_shapes": (_REST, "obs/ (query-shape log)"),
    "stats/tenants": (_REST, "control/ (tenant QoS)"),
    "/q": (_REST, "tsd/graph.py (graphs)"),
    "/s": (_REST, "static files"),
    "/metrics": (_REST, "obs/ (OpenMetrics exposition)"),
    "/logs": (_REST, "the /logs ring buffer"),
    "/plugin": (_REST, "plugins"),
}


def _not_ported(endpoint: str) -> NotImplementedError:
    item, what = UNPORTED[endpoint]
    path = endpoint if endpoint.startswith("/") else f"/api/{endpoint}"
    return NotImplementedError(
        f"{path} is not ported yet: it needs {what} "
        f"(ROADMAP Queue 1, {item})")


@dataclass
class HttpRequest:
    method: str
    path: str
    params: dict[str, list[str]] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    remote: str = ""
    serializer: Any = None  # set by the router (?serializer= choice)

    def param(self, key: str, default: str | None = None) -> str | None:
        vals = self.params.get(key)
        return vals[0] if vals else default

    def has_param(self, key: str) -> bool:
        return key in self.params

    def flag(self, key: str) -> bool:
        """true when ?key or ?key=true (ref: HttpQuery.parseBoolean)."""
        if key not in self.params:
            return False
        v = self.params[key][0]
        return v in ("", "true", "1", "yes")

    def json_object(self, default: dict | None = None) -> dict:
        """The body as a JSON object; anything else, valid-JSON scalars
        included, is a clean 400 (ref: the reference wraps every body
        parse failure in BadRequestException)."""
        if not self.body:
            if default is not None:
                return default
            raise BadRequestError("Missing request content")
        try:
            obj = json.loads(self.body)
        except Exception as exc:  # noqa: BLE001 - any parse error is a 400
            raise BadRequestError(
                f"Unable to parse JSON body: {exc}") from None
        if not isinstance(obj, dict):
            raise BadRequestError(
                f"Request body must be a JSON object, got "
                f"{type(obj).__name__}")
        return obj


def as_int(value, name: str, default: int = 0) -> int:
    """Coerce a JSON/query value to int with a clean 400: bare
    ``int()`` raises TypeError on null/list/bool inputs, which the
    router would answer with a 500."""
    if value is None:
        return default
    if isinstance(value, bool):
        raise BadRequestError(f"{name} must be an integer")
    try:
        return int(value)
    except (TypeError, ValueError):
        raise BadRequestError(f"{name} must be an integer") from None


@dataclass
class HttpResponse:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=UTF-8"
    headers: dict[str, str] = field(default_factory=dict)
    # generator of bytes chunks: set for very large responses, which
    # the server streams with Transfer-Encoding: chunked (ref:
    # formatQueryAsyncV1 writing the response incrementally)
    body_iter: Any = None
    # force Connection: close after this response (diediedie must not
    # leave a keep-alive handler pinning the server's shutdown)
    close_connection: bool = False


_DEFAULT_CONTENT_TYPE = HttpResponse.__dataclass_fields__[
    "content_type"].default


class HttpError(Exception):
    def __init__(self, status: int, message: str, details: str = ""):
        super().__init__(message)
        self.status = status
        self.message = message
        self.details = details


def version_info() -> dict[str, str]:
    """(ref: BuildData emitted by VersionRpc)"""
    return {
        "version": __version__,
        "short_revision": "torch",
        "full_revision": "opentsdb_tpu_torch",
        "timestamp": str(int(time.time())),
        "repo_status": "MODIFIED",
        "user": "tsd",
        "host": platform.node(),
        "repo": "opentsdb_tpu_torch",
    }


class HttpRpcRouter:
    """(ref: RpcManager + RpcHandler.java:46)"""

    _JSONP_RE = re.compile(r"^[A-Za-z_$][A-Za-z0-9_$.]*$")

    def __init__(self, tsdb):
        self.tsdb = tsdb
        self.serializer = HttpJsonSerializer.for_tsdb(tsdb)
        self.serializers: dict[str, Any] = {
            self.serializer.shortname: self.serializer}
        mode = tsdb.mode
        self._routes: dict[str, Callable] = {}
        # read RPCs (not registered in write-only mode, RpcManager:274)
        if mode in ("rw", "ro"):
            self._routes.update({
                "query": self._handle_query,
                "suggest": self._handle_suggest,
            })
        # write RPCs (not registered in read-only mode, RpcManager:327)
        if mode in ("rw", "wo"):
            self._routes["put"] = self._handle_put
            self._routes["rollup"] = self._handle_rollup
            self._routes["histogram"] = self._handle_histogram
        self._routes.update({
            "aggregators": self._handle_aggregators,
            "config": self._handle_config,
            "dropcaches": self._handle_dropcaches,
            "serializers": self._handle_serializers,
            "stats": self._handle_stats,
            "version": self._handle_version,
        })
        # the reference's mode gating holds for the unported endpoints
        # too: a route the mode would not register stays a 404
        read_only = {"search", "uid", "annotation", "annotations", "tree"}
        for name in UNPORTED:
            if "/" in name or (name in read_only and mode == "wo"):
                continue
            self._routes[name] = self._unported(name)
        # set by TSDServer so HTTP diediedie can request shutdown
        self.server = None
        self.start_time = time.time()

    @staticmethod
    def _unported(name: str) -> Callable:
        def handler(request: HttpRequest, rest) -> HttpResponse:
            raise _not_ported(name)
        return handler

    # ------------------------------------------------------------------

    def handle(self, request: HttpRequest) -> HttpResponse:
        return self._apply_jsonp(request, self._handle_inner(request))

    def _handle_inner(self, request: HttpRequest) -> HttpResponse:
        # content negotiation: ?serializer=<shortname> picks a
        # registered wire format (ref: HttpSerializer.java:93)
        request.serializer = self.serializer
        name = request.param("serializer")
        if name:
            chosen = self.serializers.get(name)
            if chosen is None:
                return HttpResponse(
                    400, self.serializer.format_error(
                        400, f"Unable to find serializer "
                        f"with name '{name}'"))
            request.serializer = chosen
        try:
            # GET-only verb override for clients that cannot send
            # PUT/DELETE, API calls only (ref: HttpQuery.getAPIMethod
            # :259-287)
            if request.method == "GET" and \
                    request.path.lstrip("/").startswith("api") and \
                    request.has_param("method_override"):
                override = (request.param("method_override")
                            or "").lower()
                if not override:
                    raise HttpError(405, "Missing method override value")
                if override not in ("get", "post", "put", "delete"):
                    raise HttpError(
                        405,
                        "Unknown or unsupported method override value")
                request.method = override.upper()
            resp = self._dispatch(request)
            if resp.content_type == _DEFAULT_CONTENT_TYPE:
                resp.content_type = \
                    request.serializer.response_content_type
            return resp
        except HttpError as e:
            return HttpResponse(e.status, request.serializer.format_error(
                e.status, e.message, e.details))
        except ValueError as e:   # BadRequestError included
            return HttpResponse(400, request.serializer.format_error(
                400, str(e)))
        except QueryLimitExceeded as e:
            # an over-budget scan is a condition the client can fix
            return HttpResponse(413, request.serializer.format_error(
                413, str(e)))
        except DegradedError as e:
            # a deliberate refusal of a degraded path (partials known to
            # be stale, an open breaker): 503 + Retry-After, never a 500
            resp = HttpResponse(503, request.serializer.format_error(
                503, str(e)))
            resp.headers["Retry-After"] = str(e.retry_after_s)
            return resp
        except NotImplementedError as e:
            return HttpResponse(501, request.serializer.format_error(
                501, str(e) or "not implemented"))
        except Exception as e:  # noqa: BLE001 (ref: RpcHandler 500 path)
            details = traceback.format_exc() if self.tsdb.config.get_bool(
                "tsd.http.show_stack_trace") else ""
            return HttpResponse(500, request.serializer.format_error(
                500, f"{type(e).__name__}: {e}", details))

    def _apply_jsonp(self, request: HttpRequest,
                     resp: HttpResponse) -> HttpResponse:
        """``?jsonp=cb`` wraps JSON bodies in ``cb(...)`` (ref:
        HttpQuery.serializeJSONP :647-658, errors included). Streamed
        responses are exempt."""
        cb = request.param("jsonp")
        if not cb or resp.body_iter is not None or not resp.body \
                or "json" not in (resp.content_type or ""):
            return resp
        if not self._JSONP_RE.fullmatch(cb):
            # a hostile callback name is script injection: drop it
            return resp
        resp.body = cb.encode() + b"(" + resp.body + b")"
        resp.content_type = "application/javascript; charset=UTF-8"
        return resp

    def _dispatch(self, request: HttpRequest) -> HttpResponse:
        path = urllib.parse.unquote(request.path.split("?", 1)[0])
        parts = [p for p in path.split("/") if p]
        if not parts:
            return self._homepage()
        # /api/[vN/]endpoint/...  (ref: HttpQuery.explodeAPIPath)
        if parts[0] == "api":
            parts = parts[1:]
            if parts and re.fullmatch(r"v[0-9]+", parts[0]):
                # only v1 exists (ref: HttpQuery.apiVersion rejects
                # versions above MAX_API_VERSION=1, HttpQuery.java:67)
                if int(parts[0][1:]) != 1:
                    raise HttpError(
                        400, f"Unsupported API version {parts[0]}",
                        "This TSD implements API v1")
                parts = parts[1:]
            if not parts:
                raise HttpError(400, "Missing API endpoint")
            endpoint, rest = parts[0], parts[1:]
        elif f"/{parts[0]}" in UNPORTED:
            raise _not_ported(f"/{parts[0]}")
        elif parts[0] == "favicon.ico":
            # (ref: the static favicon, else an empty 204)
            return HttpResponse(204)
        elif parts[0] == "diediedie":
            # graceful shutdown over HTTP (ref: RpcManager DieDieDie)
            if self.server is not None:
                self.server.request_shutdown()
                return HttpResponse(
                    200, b"<html><body>Cleanup complete, shutting down"
                    b"</body></html>", content_type="text/html",
                    close_connection=True)
            raise HttpError(404, "Endpoint not found: /diediedie",
                            "No server attached")
        elif parts[0] in ("aggregators", "version", "suggest", "stats",
                          "dropcaches"):
            # legacy unversioned aliases (ref: RpcManager deprecated map)
            endpoint, rest = parts[0], parts[1:]
        else:
            raise HttpError(404, f"Endpoint not found: /{parts[0]}",
                            "The requested endpoint was not found")
        handler = self._routes.get(endpoint)
        if handler is None:
            raise HttpError(404, f"Endpoint not found: /api/{endpoint}",
                            "The requested endpoint was not found")
        return handler(request, rest)

    # -- write path ----------------------------------------------------

    def _handle_put(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: PutDataPointRpc.java:272) Decode the body, validate and
        group it into per-series columns in one pass, then write the
        groups through ``TSDB.add_point_groups``: a bad point fails
        alone and the good points of the body land."""
        if request.method != "POST":
            raise HttpError(405, "Method not allowed",
                            "The HTTP method is not permitted")
        points = request.serializer.parse_put(request.body)
        details = request.flag("details")
        summary = request.flag("summary")
        errors: list[dict] = []
        groups: dict[tuple, tuple] = {}
        for dp in points:
            try:
                metric = dp["metric"]
                ts = int(dp["timestamp"])
                value = dp["value"]
                if isinstance(value, str):
                    # strict parse: int()/float() leniency would store
                    # e.g. "1_0" as 10 instead of failing
                    value = parse_put_value(value)
                elif value is None or isinstance(value, bool) or \
                        not isinstance(value, (int, float)):
                    # (ref: PutDataPointRpc rejects null/empty values
                    # per datapoint)
                    raise ValueError(f"invalid value: {value!r}")
                tags = dp.get("tags") or {}
                key = (metric, tuple(sorted(tags.items())))
                g = groups.get(key)
                if g is None:
                    g = groups[key] = (metric, tags, [], [], [])
                g[2].append(dp)
                g[3].append(ts)
                g[4].append(value)
            except (KeyError, TypeError) as e:
                errors.append({"datapoint": dp,
                               "error": f"missing field: {e}"})
            except ValueError as e:
                errors.append({"datapoint": dp, "error": str(e)})

        def on_error(dp: dict, e: Exception) -> None:
            errors.append({"datapoint": dp, "error": str(e)})

        success, _ = self.tsdb.add_point_groups(groups.values(),
                                                on_error=on_error)
        failed = len(errors)
        if not details and not summary:
            if failed:
                raise HttpError(
                    400, "One or more data points had errors",
                    f"{failed} error(s) storing datapoints")
            return HttpResponse(204)
        return HttpResponse(
            400 if failed else 200,
            request.serializer.format_put(success, failed, errors,
                                          details))

    def _handle_rollup(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: RollupDataPointRpc.java:227; ``_handle_rollup``) A put
        body whose points also carry ``interval`` and ``aggregator``
        (a tier point) or ``groupByAggregator`` (a pre-aggregate), each
        written by ``TSDB.add_aggregate_point``: a bad point fails alone.
        The body's WAL records commit as one write and one fsync."""
        if request.method != "POST":
            raise HttpError(405, "Method not allowed")
        points = request.serializer.parse_put(request.body)
        success = 0
        errors: list[dict] = []
        with self.tsdb._wal_scope():
            for dp in points:
                try:
                    value = dp["value"]
                    if isinstance(value, str):
                        value = float(parse_put_value(value,
                                                      allow_special=True))
                    self.tsdb.add_aggregate_point(
                        dp["metric"], int(dp["timestamp"]), value,
                        dp.get("tags") or {},
                        bool(dp.get("groupByAggregator")
                             or dp.get("isGroupBy")),
                        dp.get("interval"), dp.get("aggregator"),
                        dp.get("groupByAggregator"))
                    success += 1
                except Exception as e:  # noqa: BLE001 - a per-point error
                    errors.append({"datapoint": dp, "error": str(e)})
        if errors and not request.flag("details") \
                and not request.flag("summary"):
            raise HttpError(400, "One or more data points had errors",
                            "; ".join(e["error"] for e in errors[:5]))
        return HttpResponse(
            400 if errors else 200,
            request.serializer.format_put(success, len(errors), errors,
                                          request.flag("details")))

    def _handle_histogram(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: HistogramDataPointRpc.java; ``_handle_histogram``) A put
        body whose values are base64 codec blobs, written through
        ``TSDB.add_histogram_batch``: a bad point fails alone and the
        good points of the body land."""
        if request.method != "POST":
            raise HttpError(405, "Method not allowed")
        points = request.serializer.parse_put(request.body)
        errors: list[dict] = []
        parsed: list[tuple] = []
        dps: list[dict] = []
        for dp in points:
            try:
                parsed.append((dp["metric"], int(dp["timestamp"]),
                               base64.b64decode(dp["value"]),
                               dp.get("tags") or {}))
                dps.append(dp)
            except Exception as e:  # noqa: BLE001 - a per-point error
                errors.append({"datapoint": dp, "error": str(e)})

        def on_error(i: int, e: Exception) -> None:
            errors.append({"datapoint": dps[i], "error": str(e)})

        success, _ = self.tsdb.add_histogram_batch(parsed,
                                                   on_error=on_error)
        if errors and not request.flag("details") \
                and not request.flag("summary"):
            raise HttpError(400, "One or more data points had errors")
        return HttpResponse(
            400 if errors else 200,
            request.serializer.format_put(success, len(errors), errors,
                                          request.flag("details")))

    # -- read path -----------------------------------------------------

    def _handle_query(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: QueryRpc.java:89-128)"""
        sub = rest[0] if rest else ""
        if f"query/{sub}" in UNPORTED:
            raise _not_ported(f"query/{sub}")
        if sub == "continuous":
            return self._handle_query_continuous(request, rest[1:])
        if sub in ("exp", "gexp"):
            from opentsdb_tpu_torch.query.expression.endpoint import (
                handle_exp, handle_gexp)
            return (handle_exp if sub == "exp" else handle_gexp)(
                self, request)
        if request.method == "POST":
            obj = request.serializer.parse_query(request.body)
            tsq = TSQuery.from_json(obj)
        elif request.method in ("GET", "DELETE"):
            # the URI form dedups identical m= specs (ref:
            # QueryRpc.parseQuery :617); POST keeps duplicates
            tsq = parse_uri_query(request.params).dedupe_queries()
        else:
            raise HttpError(405, "Method not allowed")
        tsq.validate()
        if request.method == "DELETE" or tsq.delete:
            if not self.tsdb.config.get_bool(
                    "tsd.http.query.allow_delete"):
                raise HttpError(400, "Deleting data is not enabled",
                                "set tsd.http.query.allow_delete")
            tsq.delete = True
        stats = QueryStats(
            request.remote, tsq,
            allow_duplicates=self.tsdb.config.get_bool(
                "tsd.query.allow_simultaneous_duplicates", True))
        # the widest pixel budget of the request (ref: the stats'
        # downsamplePixels; 0 = full resolution)
        px = max((effective_pixels(tsq, s)[0] for s in tsq.queries),
                 default=0)
        show_summary = tsq.show_summary or request.flag("show_summary")
        show_stats = tsq.show_stats or request.flag("show_stats")
        as_arrays = request.flag("arrays")
        streamed = False
        try:
            results = self.tsdb.new_query().run(tsq, stats)
            if px:
                stats.add_stat(QueryStat.DOWNSAMPLE_PIXELS, px)
            t_ser = time.monotonic()
            total_dps = sum(r.num_dps for r in results)
            stats.add_stat(QueryStat.EMITTED_DPS, total_dps)
            if show_stats:
                # the NaN census walks every emitted point: only when
                # the caller asked for stats (ref: nanDPs)
                stats.add_stat(QueryStat.NAN_DPS, sum(
                    int(np.isnan(r.dps_arrays[1]).sum()) for r in results))
            # very large responses stream per series with chunked
            # transfer encoding instead of being built whole
            stream_after = self.tsdb.config.get_int(
                "tsd.http.query.stream_threshold_dps", 1_000_000)
            if stream_after and total_dps > stream_after \
                    and not (show_summary or show_stats):
                inner = request.serializer.stream_query(
                    tsq, results, as_arrays=as_arrays)
                stats.add_stat(
                    QueryStat.PROCESSING_PRE_WRITE_TIME,
                    (time.monotonic_ns() - stats.start_ns) / 1e6)
                streamed = True
                return HttpResponse(200, b"", body_iter=self._stream_body(
                    inner, stats, t_ser))
            body = request.serializer.format_query(
                tsq, results, as_arrays=as_arrays,
                show_summary=show_summary, show_stats=show_stats,
                summary_extra=stats.stats)
            self._record_serialization(stats, t_ser, len(body))
            stats.add_stat(QueryStat.PROCESSING_PRE_WRITE_TIME,
                           (time.monotonic_ns() - stats.start_ns) / 1e6)
            stats.mark_serialization_successful()
        finally:
            # a raise lands here with executed still False; a streamed
            # response completes inside its body iterator instead
            if not streamed:
                stats.mark_complete()
        return HttpResponse(200, body)

    def _handle_query_continuous(self, request: HttpRequest,
                                 rest) -> HttpResponse:
        """Continuous (standing) queries (ref:
        ``_handle_query_continuous``; :mod:`opentsdb_tpu_torch.streaming`):

        - ``POST /api/query/continuous``: register (a TSQuery body, an
          optional ``id``, ``window`` and ``watermark``); 400 when the
          query cannot be maintained incrementally.
        - ``GET /api/query/continuous``: the registered queries.
        - ``GET /api/query/continuous/<id>``: one query with its plans.
        - ``GET .../<id>/result``: the current windowed results (drains
          pending folds first; 503 while its partials are known stale).
        - ``GET .../<id>/deltas``: one incremental update batch.
        - ``GET .../<id>/stream``: Server-Sent Events, a ``snapshot``
          then ``windows`` events; ``Last-Event-ID`` (or
          ``?last_event_id=``) resumes.
        - ``DELETE /api/query/continuous/<id>``: deregister.

        The reference's tenant fold budget (its control plane) and its
        router mode (its cluster) are not ported (ROADMAP Queue 1, the
        rest, with no device compute)."""
        registry = self.tsdb.streaming
        if registry is None:
            raise HttpError(400, "Continuous queries are disabled",
                            "set tsd.streaming.enable = true")
        if not rest:
            if request.method == "POST":
                cq = registry.register(request.json_object())
                return HttpResponse(
                    200, json.dumps(cq.describe()).encode())
            if request.method == "GET":
                return HttpResponse(200, json.dumps(
                    [cq.describe() for cq in registry.list()]).encode())
            raise HttpError(405, "Method not allowed")
        cid = rest[0]
        what = rest[1] if len(rest) > 1 else ""
        if what in ("result", "deltas", "stream") \
                and request.method != "GET":
            raise HttpError(405, "Method not allowed")
        if what in ("result", "deltas", "stream") \
                or request.method == "GET":
            cq = registry.get(cid)
            if cq is None:
                raise HttpError(
                    404, f"No continuous query with id {cid!r}")
        if what == "result":
            return HttpResponse(200, json.dumps(
                registry.current_results(cq)).encode())
        if what == "deltas":
            return HttpResponse(200, json.dumps(
                registry.delta_updates(cq)).encode())
        if what == "stream":
            # browsers send Last-Event-ID on reconnect; a non-integer
            # id is ignored (a full snapshot), never a 400
            raw_id = request.headers.get(
                "last-event-id", request.param("last_event_id"))
            try:
                last_event_id = int(raw_id) if raw_id else None
            except ValueError:
                last_event_id = None
            resp = HttpResponse(
                200, b"",
                body_iter=sse_stream(
                    registry, cq,
                    max_lifetime_s=self.tsdb.config.get_float(
                        "tsd.streaming.sse.max_lifetime_s", 0.0),
                    last_event_id=last_event_id),
                content_type="text/event-stream; charset=UTF-8")
            resp.headers["Cache-Control"] = "no-cache"
            # an SSE stream is single-use by construction
            resp.close_connection = True
            return resp
        if request.method == "GET":
            return HttpResponse(
                200, json.dumps(cq.describe(verbose=True)).encode())
        if request.method == "DELETE":
            if not registry.delete(cid):
                raise HttpError(
                    404, f"No continuous query with id {cid!r}")
            return HttpResponse(204)
        raise HttpError(405, "Method not allowed")

    def _record_serialization(self, stats: QueryStats, t_ser: float,
                              nbytes: int) -> None:
        ser_ms = (time.monotonic() - t_ser) * 1e3
        stats.add_stat(QueryStat.SERIALIZATION_TIME, ser_ms)
        stats.add_stat(QueryStat.PAYLOAD_BYTES, nbytes)
        self.tsdb.payload_stats.record(nbytes, ser_ms)

    def _stream_body(self, inner, stats: QueryStats, t_ser: float):
        """The streamed body: serialization time, success and
        completion are marked when the stream ends (or aborts), so
        ``/api/stats/query`` reports a streamed query's real total."""
        nbytes = 0
        try:
            for chunk in inner:
                nbytes += len(chunk)
                yield chunk
            self._record_serialization(stats, t_ser, nbytes)
            stats.mark_serialization_successful()
        finally:
            stats.mark_complete()

    def _handle_suggest(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: SuggestRpc.java:30)"""
        if request.method == "POST":
            obj = request.json_object(default={})
            stype = obj.get("type", "")
            q = obj.get("q", "")
            max_results = as_int(obj.get("max"), "max", 25)
        else:
            stype = request.param("type", "")
            q = request.param("q", "") or ""
            max_results = int(request.param("max", "25"))
        if stype not in ("metrics", "tagk", "tagv"):
            raise BadRequestError(f"Invalid 'type' parameter: {stype}")
        if stype == "metrics":
            names = self.tsdb.suggest_metrics(q, max_results)
        elif stype == "tagk":
            names = self.tsdb.suggest_tag_names(q, max_results)
        else:
            names = self.tsdb.suggest_tag_values(q, max_results)
        return HttpResponse(200, request.serializer.format_suggest(names))

    # -- monitoring ----------------------------------------------------

    def _handle_serializers(self, request: HttpRequest, rest
                            ) -> HttpResponse:
        """Registered wire formats (ref: HttpSerializer listing,
        TestHttpJsonSerializer.formatSerializersV1)."""
        out = [{
            "serializer": s.shortname,
            "class": type(s).__name__,
            "version": "2.0.0",
            "request_content_type": s.request_content_type,
            "response_content_type": s.response_content_type,
        } for s in self.serializers.values()]
        return HttpResponse(200, json.dumps(out).encode())

    def _handle_aggregators(self, request: HttpRequest, rest
                            ) -> HttpResponse:
        return HttpResponse(
            200, request.serializer.format_aggregators(aggs_mod.names()))

    def _handle_config(self, request: HttpRequest, rest) -> HttpResponse:
        if rest and rest[0] == "filters":
            return HttpResponse(200, json.dumps(
                filters_mod.filter_types()).encode())
        return HttpResponse(200, request.serializer.format_config(
            self.tsdb.config.dump_configuration()))

    def _handle_dropcaches(self, request: HttpRequest, rest
                           ) -> HttpResponse:
        self.tsdb.drop_caches()
        return HttpResponse(200, request.serializer.format_dropcaches(
            {"status": "200", "message": "Caches dropped"}))

    def _handle_stats(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: StatsRpc.java; /api/stats + /query /jvm /threads
        /region_clients)"""
        sub = rest[0] if rest else ""
        if f"stats/{sub}" in UNPORTED:
            raise _not_ported(f"stats/{sub}")
        if sub == "query":
            return HttpResponse(200, request.serializer.format_query_stats(
                QueryStats.running_and_completed()))
        if sub == "jvm":
            return HttpResponse(200, json.dumps(
                self._runtime_stats()).encode())
        if sub == "threads":
            return HttpResponse(200, json.dumps([
                {"name": t.name, "state": "ALIVE" if t.is_alive()
                 else "DEAD", "daemon": t.daemon}
                for t in threading.enumerate()]).encode())
        if sub == "region_clients":
            # storage is in-process: one logical "region client"
            return HttpResponse(200, json.dumps([{
                "id": 0, "backend": "memory",
                "pendingRPCs": 0, "dead": False,
            }]).encode())
        collector = self.tsdb.stats.collect()
        self.tsdb.collect_stats(collector)
        return HttpResponse(200, request.serializer.format_stats(
            collector.as_json()))

    def _runtime_stats(self) -> dict[str, Any]:
        import gc
        import os
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "os": {"systemLoadAverage": os.getloadavg()[0]},
            "runtime": {"uptime": int((time.time() - self.start_time)
                                      * 1000)},
            "memory": {"maxRssKb": ru.ru_maxrss},
            "gc": {"collections": sum(s["collections"]
                                      for s in gc.get_stats())},
        }

    def _handle_version(self, request: HttpRequest, rest) -> HttpResponse:
        return HttpResponse(200, request.serializer.format_version(
            version_info()))

    @staticmethod
    def _homepage() -> HttpResponse:
        """(ref: HomePage; the port serves no static dashboard yet)"""
        body = (b"<html><head><title>opentsdb_tpu_torch</title></head>"
                b"<body><h1>opentsdb_tpu_torch " + __version__.encode() +
                b"</h1><p>See /api/version, /api/aggregators, /api/query"
                b"</p></body></html>")
        return HttpResponse(200, body, content_type="text/html")
