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
delete), ``/api/query/last``, ``/api/suggest``, ``/api/search``
(``/lookup``, and the search plugin's own types),
``/api/annotation`` (+``/bulk``), ``/api/annotations``, ``/api/uid``
(``/assign``, ``/rename``, ``/uidmeta``, ``/tsmeta``), ``/api/tree``
(:mod:`opentsdb_tpu_torch.tree.rpc`), ``/plugin/<path>`` (the
``tsd.http.rpc`` plugins),
``/api/aggregators``, ``/api/config`` (+``/filters``),
``/api/dropcaches``, ``/api/lifecycle`` (+``/sweep``; the data
lifecycle), ``/api/serializers``, ``/api/version``,
``/api/stats`` (+``/query``, ``/jvm``, ``/threads``,
``/region_clients``, ``/raw``, ``/query_shapes``, ``/tenants``),
the observability surface (``/api/health``, ``/api/trace``
(+``/<id>``), ``/api/profile``, ``/metrics``, ``/logs``), the control
plane (``/api/control`` (+``/materialized``, ``/plan``, ``/tick``)),
the cluster surface (``/api/cluster`` (+``/status``, ``/reshard``),
``/api/stats/fleet``), ``/diediedie``, and the legacy unversioned
aliases. Every other
endpoint of the reference's surface needs a subsystem the port does
not have yet and answers a structured 501 naming the ROADMAP item that
ports it (:data:`UNPORTED`); a path the reference does not know
answers 404.

On a cluster router (``tsd.cluster.role = router``,
:mod:`opentsdb_tpu_torch.cluster.router`) the router owns no data:
``/api/put`` forwards to the owning shards (every replica owner at
``tsd.cluster.rf`` > 1, spooling for an unreachable one), ``/api/query``
scatters and merges the shards' partials (a 200 partial with
``shardsDegraded`` when a shard, or at rf > 1 a whole replica set,
fails), ``/api/query/last``, ``/api/suggest`` and ``/api/search/lookup``
scatter and union, ``/api/query/continuous`` serves federated
continuous queries, and the endpoints that would read or write its
empty local store answer 400.
On a shard, a wire delivery (``request.wire_groups``) lands as one
grouped write, and a wire read (``request.wire_sink``) streams each
sub-query's partial grids as frames instead of a JSON body.

``/api/put`` and ``/api/query`` are trace roots (``ingest.put``,
``query.http``; :mod:`opentsdb_tpu_torch.obs.trace`): a retained
trace's id rides the response as ``X-TSD-Trace-Id``. A request that
did not come through the socket server (``received_at`` unset) feeds
the SLO tracker here; the server feeds it for the rest.

The wire format is the JSON serializer unless
``tsd.http.serializer.plugin`` names another class, which is
registered under its ``shortname`` and made the default
(``?serializer=<shortname>`` picks one per request). With
authentication on, the server sets ``request.auth`` and each RPC checks
its permission (403): ``/api/put``, ``/api/rollup`` and
``/api/histogram`` need HTTP_PUT, every ``/api/query`` endpoint
HTTP_QUERY, and ``/api/uid/assign`` the CREATE_* of each kind it
assigns.

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
import os
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
from opentsdb_tpu_torch.auth.simple import Permissions
from opentsdb_tpu_torch.control.shapes import cq_candidate
from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.tags import parse_put_value
from opentsdb_tpu_torch.core.uid import FailedToAssignUniqueIdError
from opentsdb_tpu_torch.meta.annotation import Annotation
from opentsdb_tpu_torch.meta.meta_store import MetaStore, UIDMeta
from opentsdb_tpu_torch.obs import openmetrics
from opentsdb_tpu_torch.obs import trace as trace_mod
from opentsdb_tpu_torch.obs.trace import (SpanRecord, build_tree,
                                          trace_begin, trace_end)
from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query.limits import QueryLimitExceeded
from opentsdb_tpu_torch.query.model import (BadRequestError, TSQuery,
                                            effective_pixels,
                                            parse_uri_query)
from opentsdb_tpu_torch.search.lookup import (last_data_points,
                                              time_series_lookup)
from opentsdb_tpu_torch.stats.stats import QueryStat, QueryStats
from opentsdb_tpu_torch.streaming.sse import sse_stream
from opentsdb_tpu_torch.tsd.json_serializer import HttpJsonSerializer
from opentsdb_tpu_torch.utils.faults import DegradedError
from opentsdb_tpu_torch.utils.logring import ring_buffer
from opentsdb_tpu_torch.utils.plugin import load_class, load_plugin_instances

# the ROADMAP Queue 1 item that ports what is left
_REST = "the rest, with no device compute"

# endpoint -> the ROADMAP Queue 1 item that ports it: /api/<name>, or
# "stats/<name>" and "query/<name>" for sub-endpoints, or "/<name>" for
# paths outside /api
UNPORTED: dict[str, tuple[str, str]] = {
    "/q": (_REST, "tsd/graph.py (graphs)"),
    "/s": (_REST, "static files"),
}


def api_endpoint(path: str) -> str:
    """The path's first endpoint segment with the ``/api[/vN]`` prefix
    stripped (agreeing with :meth:`HttpRpcRouter._dispatch`'s parse)."""
    parts = [p for p in path.split("/") if p]
    if parts and parts[0] == "api":
        parts = parts[1:]
        if parts and re.fullmatch(r"v[0-9]+", parts[0]):
            parts = parts[1:]
    return parts[0] if parts else ""


# endpoints a cluster router refuses with a 400: they would read or
# write its empty local store (ref: ``_dispatch``)
_ROUTER_REFUSED = ("uid", "annotation", "annotations", "tree", "rollup",
                   "histogram")

# the endpoints the SLO tracker holds to objectives (ref: _slo_endpoint)
_SLO_ENDPOINTS = {"query": "query", "q": "query", "put": "put"}


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
    auth: Any = None  # the AuthState when authentication is on
    # the socket server's receipt stamp (time.monotonic()): the query
    # root's admission span starts here, and a request with it set has
    # its SLO event recorded by the server, not by the router
    received_at: float = 0.0
    # a retained trace's id, stamped by the router's trace wrapper
    trace_id_hint: str = ""
    # a shard's binary cluster wire (cluster/wire.py): a delivered put
    # batch as decoded (metric, tags, refs, ts, values) groups, and the
    # read leg's sink of each sub-query's results (tsq, index, rows)
    wire_groups: list | None = None
    wire_sink: Callable | None = None

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

    def _json_body(self, expected: type, noun: str, default):
        """The body as JSON of one container type; anything else,
        valid-JSON scalars included, is a clean 400 (ref: the reference
        wraps every body parse failure in BadRequestException)."""
        if not self.body:
            if default is not None:
                return default
            raise BadRequestError("Missing request content")
        try:
            obj = json.loads(self.body)
        except Exception as exc:  # noqa: BLE001 - any parse error is a 400
            raise BadRequestError(
                f"Unable to parse JSON body: {exc}") from None
        if not isinstance(obj, expected):
            raise BadRequestError(
                f"Request body must be a JSON {noun}, got "
                f"{type(obj).__name__}")
        return obj

    def json_object(self, default: dict | None = None) -> dict:
        return self._json_body(dict, "object", default)

    def json_array(self, default: list | None = None) -> list:
        return self._json_body(list, "array", default)


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
        default_json = HttpJsonSerializer.for_tsdb(tsdb)
        self.serializers: dict[str, Any] = {
            default_json.shortname: default_json}
        self.serializer = default_json
        ser_path = tsdb.config.get_string("tsd.http.serializer.plugin", "")
        if ser_path:
            # registered under its shortname and made the default (ref:
            # the shortname registry, HttpSerializer.java:93)
            cls = load_class(ser_path)
            plugin_ser = cls.for_tsdb(tsdb) \
                if isinstance(cls, type) and issubclass(
                    cls, HttpJsonSerializer) \
                and cls.__init__ is HttpJsonSerializer.__init__ else cls()
            self.serializers[plugin_ser.shortname] = plugin_ser
            self.serializer = plugin_ser
        mode = tsdb.mode
        self._routes: dict[str, Callable] = {}
        # read RPCs (not registered in write-only mode, RpcManager:274)
        if mode in ("rw", "ro"):
            self._routes.update({
                "query": self._handle_query,
                "suggest": self._handle_suggest,
                "search": self._handle_search,
                "uid": self._handle_uid,
                "annotation": self._handle_annotation,
                "annotations": self._handle_annotations,
                "tree": self._handle_tree,
            })
        # write RPCs (not registered in read-only mode, RpcManager:327)
        if mode in ("rw", "wo"):
            self._routes["put"] = self._handle_put
            self._routes["rollup"] = self._handle_rollup
            self._routes["histogram"] = self._handle_histogram
        self._routes.update({
            "aggregators": self._handle_aggregators,
            "config": self._handle_config,
            "control": self._handle_control,
            "dropcaches": self._handle_dropcaches,
            "health": self._handle_health,
            "lifecycle": self._handle_lifecycle,
            "profile": self._handle_profile,
            "serializers": self._handle_serializers,
            "stats": self._handle_stats,
            "cluster": self._handle_cluster,
            "trace": self._handle_trace,
            "version": self._handle_version,
        })
        for name in UNPORTED:
            if "/" not in name:
                self._routes[name] = self._unported(name)
        # set by TSDServer so HTTP diediedie can request shutdown
        self.server = None
        # /plugin/<path> endpoints (ref: HttpRpcPlugin.java:40,
        # RpcManager tsd.http.rpc.plugins :153)
        self.http_rpc_plugins: dict[str, Any] = {
            plugin.path().strip("/"): plugin
            for plugin in load_plugin_instances(
                tsdb.config, "tsd.http.rpc", init_arg=tsdb)}
        self.start_time = time.time()

    @staticmethod
    def _unported(name: str) -> Callable:
        def handler(request: HttpRequest, rest) -> HttpResponse:
            raise _not_ported(name)
        return handler

    # ------------------------------------------------------------------

    def handle(self, request: HttpRequest) -> HttpResponse:
        t0 = time.monotonic()
        resp = self._apply_jsonp(request, self._handle_inner(request))
        # set here so that error responses, built after the trace
        # wrapper unwound, carry the id too
        if request.trace_id_hint:
            resp.headers.setdefault("X-TSD-Trace-Id",
                                    request.trace_id_hint)
        # the SLO feed of a caller that is not the socket server (ref:
        # ``handle``): a 5xx burns availability; the server records its
        # own requests at response time, sheds and timeouts included
        if not request.received_at and self.tsdb.slo.enabled:
            endpoint = _SLO_ENDPOINTS.get(api_endpoint(request.path))
            if endpoint is not None:
                self.tsdb.slo.record(endpoint,
                                     (time.monotonic() - t0) * 1000.0,
                                     resp.status >= 500)
        return resp


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
        elif parts[0] == "metrics":
            # OpenMetrics, outside /api where Prometheus scrapes
            return self._handle_metrics(request)
        elif parts[0] == "logs":
            return self._handle_logs(request)
        elif parts[0] == "plugin":
            plugin = self.http_rpc_plugins.get("/".join(parts[1:]))
            if plugin is None:
                raise HttpError(404, f"No HTTP RPC plugin at /{path}",
                                "The requested endpoint was not found")
            return plugin.execute(self.tsdb, request)
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
        if endpoint in _ROUTER_REFUSED and self.tsdb.cluster is not None:
            # the router owns no data: these would serve from (or write
            # into) its EMPTY local store, where no scattered read ever
            # looks (ref)
            raise HttpError(
                400, f"/api/{endpoint} is not supported in router mode",
                "point this request at a shard TSD, or use "
                "/api/put and /api/query")
        handler = self._routes.get(endpoint)
        if handler is None:
            raise HttpError(404, f"Endpoint not found: /api/{endpoint}",
                            "The requested endpoint was not found")
        return handler(request, rest)

    # -- tracing -------------------------------------------------------

    def _trace_request(self, name: str, request: HttpRequest,
                       fn: Callable[[], HttpResponse]) -> HttpResponse:
        """Root one traced request (``ingest.put`` or ``query.http``;
        ref: ``_trace_request``): bind the context for the handler's
        whole stack, mark an error, and stamp a retained trace's id for
        the ``X-TSD-Trace-Id`` header."""
        tracer = self.tsdb.tracer
        ctx = tracer.start_request(name, request)
        if ctx is None:
            return fn()
        error: BaseException | None = None
        try:
            with trace_mod.use(ctx):
                return fn()
        except BaseException as exc:
            error = exc
            raise
        finally:
            if error is not None:
                ctx.set_error(error)
            tracer.finish(ctx)
            if ctx.committed:
                request.trace_id_hint = ctx.trace_id

    # -- write path ----------------------------------------------------

    @staticmethod
    def _check_permission(request: HttpRequest, perm) -> None:
        """403 when the request's AuthState lacks ``perm`` (ref: the
        Permissions gating of the RPC handlers)."""
        if request.auth is not None and \
                not request.auth.has_permission(perm):
            raise HttpError(403, "Permission denied",
                            f"{perm.name} is not granted")

    def _put_error_sink(self, errors: list) -> Callable:
        """The per-point error sink of a put: the error goes into the
        response, and a storage failure also to the storage exception
        handler (ref: ``_put_error_sink``, PutDataPointRpc's requeue); a
        bad point (an unknown name, a filter's veto, a bad value) would
        fail the same way again and is not handed on."""
        def sink(dp: dict, e: Exception) -> None:
            errors.append({"datapoint": dp, "error": str(e)})
            seh = self.tsdb.storage_exception_handler
            if seh is not None and not isinstance(
                    e, (ValueError, LookupError,
                        FailedToAssignUniqueIdError)):
                seh.handle_error(dp, e)
        return sink

    def _handle_put(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: PutDataPointRpc.java:272) Decode the body, validate and
        group it into per-series columns in one pass, then write the
        groups through ``TSDB.add_point_groups``: a bad point fails
        alone and the good points of the body land. Traced as an
        ``ingest.put`` root: ``ingest.decode``, ``store.scatter`` and
        the WAL's ``wal.commit_wait``."""
        self._check_permission(request, Permissions.HTTP_PUT)
        if request.method != "POST":
            raise HttpError(405, "Method not allowed",
                            "The HTTP method is not permitted")
        return self._trace_request("ingest.put", request,
                                   lambda: self._handle_put_run(request))

    def _put_answer(self, request: HttpRequest, success: int, failed: int,
                    errors: list) -> HttpResponse:
        """A put's answer: 204, or the 400 of a failed point, without
        ``summary``/``details``; else the put summary."""
        details = request.flag("details")
        if not details and not request.flag("summary"):
            if failed:
                raise HttpError(
                    400, "One or more data points had errors",
                    f"{failed} error(s) storing datapoints")
            return HttpResponse(204)
        return HttpResponse(
            400 if failed else 200,
            request.serializer.format_put(success, failed, errors,
                                          details))

    def _handle_put_wire(self, request: HttpRequest,
                         groups: list) -> HttpResponse:
        """A columnar wire delivery (ref: ``_handle_put_wire``): the
        batch arrives as decoded ``(metric, tags, refs, ts, values)``
        groups and lands through ``add_point_groups``, one WAL write and
        one group-committed fsync, with no JSON in between; the store
        validates and reports each point as the JSON path does. A wire
        delivery that reaches a router re-partitions and forwards."""
        cluster = self.tsdb.cluster
        if cluster is not None:
            success, failed, errors = cluster.forward_writes(
                [dp for g in groups for dp in g[2]])
            return HttpResponse(
                400 if failed else 200,
                request.serializer.format_put(success, failed, errors,
                                              request.flag("details")))
        errors: list[dict] = []
        h = trace_begin("store.scatter", groups=len(groups))
        success, _ = self.tsdb.add_point_groups(
            groups, on_error=self._put_error_sink(errors))
        trace_end(h)
        return self._put_answer(request, success, len(errors), errors)

    def _handle_put_run(self, request: HttpRequest) -> HttpResponse:
        if request.wire_groups is not None:
            return self._handle_put_wire(request, request.wire_groups)
        h = trace_begin("ingest.decode")
        points = request.serializer.parse_put(request.body)
        if h is not None:
            h.tag(points=len(points))
        cluster = self.tsdb.cluster
        if cluster is not None:
            # router mode: partition by the consistent-hash series key
            # and forward one series-grouped body per shard; an
            # unreachable shard's batch is durably spooled and still
            # acknowledged (forwarding re-validates on the shard, which
            # records its own decode)
            trace_end(h)
            return self._put_answer(request,
                                    *cluster.forward_writes(points))
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

        trace_end(h)
        h = trace_begin("store.scatter", groups=len(groups))
        success, _ = self.tsdb.add_point_groups(
            groups.values(), on_error=self._put_error_sink(errors))
        trace_end(h)
        return self._put_answer(request, success, len(errors), errors)

    def _handle_rollup(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: RollupDataPointRpc.java:227; ``_handle_rollup``) A put
        body whose points also carry ``interval`` and ``aggregator``
        (a tier point) or ``groupByAggregator`` (a pre-aggregate), each
        written by ``TSDB.add_aggregate_point``: a bad point fails alone.
        The body's WAL records commit as one write and one fsync. It
        needs HTTP_PUT, as ``/api/put`` (RollupDataPointRpc extends
        PutDataPointRpc)."""
        self._check_permission(request, Permissions.HTTP_PUT)
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
        good points of the body land. It needs HTTP_PUT, as ``/api/put``
        (HistogramDataPointRpc extends PutDataPointRpc)."""
        self._check_permission(request, Permissions.HTTP_PUT)
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
        """(ref: QueryRpc.java:89-128) Every sub-endpoint needs
        HTTP_QUERY."""
        self._check_permission(request, Permissions.HTTP_QUERY)
        sub = rest[0] if rest else ""
        if sub in ("exp", "gexp") and self.tsdb.cluster is not None:
            # the router owns no data: these would run against its EMPTY
            # local store (ref)
            raise HttpError(
                400, f"/api/query/{sub} is not supported in router mode",
                "point this request at a shard TSD, or use /api/query")
        if sub == "last":
            return self._handle_query_last(request)
        if sub == "continuous":
            return self._handle_query_continuous(request, rest[1:])
        if sub in ("exp", "gexp"):
            from opentsdb_tpu_torch.query.expression.endpoint import (
                handle_exp, handle_gexp)
            return (handle_exp if sub == "exp" else handle_gexp)(
                self, request)
        return self._trace_request("query.http", request,
                                   lambda: self._handle_query_run(request))

    def _handle_query_run(self, request: HttpRequest) -> HttpResponse:
        """``/api/query`` under its ``query.http`` root: the root carries
        the query-shape tags the shape log records (and the miner's
        continuous-query candidate), then the cache outcome."""
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
        tctx = trace_mod.current()
        if tctx is not None:
            s0 = tsq.queries[0] if tsq.queries else None
            tctx.tag(
                metrics=",".join(sorted({s.metric or "<tsuid>"
                                         for s in tsq.queries})),
                subs=len(tsq.queries),
                aggregator=s0.aggregator if s0 is not None else "",
                downsample=(s0.downsample or "") if s0 is not None
                else "",
                filters=sum(len(s.filters) for s in tsq.queries),
                pixels=px, start=tsq.start_ms, end=tsq.end_ms,
                delete=bool(tsq.delete))
            # the canonical continuous-query candidate the control
            # plane's miner groups on (None: not materializable)
            cand = cq_candidate(tsq)
            if cand:
                tctx.tag(cq=cand)
        show_summary = tsq.show_summary or request.flag("show_summary")
        show_stats = tsq.show_stats or request.flag("show_stats")
        as_arrays = request.flag("arrays")
        streamed = False
        cluster = self.tsdb.cluster
        degraded: list[str] = []
        try:
            if cluster is not None:
                # router mode: scatter to every shard and merge the
                # group partials; a dead, hung or tripped shard gives a
                # 200 PARTIAL with the shardsDegraded marker, never a
                # 5xx, and is never retained by the result cache
                results, degraded = cluster.run_cached(tsq)
            else:
                results = self.tsdb.new_query().run(tsq, stats)
            if px:
                stats.add_stat(QueryStat.DOWNSAMPLE_PIXELS, px)
            if tctx is not None:
                st = stats.stats
                tctx.tag(cache=(
                    "streaming" if st.get("streamingHit")
                    else "hit" if st.get("resultCacheHit")
                    else "coalesced" if st.get("resultCacheCoalesced")
                    else "miss"))
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
                    and cluster is None and request.wire_sink is None \
                    and not (show_summary or show_stats):
                inner = request.serializer.stream_query(
                    tsq, results, as_arrays=as_arrays)
                stats.add_stat(
                    QueryStat.PROCESSING_PRE_WRITE_TIME,
                    (time.monotonic_ns() - stats.start_ns) / 1e6)
                streamed = True
                return HttpResponse(200, b"", body_iter=self._stream_body(
                    inner, stats, t_ser, px))
            h = trace_begin("query.serialize")
            if request.wire_sink is not None:
                # a shard's wire leg: each sub-query's grids go onto the
                # socket as framed column blocks, no JSON at all
                by_sub: dict[int, list] = {}
                for r in results:
                    by_sub.setdefault(r.sub_query_index, []).append(r)
                for idx, rows in sorted(by_sub.items()):
                    request.wire_sink(tsq, idx, rows)
                body = b""
            else:
                body = request.serializer.format_query(
                    tsq, results, as_arrays=as_arrays,
                    show_summary=show_summary, show_stats=show_stats,
                    summary_extra=stats.stats, degraded_shards=degraded)
            trace_end(h)
            self._record_serialization(stats, t_ser, len(body), px)
            stats.add_stat(QueryStat.PROCESSING_PRE_WRITE_TIME,
                           (time.monotonic_ns() - stats.start_ns) / 1e6)
            stats.mark_serialization_successful()
        finally:
            # a raise lands here with executed still False; a streamed
            # response completes inside its body iterator instead
            if not streamed:
                stats.mark_complete()
        # the header twin of the body's marker, for load balancers
        return self._with_degraded(HttpResponse(200, body), degraded)

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

        Under tenant QoS a registration is held to its tenant's fold
        budget (``tsd.control.qos.tenant_fold_mb``): past it, 400.

        On a cluster router the same surface serves FEDERATED
        continuous queries (:mod:`opentsdb_tpu_torch.cluster.cq`): a
        registration stands on every shard, a pull merges the shards'
        partials and the stream pushes merged frames; ``deltas`` is the
        shards' drain, which the router consumes, so it answers 400
        there (ref)."""
        cluster = self.tsdb.cluster
        registry = cluster.cqs if cluster is not None \
            else self.tsdb.streaming
        if registry is None:
            raise HttpError(400, "Continuous queries are disabled",
                            "set tsd.streaming.enable = true")
        if not rest:
            if request.method == "POST":
                obj = request.json_object()
                ctl = self.tsdb._control
                tenant = None
                if ctl is not None and ctl.qos.enabled:
                    # standing rings are the one resource a tenant
                    # holds for good: the budget gates registration
                    tenant = ctl.qos.tenant_of(request.headers)
                    if not ctl.qos.fold_budget_allows(tenant, registry,
                                                      body=obj):
                        raise HttpError(
                            400, "tenant fold-memory budget exhausted",
                            f"tenant {tenant!r} already holds "
                            "tsd.control.qos.tenant_fold_mb of standing "
                            "continuous-query state; delete one or raise "
                            "the budget")
                cq = registry.register(obj)
                if tenant is not None:
                    cq.tenant = tenant
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
            if cluster is not None:
                raise HttpError(
                    400, "deltas is a shard-local drain surface",
                    "the router consumes it; use /stream or /result")
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

    def _handle_query_last(self, request: HttpRequest) -> HttpResponse:
        """(ref: QueryRpc.java:346 /api/query/last via TSUIDQuery) The
        last point of each series the specs name. On a cluster router
        the request scatters to every shard and the newest point per
        series wins; tsuid specs are refused (UIDs are per shard), and
        degraded shards ride a trailing body marker and the header, as
        in ``/api/query``."""
        if request.method == "POST":
            obj = request.json_object(default={})
            specs = obj.get("queries", [])
            if not isinstance(specs, list) or not all(
                    isinstance(q, dict) for q in specs):
                raise HttpError(
                    400, "queries must be an array of objects")
            for q in specs:
                ts = q.get("tsuids")
                if ts is not None and (not isinstance(ts, list)
                                       or not all(isinstance(x, str)
                                                  for x in ts)):
                    raise HttpError(
                        400, "tsuids must be a list of strings")
            back_scan = as_int(obj.get("backScan"), "backScan")
            resolve = bool(obj.get("resolveNames", False))
        else:
            specs = [{"uri": m} for m in request.params.get(
                "timeseries", [])]
            back_scan = int(request.param("back_scan", "0"))
            resolve = request.flag("resolve")
        cluster = self.tsdb.cluster
        if cluster is not None:
            if any(q.get("tsuids") for q in specs):
                raise HttpError(
                    400, "tsuid specs are not supported in router mode",
                    "UIDs are assigned per shard — query by metric "
                    "and tags instead")
            points, degraded = cluster.scatter_last(specs, back_scan,
                                                    resolve)
            if degraded:
                points = points + [{"shardsDegraded": degraded}]
            return self._with_degraded(HttpResponse(
                200, request.serializer.format_last_points(points)),
                degraded)
        points = last_data_points(self.tsdb, specs, back_scan, resolve)
        return HttpResponse(200,
                            request.serializer.format_last_points(points))

    @staticmethod
    def _with_degraded(resp: HttpResponse,
                       degraded: list[str]) -> HttpResponse:
        """Name a router's degraded shards in the response's header."""
        if degraded:
            resp.headers["X-OpenTSDB-Shards-Degraded"] = ",".join(degraded)
        return resp

    def _record_serialization(self, stats: QueryStats, t_ser: float,
                              nbytes: int, pixels: int) -> None:
        ser_ms = (time.monotonic() - t_ser) * 1e3
        stats.add_stat(QueryStat.SERIALIZATION_TIME, ser_ms)
        stats.add_stat(QueryStat.PAYLOAD_BYTES, nbytes)
        self.tsdb.payload_stats.record(nbytes, ser_ms, pixels)

    def _stream_body(self, inner, stats: QueryStats, t_ser: float,
                     pixels: int):
        """The streamed body: serialization time, success and
        completion are marked when the stream ends (or aborts), so
        ``/api/stats/query`` reports a streamed query's real total."""
        nbytes = 0
        try:
            for chunk in inner:
                nbytes += len(chunk)
                yield chunk
            self._record_serialization(stats, t_ser, nbytes, pixels)
            stats.mark_serialization_successful()
        finally:
            stats.mark_complete()

    def _handle_suggest(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: SuggestRpc.java:30) On a cluster router the suggest
        scatters to every shard and the union answers; degraded shards
        ride the header (a bare name array has no room for a marker)."""
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
        cluster = self.tsdb.cluster
        if cluster is not None:
            names, degraded = cluster.scatter_suggest(stype, q,
                                                      max_results)
            return self._with_degraded(HttpResponse(
                200, request.serializer.format_suggest(names)), degraded)
        if stype == "metrics":
            names = self.tsdb.suggest_metrics(q, max_results)
        elif stype == "tagk":
            names = self.tsdb.suggest_tag_names(q, max_results)
        else:
            names = self.tsdb.suggest_tag_values(q, max_results)
        return HttpResponse(200, request.serializer.format_suggest(names))

    # -- search (ref: SearchRpc.java) ----------------------------------

    def _handle_search(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: SearchRpc.java) ``/api/search/lookup`` walks the store's
        tag index (TimeSeriesLookup.java:83); any other type goes to the
        search plugin, a 400 without one. On a cluster router ``lookup``
        scatters to every shard and the union dedupes on (metric, tags);
        plugin search answers 400 there (the router has no index)."""
        sub = rest[0] if rest else ""
        cluster = self.tsdb.cluster
        if cluster is not None and sub != "lookup":
            raise HttpError(
                400, f"/api/search/{sub} is not supported in router mode",
                "point this request at a shard TSD, or use "
                "/api/search/lookup")
        if sub == "lookup":
            if request.method == "POST":
                obj = request.json_object(default={})
                metric = obj.get("metric") or ""
                if not isinstance(metric, str):
                    raise HttpError(400, "metric must be a string")
                raw_tags = obj.get("tags") or []
                if not isinstance(raw_tags, list) or not all(
                        isinstance(t, dict) for t in raw_tags):
                    raise HttpError(
                        400, "tags must be a list of {key, value}")
                tags = [(t.get("key"), t.get("value"))
                        for t in raw_tags]
                limit = as_int(obj.get("limit"), "limit", 25)
                use_meta = bool(obj.get("useMeta", False))
            else:
                m = request.param("m", "") or ""
                metric, tag_map = tags_mod.parse_with_metric(m) \
                    if m else ("", {})
                tags = list(tag_map.items())
                limit = int(request.param("limit", "25"))
                use_meta = request.flag("use_meta")
            if cluster is not None:
                results, degraded = cluster.scatter_lookup(
                    metric, tags, limit, use_meta)
                return self._with_degraded(HttpResponse(
                    200, request.serializer.format_search(results)),
                    degraded)
            results = time_series_lookup(self.tsdb, metric, tags, limit,
                                         use_meta)
            return HttpResponse(200,
                                request.serializer.format_search(results))
        if self.tsdb.search_plugin is None:
            raise BadRequestError(
                "Searching is not enabled on this TSD")
        obj = request.json_object(default={})
        results = self.tsdb.search_plugin.execute_query(sub, obj)
        return HttpResponse(200, request.serializer.format_search(results))

    # -- annotations (ref: AnnotationRpc.java) --------------------------

    def _handle_annotation(self, request: HttpRequest, rest
                           ) -> HttpResponse:
        """One note: GET by ``tsuid`` and ``start_time``, POST merges
        into an existing note, PUT replaces it, DELETE removes it;
        ``/bulk`` edits many. A write is indexed by the search plugin."""
        if rest and rest[0] == "bulk":
            return self._handle_annotation_bulk(request)
        store = self.tsdb.annotations
        if request.method == "GET":
            tsuid = request.param("tsuid", "") or ""
            start = int(request.param("start_time", "0"))
            note = store.get(tsuid.upper() if tsuid else "", start)
            if note is None:
                raise HttpError(404,
                                "Unable to locate annotation in storage")
            return HttpResponse(200,
                                request.serializer.format_annotation(note))
        if request.method in ("POST", "PUT"):
            note = Annotation.from_json(request.json_object(default={}))
            note.tsuid = note.tsuid.upper()
            existing = store.get(note.tsuid, note.start_time)
            if request.method == "POST" and existing is not None:
                # POST merges into the stored note (ref: AnnotationRpc
                # syncToStorage)
                if not note.description:
                    note.description = existing.description
                if not note.notes:
                    note.notes = existing.notes
                if not note.end_time:
                    note.end_time = existing.end_time
                note.custom = {**existing.custom, **note.custom}
            store.store(note)
            if self.tsdb.search_plugin is not None:
                self.tsdb.search_plugin.index_annotation(note)
            return HttpResponse(200,
                                request.serializer.format_annotation(note))
        if request.method == "DELETE":
            tsuid = (request.param("tsuid", "") or "").upper()
            start = int(request.param("start_time", "0"))
            note = store.get(tsuid, start)
            if note is None or not store.delete(tsuid, start):
                raise HttpError(404,
                                "Unable to locate annotation in storage")
            if self.tsdb.search_plugin is not None:
                self.tsdb.search_plugin.delete_annotation(note)
            return HttpResponse(204)
        raise HttpError(405, "Method not allowed")

    def _handle_annotation_bulk(self, request: HttpRequest) -> HttpResponse:
        store = self.tsdb.annotations
        if request.method in ("POST", "PUT"):
            objs = request.json_array(default=[])
            if not all(isinstance(o, dict) for o in objs):
                raise HttpError(
                    400, "Each annotation must be an object")
            notes = []
            for obj in objs:
                note = Annotation.from_json(obj)
                note.tsuid = note.tsuid.upper()
                store.store(note)
                notes.append(note)
            return HttpResponse(
                200, request.serializer.format_annotations(notes))
        if request.method == "DELETE":
            obj = request.json_object(default={})
            tsuids = obj.get("tsuids")
            if obj.get("global"):
                tsuids = [""]
            elif not tsuids:
                # ref: Annotation.deleteRange needs tsuids or global
                raise HttpError(
                    400, "Please supply either the global flag or tsuids")
            if not isinstance(tsuids, list) or not all(
                    isinstance(t, str) for t in tsuids):
                raise HttpError(400, "tsuids must be a list of strings")
            start = as_int(obj.get("startTime"), "startTime")
            end = as_int(obj.get("endTime"), "endTime", int(time.time()))
            obj["totalDeleted"] = store.delete_range(
                [t.upper() for t in tsuids], start, end)
            return HttpResponse(200, json.dumps(obj).encode())
        raise HttpError(405, "Method not allowed")

    def _handle_annotations(self, request: HttpRequest, rest
                            ) -> HttpResponse:
        """The global notes in a range (ref: AnnotationRpc); bulk edits
        go to /api/annotation/bulk."""
        if request.method != "GET":
            raise HttpError(405, "Method not allowed",
                            "Use /api/annotation/bulk for bulk edits")
        start = as_int(request.param("start_time"), "start_time")
        end = as_int(request.param("end_time"), "end_time",
                     int(time.time()))
        notes = self.tsdb.annotations.global_range(start, end)
        return HttpResponse(200,
                            request.serializer.format_annotations(notes))

    # -- uid (ref: UniqueIdRpc.java) -----------------------------------

    def _handle_uid(self, request: HttpRequest, rest) -> HttpResponse:
        sub = rest[0] if rest else ""
        if sub == "assign":
            return self._uid_assign(request)
        if sub == "rename":
            return self._uid_rename(request)
        if sub == "uidmeta":
            return self._uid_meta(request)
        if sub == "tsmeta":
            return self._ts_meta(request)
        raise HttpError(404, "Endpoint not found",
                        f"/api/uid/{sub} is not a valid endpoint")

    def _uid_assign(self, request: HttpRequest) -> HttpResponse:
        """Assign UIDs to names of each kind; a name that fails is
        reported in ``<kind>_errors`` and the answer is a 400. Every
        requested kind's CREATE_* permission is checked before any
        assignment (ref: Permissions.java:27)."""
        if request.method == "POST":
            obj = request.json_object(default={})
        else:
            obj = {k: (request.param(k) or "").split(",")
                   for k in ("metric", "tagk", "tagv")
                   if request.has_param(k)}
            unknown = [k for k in request.params
                       if k not in ("metric", "tagk", "tagv",
                                    "serializer", "jsonp")]
            if unknown:
                # a misspelt kind would assign nothing (ref:
                # TestUniqueIdRpc.assignQsTypo -> 400)
                raise HttpError(
                    400, f"Unknown parameter(s): {unknown}",
                    "Recognized types: metric, tagk, tagv")
        if not any(obj.get(k) for k in ("metric", "tagk", "tagv")):
            raise HttpError(
                400, "Missing values to assign UIDs",
                "Supply metric, tagk and/or tagv name lists")
        create_perm = {"metric": Permissions.CREATE_METRIC,
                       "tagk": Permissions.CREATE_TAGK,
                       "tagv": Permissions.CREATE_TAGV}
        for kind in ("metric", "tagk", "tagv"):
            if obj.get(kind):
                self._check_permission(request, create_perm[kind])
        response: dict[str, Any] = {}
        had_error = False
        for kind in ("metric", "tagk", "tagv"):
            names = obj.get(kind) or []
            if isinstance(names, str):
                names = [names]
            if not isinstance(names, list) or not all(
                    isinstance(n, str) for n in names):
                raise HttpError(
                    400, f"{kind} must be a name or list of names")
            good: dict[str, str] = {}
            bad: dict[str, str] = {}
            registry = self.tsdb.uids.by_kind(kind)
            for name in names:
                try:
                    uid = self.tsdb.assign_uid(kind, name)
                    good[name] = registry.int_to_uid(uid).hex().upper()
                except Exception as e:  # noqa: BLE001 - a name's error
                    bad[name] = str(e)
                    had_error = True
            if names:
                response[kind] = good
                if bad:
                    response[f"{kind}_errors"] = bad
        return HttpResponse(400 if had_error else 200,
                            request.serializer.format_uid_assign(response))

    def _uid_rename(self, request: HttpRequest) -> HttpResponse:
        obj = request.json_object(default={}) \
            if request.method == "POST" else \
            {k: request.param(k) for k in ("metric", "tagk", "tagv",
                                           "name")}
        new_name = obj.get("name") or ""
        if not new_name:
            raise BadRequestError("Missing 'name' parameter")
        for kind in ("metric", "tagk", "tagv"):
            old = obj.get(kind)
            if old:
                try:
                    self.tsdb.uids.by_kind(kind).rename(old, new_name)
                    return HttpResponse(200, json.dumps(
                        {"result": "true"}).encode())
                except Exception as e:  # noqa: BLE001 - the answer
                    return HttpResponse(400, json.dumps(
                        {"result": "false", "error": str(e)}).encode())
        raise BadRequestError("Missing uid type/name to rename")

    def _uid_meta(self, request: HttpRequest) -> HttpResponse:
        """UIDMeta: GET (a skeleton document for a UID without one),
        POST merges, PUT replaces (304 when nothing changed), DELETE
        (ref: UniqueIdRpc.java:179-226)."""
        meta_store = self.tsdb.meta
        if request.method == "GET":
            uid = (request.param("uid", "") or "").upper()
            kind = (request.param("type", "") or "").lower()
            meta = meta_store.get_uid_meta(kind, uid)
            if meta is None:
                try:
                    name = self.tsdb.uids.by_kind(kind).get_name(
                        bytes.fromhex(uid))
                except Exception:  # noqa: BLE001 - any bad UID is a 404
                    raise HttpError(
                        404, "Could not find the requested UID") from None
                meta = UIDMeta(uid=uid, type=kind.upper(), name=name)
            return HttpResponse(200, json.dumps(meta.to_json()).encode())
        fields = self._meta_request_fields(request)
        uid = (fields.get("uid") or request.param("uid", "")
               or "").upper()
        kind = (fields.get("type") or request.param("type", "")
                or "").lower()
        if not uid or kind not in ("metric", "tagk", "tagv"):
            raise BadRequestError("Missing/invalid uid or type")
        if request.method in ("POST", "PUT"):
            try:
                meta = meta_store.sync_uid_meta(
                    kind, uid, fields, request.method == "PUT")
            except MetaStore.NotModified:
                return HttpResponse(304, b"")
            except LookupError:
                raise HttpError(
                    404, "Could not find the requested UID") from None
            return HttpResponse(200, json.dumps(meta.to_json()).encode())
        if request.method == "DELETE":
            meta_store.delete_uid_meta(kind, uid)
            return HttpResponse(204, b"")
        raise HttpError(405, "Method not allowed")

    @staticmethod
    def _meta_request_fields(request: HttpRequest) -> dict:
        """The body's JSON, or the query-string form of the same fields
        (ref: parseUIDMetaQS / parseTSMetaQS)."""
        if request.body:
            return request.json_object()
        out = {}
        for key in ("uid", "type", "tsuid", "m", "displayName",
                    "display_name", "description", "notes", "units",
                    "dataType", "retention", "max", "min"):
            val = request.param(key)
            if val is not None:
                out["displayName" if key == "display_name"
                    else key] = val
        return out

    def _ts_meta(self, request: HttpRequest) -> HttpResponse:
        """TSMeta by ``tsuid`` or ``m=metric{tagk=tagv,...}``
        (``create=true`` makes the document): GET, POST merges, PUT
        replaces, DELETE."""
        meta_store = self.tsdb.meta
        if request.method == "GET":
            tsuid = (request.param("tsuid", "") or "").upper()
            meta = meta_store.get_ts_meta(tsuid)
            if meta is None:
                raise HttpError(
                    404, "Could not find Timeseries meta data")
            return HttpResponse(200, json.dumps(meta.to_json()).encode())
        fields = self._meta_request_fields(request)
        tsuid = (fields.get("tsuid") or request.param("tsuid", "")
                 or "").upper()
        create = False
        if not tsuid:
            mspec = fields.get("m") or request.param("m")
            if not mspec:
                raise BadRequestError("Missing tsuid or m parameter")
            try:
                tsuid = self._tsuid_for_metric(mspec)
            except LookupError as e:
                # an unknown name in the spec is the client's error
                raise HttpError(404, str(e)) from None
            create = (fields.get("create") or request.param(
                "create", "") or "") in ("true", True)
        if request.method in ("POST", "PUT"):
            try:
                meta = meta_store.sync_ts_meta(
                    tsuid, fields, request.method == "PUT",
                    create=create)
            except MetaStore.NotModified:
                return HttpResponse(304, b"")
            except LookupError as e:
                raise HttpError(404, str(e)) from None
            return HttpResponse(200, json.dumps(meta.to_json()).encode())
        if request.method == "DELETE":
            meta_store.delete_ts_meta(tsuid)
            return HttpResponse(204, b"")
        raise HttpError(405, "Method not allowed")

    def _tsuid_for_metric(self, mspec: str) -> str:
        """``metric{tagk=tagv,...}`` -> its TSUID in hex
        (ref: UniqueIdRpc.getTSUIDForMetric)."""
        m = re.match(r"^([^{]+)(?:\{([^}]*)\})?$", mspec.strip())
        if not m:
            raise BadRequestError(f"Invalid metric spec {mspec!r}")
        uids = self.tsdb.uids
        metric_id = uids.metrics.get_id(m.group(1))
        tag_ids = []
        for pair in (m.group(2) or "").split(","):
            if not pair:
                continue
            k, _, v = pair.partition("=")
            tag_ids.append((uids.tag_names.get_id(k.strip()),
                            uids.tag_values.get_id(v.strip())))
        return uids.tsuid(metric_id, sorted(tag_ids)).hex().upper()

    # -- tree (ref: TreeRpc.java) --------------------------------------

    def _handle_tree(self, request: HttpRequest, rest) -> HttpResponse:
        from opentsdb_tpu_torch.tree.rpc import handle_tree_request
        return handle_tree_request(self, request, rest)

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

    def _handle_lifecycle(self, request: HttpRequest, rest
                          ) -> HttpResponse:
        """The data lifecycle's admin surface (ref: ``_handle_lifecycle``):

        - ``GET /api/lifecycle``: policies, demotion and spill
          boundaries, sweep counters;
        - ``POST``/``PUT /api/lifecycle``: replace the policy table
          (``{"policies": [{"metric": "*", "retention": "90d",
          "demoteAfter": "6h", "demoteTiers": ["1m"]}, ...]}``);
        - ``POST /api/lifecycle/sweep``: run one sweep and answer its
          report (the sweeper thread runs on
          ``tsd.lifecycle.interval_s``)."""
        lc = self.tsdb.lifecycle
        if lc is None:
            raise HttpError(400, "Data lifecycle is disabled",
                            "set tsd.lifecycle.enable = true")
        if rest and rest[0] == "sweep":
            if request.method != "POST":
                raise HttpError(405, "Method not allowed",
                                "POST runs one sweep")
            return HttpResponse(200, json.dumps(lc.sweep()).encode())
        if rest:
            raise HttpError(404, f"Endpoint not found: "
                            f"/api/lifecycle/{rest[0]}")
        if request.method == "GET":
            return HttpResponse(200, json.dumps(lc.describe()).encode())
        if request.method in ("POST", "PUT"):
            lc.update_policies(request.json_object())
            return HttpResponse(200, json.dumps(lc.describe()).encode())
        raise HttpError(405, "Method not allowed")

    def _handle_stats(self, request: HttpRequest, rest) -> HttpResponse:
        """(ref: StatsRpc.java; /api/stats + /query /jvm /threads
        /region_clients, and the reference's /raw, /query_shapes,
        /tenants and, on a cluster router, /fleet)"""
        sub = rest[0] if rest else ""
        if sub == "fleet":
            # the router's fleet-wide merge of its shards' raw stats
            cluster = self.tsdb.cluster
            if cluster is None:
                raise HttpError(
                    400, "/api/stats/fleet requires tsd.cluster.role "
                    "= router", "per-node stats live at /api/stats[/raw]")
            return HttpResponse(200, json.dumps(
                cluster.fleet_stats()).encode())
        if sub == "query":
            return HttpResponse(200, request.serializer.format_query_stats(
                QueryStats.running_and_completed()))
        if sub == "raw":
            # the records and the histograms at full resolution (a
            # merge sums buckets; percentiles do not merge)
            collector = self.tsdb.stats.collect(latency_percentiles=False)
            self.tsdb.collect_stats(collector)
            return HttpResponse(200, json.dumps({
                "ts": int(time.time()),
                "records": [{"metric": name, "value": value, "tags": tags}
                            for name, value, tags in collector.records],
                "histograms": [
                    {"name": name, "labels": labels, **hist.snapshot()}
                    for name, labels, hist
                    in self.tsdb.stats.histograms()],
            }).encode())
        if sub == "query_shapes":
            return self._handle_query_shapes(request)
        if sub == "tenants":
            # the raw attribute: a stats read must not build the plane
            ctl = self.tsdb._control
            doc = ctl.qos.describe() if ctl is not None else {
                "enabled": self.tsdb.config.get_bool(
                    "tsd.control.qos.enable", False)}
            return HttpResponse(200, json.dumps(doc).encode())
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

    # -- observability -------------------------------------------------

    def _handle_metrics(self, request: HttpRequest) -> HttpResponse:
        """``GET /metrics``: the OpenMetrics exposition of the whole
        stats registry (ref: ``_handle_metrics``)."""
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        return HttpResponse(200, openmetrics.render(self.tsdb),
                            content_type=openmetrics.CONTENT_TYPE)

    def _handle_logs(self, request: HttpRequest) -> HttpResponse:
        """``/logs``: the in-process log ring, newest first (ref:
        LogsRpc; ``?json`` for a JSON array)."""
        lines = ring_buffer.lines()
        if request.flag("json"):
            return HttpResponse(200, json.dumps(lines).encode())
        return HttpResponse(200, "\n".join(lines).encode(),
                            content_type="text/plain")

    def _handle_profile(self, request: HttpRequest, rest) -> HttpResponse:
        """``GET /api/profile?seconds=N``: the sampling profiler's
        trailing window as collapsed stacks, or ``?format=json``;
        ``?role=query`` keeps one thread role (ref: ``_handle_profile``)."""
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        profiler = self.tsdb.profiler
        if not profiler.enabled or profiler.hz <= 0:
            raise HttpError(400, "Profiling is disabled",
                            "set tsd.profile.enable = true and "
                            "tsd.profile.hz > 0")
        seconds = as_int(request.param("seconds"), "seconds",
                         profiler.ring_s)
        role = request.param("role", "") or ""
        fmt = request.param("format", "collapsed") or "collapsed"
        if fmt == "json":
            return HttpResponse(200, json.dumps({
                "seconds": min(max(seconds, 1), profiler.ring_s),
                "hz": profiler.hz,
                "roles": profiler.report(seconds, role),
                "profiler": profiler.health_info(),
            }).encode())
        if fmt != "collapsed":
            raise HttpError(400, "format must be collapsed or json")
        return HttpResponse(200, profiler.collapsed(seconds, role).encode(),
                            content_type="text/plain; charset=UTF-8")

    def _handle_query_shapes(self, request: HttpRequest) -> HttpResponse:
        """``GET /api/stats/query_shapes``: a top-N summary of the
        query-shape log (the current and one rotated generation) by
        shape, with counts, the cache-outcome mix and p50/p95 of the
        duration and of each stage (ref: ``_handle_query_shapes``)."""
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        path = self.tsdb.tracer.shape_path
        if not path:
            raise HttpError(
                400, "Query-shape logging is disabled",
                "needs tsd.trace.enable + tsd.trace.shapes.enable "
                "and a tsd.storage.data_dir")
        limit = as_int(request.param("limit"), "limit", 20)
        shapes: dict[tuple, dict[str, Any]] = {}
        lines_read = 0
        for p in (path + ".1", path):
            if not os.path.isfile(p):
                continue
            with open(p, "r", encoding="utf-8") as fh:
                for line in fh:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue  # the torn tail of a rotation
                    if not isinstance(doc, dict):
                        continue
                    lines_read += 1
                    key = (doc.get("metrics", ""),
                           doc.get("aggregator", ""),
                           doc.get("downsample", ""),
                           doc.get("filters", 0), doc.get("pixels", 0))
                    s = shapes.get(key)
                    if s is None:
                        s = shapes[key] = {"count": 0, "cache": {},
                                           "durations": [], "stages": {}}
                    s["count"] += 1
                    outcome = str(doc.get("cache", "unknown"))
                    s["cache"][outcome] = s["cache"].get(outcome, 0) + 1
                    s["durations"].append(float(doc.get("durationMs",
                                                        0.0)))
                    for stage, ms in (doc.get("stages") or {}).items():
                        s["stages"].setdefault(stage, []).append(
                            float(ms))

        def pct(vals: list, q: float) -> float:
            if not vals:
                return 0.0
            vs = sorted(vals)
            return round(vs[min(int(len(vs) * q / 100.0), len(vs) - 1)],
                         3)

        top = sorted(shapes.items(), key=lambda kv:
                     (-kv[1]["count"], kv[0]))[:max(limit, 1)]
        out = []
        for (metrics, agg, ds, nfilters, px), s in top:
            out.append({
                "metrics": metrics, "aggregator": agg,
                "downsample": ds, "filters": nfilters, "pixels": px,
                "count": s["count"], "cacheOutcomes": s["cache"],
                "durationMs": {"p50": pct(s["durations"], 50),
                               "p95": pct(s["durations"], 95)},
                "stagesMs": {stage: {"p50": pct(vals, 50),
                                     "p95": pct(vals, 95)}
                             for stage, vals in sorted(s["stages"].items())},
            })
        return HttpResponse(200, json.dumps({
            "shapes": out, "distinctShapes": len(shapes),
            "linesRead": lines_read, "source": path}).encode())

    def _handle_trace(self, request: HttpRequest, rest) -> HttpResponse:
        """The trace surface (ref: ``_handle_trace``):

        - ``GET /api/trace``: the retained roots, newest first;
          ``?status=ok|error``, ``?min_duration_ms=N``, ``?slow=true``
          (the slow ring only), ``?limit=N``;
        - ``GET /api/trace/<id>``: one trace's spans and their tree. On a
          cluster router the shards' subtrees are fetched and stitched
          under their ``cluster.peer`` spans, and shards that could not
          answer are listed in ``stitchIncomplete``; ``?local=true``
          skips the stitch (what the router sends a shard)."""
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        tracer = self.tsdb.tracer
        if not tracer.enabled:
            raise HttpError(400, "Tracing is disabled",
                            "set tsd.trace.enable = true")
        if not rest:
            limit = as_int(request.param("limit"), "limit", 50)
            min_ms = float(request.param("min_duration_ms", "0") or "0")
            status = request.param("status", "") or ""
            if status not in ("", "ok", "error"):
                raise HttpError(400, "status must be ok or error")
            return HttpResponse(200, json.dumps(tracer.recent(
                status=status, min_duration_ms=min_ms,
                slow_only=request.flag("slow"), limit=limit)).encode())
        trace_id = rest[0]
        data = tracer.get(trace_id)
        spans = list(data.spans) if data is not None else []
        incomplete: list[str] = []
        cluster = self.tsdb.cluster
        if cluster is not None and not request.flag("local"):
            # ask the shards even when the router's own copy was
            # evicted: their subtrees may outlive it
            extra, incomplete = cluster.fetch_peer_trace(trace_id)
            spans.extend(SpanRecord.from_json(d) for d in extra)
        if not spans:
            raise HttpError(404, f"No trace with id {trace_id!r}",
                            "evicted from the ring, or never "
                            "retained (see tsd.trace.sample)")
        doc: dict[str, Any] = {
            "traceId": trace_id,
            "slow": bool(data is not None and data.slow),
            "spanCount": len(spans),
            "spans": [s.to_json() for s in spans],
            "tree": build_tree(spans)}
        if incomplete:
            doc["stitchIncomplete"] = incomplete
        return HttpResponse(200, json.dumps(doc).encode())

    def _handle_cluster(self, request: HttpRequest, rest) -> HttpResponse:
        """The cluster admin surface of a router (ref:
        ``_handle_cluster``):

        - ``GET /api/cluster``: the router's health document (ring,
          peers, spools, counters);
        - ``GET /api/cluster/status``: the operator progress document
          (spool backlog and dirty debt per peer, with drain ETAs);
        - ``POST /api/cluster/reshard``: install a new ring at a
          fenced epoch (body: ``{"peers": "[name=]host:port,...",
          "vnodes": 64}``). The cutover window writes to the old and
          the new owners, keeps reads on the old ring and backfills
          the moved series in the background; the epoch finalizes
          itself when the copy completes. 400 on an empty spec, a
          renamed address, or while another reshard is open;
        - ``GET /api/cluster/reshard``: the same document (operators
          poll it to watch the window close).

        ``POST /api/cluster/gossip`` applies a sibling router's push
        and answers the ack; a router that names no siblings
        (``tsd.cluster.routers``) answers the reference's 400."""
        cluster = self.tsdb.cluster
        if cluster is None:
            raise HttpError(400, "/api/cluster requires tsd.cluster.role "
                            "= router", "this TSD is not a cluster router")
        sub = rest[0] if rest else ""
        if sub == "status":
            if request.method != "GET":
                raise HttpError(405, "Method not allowed")
            return HttpResponse(200, json.dumps(
                cluster.cluster_status()).encode())
        if sub == "gossip":
            if request.method != "POST":
                raise HttpError(405, "Method not allowed")
            if cluster.gossip is None:
                raise HttpError(400,
                                "gossip is not configured on this router",
                                "set tsd.cluster.routers to the sibling "
                                "list")
            try:
                ack = cluster.gossip.apply_remote(request.json_object())
            except ValueError as exc:
                raise BadRequestError(str(exc)) from None
            return HttpResponse(200, json.dumps(ack).encode())
        if sub == "reshard":
            if request.method == "POST":
                obj = request.json_object(default={})
                peers = obj.get("peers")
                if not isinstance(peers, str) or not peers.strip():
                    raise BadRequestError(
                        "reshard body needs a peers spec string")
                info = cluster.begin_reshard(
                    peers, as_int(obj.get("vnodes"), "vnodes", 0))
                return HttpResponse(200, json.dumps(info).encode())
            if request.method == "GET":
                return HttpResponse(200, json.dumps(
                    cluster.reshard_info()).encode())
            raise HttpError(405, "Method not allowed")
        if rest:
            raise HttpError(404, f"Endpoint not found: /api/cluster/{sub}")
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        return HttpResponse(200, json.dumps(
            cluster.health_info()).encode())

    def _handle_control(self, request: HttpRequest, rest) -> HttpResponse:
        """The control plane (ref: ``_handle_control``):

        - ``GET /api/control``: the loop and each actuator;
        - ``GET /api/control/materialized``: the standing auto continuous
          queries with their scores and mined bodies;
        - ``GET /api/control/plan``: the placement assessment (none on a
          TSD that is not a cluster router);
        - ``POST /api/control/plan``: confirm a proposal (``{"planId":
          ...}``): 400, no proposal stands here;
        - ``POST /api/control/tick``: one tick now, with its report."""
        ctl = self.tsdb.control
        if ctl is None:
            raise HttpError(400, "The control plane is disabled",
                            "set tsd.control.enable = true")
        sub = rest[0] if rest else ""
        if sub == "materialized":
            if request.method != "GET":
                raise HttpError(405, "Method not allowed")
            return HttpResponse(200, json.dumps(
                ctl.materialized_info()).encode())
        if sub == "plan":
            if request.method == "GET":
                return HttpResponse(200,
                                    json.dumps(ctl.plan_info()).encode())
            if request.method == "POST":
                obj = request.json_object(default={})
                return HttpResponse(200, json.dumps(ctl.apply_plan(
                    str(obj.get("planId", "")))).encode())
            raise HttpError(405, "Method not allowed")
        if sub == "tick":
            if request.method != "POST":
                raise HttpError(405, "Method not allowed",
                                "POST runs one control tick")
            return HttpResponse(200, json.dumps(ctl.tick()).encode())
        if rest:
            raise HttpError(404, f"Endpoint not found: /api/control/{sub}")
        if request.method != "GET":
            raise HttpError(405, "Method not allowed")
        return HttpResponse(200, json.dumps(ctl.describe()).encode())

    def _handle_health(self, request: HttpRequest, rest) -> HttpResponse:
        """``/api/health`` (ref: ``_handle_health``): the WAL, every
        breaker, the caches, the continuous queries, the lifecycle, the
        stores' footprint, the latency percentiles, SLO burn, the
        profiler, the tracer, the telemetry pump, the cluster tier (a
        router's peers, spools and fleet rows, else the role) and the
        control plane, with the connections and admission when a server
        is attached.
        Always 200: ``status`` carries the verdict and ``causes`` why.
        Each lazy subsystem is read through its raw attribute, so health
        never builds one to report it absent."""
        t = self.tsdb
        causes: list[str] = []
        breakers: dict[str, Any] = {}

        def breaker(b) -> None:
            if b is not None:
                breakers[b.name] = b.health_info()
                if b.state != b.CLOSED:
                    causes.append(f"breaker:{b.name}")

        wal_info: dict[str, Any] = {"enabled": t.wal is not None}
        if t.wal is not None:
            wal_info.update(t.wal.health_info())
            if wal_info.get("degraded"):
                causes.append("wal_sync")
            if wal_info.get("durability_hole"):
                causes.append("wal_durability_hole")
        breaker(t.device_breaker)
        rcache = t._result_cache
        if rcache is not None:
            cache_info = rcache.health_info()
            cache_info["enabled"] = t.config.get_bool(
                "tsd.query.cache.enable", True)
        else:
            cache_info = {"enabled": t.config.get_bool(
                "tsd.query.cache.enable", True)
                and t.config.get_int("tsd.query.cache.mb", 256) > 0}
        streaming = t._streaming
        if streaming is not None:
            streaming_info = streaming.health_info()
            breaker(streaming.breaker)
        else:
            streaming_info = {"enabled": t.config.get_bool(
                "tsd.streaming.enable", True), "queries": 0}
        lifecycle = t._lifecycle
        if lifecycle is not None:
            lifecycle_info = lifecycle.health_info()
            breaker(lifecycle.breaker)
            if lifecycle.coldstore is not None:
                breaker(lifecycle.coldstore.read_breaker)
        else:
            lifecycle_info = {"enabled": t.config.get_bool(
                "tsd.lifecycle.enable", False)}
        clus = t._cluster
        if clus is not None:
            cluster_info = clus.health_info()
            # one status row per shard (a scattered /api/health, breaker
            # aware): an unreachable shard is a row, never a 5xx here
            cluster_info["fleet"] = clus.fleet_health()
            if cluster_info["fleet"]["degraded"]:
                causes.append("fleet_shards_degraded")
            dirty_age = cluster_info["replica_dirty"].get("oldest_age_s",
                                                          0)
            rr_age = cluster_info["read_repair"].get(
                "oldest_pending_age_s", 0)
            if dirty_age > 3600 or rr_age > 3600:
                causes.append("replica_dirty_debt_stale")
            gossip_info = cluster_info["gossip"]
            if gossip_info and gossip_info["degraded"]:
                # a sibling router is partitioned: this router serves
                # around its cache until its pushes land again
                causes.append("cluster_gossip_degraded")
            for _name, peer in sorted(clus.peers.items()):
                # a shard being served around (degraded partials and
                # spooled writes), not failed
                breaker(peer.breaker)
            if cluster_info["spool_backlog_records"]:
                causes.append("cluster_spool_backlog")
        else:
            cluster_info = {"role": t.config.get_string(
                "tsd.cluster.role", "") or "standalone"}
        ctl = t._control
        if ctl is not None:
            control_info = ctl.describe()
            breaker(ctl.breaker)
        else:
            control_info = {"enabled": t.config.get_bool(
                "tsd.control.enable", False)}
        doc: dict[str, Any] = {
            "status": "degraded" if causes else "ok",
            "degraded": bool(causes),
            "causes": causes,
            "uptime_seconds": int(time.time() - t.start_time),
            "wal": wal_info,
            "breakers": breakers,
            "faults": t.faults.health_info(),
            "query_cache": cache_info,
            "streaming": streaming_info,
            "lifecycle": lifecycle_info,
            "storage": t.storage_memory_info(),
            "query_payload": t.payload_stats.health_info(),
            "latency": t.stats.latency_summary(),
            "slo": t.slo.health_info(),
            "profiler": t.profiler.health_info(),
            "trace": t.tracer.health_info(),
            "telemetry": t.telemetry.health_info(),
            # the router's peers, spools and counters, or the role
            "cluster": cluster_info,
            "control": control_info,
            "hook_errors": dict(t.hook_errors),
        }
        server = self.server
        if server is not None:
            cm = server.connections
            doc["connections"] = {
                "open": cm.open_connections,
                "total": cm.total_connections,
                "refused": cm.rejected_connections,
                "idle_closed": cm.idle_closed,
                "limit": cm.max_connections,
            }
            doc["admission"] = server.admission.health_info(
                server.query_queue_depth())
        return HttpResponse(200, json.dumps(doc).encode())

    def _runtime_stats(self) -> dict[str, Any]:
        import gc
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
