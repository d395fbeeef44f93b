"""The TSD network server (ref: ``src/tsd/PipelineFactory.java:44``,
``src/tools/TSDMain.java:48``).

One asyncio server on one port speaking both HTTP and the telnet line
protocol, told apart by sniffing the first bytes of a connection as
the reference's ``DetectHttpOrRpc`` does (PipelineFactory.java:134-171):
a first token that looks like an HTTP method makes the connection HTTP
(with keep-alive), otherwise each line is a telnet command.

The event loop never touches the device: queries run on a bounded
``tsd-query`` pool (``tsd.query.workers``), every other request and the
telnet commands on a ``tsd-http`` pool. A continuous query's event
stream (``text/event-stream``) is written with no query timeout, no
gzip and no buffering, chunked, and closes its connection; its frames
are produced on the loop's default executor, and a client that goes
away closes the stream's generator. :meth:`TSDServer.start` starts the
continuous queries' fold workers and the warmup thread
(:mod:`~opentsdb_tpu_torch.tsd.warmup`); :meth:`TSDServer.stop` stops
the warmup, ends the event streams, closes the listener, joins both
pools and the warmup thread, and shuts the TSDB down.
:class:`ServerThread` runs a server on a thread of its own with its own
loop, for callers that are not asyncio programs.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import gzip
import json
import logging
import re
import threading
import time
import urllib.parse
import zlib

from opentsdb_tpu_torch.tsd.http_api import (HttpRequest, HttpResponse,
                                             HttpRpcRouter)
from opentsdb_tpu_torch.tsd.telnet import (TelnetCloseConnection,
                                           TelnetRouter,
                                           TelnetServerShutdown)
from opentsdb_tpu_torch.tsd.warmup import start_warmup_thread

LOG = logging.getLogger("tsd.server")

_HTTP_METHODS = (b"GET ", b"POST", b"PUT ", b"DELE", b"HEAD", b"OPTI",
                 b"PATC")
_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Request Entity Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable", 504: "Gateway Timeout"}


def _api_endpoint(path: str) -> str:
    """The path's first endpoint segment with the ``/api[/vN]`` prefix
    stripped (agreeing with HttpRpcRouter._dispatch's parse)."""
    parts = [p for p in path.split("/") if p]
    if parts and parts[0] == "api":
        parts = parts[1:]
        if parts and re.fullmatch(r"v[0-9]+", parts[0]):
            parts = parts[1:]
    return parts[0] if parts else ""


def _structured_error(status: int, message: str,
                      details: str = "", **headers) -> HttpResponse:
    """A structured error body for the framing layer, which answers
    before any serializer is bound."""
    doc: dict = {"error": {"code": status, "message": message}}
    if details:
        doc["error"]["details"] = details
    return HttpResponse(status, json.dumps(doc).encode(),
                        headers=dict(headers))


class IdleTimeout(Exception):
    """A connection sat idle past ``tsd.core.socket.timeout``."""


class ConnectionManager:
    """(ref: src/tsd/ConnectionManager.java:37)"""

    def __init__(self, max_connections: int = 0):
        self.max_connections = max_connections
        self.open_connections = 0
        self.total_connections = 0
        self.rejected_connections = 0
        self.exceptions_unknown = 0
        self.idle_closed = 0

    def accept(self) -> bool:
        if self.max_connections and \
                self.open_connections >= self.max_connections:
            self.rejected_connections += 1
            return False
        self.open_connections += 1
        self.total_connections += 1
        return True

    def release(self) -> None:
        self.open_connections -= 1

    def collect_stats(self, collector) -> None:
        collector.record("connectionmgr.connections",
                         self.open_connections, type="open")
        collector.record("connectionmgr.connections",
                         self.total_connections, type="total")
        collector.record("connectionmgr.exceptions",
                         self.rejected_connections, type="rejected")
        collector.record("connectionmgr.connections", self.idle_closed,
                         type="idle_closed")
        collector.record("connectionmgr.exceptions",
                         self.exceptions_unknown, type="unknown")
        collector.record("connections.refused",
                         self.rejected_connections)


class AdmissionController:
    """Query load shedding: once in-flight queries or the query pool's
    queue cross their thresholds, a new query is answered with a
    structured 503 + ``Retry-After`` instead of queueing without bound.
    Writes and admin endpoints are never shed."""

    CAUSES = ("inflight", "queue")

    def __init__(self, max_inflight: int = 0, max_queue: int = 0,
                 retry_after_s: int = 1):
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self.retry_after_s = max(retry_after_s, 1)
        # try_admit runs on the event loop and counts an admitted query
        # in flight; finished runs on the worker thread: only the
        # worker finishing frees the slot, so a timed-out query holds
        # it while its thread runs
        self._lock = threading.Lock()
        self.inflight = 0
        self.shed_counts = {cause: 0 for cause in self.CAUSES}

    def try_admit(self, queue_depth: int) -> str | None:
        """The shed cause, or None when admitted (the caller then owes
        one :meth:`finished`)."""
        with self._lock:
            if self.max_inflight and self.inflight >= self.max_inflight:
                self.shed_counts["inflight"] += 1
                return "inflight"
            if self.max_queue and queue_depth >= self.max_queue:
                self.shed_counts["queue"] += 1
                return "queue"
            self.inflight += 1
            return None

    def finished(self) -> None:
        with self._lock:
            self.inflight -= 1

    def collect_stats(self, collector) -> None:
        collector.record("admission.inflight", self.inflight)
        for cause, n in self.shed_counts.items():
            collector.record("admission.shed", n, cause=cause)


class TSDServer:
    """(ref: TSDMain.java:71)"""

    # responses below this size aren't worth the deflate round trip
    _GZIP_MIN_BYTES = 1024

    def __init__(self, tsdb, host: str | None = None,
                 port: int | None = None):
        self.tsdb = tsdb
        config = tsdb.config
        self.host = host or config.get_string("tsd.network.bind")
        # 0 binds an ephemeral port; start() sets the bound one here
        self.port = port if port is not None else \
            config.get_int("tsd.network.port")
        self.http_router = HttpRpcRouter(tsdb)
        self.http_router.server = self
        self.telnet_router = TelnetRouter(tsdb)
        self.connections = ConnectionManager(
            config.get_int("tsd.core.connections.limit", 0))
        tsdb.stats.register(self.connections)
        self.admission = AdmissionController(
            max_inflight=config.get_int("tsd.query.admission.max_inflight"),
            max_queue=config.get_int("tsd.query.admission.max_queue"),
            retry_after_s=config.get_int(
                "tsd.query.admission.retry_after_s"))
        tsdb.stats.register(self.admission)
        self.cors_domains = [
            d.strip() for d in config.get_string(
                "tsd.http.request.cors_domains").split(",") if d.strip()]
        # ms; 0 = no limit (ref: tsd.query.timeout expiring queries)
        self.query_timeout_ms = config.get_int("tsd.query.timeout")
        # seconds a connection may sit idle (ref: the IdleStateHandler
        # of PipelineFactory.java:169); 0 never reaps
        self.socket_timeout_s = config.get_int("tsd.core.socket.timeout",
                                               0)
        self.max_body = config.get_int("tsd.http.request.max_chunk") * 64
        self.enable_chunked = config.get_bool(
            "tsd.http.request.enable_chunked")
        # queries run on their own bounded pool, so abandoned
        # (timed-out) query threads cannot starve puts and admin calls
        self._query_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=config.get_int("tsd.query.workers", 8),
            thread_name_prefix="tsd-query")
        self._http_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="tsd-http")
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._warmup_thread: threading.Thread | None = None

    # -- life cycle ----------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port,
            backlog=self.tsdb.config.get_int("tsd.network.backlog"),
            reuse_address=self.tsdb.config.get_bool(
                "tsd.network.reuse_address"))
        self.port = self._server.sockets[0].getsockname()[1]
        # load the libraries and run the warm set on the query device
        # in the background (tsd.tpu.warmup), so the first query of
        # each class does not pay for it
        self._warmup_thread = start_warmup_thread(self.tsdb)
        # the fold workers start now rather than in the first ingest
        # burst that crosses the drain threshold
        streaming = self.tsdb.streaming
        if streaming is not None and streaming.workers.enabled:
            streaming.workers.start()
        LOG.info("Ready to serve on %s:%s", self.host, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._shutdown.wait()
        await self.stop()

    async def stop(self) -> None:
        """Stop the warmup between classes and end the event streams,
        close the listener, wait (at most 10 s) for open connections,
        join both worker pools and the warmup thread, and shut the TSDB
        down."""
        if self.tsdb._warmup_stop is not None:
            self.tsdb._warmup_stop.set()
        if self.tsdb._streaming is not None:
            # deregistering ends every stream with its "end" event
            self.tsdb._streaming.shutdown()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 10)
            except asyncio.TimeoutError:
                LOG.warning("connections still open after 10s; "
                            "forcing shutdown")
            self._server = None
        # a timed-out query may still run: the join waits for it, so no
        # worker outlives the server
        self._query_pool.shutdown(wait=True, cancel_futures=True)
        self._http_pool.shutdown(wait=True, cancel_futures=True)
        th = self._warmup_thread
        if th is not None and th.is_alive():
            await asyncio.get_running_loop().run_in_executor(
                None, th.join, 30)
        self.tsdb.shutdown()

    def request_shutdown(self) -> None:
        """Ask :meth:`serve_forever` to stop; callable from any thread
        (HTTP diediedie runs on a worker)."""
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._shutdown.set)
        else:
            self._shutdown.set()

    # -- connections ---------------------------------------------------

    async def _on_client(self, coro):
        """Await a client-facing read or drain under the idle deadline."""
        if self.socket_timeout_s <= 0:
            return await coro
        try:
            return await asyncio.wait_for(coro, self.socket_timeout_s)
        except asyncio.TimeoutError:
            self.connections.idle_closed += 1
            raise IdleTimeout() from None

    def query_queue_depth(self) -> int:
        """Pending (unstarted) tasks of the query pool (``_work_queue``
        is CPython's; 0 if a runtime hides it, and admission then rests
        on the in-flight limit alone)."""
        queue = getattr(self._query_pool, "_work_queue", None)
        return queue.qsize() if queue is not None else 0

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        if not self.connections.accept():
            # the protocol is unknown here: speak HTTP, so an HTTP
            # client sees a proper 503 and a telnet client one line
            try:
                await self._refuse(reader, writer, _structured_error(
                    503, "Connection limit exceeded",
                    "tsd.core.connections.limit reached; retry later",
                    **{"Retry-After": str(self.admission.retry_after_s)}))
            except ConnectionError:
                pass  # the client left before its refusal
            writer.close()
            return
        try:
            # protocol sniff (ref: DetectHttpOrRpc.decode :134)
            first = await self._on_client(reader.read(4))
            if not first:
                return
            if first in _HTTP_METHODS or first[:3] == b"GET":
                await self._serve_http(first, reader, writer)
            else:
                await self._serve_telnet(first, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except IdleTimeout:
            LOG.info("closing idle connection (tsd.core.socket.timeout="
                     "%ds)", self.socket_timeout_s)
        except TelnetServerShutdown:
            writer.write(b"Cleanup complete, shutting down.\n")
            await writer.drain()
            self.request_shutdown()
        except Exception:  # noqa: BLE001 - one connection's fault
            LOG.exception("connection handler error")
            self.connections.exceptions_unknown += 1
        finally:
            self.connections.release()
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass  # the peer reset an already-closing connection

    # -- telnet --------------------------------------------------------

    async def _serve_telnet(self, first: bytes, reader, writer) -> None:
        buffer = first
        loop = asyncio.get_running_loop()
        while True:
            if buffer.find(b"\n") < 0:
                chunk = await self._on_client(reader.read(65536))
                if not chunk:
                    break
                buffer += chunk
                continue
            # every complete line already buffered: a pipelined put
            # burst decodes as one batch (TelnetRouter.execute_lines)
            raw, _, buffer = buffer.rpartition(b"\n")
            lines = [ln.rstrip(b"\r").decode("utf-8", "replace")
                     for ln in raw.split(b"\n")]
            responses, deferred = await loop.run_in_executor(
                self._http_pool, self.telnet_router.execute_lines, lines)
            if responses:
                writer.write("\n".join(responses).encode() + b"\n")
                await self._on_client(writer.drain())
            if isinstance(deferred, TelnetCloseConnection):
                return
            if deferred is not None:
                raise deferred

    # -- http ----------------------------------------------------------

    async def _refuse(self, reader, writer, response: HttpResponse,
                      version: str = "HTTP/1.1") -> None:
        """Answer an early protocol error, then drain briefly before the
        close: closing with unread body bytes sends an RST that can
        destroy the response in flight."""
        await self._write_response(writer, response, version, False)
        try:
            for _ in range(16):
                chunk = await asyncio.wait_for(reader.read(65536), 0.2)
                if not chunk:
                    break
        except (asyncio.TimeoutError, ConnectionError):
            pass

    async def _read_chunked(self, reader, buffer: bytes):
        """Dechunk a ``Transfer-Encoding: chunked`` request body (ref:
        Netty's HttpChunkAggregator behind
        tsd.http.request.enable_chunked). Returns (body, remainder,
        error): error is "framing" for a malformed stream (the caller
        drops the connection) or "too_large" past the body limit."""
        body = bytearray()
        buffer = bytearray(buffer)

        async def need(pred) -> bool:
            while not pred():
                if len(buffer) > 8192 + len(body):
                    return False
                chunk = await self._on_client(reader.read(65536))
                if not chunk:
                    return False
                buffer.extend(chunk)
            return True

        while True:
            if not await need(lambda: b"\r\n" in buffer):
                return None, b"", "framing"
            size_line, _, rest = bytes(buffer).partition(b"\r\n")
            buffer = bytearray(rest)
            # strict ASCII hex: int()'s leniency (underscores, signs)
            # is a request-smuggling precondition
            hex_part = size_line.split(b";")[0].strip()
            if not re.fullmatch(rb"[0-9A-Fa-f]{1,16}", hex_part):
                return None, b"", "framing"
            size = int(hex_part, 16)
            if len(body) + size > self.max_body:
                return None, b"", "too_large"
            if size == 0:
                # the terminal chunk: consume optional trailers up to
                # the blank line so keep-alive framing stays in step
                if not await need(lambda: buffer.startswith(b"\r\n")
                                  or b"\r\n\r\n" in buffer):
                    return None, b"", "framing"
                if buffer.startswith(b"\r\n"):
                    del buffer[:2]
                else:
                    buffer = bytearray(
                        bytes(buffer).split(b"\r\n\r\n", 1)[1])
                return bytes(body), bytes(buffer), ""
            while len(buffer) < size + 2:  # data + trailing CRLF
                chunk = await self._on_client(reader.read(65536))
                if not chunk:
                    return None, b"", "framing"
                buffer.extend(chunk)
            if buffer[size:size + 2] != b"\r\n":
                return None, b"", "framing"
            body += buffer[:size]
            del buffer[:size + 2]

    async def _read_body(self, reader, writer, headers: dict,
                         buffer: bytes):
        """(body, remainder), or None after refusing the request."""
        te = [t.strip() for t in headers.get("transfer-encoding", "")
              .lower().split(",") if t.strip()]
        if te and te[-1] != "chunked":
            # RFC 9112: with a final coding other than chunked the body
            # length is unknowable; falling back to Content-Length is a
            # request-smuggling precondition
            await self._refuse(reader, writer, _structured_error(
                400, "Unsupported Transfer-Encoding: final coding must "
                "be chunked"))
            return None
        if te:
            if not self.enable_chunked:
                # (ref: HttpQuery rejects chunked requests unless
                # tsd.http.request.enable_chunked)
                await self._refuse(reader, writer, _structured_error(
                    400, "Chunked request not supported; set "
                    "tsd.http.request.enable_chunked"))
                return None
            body, rest, err = await self._read_chunked(reader, buffer)
            if body is None:
                if err == "too_large":
                    await self._refuse(reader, writer, _structured_error(
                        413, "content too large"))
                return None
            return body, rest
        cl = headers.get("content-length", "0")
        if not re.fullmatch(r"[0-9]{1,18}", cl):
            await self._refuse(reader, writer, _structured_error(
                400, "Invalid Content-Length"))
            return None
        length = int(cl)
        if length > self.max_body:
            await self._refuse(reader, writer, _structured_error(
                413, "content too large"))
            return None
        while len(buffer) < length:
            chunk = await self._on_client(reader.read(65536))
            if not chunk:
                return None
            buffer += chunk
        return buffer[:length], buffer[length:]

    async def _serve_http(self, first: bytes, reader, writer) -> None:
        buffer = first
        keep_alive = True
        while keep_alive:
            while b"\r\n\r\n" not in buffer:
                chunk = await self._on_client(reader.read(65536))
                if not chunk:
                    return
                buffer += chunk
            head, _, buffer = buffer.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, target, version = lines[0].split(" ", 2)
            except ValueError:
                return
            headers = {}
            for hline in lines[1:]:
                name, _, val = hline.partition(":")
                headers[name.strip().lower()] = val.strip()
            got = await self._read_body(reader, writer, headers, buffer)
            if got is None:
                return
            body, buffer = got
            parsed = urllib.parse.urlsplit(target)
            peer = writer.get_extra_info("peername")
            keep_alive = (version == "HTTP/1.1" and
                          headers.get("connection", "").lower() != "close")
            t0 = time.monotonic()
            request = HttpRequest(
                method=method.upper(), path=parsed.path,
                params=urllib.parse.parse_qs(parsed.query,
                                             keep_blank_values=True),
                headers=headers, body=body,
                remote=f"{peer[0]}:{peer[1]}" if peer else "")
            response = await self._respond(request, t0)
            self._apply_cors(request, response)
            # an event stream is long-lived by design, and gzip would
            # hold its events in the compressor: no deadline, no gzip
            is_sse = response.content_type.startswith("text/event-stream")
            if not is_sse:
                await self._apply_gzip(request, response)
            if response.close_connection:
                keep_alive = False
            deadline = (t0 + self.query_timeout_ms / 1000.0
                        if self.query_timeout_ms > 0 and not is_sse
                        and response.body_iter is not None else None)
            await self._write_response(writer, response, version,
                                       keep_alive, deadline=deadline)

    async def _respond(self, request: HttpRequest,
                       t0: float) -> HttpResponse:
        """Route one request on its pool: queries on the query pool
        (admission-controlled, under ``tsd.query.timeout``), the rest
        on the http pool. Feeds the latency histograms."""
        if request.method == "OPTIONS":
            return self._cors_preflight(request)
        loop = asyncio.get_running_loop()
        endpoint = _api_endpoint(urllib.parse.unquote(request.path))
        is_query = endpoint in ("query", "q")
        if not is_query:
            response = await loop.run_in_executor(
                self._http_pool, self.http_router.handle, request)
            if endpoint == "put":
                self.tsdb.stats.latency_put.add(
                    (time.monotonic() - t0) * 1000)
            return response
        cause = self.admission.try_admit(self.query_queue_depth())
        if cause is not None:
            LOG.warning("shedding query %s (%s; %d in flight)",
                        request.path, cause, self.admission.inflight)
            return self._overload_response(cause)

        def run() -> HttpResponse:
            try:
                return self.http_router.handle(request)
            finally:
                self.admission.finished()

        fut = loop.run_in_executor(self._query_pool, run)
        if self.query_timeout_ms > 0:
            try:
                # shield: the worker runs on to its end, and the
                # cancelled wait must not mark its future cancelled
                response = await asyncio.wait_for(
                    asyncio.shield(fut), self.query_timeout_ms / 1000.0)
            except asyncio.TimeoutError:
                response = _structured_error(
                    504, f"Query timeout exceeded "
                    f"({self.query_timeout_ms}ms)")
        else:
            response = await fut
        self.tsdb.stats.latency_query.add((time.monotonic() - t0) * 1000)
        return response

    def _overload_response(self, cause: str) -> HttpResponse:
        """Structured load-shed answer (503 + Retry-After)."""
        message = {"inflight": "too many in-flight queries",
                   "queue": "query queue is full"}[cause]
        return _structured_error(
            503, f"Service overloaded: {message}",
            f"shed cause: {cause}; retry after "
            f"{self.admission.retry_after_s}s",
            **{"Retry-After": str(self.admission.retry_after_s)})

    def _cors_preflight(self, request: HttpRequest) -> HttpResponse:
        """(ref: RpcHandler CORS handling :46)"""
        if not self.cors_domains:
            return HttpResponse(405, b"")
        resp = HttpResponse(200, b"")
        resp.headers["Access-Control-Allow-Methods"] = \
            "GET, POST, PUT, DELETE"
        resp.headers["Access-Control-Allow-Headers"] = \
            self.tsdb.config.get_string("tsd.http.request.cors_headers")
        return resp

    def _apply_cors(self, request: HttpRequest,
                    response: HttpResponse) -> None:
        origin = request.headers.get("origin", "")
        if not origin or not self.cors_domains:
            return
        if "*" in self.cors_domains or origin in self.cors_domains:
            response.headers["Access-Control-Allow-Origin"] = origin

    async def _apply_gzip(self, request: HttpRequest,
                          response: HttpResponse) -> None:
        """Compress a large response body when the client accepts gzip
        (ref: Netty's HttpContentCompressor in PipelineFactory). The
        deflate runs on the http pool; a streamed body compresses chunk
        by chunk."""
        accept = request.headers.get("accept-encoding", "")
        if "gzip" not in accept.lower():
            return
        if response.body_iter is not None:
            inner = response.body_iter

            def gz_iter():
                co = zlib.compressobj(6, zlib.DEFLATED, 31)  # gzip header
                for chunk in inner:
                    out = co.compress(chunk)
                    if out:
                        yield out
                yield co.flush()

            response.body_iter = gz_iter()
        elif len(response.body) >= self._GZIP_MIN_BYTES:
            response.body = await asyncio.get_running_loop() \
                .run_in_executor(self._http_pool, gzip.compress,
                                 response.body, 6)
        else:
            return
        response.headers["Content-Encoding"] = "gzip"
        # shared caches must key on the encoding
        response.headers["Vary"] = "Accept-Encoding"

    @staticmethod
    def _head(response: HttpResponse, version: str,
              keep_alive: bool) -> bytes:
        reason = _REASONS.get(response.status, "Unknown")
        head = [f"{version} {response.status} {reason}"]
        if response.body_iter is not None:
            head.append("Transfer-Encoding: chunked")
            head.append(f"Content-Type: {response.content_type}")
        else:
            head.append(f"Content-Length: {len(response.body)}")
            if response.body:
                head.append(f"Content-Type: {response.content_type}")
        head.append("Connection: " +
                    ("keep-alive" if keep_alive else "close"))
        for k, v in response.headers.items():
            head.append(f"{k}: {v}")
        return "\r\n".join(head).encode("latin-1") + b"\r\n\r\n"

    async def _write_response(self, writer, response: HttpResponse,
                              version: str, keep_alive: bool,
                              deadline: float | None = None) -> None:
        loop = asyncio.get_running_loop()
        is_sse = response.content_type.startswith("text/event-stream")
        if response.body_iter is not None and version != "HTTP/1.1":
            if is_sse:
                # an event stream never ends by itself, so it cannot be
                # joined into one body: it needs chunked transfer
                response.body_iter.close()
                response = _structured_error(
                    400, "Event streams require HTTP/1.1")
                response.close_connection = True
                keep_alive = False
            else:
                # chunked transfer needs 1.1: older clients get one
                # body, joined on the http pool (serialization is CPU
                # work)
                it = response.body_iter
                response.body = await loop.run_in_executor(
                    self._http_pool, b"".join, it)
                response.body_iter = None
        writer.write(self._head(response, version, keep_alive))
        if response.body_iter is None:
            writer.write(response.body)
            await self._on_client(writer.drain())
            return
        # stream bounded chunks; the generator (the JSON serialization)
        # advances on the http pool so other connections keep being
        # served, and drain applies backpressure. An event stream's
        # generator waits for its events on the default executor, so a
        # quiet stream holds none of the http pool's workers
        pool = None if is_sse else self._http_pool
        it = iter(response.body_iter)
        sentinel = object()
        fut = None
        try:
            while True:
                if deadline is not None and time.monotonic() > deadline:
                    # past the query timeout mid-stream: abort (headers
                    # are sent; an unterminated chunked body says so)
                    LOG.warning("query stream exceeded tsd.query.timeout;"
                                " aborting")
                    raise ConnectionResetError("stream timeout")
                fut = loop.run_in_executor(pool, next, it, sentinel)
                chunk = await fut
                if chunk is sentinel:
                    break
                if chunk:
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk
                                 + b"\r\n")
                    await self._on_client(writer.drain())
            writer.write(b"0\r\n\r\n")
            await self._on_client(writer.drain())
        finally:
            # a client that went away closes the generator (an event
            # stream then leaves its query's subscribers); one still
            # inside next() is closed when that call returns
            close = getattr(it, "close", None)
            if close is not None:
                if fut is None or fut.done():
                    close()
                else:
                    fut.add_done_callback(lambda _f: close())


class ServerThread:
    """A :class:`TSDServer` on a daemon thread with its own event loop:
    ``start()`` returns once the port is bound (``.port``), ``stop()``
    asks the server to stop and joins the thread, which ends after the
    server has joined its pools and shut the TSDB down."""

    def __init__(self, tsdb, host: str = "127.0.0.1", port: int = 0):
        self.server = TSDServer(tsdb, host=host, port=port)
        self._ready = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run,
                                        name="tsd-server", daemon=True)

    def _run(self) -> None:
        async def main():
            await self.server.start()
            self._ready.set()
            await self.server.serve_forever()

        try:
            asyncio.run(main())
        except BaseException as e:  # noqa: BLE001 - handed to start()
            self._error = e
        finally:
            self._ready.set()

    @property
    def port(self) -> int:
        return self.server.port

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("the TSD server did not start in time")
        if self._error is not None:
            raise self._error
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self.server.request_shutdown()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the TSD server did not stop in time")
        if self._error is not None:
            raise self._error

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
