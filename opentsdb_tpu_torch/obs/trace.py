"""Per-request tracing: cheap sampled span records (ref:
``opentsdb_tpu/obs/trace.py``).

1. **Overhead is first-class.** With ``tsd.trace.enable = false`` (or
   outside a traced request) every instrumentation site costs one
   thread-local read returning ``None``. With tracing on, a span is two
   ``time.monotonic()`` calls, one small object and one lock-guarded
   list append; spans wrap request-scoped stages, never per-point work.
   Sampling (``tsd.trace.sample`` = keep 1 in N request roots) gates
   only retention: every request records its spans, so the slow-request
   log can keep any slow trace whole, and the per-stage latency
   histograms see every request.
2. **Host clocks.** A span reads the host's monotonic clock. A CUDA
   launch returns before its kernel runs, so the card's time lands in
   the stage that first reads a result on the host: ``query.execute``,
   which wraps the whole pipeline and its ``.cpu()`` copies. No span
   synchronizes the device.
3. **Slow traces are never lost.** ``tsd.query.slowlog.threshold_ms``
   forces retention of any query root past the threshold (and a WARN in
   the ``/logs`` ring carrying the trace id) into a bounded slow ring of
   its own.

Span names form a closed registry (:data:`KNOWN_SPANS`): starting an
unregistered name raises. The ``X-TSD-Trace`` header
(``trace_id:parent_span_id:sampled``) is honored only in the shard role
of a cluster (``tsd.cluster.role = shard``): a router stamps it on each
leg, so the shard roots its subtree under that leg's span, and a shard
that serves several legs of one trace merges them into one retained
trace, which the router stitches behind ``GET /api/trace/<id>``.

The query-shape log: each committed ``query.http`` trace appends one
JSONL line (metric, filters, downsample, pixel budget, cache outcome,
stage breakdown, continuous-query candidate) to a bounded rotating file
in ``data_dir``, which the control plane's miner reads.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import secrets
import threading
import time
from collections import deque
from typing import Any

LOG = logging.getLogger("obs.trace")

# ---------------------------------------------------------------------------
# span-name registry
# ---------------------------------------------------------------------------
# Every span name started anywhere — roots and stages — must resolve
# here: :meth:`TraceContext.begin` enforces it at run time, so a typo'd
# stage name fails the first test that crosses it instead of silently
# recording an orphan stage.

KNOWN_SPANS: frozenset[str] = frozenset({
    # request roots
    "ingest.put",            # HTTP /api/put body
    "ingest.telnet",         # one telnet put burst
    "query.http",            # /api/query
    # background roots
    "lifecycle.sweep",       # lifecycle/manager.py sweep
    "streaming.drain",       # streaming/workers.py off-path fold drain
    "telemetry.pump",        # obs/telemetry.py self-stats ingest
    "control.loop",          # control/plane.py one control tick
    "cluster.spool.replay",  # cluster/router.py spool catch-up drain
    "cluster.replica.repair",  # cluster/router.py anti-entropy pass
    "cluster.reshard.backfill",  # cluster/reshard.py moved-key copy
    "cluster.retire",        # cluster/retire.py stale-copy delete
    "cluster.gossip.push",   # cluster/gossip.py sibling push round
    "cluster.read_repair",   # cluster/router.py staged-hint drain
    # ingest stages
    "ingest.decode",         # body parse + validate + series grouping
    "store.scatter",         # columnar store appends (+ inline taps)
    "wal.commit_wait",       # WAL group-commit fsync wait
    "stream.tap",            # continuous-query ingest tap
    # query stages
    "query.admission",       # admission + worker-queue wait
    "query.streaming_lookup",  # CQ registry try_serve
    "query.plan",            # store/tier selection, filters, groups
    "sketch.fold",           # lifecycle/manager.py demote-time
                             # quantile-sketch fold (fifth stat column)
    "query.execute",         # scan + device pipeline (parent stage);
                             # holds the wait on the card
    "query.assemble",        # result assembly incl. pixel reduce
    "query.serialize",       # response body serialization
    # cluster stages
    "cluster.scatter",       # router read fan-out (parent stage)
    "cluster.peer",          # one shard's scatter leg (error = degraded)
    "cluster.merge",         # cross-shard partial merge
    "cluster.forward",       # one shard's write-forward leg
    "cluster.spool.append",  # durable handoff of one write batch
    "cluster.wire.connect",  # binary wire negotiation (cluster/wire.py)
    "cluster.cq",            # one federated-CQ shard exchange
    "cluster.cq.pump",       # one merged cross-shard delta drain
    # background stages
    "coldstore.spill",       # lifecycle sweep's disk spill phase
})

#: wire header carrying trace identity across the cluster tier
TRACE_HEADER = "x-tsd-trace"

# id generation: trace/span ids need UNIQUENESS (across restarts and
# across cluster nodes, so stitched trees never alias), not
# unpredictability — os.urandom per request cost ~50us/trace, an
# order of magnitude over the rest of the tracer combined. One random
# process nonce + a counter gives both properties at ~1us.
_PROC_NONCE = secrets.token_hex(4)
_id_lock = threading.Lock()
_id_counter = 0


def _next_id() -> str:
    global _id_counter
    with _id_lock:
        _id_counter += 1
        n = _id_counter
    return f"{_PROC_NONCE}{n:08x}"


def parse_trace_header(value: str) -> tuple[str, str, bool] | None:
    """``trace_id:parent_span_id:sampled_flag`` -> parts, or None on
    anything malformed (a hostile header must never 500 a write)."""
    if not value or len(value) > 128:
        return None
    parts = value.split(":")
    if len(parts) != 3:
        return None
    trace_id, parent, flag = parts
    if not (1 <= len(trace_id) <= 32 and trace_id.isalnum()):
        return None
    if len(parent) > 32 or not all(
            c.isalnum() or c == "-" for c in parent):
        return None
    return trace_id, parent, flag == "1"


# ---------------------------------------------------------------------------
# thread-local current context
# ---------------------------------------------------------------------------

_local = threading.local()


def current() -> "TraceContext | None":
    """The active request's trace context on THIS thread, or None.
    Deep layers (WAL, engine, router) read this instead of threading
    a context parameter through every signature."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use(ctx: "TraceContext | None"):
    """Bind ``ctx`` as the thread's current trace context for the
    scope (None is a no-op bind — instrumentation sees no context).
    Fan-out workers re-bind the parent's context so sub-query spans
    land in the right trace."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def trace_begin(name: str, ctx: "TraceContext | None" = None,
                parent: str | None = None, **tags) -> "SpanHandle | None":
    """Open a span on the current (or given) context; None when
    untraced — pair with :func:`trace_end`. For straight-line regions
    with early exits prefer :func:`trace_span`."""
    c = ctx if ctx is not None else getattr(_local, "ctx", None)
    if c is None:
        return None
    return c.begin(name, parent=parent, **tags)


def trace_end(handle: "SpanHandle | None",
              error: BaseException | None = None) -> None:
    if handle is not None:
        if error is not None:
            handle.set_error(error)
        handle.finish()


@contextlib.contextmanager
def trace_span(name: str, ctx: "TraceContext | None" = None, **tags):
    """Span context manager: exceptions mark the span ``error`` and
    propagate."""
    h = trace_begin(name, ctx=ctx, **tags)
    try:
        yield h
    except BaseException as exc:
        trace_end(h, error=exc)
        raise
    else:
        trace_end(h)


def record_span(ctx: "TraceContext | None", name: str,
                start_mono: float, end_mono: float, **tags) -> None:
    """Record an already-timed span (e.g. the admission/queue wait,
    whose start predates the context)."""
    if ctx is None:
        return
    ctx.record(name, start_mono, end_mono, **tags)


# ---------------------------------------------------------------------------
# span model
# ---------------------------------------------------------------------------

class SpanRecord:
    """One finished span. Immutable once appended to its context."""

    __slots__ = ("span_id", "parent_id", "name", "start_ms",
                 "duration_ms", "status", "error", "tags")

    def __init__(self, span_id: str, parent_id: str, name: str,
                 start_ms: float, duration_ms: float,
                 status: str = "ok", error: str = "",
                 tags: dict | None = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ms = start_ms
        self.duration_ms = duration_ms
        self.status = status
        self.error = error
        self.tags = tags or {}

    def to_json(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "spanId": self.span_id, "parentId": self.parent_id,
            "name": self.name,
            "startMs": round(self.start_ms, 3),
            "durationMs": round(self.duration_ms, 3),
            "status": self.status,
        }
        if self.error:
            doc["error"] = self.error
        if self.tags:
            doc["tags"] = self.tags
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "SpanRecord":
        return cls(str(doc.get("spanId", "")),
                   str(doc.get("parentId", "")),
                   str(doc.get("name", "?")),
                   float(doc.get("startMs", 0.0)),
                   float(doc.get("durationMs", 0.0)),
                   str(doc.get("status", "ok")),
                   str(doc.get("error", "")),
                   doc.get("tags") or {})


class SpanHandle:
    """An OPEN span: carry tags, then :meth:`finish` to record."""

    __slots__ = ("_ctx", "span_id", "parent_id", "name", "tags",
                 "_t0", "status", "error", "_done")

    def __init__(self, ctx: "TraceContext", span_id: str,
                 parent_id: str, name: str, tags: dict):
        self._ctx = ctx
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tags = tags
        self._t0 = time.monotonic()
        self.status = "ok"
        self.error = ""
        self._done = False

    def tag(self, **tags) -> None:
        self.tags.update(tags)

    def set_error(self, exc: BaseException | str) -> None:
        self.status = "error"
        self.error = (f"{type(exc).__name__}: {exc}"
                      if isinstance(exc, BaseException) else str(exc))

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self._ctx._append(self, self._t0, time.monotonic())

    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set_error(exc)
        self.finish()
        return False


class TraceContext:
    """One request's (or background root's) in-flight trace."""

    __slots__ = ("tracer", "trace_id", "root_name", "remote",
                 "sampled", "forced", "parent_id", "root_span_id",
                 "start_epoch_ms", "_t0", "_lock", "spans",
                 "_next_span", "_nonce", "finished", "committed",
                 "slow", "error", "tags", "dropped_spans")

    def __init__(self, tracer: "Tracer", trace_id: str,
                 root_name: str, sampled: bool, forced: bool,
                 parent_id: str = "", remote: str = ""):
        self.tracer = tracer
        self.trace_id = trace_id
        self.root_name = root_name
        self.remote = remote
        self.sampled = sampled
        self.forced = forced
        self.parent_id = parent_id
        # per-context nonce keeps span ids globally unique so a
        # stitched cross-node tree can never alias parent links
        self._nonce = _next_id()
        self.root_span_id = f"{self._nonce}-0"
        self.start_epoch_ms = time.time() * 1000.0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        # capped by the tracer's
        # tsd.trace.max_spans (overflow counted in spans_dropped),
        # and the context dies with its request
        self.spans: list[SpanRecord] = []
        self._next_span = 0
        self.finished = False
        self.committed = False
        self.slow = False
        self.error = ""
        self.tags: dict[str, Any] = {}
        self.dropped_spans = 0

    # -- span surface --------------------------------------------------

    def begin(self, name: str, parent: str | None = None,
              **tags) -> SpanHandle | None:
        if name not in KNOWN_SPANS:
            raise ValueError(
                f"unknown span name {name!r}; register it in "
                f"obs/trace.py KNOWN_SPANS")
        with self._lock:
            if self.finished or \
                    len(self.spans) >= self.tracer.max_spans:
                self.dropped_spans += 1
                return None
            self._next_span += 1
            sid = f"{self._nonce}-{self._next_span}"
        return SpanHandle(self, sid,
                          parent if parent is not None
                          else self.root_span_id, name, tags)

    def record(self, name: str, start_mono: float, end_mono: float,
               **tags) -> None:
        """Append an already-timed span (see :func:`record_span`)."""
        h = self.begin(name, **tags)
        if h is None:
            return
        h._t0 = start_mono
        self._append(h, start_mono, end_mono)

    def _append(self, h: SpanHandle, t0: float, t1: float) -> None:
        rec = SpanRecord(
            h.span_id, h.parent_id, h.name,
            self.start_epoch_ms + (t0 - self._t0) * 1000.0,
            (t1 - t0) * 1000.0, h.status, h.error, h.tags)
        with self._lock:
            if self.finished:
                self.dropped_spans += 1
                return
            self.spans.append(rec)

    # -- root surface --------------------------------------------------

    def tag(self, **tags) -> None:
        self.tags.update(tags)

    def set_error(self, exc: BaseException | str) -> None:
        self.error = (f"{type(exc).__name__}: {exc}"
                      if isinstance(exc, BaseException) else str(exc))

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1000.0


class TraceData:
    """One committed trace in the ring."""

    __slots__ = ("trace_id", "root", "spans", "slow")

    def __init__(self, trace_id: str, root: SpanRecord,
                 spans: tuple, slow: bool):
        self.trace_id = trace_id
        self.root = root
        self.spans = spans  # root first
        self.slow = slow

    def summary(self) -> dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "name": self.root.name,
            "startMs": round(self.root.start_ms, 3),
            "durationMs": round(self.root.duration_ms, 3),
            "status": self.root.status,
            "error": self.root.error,
            "spans": len(self.spans),
            "slow": self.slow,
        }


def build_tree(spans: list[SpanRecord]) -> list[dict[str, Any]]:
    """Nest flat span records by parent id; orphans (parent not in
    the set — e.g. a shard subtree whose router leg was evicted)
    become additional roots so no span is ever silently dropped."""
    nodes = {s.span_id: dict(s.to_json(), children=[]) for s in spans}
    roots: list[dict] = []
    for s in spans:
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id)
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(n):
        n["children"].sort(key=lambda c: c["startMs"])
        for c in n["children"]:
            _sort(c)
    for r in roots:
        _sort(r)
    roots.sort(key=lambda n: n["startMs"])
    return roots


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Owns the sampling decision, the bounded trace rings, the
    slow-request log and the query-shape log. One per TSDB."""

    def __init__(self, config, data_dir: str = "", stats=None):
        self.enabled = config.get_bool("tsd.trace.enable", True)
        # the X-TSD-Trace header is honored ONLY in shard role — it
        # is the router→shard propagation channel, not a client
        # surface: an external client sending forged headers to a
        # standalone/router TSD could otherwise bypass sampling
        # (per-request shape-log writes, ring churn) and overwrite
        # the very trace ids an operator is investigating
        self.accept_headers = config.get_string(
            "tsd.cluster.role", "") == "shard"
        self.sample_n = max(config.get_int("tsd.trace.sample", 64), 1)
        self.max_spans = max(
            config.get_int("tsd.trace.max_spans", 512), 16)
        self.slow_ms = config.get_float(
            "tsd.query.slowlog.threshold_ms", 0.0)
        self.stats = stats  # StatsCollectorRegistry (stage histograms)
        self._lock = threading.Lock()
        self._ring: deque[TraceData] = deque(
            maxlen=max(config.get_int("tsd.trace.ring", 256), 1))
        self._slow_ring: deque[TraceData] = deque(
            maxlen=max(config.get_int("tsd.trace.slow_ring", 64), 1))
        self._index: dict[str, TraceData] = {}
        self._root_count = 0
        # counters (exported via collect_stats + /api/health)
        self.traces_started = 0
        self.traces_committed = 0
        self.traces_sampled_out = 0
        self.slow_traces = 0
        self.spans_dropped = 0
        # query-shape log: bounded JSONL ring file in data_dir
        self.shape_path = ""
        if data_dir and config.get_bool("tsd.trace.shapes.enable",
                                        True):
            self.shape_path = os.path.join(data_dir,
                                           "query_shapes.jsonl")
        self.shape_max_bytes = max(
            config.get_int("tsd.trace.shapes.max_kb", 1024), 1) * 1024
        self._shape_lock = threading.Lock()
        self._shape_fh = None
        self.shape_lines = 0
        self.shape_errors = 0

    # -- root creation -------------------------------------------------

    def _sample_next(self) -> bool:
        """Deterministic 1-in-N retention: the 1st, (N+1)th, ... roots
        are kept — a counter, not a coin flip, so trace batteries (and
        the bench) reproduce exactly."""
        with self._lock:
            self._root_count += 1
            return (self._root_count - 1) % self.sample_n == 0

    def start_request(self, name: str, request=None,
                      remote: str = "") -> TraceContext | None:
        """Root a request trace, honoring an ``X-TSD-Trace`` header
        when present (cluster propagation: the upstream router made
        the sampling decision and this node's subtree must exist iff
        the router's tree does). Returns None when tracing is off."""
        if not self.enabled:
            return None
        if name not in KNOWN_SPANS:
            raise ValueError(
                f"unknown span name {name!r}; register it in "
                f"obs/trace.py KNOWN_SPANS")
        trace_id = parent_id = ""
        forced = False
        headers = getattr(request, "headers", None) \
            if self.accept_headers else None
        if headers:
            parsed = parse_trace_header(
                headers.get(TRACE_HEADER, ""))
            if parsed is not None:
                trace_id, parent_id, forced = parsed
        if trace_id:
            sampled = forced
        else:
            trace_id = _next_id()
            sampled = self._sample_next()
        ctx = TraceContext(
            self, trace_id, name, sampled, forced,
            parent_id=parent_id,
            remote=remote or getattr(request, "remote", ""))
        with self._lock:
            self.traces_started += 1
        # the admission/queue wait predates this context: synthesize
        # it from the server's receipt stamp so the trace shows where
        # a loaded TSD's queries actually wait
        received = getattr(request, "received_at", 0.0)
        if received and name == "query.http":
            record_span(ctx, "query.admission", received,
                        time.monotonic())
        return ctx

    def start_background(self, name: str, sample: bool = False,
                         **tags) -> TraceContext | None:
        """Root a background trace (sweep, spill, drain, replay).
        ``sample=True`` applies the 1-in-N retention (for
        high-frequency roots like fold drains); the default retains
        every occurrence — background roots are rare and are exactly
        what an operator goes looking for."""
        if not self.enabled:
            return None
        if name not in KNOWN_SPANS:
            raise ValueError(
                f"unknown span name {name!r}; register it in "
                f"obs/trace.py KNOWN_SPANS")
        sampled = self._sample_next() if sample else True
        ctx = TraceContext(self, _next_id(), name, sampled, False)
        if tags:
            ctx.tag(**tags)
        with self._lock:
            self.traces_started += 1
        return ctx

    def header_for(self, ctx: TraceContext,
                   span: SpanHandle | None = None) -> str:
        """The ``X-TSD-Trace`` value a downstream hop should carry:
        the hop's subtree hangs off ``span`` (this node's per-peer
        span) and inherits the retention decision.

        With a slowlog configured, QUERY hops always propagate
        flag=1: slow-retention is decided at finish, AFTER the shards
        already chose whether to keep their subtrees — without this a
        slow-but-unsampled router trace would commit locally and
        stitch an empty tree, losing exactly the evidence the
        slowlog exists for. Shard rings are bounded, so the cost is
        churn, not growth."""
        parent = span.span_id if span is not None else \
            ctx.root_span_id
        keep = ctx.sampled or ctx.forced or \
            (self.slow_ms > 0 and ctx.root_name.startswith("query"))
        return f"{ctx.trace_id}:{parent}:{'1' if keep else '0'}"

    # -- finish / commit -----------------------------------------------

    def finish(self, ctx: TraceContext | None) -> bool:
        """Close a root: feed the stage histograms, decide retention
        (sampled | propagated-sampled | slow | error), commit to the
        ring(s). Returns whether the trace was retained."""
        if ctx is None:
            return False
        with ctx._lock:
            if ctx.finished:
                return ctx.committed
            ctx.finished = True
            spans = list(ctx.spans)
            dropped = ctx.dropped_spans
        duration_ms = ctx.elapsed_ms()
        root = SpanRecord(
            ctx.root_span_id, ctx.parent_id, ctx.root_name,
            ctx.start_epoch_ms, duration_ms,
            "error" if ctx.error else "ok", ctx.error, dict(ctx.tags))
        # per-stage latency histograms see EVERY traced request —
        # sampling gates only ring retention, so /api/stats
        # percentiles are not biased toward the sampled subset
        stats = self.stats
        if stats is not None:
            stats.observe_stage(root.name, duration_ms)
            for s in spans:
                stats.observe_stage(s.name, s.duration_ms)
        slow = (self.slow_ms > 0 and duration_ms >= self.slow_ms
                and ctx.root_name.startswith("query"))
        commit = ctx.sampled or ctx.forced or slow or bool(ctx.error)
        data = TraceData(ctx.trace_id, root,
                         tuple([root] + spans), slow)
        with self._lock:
            self.spans_dropped += dropped
            if not commit:
                self.traces_sampled_out += 1
            else:
                self.traces_committed += 1
                if slow:
                    self.slow_traces += 1
                existing = self._index.get(ctx.trace_id)
                if existing is not None:
                    # a shard can serve SEVERAL legs of one trace
                    # (per-sub retries, hedged duplicates): merge the
                    # new leg's spans into the retained trace in place
                    data = TraceData(ctx.trace_id, existing.root,
                                     existing.spans + data.spans,
                                     existing.slow or slow)
                    self._index[ctx.trace_id] = data
                    for ring in (self._ring, self._slow_ring):
                        for i, d in enumerate(ring):
                            if d is existing:
                                ring[i] = data
                                break
                        else:
                            continue
                        break
                else:
                    ring = self._slow_ring if slow else self._ring
                    if len(ring) == ring.maxlen:
                        evicted = ring[0]
                        if self._index.get(evicted.trace_id) is evicted:
                            del self._index[evicted.trace_id]
                    ring.append(data)
                    self._index[ctx.trace_id] = data
        ctx.slow = slow
        ctx.committed = commit
        if slow:
            # the WARN lands in the /logs ring; the trace id is the
            # cross-reference into /api/trace/<id>
            LOG.warning(
                "slow query trace=%s %.1fms >= slowlog threshold "
                "%.0fms (remote=%s, retained at full fidelity)",
                ctx.trace_id, duration_ms, self.slow_ms, ctx.remote)
        if commit and ctx.root_name == "query.http" and \
                self.shape_path:
            self._write_shape(ctx, root, spans)
        return commit

    # -- retrieval -----------------------------------------------------

    def get(self, trace_id: str) -> TraceData | None:
        with self._lock:
            return self._index.get(trace_id)

    def recent(self, status: str = "", min_duration_ms: float = 0.0,
               slow_only: bool = False, limit: int = 50
               ) -> list[dict[str, Any]]:
        with self._lock:
            items = list(self._slow_ring) if slow_only else \
                list(self._ring) + list(self._slow_ring)
        items.sort(key=lambda d: d.root.start_ms, reverse=True)
        out = []
        for d in items:
            if status and d.root.status != status:
                continue
            if d.root.duration_ms < min_duration_ms:
                continue
            out.append(d.summary())
            if len(out) >= max(limit, 1):
                break
        return out

    # -- query-shape log -----------------------------------------------

    def _write_shape(self, ctx: TraceContext, root: SpanRecord,
                     spans: list[SpanRecord]) -> None:
        stages: dict[str, float] = {}
        for s in spans:
            stages[s.name] = round(
                stages.get(s.name, 0.0) + s.duration_ms, 3)
        line = json.dumps({
            "ts": round(root.start_ms / 1000.0, 3),
            "traceId": ctx.trace_id,
            "durationMs": round(root.duration_ms, 3),
            "status": root.status,
            "slow": ctx.slow,
            **{k: v for k, v in root.tags.items()},
            "stages": stages,
        }) + "\n"
        try:
            with self._shape_lock:
                fh = self._shape_fh
                if fh is None:
                    fh = self._shape_fh = open(self.shape_path, "a",
                                               encoding="utf-8")
                fh.write(line)
                fh.flush()
                if fh.tell() >= self.shape_max_bytes:
                    # bounded ring: one rotation generation keeps the
                    # most recent window without unbounded growth
                    fh.close()
                    self._shape_fh = None
                    os.replace(self.shape_path,
                               self.shape_path + ".1")
                self.shape_lines += 1
        except OSError:
            # mining data must never fail (or slow) a served query
            self.shape_errors += 1

    def close(self) -> None:
        with self._shape_lock:
            if self._shape_fh is not None:
                try:
                    self._shape_fh.close()
                except OSError:  # pragma: no cover - teardown race
                    LOG.warning("query-shape log close failed")
                self._shape_fh = None

    # -- observability about the observer ------------------------------

    def collect_stats(self, collector) -> None:
        collector.record("trace.started", self.traces_started)
        collector.record("trace.committed", self.traces_committed)
        collector.record("trace.sampled_out", self.traces_sampled_out)
        collector.record("trace.slow", self.slow_traces)
        collector.record("trace.spans_dropped", self.spans_dropped)
        collector.record("trace.shape_lines", self.shape_lines)
        collector.record("trace.shape_errors", self.shape_errors)

    def health_info(self) -> dict[str, Any]:
        with self._lock:
            ring_len = len(self._ring)
            slow_len = len(self._slow_ring)
        return {
            "enabled": self.enabled,
            "sample": self.sample_n,
            "ring": ring_len,
            "slow_ring": slow_len,
            "slowlog_threshold_ms": self.slow_ms,
            "started": self.traces_started,
            "committed": self.traces_committed,
            "sampled_out": self.traces_sampled_out,
            "slow": self.slow_traces,
            "spans_dropped": self.spans_dropped,
            "shape_log": self.shape_path,
            "shape_lines": self.shape_lines,
        }
