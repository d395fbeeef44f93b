"""The port's request tracer (``opentsdb_tpu_torch/obs/trace.py``) and its
trace sites, held to the JAX package's (``opentsdb_tpu/obs/trace.py``)
on the CPU.

- The tracer core: the cases of the reference's ``TestTracerCore``
  that need no cluster shard role, each run on both tracers with the
  same calls and compared answer for answer.
- The span trees of the requests the port serves: ``/api/put``,
  ``/api/query`` on the K1 path, a two-sub fan-out, a pull served by a
  continuous query, a result-cache hit, a telnet burst (both stores),
  the WAL's commit wait, a lifecycle sweep with its spill and sketch
  fold, and a fold worker's drain. Each request goes to both packages
  on the same data, and the two trees must be equal by names, parents
  and tags (:func:`torch_obs_pair.tree_shape`; ids, clocks and
  durations left out).

Tolerance: none. Trees and tracer answers compare exactly.
"""

import time

import numpy as np
import pytest

from torch_obs_pair import (ENGINE_KEYS, JAX, PORT, SIDES, T0,
                            T0_MS, both, call, last_trace, put_body,
                            query_obj, shutdown, trace_doc, tree_shape,
                            tsdb)


@pytest.fixture
def pair():
    """One TSDB a side, joined at the end; a test passes its keys."""
    made = []

    def make(**keys):
        out = []
        for side in SIDES:
            t = tsdb(side, **keys)
            made.append(t)
            out.append(t)
        return out

    yield make
    for t in made:
        shutdown(t)


# -- the tracer core ----------------------------------------------------

def _tracer(side, **over):
    return side.trace.Tracer(side.Config(**{**side.keys, **over}))


def test_known_spans_are_the_reference_s_but_cluster():
    """The closed registry: the reference's names less ``cluster.*``,
    which come with ``cluster/``."""
    assert PORT.trace.KNOWN_SPANS == {
        n for n in JAX.trace.KNOWN_SPANS if not n.startswith("cluster.")}


def test_sampling_is_deterministic():
    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "4"})
        pattern = [tracer.finish(tracer.start_request("query.http"))
                   for _ in range(8)]
        return pattern, tracer.traces_committed, tracer.traces_sampled_out

    got, want = both(run)
    assert got == want == ([True, False, False, False] * 2, 2, 6)


def test_unknown_span_name_raises():
    for side in SIDES:
        tracer = _tracer(side)
        with pytest.raises(ValueError, match="KNOWN_SPANS"):
            # tsdlint: allow[trace-sites] deliberately unregistered —
            # this test proves the runtime side of the registry
            tracer.start_request("not.a.span")
        ctx = tracer.start_request("query.http")
        with pytest.raises(ValueError, match="KNOWN_SPANS"):
            ctx.begin("also.not.a.span")
        with pytest.raises(ValueError, match="KNOWN_SPANS"):
            # tsdlint: allow[trace-sites] deliberately unregistered
            tracer.start_background("not.a.root")
        tracer.finish(ctx)


def test_ring_bound_and_index_eviction():
    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "1",
                                  "tsd.trace.ring": "4"})
        ids = []
        for _ in range(10):
            ctx = tracer.start_request("query.http")
            tracer.finish(ctx)
            ids.append(ctx.trace_id)
        kept = [r["traceId"] for r in tracer.recent(limit=100)]
        return (sorted(ids.index(k) for k in kept),
                [tracer.get(i) is None for i in ids])

    got, want = both(run)
    assert got == want
    assert got[0] == [6, 7, 8, 9]


def test_span_cap_drops_and_counts():
    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "1",
                                  "tsd.trace.max_spans": "16"})
        ctx = tracer.start_request("query.http")
        for _ in range(40):
            h = ctx.begin("query.plan")
            if h is not None:
                h.finish()
        tracer.finish(ctx)
        return len(tracer.get(ctx.trace_id).spans), tracer.spans_dropped

    got, want = both(run)
    assert got == want == (17, 24)


def test_disabled_tracer_is_noop():
    for side in SIDES:
        tracer = _tracer(side, **{"tsd.trace.enable": "false"})
        assert tracer.start_request("query.http") is None
        assert tracer.start_background("lifecycle.sweep") is None
        assert tracer.finish(None) is False
        assert side.trace.trace_begin("query.plan") is None


def test_error_trace_always_retained():
    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "1000000"})
        tracer.finish(tracer.start_request("ingest.put"))  # the sampled 1st
        ctx = tracer.start_request("query.http")
        tracer.finish(ctx)
        out = [ctx.committed]
        ctx = tracer.start_request("query.http")
        ctx.set_error(ValueError("boom"))
        out.append(tracer.finish(ctx))
        root = tracer.get(ctx.trace_id).root
        return out + [root.status, root.error]

    got, want = both(run)
    assert got == want == [False, True, "error", "ValueError: boom"]


def test_header_round_trip():
    """The hop header's form (the reference's cluster propagation; the
    port parses it and ignores it outside a shard), and malformed
    values parse to None."""
    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "1"})
        ctx = tracer.start_request("query.http")
        h = ctx.begin("query.plan")
        val = tracer.header_for(ctx, h)
        parsed = side.trace.parse_trace_header(val)
        ok = parsed == (ctx.trace_id, h.span_id, True)
        bad = [side.trace.parse_trace_header(b) for b in (
            "", "a:b", "x" * 200, "id:parent:1:extra", "../../x:p:1",
            "abc:def:0")]
        h.finish()
        tracer.finish(ctx)
        return ok, bad

    got, want = both(run)
    assert got == want
    assert got[0] and got[1][-1] == ("abc", "def", False)


def test_header_ignored_outside_shard_role():
    """``tests/test_obs.py::test_header_ignored_outside_shard_role``: a
    forged header picks neither the trace id nor the sampling."""
    class Req:
        headers = {"x-tsd-trace": "cafe1234cafe1234:abc-1:1"}
        remote = ""
        received_at = 0.0

    def run(side):
        tracer = _tracer(side, **{"tsd.trace.sample": "1000000"})
        tracer.finish(tracer.start_request("ingest.put"))
        ctx = tracer.start_request("query.http", Req())
        return ctx.trace_id == "cafe1234cafe1234", ctx.parent_id, \
            tracer.finish(ctx)

    got, want = both(run)
    assert got == want == (False, "", False)


def test_slowlog_propagates_retention_to_hops():
    def run(side):
        out = []
        for slow in ("200", "0"):
            tracer = _tracer(side, **{
                "tsd.trace.sample": "1000000",
                "tsd.query.slowlog.threshold_ms": slow})
            tracer.finish(tracer.start_request("ingest.put"))
            ctx = tracer.start_request("query.http")
            out.append((ctx.sampled, tracer.header_for(ctx)[-2:]))
            tracer.finish(ctx)
        return out

    got, want = both(run)
    assert got == want == [(False, ":1"), (False, ":0")]


def test_build_tree_orphans_become_roots():
    def run(side):
        rec = side.trace.SpanRecord
        spans = [rec("a-0", "", "query.http", 0.0, 5.0),
                 rec("a-1", "a-0", "query.plan", 1.0, 1.0),
                 rec("b-0", "missing", "query.execute", 2.0, 1.0)]
        return side.trace.build_tree(spans)

    got, want = both(run)
    assert got == want
    assert [r["name"] for r in got] == ["query.http", "query.execute"]


def test_span_record_json_round_trip():
    def run(side):
        rec = side.trace.SpanRecord("a-1", "a-0", "query.plan", 12.3456,
                                    1.5, "error", "boom", {"sub": 0})
        doc = rec.to_json()
        return doc, side.trace.SpanRecord.from_json(doc).to_json()

    got, want = both(run)
    assert got == want
    assert got[0] == got[1]


def test_context_binding_is_thread_local():
    """``use`` binds a context for its block only, and a span opened on
    another thread without a binding records nothing."""
    import threading
    for side in SIDES:
        tracer = _tracer(side, **{"tsd.trace.sample": "1"})
        ctx = tracer.start_request("query.http")
        seen = []
        with side.trace.use(ctx):
            assert side.trace.current() is ctx
            th = threading.Thread(
                target=lambda: seen.append(side.trace.current()))
            th.start()
            th.join()
        assert side.trace.current() is None
        assert seen == [None]
        tracer.finish(ctx)


# -- span trees of served requests --------------------------------------

def _both_trees(pair_tsdbs, send):
    """``send(side, router)`` -> a trace id on each side; the two
    trees' shapes."""
    shapes = []
    for side, t in zip(SIDES, pair_tsdbs):
        router = side.http.HttpRpcRouter(t)
        tid = send(side, router, t)
        shapes.append(tree_shape(trace_doc(side, router, tid)))
    return shapes


def _names(shape) -> set:
    out = set()

    def walk(node):
        out.add(node[0])
        for c in node[3]:
            walk(c)
    for n in shape:
        walk(n)
    return out


def _put(side, router, t, body=None):
    resp = call(side, router, "POST", "/api/put", body or put_body())
    assert resp.status == 204, resp.body
    return resp.headers["X-TSD-Trace-Id"]


def _query(side, router, t, q=None):
    resp = call(side, router, "POST", "/api/query", q or query_obj())
    assert resp.status == 200, resp.body
    return resp.headers["X-TSD-Trace-Id"]


@pytest.mark.parametrize("backend", ["memory", "native"])
def test_put_tree(pair, backend):
    got, want = _both_trees(pair(**{"tsd.storage.backend": backend}), _put)
    assert got == want
    assert {"ingest.put", "ingest.decode", "store.scatter"} <= _names(got)


def test_query_tree_on_the_kernel_path(pair):
    """``/api/query`` at ``ENGINE_KEYS`` (on a card: the K1 launch):
    the root's shape tags and the plan, execute, assemble and serialize
    stages."""
    def send(side, router, t):
        _put(side, router, t, put_body(n=60) + put_body(host="b", n=60))
        q = query_obj(ds="10s-avg")
        q["queries"][0]["filters"] = [
            {"type": "wildcard", "tagk": "host", "filter": "*",
             "groupBy": True}]
        return _query(side, router, t, q)

    got, want = _both_trees(pair(**ENGINE_KEYS), send)
    assert got == want
    assert {"query.http", "query.plan", "query.execute", "query.assemble",
            "query.serialize"} <= _names(got)


def test_two_sub_fan_out_tree(pair):
    """Both subs' stages land in the request's tree: the second runs on
    a ``tsd-subq`` worker, which binds the request's context."""
    def send(side, router, t):
        _put(side, router, t)
        return _query(side, router, t, query_obj(subs=2))

    got, want = _both_trees(
        pair(**ENGINE_KEYS, **{"tsd.query.fanout.workers": "2"}), send)
    assert got == want
    root = got[0]
    assert sum(1 for c in root[3] if c[0] == "query.execute") == 2


def test_cache_hit_tree(pair):
    """A result-cache hit runs no engine: no ``query.execute``, and the
    root is tagged ``cache=hit``."""
    def send(side, router, t):
        _put(side, router, t)
        _query(side, router, t)
        return _query(side, router, t)

    got, want = _both_trees(pair(), send)
    assert got == want
    assert "query.execute" not in _names(got)
    assert '"cache": "hit"' in got[0][2]


def test_streaming_served_pull_tree(pair):
    """A pull a continuous query serves: ``query.streaming_lookup``,
    the tail's assembly, ``cache=streaming``."""
    body = {"start": T0_MS, "end": T0_MS + 599_999,
            "queries": [{"metric": "sys.obs", "aggregator": "sum",
                         "downsample": "1m-sum"}]}

    def send(side, router, t):
        _put(side, router, t, put_body(n=300))
        t.streaming.register(dict(body, id="cq1"), now_ms=T0_MS + 600_000)
        return _query(side, router, t, body)

    got, want = _both_trees(pair(**{"tsd.query.cache.enable": "false"}),
                            send)
    assert got == want
    assert "query.streaming_lookup" in _names(got)
    assert '"cache": "streaming"' in got[0][2]


@pytest.mark.parametrize("backend", ["memory", "native"])
def test_telnet_burst_tree(pair, backend):
    def run(t, side):
        router = side.telnet.TelnetRouter(t)
        lines = [f"put sys.tn {T0 + i} {i} host=a" for i in range(8)]
        responses, _exc = router.execute_lines(lines)
        assert not responses
        return tree_shape(trace_doc(side, side.http.HttpRpcRouter(t),
                                    last_trace(t, "ingest.telnet")))

    tt, jt = pair(**{"tsd.storage.backend": backend})
    got, want = run(tt, PORT), run(jt, JAX)
    assert got == want
    assert {"ingest.telnet", "ingest.decode", "store.scatter"} \
        <= _names(got)


def test_single_telnet_put_is_not_a_root(pair):
    for t, side in zip(pair(), SIDES):
        side.telnet.TelnetRouter(t).execute_lines(
            [f"put sys.tn {T0} 1 host=a"])
        assert not [r for r in t.tracer.recent(limit=50)
                    if r["name"] == "ingest.telnet"]


def test_wal_commit_wait_tree(pair, tmp_path):
    made = []
    for side in SIDES:
        made.append(tsdb(side, **{
            "tsd.storage.data_dir": str(tmp_path / side.name),
            "tsd.storage.wal.fsync": "always"}))
    try:
        got, want = _both_trees(made, _put)
    finally:
        for t in made:
            shutdown(t)
    assert got == want
    assert "wal.commit_wait" in _names(got)


def test_lifecycle_sweep_tree(pair, tmp_path):
    """A sweep that demotes, folds sketches and spills: the
    ``lifecycle.sweep`` root with ``sketch.fold`` and
    ``coldstore.spill`` stages and the report's counts as tags."""
    keys = {"tsd.rollups.enable": "true", "tsd.lifecycle.enable": "true",
            "tsd.lifecycle.demote_after": "1h",
            "tsd.lifecycle.demote_tiers": "1m",
            "tsd.lifecycle.spill_after": "2h",
            "tsd.sketch.enable": "true"}
    shapes = []
    made = []
    try:
        for side in SIDES:
            t = tsdb(side, **keys,
                     **{"tsd.storage.data_dir": str(tmp_path / side.name),
                        "tsd.storage.wal.enable": "false"})
            made.append(t)
            rng = np.random.default_rng(3)
            for h in range(4):
                t.add_points("lc.m", T0 + 60 * np.arange(240),
                             rng.normal(10, 2, 240), {"host": f"h{h}"})
            report = t.lifecycle.sweep(now_ms=T0_MS + 6 * 3600_000)
            assert "error" not in report, report
            tid = last_trace(t, "lifecycle.sweep")
            shapes.append(tree_shape(trace_doc(
                side, side.http.HttpRpcRouter(t), tid)))
    finally:
        for t in made:
            shutdown(t)
    got, want = shapes
    assert got == want
    assert {"lifecycle.sweep", "coldstore.spill", "sketch.fold"} \
        <= _names(got)


def test_fold_drain_tree(pair):
    """A burst past ``tsd.streaming.buffer_points`` hands the partial to
    a fold worker, whose drain is a ``streaming.drain`` root."""
    keys = {"tsd.streaming.buffer_points": "16",
            "tsd.streaming.workers.count": "1",
            "tsd.query.cache.enable": "false"}
    body = {"start": T0_MS, "end": T0_MS + 599_999,
            "queries": [{"metric": "sys.obs", "aggregator": "sum",
                         "downsample": "1m-sum"}]}
    shapes = []
    for t, side in zip(pair(**keys), SIDES):
        router = side.http.HttpRpcRouter(t)
        _put(side, router, t, put_body(n=10))
        t.streaming.register(dict(body, id="cq1"), now_ms=T0_MS + 600_000)
        _put(side, router, t, put_body(n=200, base=T0 + 10))
        deadline = time.monotonic() + 30
        while not [r for r in t.tracer.recent(limit=500)
                   if r["name"] == "streaming.drain"]:
            assert time.monotonic() < deadline, "no drain was traced"
            time.sleep(0.01)
        shapes.append(tree_shape(trace_doc(
            side, router, last_trace(t, "streaming.drain"))))
    got, want = shapes
    assert got == want == [("streaming.drain", "ok", "{}", ())]


def test_stage_histograms_see_every_request(pair):
    """Sampling gates retention only: every traced request feeds the
    stage histograms (``/api/stats`` ``tsd.latency.<stage>``)."""
    def run(side, t):
        router = side.http.HttpRpcRouter(t)
        _put(side, router, t)
        for _ in range(3):
            call(side, router, "POST", "/api/query", query_obj())
        summary = t.stats.latency_summary()["stages"]
        return {k: v["count"] for k, v in summary.items()}

    tt, jt = pair(**{"tsd.trace.sample": "1000000",
                     "tsd.query.cache.enable": "false"})
    got, want = run(PORT, tt), run(JAX, jt)
    assert got == want
    assert got["query.http"] == 3 and got["query.execute"] == 3


def test_disabled_tracing_records_nothing(pair):
    """``tsd.trace.enable=false``: no trace is retained, no stage
    histogram fills, no ``X-TSD-Trace-Id``, and ``/api/trace`` is a
    400."""
    for t, side in zip(pair(**{"tsd.trace.enable": "false"}), SIDES):
        router = side.http.HttpRpcRouter(t)
        resp = call(side, router, "POST", "/api/put", put_body())
        assert "X-TSD-Trace-Id" not in resp.headers
        resp = call(side, router, "POST", "/api/query", query_obj())
        assert resp.status == 200
        assert "X-TSD-Trace-Id" not in resp.headers
        assert t.tracer.traces_started == 0
        assert t.stats.latency_summary()["stages"] == {}
        resp = call(side, router, "GET", "/api/trace")
        assert resp.status == 400


def test_disabled_site_costs_one_thread_local_read(monkeypatch):
    """Untraced, a site reads the thread-local and returns: it never
    reaches a context or a clock."""
    calls = []
    monkeypatch.setattr(PORT.trace.time, "monotonic",
                        lambda: calls.append(1) or 0.0)
    assert PORT.trace.trace_begin("query.plan") is None
    PORT.trace.trace_end(None)
    with PORT.trace.trace_span("query.execute") as h:
        assert h is None
    assert not calls


def test_trace_header_on_error_response(pair):
    """An unknown metric answers 400 and still carries its retained
    error trace's id (ref: ``test_trace_list_filters_and_404``)."""
    def run(side, t):
        router = side.http.HttpRpcRouter(t)
        _put(side, router, t)
        resp = call(side, router, "POST", "/api/query",
                    query_obj("no.such.metric"))
        assert resp.status == 400
        doc = trace_doc(side, router, resp.headers["X-TSD-Trace-Id"])
        return tree_shape(doc)

    tt, jt = pair()
    got, want = run(PORT, tt), run(JAX, jt)
    assert got == want
    assert got[0][1] == "error"
