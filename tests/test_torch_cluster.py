"""The port's cluster at one replica against the JAX package's, live:
a router over three shard TSDs of each package, on real sockets, given
the same writes (``tests/torch_cluster_pair.py``):

- every series lands on the same shard in both;
- :data:`QUERIES` answer bit-equal to the JAX cluster and to one port
  node holding every point; :data:`QUERIES_APPROX` (a rate, averages of
  varying values) within ``APPROX_RTOL`` of the JAX cluster;
- the URI form, pixel budgets, telnet bursts through the router,
  suggest, lookup and last;
- the router-mode 400s, the tsuid refusal and the non-decomposable
  aggregator's 400;
- ``/api/cluster`` (+``/status``, ``/reshard``), ``/api/stats/fleet``
  and ``/api/health``, equal apart from clocks and addresses, and the
  gossip block of a router that names a sibling;
- a shard with the wire off: the router falls back to JSON HTTP;
- percentile subs and aggregators through the router (sketch partials);
- a trace's legs merged on a shard and stitched on the router;
- the router's threads: their profiler roles, and none left after a
  close.
"""

from __future__ import annotations

import json
import time

import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PORT, QUERIES,
                                QUERIES_APPROX, SIDES, LiveCluster,
                                assert_rows_close, mkpoints, req,
                                sorted_rows, strip_marker, tsq,
                                volatile_free)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

# no failure is injected here: a shard's first query compiles (the JAX
# package's), and under a loaded test run that must not be mistaken for
# a dead shard
CALM = {"tsd.cluster.timeout_ms": "30000"}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    points = mkpoints()
    varied = mkpoints(metric="c.v", seed=11)
    out = {}
    try:
        for side in SIDES:
            c = LiveCluster(tmp_path_factory.mktemp(side.name), side,
                            **CALM)
            out[side.name] = c
            for pts in (points, varied):
                resp = c.put(pts, summary="true")
                assert resp.status == 200, resp.body
                assert json.loads(resp.body)["failed"] == 0
        yield out, points
    finally:
        for c in out.values():
            c.close()


@pytest.fixture(scope="module")
def oracle(clusters):
    """One port node holding every point."""
    _, points = clusters
    t = PORT.TSDB(PORT.Config(**{**PORT.keys,
                                 "tsd.core.auto_create_metrics": "true"}))
    for dp in points:
        t.add_point(dp["metric"], dp["timestamp"], dp["value"], dp["tags"])
    yield PORT.http.HttpRpcRouter(t)
    t.shutdown()


def _query(c, body):
    resp, doc = c.query(body)
    assert resp.status == 200, resp.body
    return doc


def test_every_series_lands_on_the_same_shard(clusters):
    cs, _ = clusters
    placement = []
    for side in SIDES:
        c = cs[side.name]
        placement.append([p.tsdb.store.num_series() for p in c.peers])
    assert placement[0] == placement[1]
    assert all(n > 0 for n in placement[1])
    for h in range(12):
        tags = {"host": f"h{h:02d}"}
        assert cs["port"].shard_of("c.m", tags) == \
            cs["jax"].shard_of("c.m", tags)


@pytest.mark.parametrize("qspec", QUERIES,
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_queries_bit_equal(clusters, oracle, qspec):
    cs, _ = clusters
    body = tsq(qspec)
    got, degraded = strip_marker(_query(cs["port"], body))
    want, jdeg = strip_marker(_query(cs["jax"], body))
    assert degraded == jdeg == []
    assert sorted_rows(got) == sorted_rows(want)
    one = json.loads(oracle.handle(req(PORT, "POST", "/api/query",
                                       body)).body)
    assert sorted_rows(got) == sorted_rows(one)


@pytest.mark.parametrize("qspec", QUERIES_APPROX,
                         ids=[f"a{i}" for i in range(len(QUERIES_APPROX))])
def test_queries_approx(clusters, qspec):
    """Varying values: the port's cluster against the JAX cluster within
    ``APPROX_RTOL`` (the JAX package computes in float32 on the CPU)."""
    cs, _ = clusters
    body = tsq(qspec, metric="c.v")
    got, _ = strip_marker(_query(cs["port"], body))
    want, _ = strip_marker(_query(cs["jax"], body))
    assert_rows_close(got, want)


def test_uri_form_pixels_and_unknown_metric(clusters):
    cs, _ = clusters
    out = []
    for side in SIDES:
        c = cs[side.name]
        uri = c.http.handle(req(side, "GET", "/api/query",
                                start=BASE_MS - 10_000,
                                end=BASE_MS + 201_000, m="sum:10s-sum:c.m",
                                arrays="true", ms="true"))
        px = c.http.handle(req(side, "POST", "/api/query", tsq(
            {"aggregator": "sum", "downsample": "1s-avg"},
            end=BASE_MS + 202_000, pixels=10)))
        unknown = c.http.handle(req(side, "POST", "/api/query", tsq(
            {"aggregator": "sum"}, metric="no.such")))
        dev = c.http.handle(req(side, "POST", "/api/query",
                                tsq({"aggregator": "dev"})))
        out.append([(r.status, json.loads(r.body))
                    for r in (uri, px, unknown, dev)])
    assert out[0] == out[1]
    assert [s for s, _ in out[1]] == [200, 200, 400, 400]


def test_telnet_burst_through_the_router(clusters):
    cs, _ = clusters
    lines = [f"put t.m {BASE + i} {i % 7} host=h{i % 5}" for i in range(60)]
    lines += ["put t.m", f"put t.m {BASE} x host=a",
              f"put t.m {BASE} 1", f"put t.m {BASE} 1 bad tag=v"]
    out = []
    for side in SIDES:
        c = cs[side.name]
        errs = side.telnet.TelnetRouter(c.tsdb).execute_lines(lines)[0]
        one = side.telnet.TelnetRouter(c.tsdb).execute_lines(
            [f"put t.m {BASE + 99} 3 host=h9"])[0]
        rows, _ = strip_marker(_query(c, tsq({"aggregator": "none"},
                                             metric="t.m")))
        out.append((errs, one, sorted_rows(rows)))
    assert out[0] == out[1]
    assert len(out[1][0]) == 4 and sum(len(r["dps"])
                                       for r in out[1][2]) == 61


def test_suggest_lookup_and_last(clusters):
    cs, _ = clusters
    out = []
    for side in SIDES:
        c = cs[side.name]
        got = []
        for path, params in (
                ("/api/suggest", {"type": "tagv", "q": "h", "max": "5"}),
                ("/api/suggest", {"type": "metrics", "q": ""}),
                ("/api/search/lookup", {"m": "c.m{host=*}",
                                        "limit": "4"}),
                ("/api/query/last", {"timeseries": "c.m{host=h03}",
                                     "resolve": "true"}),
                ("/api/query/last", {"timeseries": "no.such{host=a}"})):
            resp = c.http.handle(req(side, "GET", path, **params))
            doc = json.loads(resp.body)
            if path.endswith("lookup"):
                doc.pop("time")
                for r in doc["results"]:
                    r.pop("tsuid")
            got.append((resp.status, doc))
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/api/query/exp", None), ("GET", "/api/query/gexp", None),
    ("GET", "/api/search/graph", None), ("GET", "/api/uid/assign", None),
    ("GET", "/api/annotation", None), ("GET", "/api/tree", None),
    ("POST", "/api/rollup", []), ("POST", "/api/histogram", []),
    ("POST", "/api/query", {"start": BASE_MS, "end": BASE_MS + 1000,
                            "queries": [{"tsuids": ["000001000001000001"],
                                         "aggregator": "sum"}]}),
    ("POST", "/api/query/last", {"queries": [{"tsuids": ["000001"]}]}),
    ("GET", "/api/cluster/nope", None)],
    ids=lambda v: v if isinstance(v, str) else None)
def test_router_mode_refusals(clusters, method, path, body):
    cs, _ = clusters
    got = [cs[side.name].http.handle(req(side, method, path, body))
           for side in SIDES]
    assert got[0].status == got[1].status in (400, 404)
    assert json.loads(got[0].body) == json.loads(got[1].body)


def test_put_summary_details_and_bad_points(clusters):
    cs, _ = clusters
    pts = [{"metric": "p.m", "timestamp": BASE, "value": 1,
            "tags": {"host": "h00"}},
           {"metric": "", "timestamp": BASE, "value": 2,
            "tags": {"host": "h01"}},
           {"metric": "p.m", "timestamp": -5, "value": 2,
            "tags": {"host": "h01"}},
           {"metric": "p.m", "timestamp": BASE, "value": "1_0",
            "tags": {"host": "h01"}}]
    out = []
    for side in SIDES:
        c = cs[side.name]
        a = c.put(pts, details="true")
        b = c.put([pts[0]])
        out.append((a.status, json.loads(a.body), b.status))
    assert out[0] == out[1]
    assert out[1][1]["success"] == 1 and out[1][1]["failed"] == 3


def _doc(c, path):
    resp, doc = c.get(path)
    assert resp.status == 200, resp.body
    return doc


def test_cluster_admin_documents(clusters):
    cs, _ = clusters
    docs = []
    for side in SIDES:
        c = cs[side.name]
        docs.append({p: volatile_free(_doc(c, p)) for p in (
            "/api/cluster", "/api/cluster/status",
            "/api/cluster/reshard")})
    for path in docs[0]:
        a, b = docs[0][path], docs[1][path]
        # every counter is the same in both: the module sends both
        # clusters the same requests in the same order; only the wire's
        # deepest pipeline depends on how deliveries overlap
        for d in (a, b):
            for peer in (d.get("peers") or {}).values():
                peer.get("wire", {}).pop("pipeline_max", None)
        assert a == b, path


def test_health_and_fleet_documents(clusters):
    cs, _ = clusters
    health, fleet = [], []
    for side in SIDES:
        c = cs[side.name]
        h = _doc(c, "/api/health")
        health.append((h["status"], h["causes"],
                       volatile_free(h["cluster"]["fleet"]),
                       sorted(b for b in h["breakers"]
                              if b.startswith("cluster.")),
                       h["cluster"]["role"], h["cluster"]["gossip"],
                       h["cluster"]["rf"], h["cluster"]["epoch"],
                       volatile_free(h["cluster"]["reshard"])))
        f = _doc(c, "/api/stats/fleet")
        fleet.append((f["nodes"], f["shardsDegraded"],
                      {k: v for k, v in f["counters"].items()
                       if k.startswith(("tsd.datapoints.added",
                                        "tsd.uid.ids-used"))}))
        shard = c.peers[0].server.http_router.handle(
            req(side, "GET", "/api/health"))
        assert json.loads(shard.body)["cluster"] == {"role": "shard"}
    assert health[0] == health[1]
    assert fleet[0] == fleet[1]
    assert fleet[1][0] == {"s0": "ok", "s1": "ok", "s2": "ok"}
    # both packages' fleet merge over the same per-node documents
    docs = {f"n{i}": {"records": [
        {"metric": "tsd.x.count", "value": i + 1, "tags": {}},
        {"metric": "tsd.connectionmgr.connections", "value": 3 * i,
         "tags": {"type": "open"}}], "histograms": []} for i in range(3)}
    assert PORT.fleet.merge_fleet(docs) == JAX.fleet.merge_fleet(docs)


@pytest.mark.parametrize("stale_ms", ["60000", "1"])
def test_health_shows_gossip_on_a_router_with_siblings(clusters,
                                                       stale_ms):
    """A router that names a sibling router carries its gossip bus in
    ``/api/health``'s ``cluster`` block, ``/api/cluster/status`` and
    ``/api/stats``, the same in both packages up to the nonce and the
    clock. A sibling that has not acknowledged a push within the stale
    window degrades the router: ``cluster_gossip_degraded`` is a
    cause."""
    cs, _ = clusters
    got = []
    for side in SIDES:
        c = cs[side.name]
        tsdb = side.TSDB(side.Config(**{
            **c.cfg, "tsd.cluster.routers": "r1=127.0.0.1:9",
            "tsd.cluster.gossip.stale_ms": stale_ms}))
        try:
            assert tsdb.cluster.gossip is not None  # builds the router
            http = side.http.HttpRpcRouter(tsdb)
            if stale_ms == "1":
                time.sleep(0.01)
            docs = []
            for path in ("/api/health", "/api/cluster/status"):
                resp = http.handle(req(side, "GET", path))
                assert resp.status == 200, resp.body
                docs.append(json.loads(resp.body))
            health, status = docs
            gossip = health["cluster"]["gossip"]
            assert status["gossip"]["nonce"] == gossip["nonce"]
            for doc in (gossip, status["gossip"]):
                assert len(doc.pop("nonce")) == 16
                for sib in doc["siblings"].values():
                    sib.pop("last_ok_age_s")
            resp = http.handle(req(side, "GET", "/api/stats", json="true"))
            stats = sorted(
                (r["metric"], r["value"])
                for r in json.loads(resp.body)
                if r["metric"].startswith("tsd.cluster.gossip."))
            got.append((health["causes"], volatile_free(gossip),
                        volatile_free(status["gossip"]), stats))
        finally:
            tsdb.shutdown()
    assert got[0] == got[1]
    causes, gossip, _status, stats = got[1]
    assert gossip["degraded"] is (stale_ms == "1")
    assert ("cluster_gossip_degraded" in causes) is (stale_ms == "1")
    assert gossip["stale_siblings"] == (["r1"] if stale_ms == "1" else [])
    assert ("tsd.cluster.gossip.degraded", int(stale_ms == "1")) in stats


def test_a_shard_without_the_wire_answers_over_http(tmp_path):
    """A shard with ``tsd.cluster.wire.enable=false`` closes the wire's
    handshake: the router counts one fallback and serves that shard
    over JSON HTTP, with the same answers (ref:
    ``TestWireFallbackNegotiation``)."""
    out = []
    for side in SIDES:
        c = LiveCluster(tmp_path / side.name, side,
                        peer_cfg={"tsd.cluster.wire.enable": "false"},
                        **CALM)
        try:
            resp = c.put(mkpoints(n_hosts=6, n_sec=40), summary="true")
            assert resp.status == 200, resp.body
            got = _query(c, tsq({"aggregator": "sum",
                                 "downsample": "10s-sum"}))
            info = c.router.health_info()["peers"]
            out.append((got, sorted((n, p["wire"]["fallbacks"] >= 1,
                                     p["wire"]["connects"])
                                    for n, p in info.items())))
        finally:
            c.close()
    assert out[0] == out[1]
    assert all(fb and n == 0 for _name, fb, n in out[1][1])


def test_cluster_threads_have_roles_and_end_with_the_router(tmp_path):
    """Each thread a port router starts (its ``tsd-cluster`` pool, its
    ``cluster-replay`` loop, the ``tsd-wire-<peer>`` readers) has the
    role the reference's profiler gives a thread of that name, and no
    thread of the cluster outlives its close (ROADMAP Queue 3 item
    24)."""
    import threading

    from opentsdb_tpu.obs import profiler as jprof
    from opentsdb_tpu_torch.obs import profiler as tprof
    before = set(threading.enumerate())
    c = LiveCluster(tmp_path, PORT)
    try:
        assert c.put(mkpoints(n_hosts=6, n_sec=30),
                     summary="true").status == 200
        _query(c, tsq({"aggregator": "sum", "downsample": "10s-sum"}))
        started = [t for t in threading.enumerate() if t not in before]
        names = {t.name for t in started}
        assert {"cluster-replay"} <= names
        assert any(n.startswith("tsd-cluster") for n in names)
        assert any(n.startswith("tsd-wire-s") for n in names)
        # the router's threads have the reference's names; the shards'
        # are the server's, held by test_torch_obs.py (item 24)
        for n in names:
            if n.startswith(("tsd-cluster", "cluster-", "tsd-wire")):
                assert tprof.thread_role(n) == jprof.thread_role(n), n
    finally:
        c.close()
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []


@pytest.mark.parametrize("qspec", [
    {"aggregator": "sum", "downsample": "30s-avg",
     "percentiles": [50.0, 99.0]},
    {"aggregator": "p95", "downsample": "10s-avg"},
    {"aggregator": "median", "downsample": "30s-max",
     "filters": [{"type": "wildcard", "tagk": "host", "filter": "*",
                  "groupBy": False}]}],
    ids=["sketch-partials", "p95", "median"])
def test_percentiles_through_the_router(clusters, qspec):
    """A ``percentiles`` sub scatters with ``sketchPartials`` (each
    shard's per-bucket sketches, merged), a percentile aggregator as
    ``none`` clones the router folds into sketches: the same answers
    in both packages."""
    cs, _ = clusters
    body = tsq(qspec)
    got = _query(cs["port"], body)
    want = _query(cs["jax"], body)
    assert sorted_rows(strip_marker(got)[0]) == \
        sorted_rows(strip_marker(want)[0])
    assert strip_marker(got)[0]


def test_a_shard_merges_the_legs_of_one_trace():
    """A shard honors ``X-TSD-Trace`` (shard role only) and keeps the
    legs of one propagated trace as one trace (the per-sub retries and
    twins of one router query), in both packages."""
    from types import SimpleNamespace

    from opentsdb_tpu.obs import trace as jtrace
    from opentsdb_tpu_torch.obs import trace as ttrace
    out = []
    for side, mod in ((JAX, jtrace), (PORT, ttrace)):
        tracer = mod.Tracer(side.Config(**{"tsd.cluster.role": "shard"}))
        header = SimpleNamespace(headers={mod.TRACE_HEADER:
                                          "abc123:9-1:1"})
        for _ in range(2):
            ctx = tracer.start_request("query.http", header)
            mod.trace_end(ctx.begin("query.plan"))
            tracer.finish(ctx)
        out.append(sorted(s.name for s in tracer.get("abc123").spans))
        # off the shard role the header is ignored: a fresh trace id
        plain = mod.Tracer(side.Config())
        ctx = plain.start_request("query.http", header)
        assert ctx.trace_id != "abc123"
        plain.finish(ctx)
    assert out[0] == out[1] == ["query.http", "query.http",
                                "query.plan", "query.plan"]


def test_a_stitched_trace_has_a_leg_from_each_shard(tmp_path):
    """``GET /api/trace/<id>`` on a router with every root kept: the
    router's scatter and one ``query.http`` subtree from each shard
    under its ``cluster.peer`` span, the same span names in both
    packages."""
    out = []
    for side in SIDES:
        c = LiveCluster(tmp_path / side.name, side,
                        **{**CALM, "tsd.trace.sample": "1"})
        try:
            assert c.put(mkpoints(n_hosts=6, n_sec=30),
                         summary="true").status == 200
            resp, _ = c.query(tsq({"aggregator": "sum",
                                   "downsample": "10s-sum"}))
            tid = resp.headers["X-TSD-Trace-Id"]
            _, doc = c.get(f"/api/trace/{tid}")
            legs = {s["spanId"]: s for s in doc["spans"]
                    if s["name"] == "cluster.peer"}
            roots = [s for s in doc["spans"] if s["name"] == "query.http"
                     and s["parentId"] in legs]
            out.append((sorted({s["name"] for s in doc["spans"]}),
                        len(legs), len(roots),
                        "stitchIncomplete" in doc))
        finally:
            c.close()
    assert out[0] == out[1]
    assert out[1][1:] == (3, 3, False)
