"""The port's observability layer (``opentsdb_tpu_torch/obs/``,
``utils/logring.py``, the health, trace, profile, metrics, logs and
stats endpoints) held to the JAX package's on the CPU.

- The keys the port used to ignore: ``tsd.control.enable``,
  ``tsd.stats.self_interval``, ``tsd.trace.enable=false``,
  ``tsd.query.slowlog.threshold_ms`` and an unknown key, each acted on
  as the reference acts on it.
- The query-shape log's lines, the slow-request log, SLO burn rates on
  one request stream with a fixed clock, the OpenMetrics text of one
  registry, the histogram merge, the profiler's thread roles and
  collapsed stacks, the telemetry pump's series, ``/logs``, the keys
  and deterministic values of ``/api/health``, ``/api/trace``'s
  filters and 404, ``/api/stats/raw`` and ``/query_shapes``, and the
  400s of a disabled subsystem: each the same inputs through both
  packages.

Tolerance: none. Documents compare exactly, less the fields that read a
clock (durations, timestamps, trace ids), which each test names.
"""

import json
import logging
import re
import threading
import time
import weakref

import pytest

from test_torch_http import assert_shape
from torch_obs_pair import (JAX, PORT, SIDES, T0, both, call, put_body,
                            query_obj, shutdown, tsdb)


@pytest.fixture
def made():
    """TSDBs a test builds, each shut down at its end."""
    out = []
    yield out
    for t in out:
        shutdown(t)


def mk(made, side, **keys):
    t = tsdb(side, **keys)
    made.append(t)
    return t


def router(side, t):
    return side.http.HttpRpcRouter(t)


# -- the keys the port ignored -------------------------------------------

def test_control_enable_builds_the_plane(made):
    """``tsd.control.enable=true``: ``TSDB.control`` is a control plane
    and ``GET /api/control`` answers its document."""
    from opentsdb_tpu_torch.control.plane import ControlPlane
    docs = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.control.enable": "true"})
        assert t.control is not None
        resp = call(side, router(side, t), "GET", "/api/control")
        assert resp.status == 200
        docs.append(json.loads(resp.body))
    assert isinstance(made[0].control, ControlPlane)
    got, want = docs
    for doc in (got, want):
        doc.pop("lastTickDurationMs")
    assert got == want


def test_self_interval_pumps_queryable_series(made):
    """``tsd.stats.self_interval``: the pump writes ``tsd.*`` series that
    ``/api/query`` returns, and a server starts its thread."""
    answers = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.stats.self_interval": "5"})
        assert t.telemetry.interval_s == 5.0
        t.telemetry.pump(now_s=T0)
        t.telemetry.pump(now_s=T0 + 60)
        resp = call(side, router(side, t), "GET", "/api/query",
                    start=T0 - 1, end=T0 + 120,
                    m="sum:tsd.telemetry.pumps")
        assert resp.status == 200, resp.body
        answers.append(json.loads(resp.body)[0]["dps"])
    assert answers[0] == answers[1] == {str(T0): 0, str(T0 + 60): 1}
    srv = PORT.server.ServerThread(made[0], port=0).start()
    try:
        assert made[0].telemetry.health_info()["running"]
    finally:
        srv.stop()
    assert not made[0].telemetry.health_info()["running"]


def test_trace_enable_false_records_no_trace(made):
    """``tsd.trace.enable=false``: nothing is retained and a site is a
    thread-local read (see ``test_torch_trace.py``)."""
    for side in SIDES:
        t = mk(made, side, **{"tsd.trace.enable": "false"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        assert t.tracer.recent() == []
        assert t.tracer.traces_started == 0


def test_slowlog_keeps_a_slow_query_past_sampling(made):
    """``tsd.query.slowlog.threshold_ms``: a query over the threshold is
    retained whatever the sampling, in the slow ring, with a WARN
    naming its trace id in ``/logs``; the put root is not eligible."""
    rows = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.trace.sample": "1000000",
                              "tsd.query.slowlog.threshold_ms": "0.001"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        resp = call(side, r, "POST", "/api/query", query_obj())
        tid = resp.headers.get("X-TSD-Trace-Id")
        assert tid, "the slow trace must be retained despite sampling"
        slow = json.loads(call(side, r, "GET", "/api/trace",
                               slow="true").body)
        assert tid in {row["traceId"] for row in slow}
        logs = call(side, r, "GET", "/logs").body.decode()
        assert f"slow query trace={tid}" in logs
        rows.append([(row["name"], row["slow"], row["status"])
                     for row in slow])
        assert t.tracer.slow_traces == 1
    assert rows[0] == rows[1] == [("query.http", True, "ok")]


def test_slowlog_threshold_zero_disables(made):
    for side in SIDES:
        t = mk(made, side, **{"tsd.trace.sample": "1000000"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        resp = call(side, r, "POST", "/api/query", query_obj())
        assert "X-TSD-Trace-Id" not in resp.headers
        assert t.tracer.slow_traces == 0


def test_unknown_key_warns(caplog, made):
    """An unknown key is logged by name when the TSDB is built, as
    ``Config.warn_unknown_keys`` does; the port's own keys, read at
    their defaults or at call sites, never warn."""
    warned = []
    for side in SIDES:
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="config"):
            mk(made, side, **{"tsd.bogus.key": "1"})
        warned.append(sorted(re.findall(r"unknown config key '([^']+)'",
                                        caplog.text)))
    assert warned[0] == ["tsd.bogus.key"]
    assert "tsd.bogus.key" in warned[1]
    cfg = PORT.Config(**{"tsd.bogus.key": "1", "tsd.torch.device": "cpu",
                         "tsd.control.enable": "true",
                         "tsd.stats.self_interval": "5",
                         "tsd.faults.wal.fsync_error_rate": "0",
                         "tsd.lifecycle.policy.m.retention": "1d",
                         "tsd.search.enable": "true",
                         "tsd.search.es.host": "x"})
    assert cfg.warn_unknown_keys() == ["tsd.bogus.key"]


def test_every_key_the_port_reads_is_declared():
    """Each ``tsd.*`` key literal in the port's source resolves in the
    declared-key registry (a prefix such as a plugin slot or a retry
    policy ends at its last dot)."""
    import pathlib
    root = pathlib.Path(PORT.config.__file__).resolve().parents[1]
    keys = set()
    for path in root.rglob("*.py"):
        keys |= set(re.findall(r'"(tsd\.[A-Za-z0-9_.]+)"',
                               path.read_text()))
    prefixes = {"tsd.server"} | set(PORT.config.PLUGIN_SLOTS) | {
        "tsd.storage.wal.retry", "tsd.storage.flush.retry",
        "tsd.cluster.retry"}
    # the keys of parts not ported yet are named, not read
    undeclared = sorted(k for k in keys if not k.endswith(".")
                        and k not in prefixes
                        and k not in PORT.config.LATER_ITEM_KEYS
                        and not PORT.config.is_declared_key(k))
    assert undeclared == []


# -- the query-shape log --------------------------------------------------

TIMING = ("ts", "traceId", "durationMs")


def _shape_lines(path):
    out = []
    for line in path.read_text().splitlines():
        doc = json.loads(line)
        for k in TIMING:
            doc.pop(k)
        doc["stages"] = sorted(doc["stages"])
        out.append(doc)
    return out


def test_shape_log_lines(made, tmp_path):
    """The lines of a miss, a hit, a pixel budget and a relative
    (materializable) query, timing fields aside."""
    lines = []
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        t = mk(made, side, **{"tsd.storage.data_dir": str(d),
                              "tsd.storage.wal.enable": "false"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body(n=50))
        q = query_obj()
        call(side, r, "POST", "/api/query", q)
        call(side, r, "POST", "/api/query", q)
        call(side, r, "POST", "/api/query", dict(q, pixels=10))
        call(side, r, "GET", "/api/query", start="30m-ago",
             m="sum:1m-sum:sys.obs{host=*}")
        shape_lines = _shape_lines(d / "query_shapes.jsonl")
        for k in ("start", "end"):
            shape_lines[3].pop(k)   # the relative window reads the clock
        lines.append(shape_lines)
    got, want = lines
    assert got == want
    assert [x["cache"] for x in got] == ["miss", "hit", "miss", "miss"]
    assert got[2]["pixels"] == 10 and "cq" in got[3]


def test_shape_log_rotation_bounds_size(made, tmp_path):
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        t = mk(made, side, **{"tsd.storage.data_dir": str(d),
                              "tsd.storage.wal.enable": "false",
                              "tsd.query.cache.enable": "false",
                              "tsd.trace.shapes.max_kb": "1"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        for _ in range(12):
            call(side, r, "POST", "/api/query", query_obj())
        rotated = d / "query_shapes.jsonl.1"
        assert rotated.exists() and rotated.stat().st_size <= 2048
        live = d / "query_shapes.jsonl"
        assert not live.exists() or live.stat().st_size <= 2048


# -- SLO burn ----------------------------------------------------------------

def test_slo_burn_on_one_stream_with_a_fixed_clock():
    def run(side):
        slo = side.slo.SloTracker(side.Config(**{
            "tsd.slo.query.latency_ms": "100",
            "tsd.slo.windows": "60,600"}))
        now = 1_700_000_000
        for i in range(200):
            slo.record("query", 50.0 + i, errored=i % 17 == 0,
                       now_s=now - 700 + 3 * i)
            slo.record("put", 5.0, errored=False, now_s=now - 30 + i % 20)
        slo.record("other", 1.0, errored=True, now_s=now)
        return (slo.burn_rates(now_s=now), slo.gauges(now_s=now),
                slo.health_info(now_s=now))

    got, want = both(run)
    assert got == want
    assert got[0]["query"]["latency"]["10m"] > 0


def test_slo_fed_by_the_router_for_direct_callers(made):
    """A caller that is not the socket server: the router records a
    query and a put; a 5xx would burn availability."""
    events = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.slo.query.latency_ms": "0"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        call(side, r, "GET", "/api/version")
        info = t.slo.health_info()
        events.append((info["events"],
                       info["burn_rates"]["query"]["latency"]["5m"] > 0,
                       info["burn_rates"]["query"]["availability"]))
    assert events[0] == events[1]
    assert events[0][0] == 2 and events[0][1]


# -- OpenMetrics and the histogram merge --------------------------------------

class _Provider:
    def collect_stats(self, collector):
        collector.record("datapoints.added", 42)
        collector.record("uptime.seconds", 7)
        collector.record("wal.sync_lag", 3)
        collector.record("query.payload.bytes_total", 1234)
        collector.record("weird-name.x", 1.5, host='a"b\\c')
        collector.record("admission.shed", 2, cause="inflight")
        collector.record("admission.shed", 0, cause="queue")


class _Registry:
    """A TSDB-shaped holder of one stats registry for ``render``."""

    def __init__(self, side):
        self.stats = side.stats.StatsCollectorRegistry()
        self.stats.register(_Provider())
        for v in (0.2, 1, 1, 3, 7, 50, 900, 20000):
            self.stats.latency_query.add(v)
        self.stats.latency_put.add(2)
        for stage, v in (("query.execute", 4), ("query.plan", 1),
                         ("query.execute", 12)):
            self.stats.observe_stage(stage, v)

    def collect_stats(self, collector):
        collector.record("storage.series.count", 9)


def test_openmetrics_text_of_one_registry():
    got, want = both(lambda side: side.openmetrics.render(_Registry(side)))
    assert got == want
    assert got.endswith(b"# EOF\n")
    assert PORT.openmetrics.CONTENT_TYPE == JAX.openmetrics.CONTENT_TYPE


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|'
    r'\\.)*"(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def strict_parse(text: str) -> int:
    """Every line a comment of the three kinds or a valid sample, and
    ``# EOF`` last; returns the sample count."""
    lines = text.split("\n")
    assert lines[-1] == "" and lines[-2] == "# EOF"
    samples = 0
    for ln in lines[:-2]:
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        assert _SAMPLE.match(ln), ln
        samples += 1
    return samples


def test_metrics_endpoint_parses(made):
    for side in SIDES:
        t = mk(made, side)
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        resp = call(side, r, "GET", "/metrics")
        assert resp.status == 200
        assert resp.content_type == side.openmetrics.CONTENT_TYPE
        assert strict_parse(resp.body.decode()) > 50
        assert call(side, r, "POST", "/metrics").status == 405


def test_histogram_merge_and_percentiles():
    def run(side):
        hs = [side.stats.Histogram(16000, 2, 1) for _ in range(3)]
        for i, h in enumerate(hs):
            for v in range(i, 400, 7):
                h.add(v * 1.3)
        snaps = [h.snapshot() for h in hs]
        merged = side.stats.merge_histogram_snapshots(snaps)
        one = side.stats.Histogram(16000, 2, 1)
        for i in range(3):
            for v in range(i, 400, 7):
                one.add(v * 1.3)
        pcts = [50.0, 95.0, 99.0, 99.9]
        return (merged, side.stats.percentiles_from_buckets(
                    merged["bounds"], merged["buckets"], merged["count"],
                    pcts),
                one.percentile_many(pcts), one.percentiles(),
                one.percentile(99.0), snaps[0]["sketch"],
                side.stats.merge_histogram_snapshots([]),
                side.stats.merge_histogram_snapshots(
                    [snaps[0], dict(snaps[1], bounds=[1, 2])]))

    got, want = both(run)
    assert got == want
    assert got[1] == got[2]
    with pytest.raises(ValueError):
        PORT.stats.Histogram().percentile(0)


def test_is_gauge_classification():
    names = ["datapoints.added", "uptime.seconds", "wal.sync_lag",
             "query.payload.bytes_total", "streaming.points.pending",
             "query.resultcache.bytes", "slo.burn_rate", "trace.started",
             "admission.inflight", "x.total", "storage.cold_bytes"]
    got, want = both(lambda side: [side.stats.is_gauge(n) for n in names])
    assert got == want


def test_collector_extra_tags():
    def run(side):
        c = side.stats.StatsCollector("tsd")
        c.add_extra_tag("host", "h1")
        c.record("a", 1, k="v")
        c.clear_extra_tag("host")
        c.record("b", 2)
        return c.records

    got, want = both(run)
    assert got == want


# -- the profiler ---------------------------------------------------------------

# each thread the port starts, and its counterpart in the reference
PORT_THREADS = {
    "tsd-query_0": "tsd-query_0",
    "tsd-subq_0": "tsd-subq_0",
    # the port's handler pool; the reference's handlers run on asyncio's
    # default executor
    "tsd-http_0": "asyncio_0",
    # ServerThread's event loop; the reference's is MainThread
    "tsd-server": "MainThread",
    "tsd-stream-fold-0": "tsd-stream-fold-0",
    "tsd-telemetry": "tsd-telemetry",
    "tsd-lifecycle": "tsd-lifecycle",
    "tsd-control": "tsd-control",
    "tsd-profiler": "tsd-profiler",
    "shape-warmup": "shape-warmup",
    "wal-fsync": "wal-fsync",
    "asyncio_0": "asyncio_0",
    "MainThread": "MainThread",
}


def test_thread_roles_map_to_the_counterparts():
    for port_name, ref_name in PORT_THREADS.items():
        assert PORT.profiler.thread_role(port_name) == \
            JAX.profiler.thread_role(ref_name), port_name
    assert PORT.profiler.thread_role("tsd-http_3") == "ingest"
    assert PORT.profiler.thread_role("tsd-server") == "serve"


def test_every_thread_the_port_starts_has_its_role(made, tmp_path):
    """A server with every background subsystem on: each thread it and
    its TSDB start is in :data:`PORT_THREADS` (by prefix), and every one
    is joined by the stop."""
    before = set(threading.enumerate())
    t = PORT.TSDB(PORT.Config(**{
        **PORT.keys, "tsd.core.auto_create_metrics": "true",
        "tsd.tpu.warmup": "true", "tsd.tpu.warmup.budget_s": "1",
        "tsd.control.enable": "true", "tsd.control.interval_s": "0.05",
        "tsd.stats.self_interval": "0.05", "tsd.profile.hz": "50",
        "tsd.lifecycle.enable": "true", "tsd.lifecycle.interval_s": "60",
        "tsd.storage.data_dir": str(tmp_path),
        "tsd.storage.wal.fsync": "interval"}))
    srv = PORT.server.ServerThread(t, port=0).start()
    try:
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        body = json.dumps(put_body()).encode()
        conn.request("POST", "/api/put", body)
        assert conn.getresponse().read() == b""
        conn.request("GET", "/api/query?start=1356998390&m=sum:sys.obs")
        assert conn.getresponse().status == 200
        t.streaming.register(dict(query_obj(ds="1m-sum"), id="cq"))
        t.streaming.workers.start()
        time.sleep(0.3)
        conn.close()
        started = [th for th in threading.enumerate() if th not in before]
        roles = {th.name: PORT.profiler.thread_role(th.name)
                 for th in started}
        for name, role in roles.items():
            ref = next((v for k, v in PORT_THREADS.items()
                        if name.startswith(k.rstrip("_0"))), None)
            assert ref is not None, f"thread {name} has no counterpart"
            assert role == JAX.profiler.thread_role(ref), name
        assert {"tsd-server", "tsd-telemetry", "tsd-control",
                "tsd-profiler", "tsd-lifecycle"} <= set(roles)
    finally:
        srv.stop()
    left = [th for th in threading.enumerate()
            if th not in before and th.is_alive()]
    assert left == []


def test_profiler_collapsed_stacks_of_one_thread():
    """Both profilers sample the same parked thread: the same role and
    the same folded stack, in the collapsed text and the report."""
    stop = threading.Event()

    def parked_query_worker():
        stop.wait(30)

    th = threading.Thread(target=parked_query_worker, name="tsd-query_7")
    th.start()
    try:
        time.sleep(0.05)
        now = 1_700_000_000

        def run(side):
            class Cfg:
                config = side.Config(**{"tsd.profile.hz": "10"})
            prof = side.profiler.SamplingProfiler(Cfg)
            prof.sample_once(now_s=now)
            prof.sample_once(now_s=now + 1)
            rep = prof.report(seconds=10, role="query", now_s=now + 1)
            text = prof.collapsed(seconds=10, role="query", now_s=now + 1)
            mine = [ln for ln in text.splitlines()
                    if "parked_query_worker" in ln]
            return rep, mine, prof.health_info()["samples"]

        got, want = both(run)
    finally:
        stop.set()
        th.join()
    assert got[1] == want[1] and len(got[1]) == 1
    assert got[1][0].startswith("query;") and got[1][0].endswith(" 2")
    mine = {k: v for k, v in got[0]["query"].items()
            if "parked_query_worker" in k}
    assert mine == {k: v for k, v in want[0]["query"].items()
                    if "parked_query_worker" in k}
    assert got[2] == want[2] == 2


def test_profile_endpoint(made):
    for side in SIDES:
        t = mk(made, side)
        r = router(side, t)
        t.profiler.sample_once()
        resp = call(side, r, "GET", "/api/profile", seconds=5)
        assert resp.status == 200
        assert resp.content_type.startswith("text/plain")
        doc = json.loads(call(side, r, "GET", "/api/profile",
                              format="json").body)
        assert set(doc) == {"seconds", "hz", "roles", "profiler"}
        assert call(side, r, "GET", "/api/profile",
                    format="nope").status == 400


# -- the telemetry pump -----------------------------------------------------------

def test_telemetry_pump_series(made):
    """The pump's records: the port's are the reference's (but the
    reference's UID cache and shard counts), with the same host tag and
    the same values where they do not read a clock."""
    snaps = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.stats.self_tag": "node-1:4242"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        snap = {(n, json.dumps(tg, sort_keys=True)): v
                for n, v, tg in t.telemetry.snapshot()}
        snaps.append(snap)
        assert t.telemetry.pump(now_s=T0) == len(snap)
        assert t.telemetry.point_errors == 0
    got, want = snaps
    extra = {k for k in got if k not in want}
    assert extra == set()
    assert {k[0] for k in want if k not in got} <= {
        "tsd.uid.cache-hit", "tsd.uid.cache-miss", "tsd.storage.shards"}
    for key in (("tsd.datapoints.added", '{"host": "node-1_4242"}'),
                ("tsd.storage.series.count", '{"host": "node-1_4242"}')):
        assert got[key] == want[key]


def test_telemetry_pump_without_auto_create(made):
    for side in SIDES:
        t = side.TSDB(side.Config(**{
            **side.keys, "tsd.core.auto_create_metrics": "false",
            "tsd.tpu.warmup": "false"}))
        made.append(t)
        assert t.telemetry.pump(now_s=T0) > 0
        assert t.telemetry.point_errors == 0
        rows = [r for r in t.tracer.recent(limit=50)
                if r["name"] == "telemetry.pump"]
        assert rows and rows[0]["status"] == "ok"


# -- /logs ----------------------------------------------------------------------------

def test_logs_endpoint(made):
    token = f"obs-log-token-{time.monotonic_ns()}"
    logging.getLogger("obs.test").warning("a line %s", token)
    bodies = []
    for side in SIDES:
        t = mk(made, side)
        r = router(side, t)
        text = call(side, r, "GET", "/logs").body.decode()
        mine = [ln for ln in text.splitlines() if token in ln]
        lines = json.loads(call(side, r, "GET", "/logs", json="true").body)
        assert [ln for ln in lines if token in ln] == mine
        bodies.append(mine)
    assert bodies[0] == bodies[1] and len(bodies[0]) == 1
    assert " WARNING [" in bodies[0][0]


# -- /api/health ----------------------------------------------------------------------

def _deterministic(doc: dict) -> dict:
    """The fields of a health document that read no clock."""
    return {
        "status": doc["status"], "causes": doc["causes"],
        "wal": doc["wal"]["enabled"], "faults": doc["faults"],
        "cluster": doc["cluster"], "control": doc["control"],
        "lifecycle": doc["lifecycle"], "streaming": doc["streaming"],
        "query_cache": doc["query_cache"]["enabled"],
        "trace": {k: v for k, v in doc["trace"].items()
                  if k != "shape_log"},
        "telemetry": doc["telemetry"],
        "profiler": {k: doc["profiler"][k] for k in
                     ("enabled", "running", "hz", "ring_s")},
        # burn rates read latencies (the JAX package's first query
        # compiles), so only the objectives and windows compare
        "slo": {k: v for k, v in doc["slo"].items()
                if k not in ("events", "burn_rates")},
        "latency_counts": {k: v["count"]
                           for k, v in doc["latency"]["stages"].items()},
        "storage_series": doc["storage"]["total"]["series"],
        "storage_points": doc["storage"]["total"]["points"],
        "payload_responses": doc["query_payload"]["responses"],
        "hook_errors": doc["hook_errors"],
    }


@pytest.mark.parametrize("keys", [
    {}, {"tsd.control.enable": "true"},
    {"tsd.faults.wal.fsync_latency_ms": "0"}], ids=["plain", "control",
                                                    "fault"])
def test_health_keys_and_values(made, keys):
    docs = []
    for side in SIDES:
        t = mk(made, side, **keys, **{"tsd.storage.backend": "memory"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        if keys.get("tsd.control.enable"):
            assert t.control is not None
        docs.append(json.loads(call(side, r, "GET", "/api/health").body))
    got, want = docs
    assert_shape(got, want)
    g, w = _deterministic(got), _deterministic(want)
    for doc in (g, w):
        if isinstance(doc["control"], dict):
            doc["control"].pop("lastTickDurationMs", None)
    assert g == w
    assert got["status"] == "ok" and got["cluster"] == {
        "role": "standalone"}


def test_health_reports_an_open_breaker(made):
    for side in SIDES:
        t = mk(made, side, **{"tsd.control.enable": "true",
                              "tsd.control.qos.enable": "true",
                              "tsd.control.breaker.failure_threshold": "1"})
        t.faults.arm("control.qos", error_count=10)
        t.control.tick()
        doc = json.loads(call(side, router(side, t), "GET",
                              "/api/health").body)
        assert doc["status"] == "degraded"
        assert doc["causes"] == ["breaker:control.loop"]
        assert doc["breakers"]["control.loop"]["state"] == "open"


def test_health_with_a_server_attached(made):
    """A server's connections and admission ride the document."""
    docs = []
    for side in SIDES:
        t = mk(made, side, **{"tsd.query.admission.max_inflight": "3"})
        srv = side.server.TSDServer(t, host="127.0.0.1", port=0)
        r = srv.http_router
        doc = json.loads(call(side, r, "GET", "/api/health").body)
        docs.append((doc["connections"], doc["admission"]))
    assert docs[0] == docs[1]
    assert docs[0][1]["max_inflight"] == 3


# -- /api/trace ---------------------------------------------------------------------------

def test_trace_list_filters_and_404(made):
    listings = []
    for side in SIDES:
        t = mk(made, side)
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        err = call(side, r, "POST", "/api/query", query_obj("no.such"))
        assert err.status == 400
        err_tid = err.headers["X-TSD-Trace-Id"]
        out = []
        for params in ({}, {"status": "error"}, {"status": "ok"},
                       {"limit": "1"}, {"min_duration_ms": "100000"},
                       {"slow": "true"}):
            rows = json.loads(call(side, r, "GET", "/api/trace",
                                   **params).body)
            out.append([(row["name"], row["status"], row["spans"],
                         row["slow"], row["traceId"] == err_tid)
                        for row in rows])
        for path, params in (("/api/trace/deadbeef00000000", {}),
                             ("/api/trace", {"status": "bogus"}),
                             ("/api/trace", {"limit": "x"})):
            resp = call(side, r, "GET", path, **params)
            out.append((resp.status, json.loads(resp.body)))
        resp = call(side, r, "POST", "/api/trace")
        out.append(resp.status)
        listings.append(out)
    got, want = listings
    assert got == want
    # ?status=error lists the failed query alone
    assert [(row[0], row[1], row[4]) for row in got[1]] == [
        ("query.http", "error", True)]


# -- /api/stats/raw and /query_shapes ------------------------------------------------

def test_stats_raw(made):
    docs = []
    for side in SIDES:
        t = mk(made, side)
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        call(side, r, "POST", "/api/query", query_obj())
        docs.append(json.loads(call(side, r, "GET", "/api/stats/raw").body))
    got, want = docs
    assert set(got) == set(want) == {"ts", "records", "histograms"}
    assert {x["metric"] for x in got["records"]} <= \
        {x["metric"] for x in want["records"]}
    assert not any(x["metric"].startswith("tsd.latency.")
                   for x in got["records"])

    def hists(doc):
        return sorted((h["name"], json.dumps(h["labels"], sort_keys=True),
                       h["count"], h["bounds"] == doc["histograms"][0]
                       ["bounds"]) for h in doc["histograms"])

    assert hists(got) == hists(want)


def test_stats_query_shapes(made, tmp_path):
    docs = []
    for side in SIDES:
        (tmp_path / side.name).mkdir()
        t = mk(made, side, **{"tsd.storage.data_dir":
                              str(tmp_path / side.name),
                              "tsd.storage.wal.enable": "false"})
        r = router(side, t)
        call(side, r, "POST", "/api/put", put_body())
        for ds in ("10s-avg", "10s-avg", "1m-sum"):
            call(side, r, "POST", "/api/query", query_obj(ds=ds))
        doc = json.loads(call(side, r, "GET", "/api/stats/query_shapes",
                              limit=5).body)
        doc.pop("source")
        for s in doc["shapes"]:
            s.pop("durationMs")
            s["stagesMs"] = sorted(s["stagesMs"])
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["linesRead"] == 3 and docs[0]["distinctShapes"] == 2


# -- the 400s of a disabled subsystem ----------------------------------------------------

@pytest.mark.parametrize("keys,method,path,params", [
    ({"tsd.trace.enable": "false"}, "GET", "/api/trace", {}),
    ({"tsd.trace.enable": "false"}, "GET", "/api/trace/abc", {}),
    ({"tsd.profile.enable": "false"}, "GET", "/api/profile", {}),
    ({"tsd.profile.hz": "0"}, "GET", "/api/profile", {}),
    ({}, "GET", "/api/stats/query_shapes", {}),
    ({}, "GET", "/api/control", {}),
    ({}, "POST", "/api/control/tick", {}),
    ({}, "GET", "/api/stats/tenants", {}),
    ({"tsd.control.enable": "true"}, "GET", "/api/control/nope", {}),
    ({"tsd.control.enable": "true"}, "GET", "/api/control/tick", {}),
    ({"tsd.control.enable": "true"}, "PUT", "/api/control", {}),
], ids=lambda x: str(x)[:40])
def test_disabled_subsystem_answers(made, keys, method, path, params):
    answers = []
    for side in SIDES:
        t = mk(made, side, **keys)
        resp = call(side, router(side, t), method, path, **params)
        answers.append((resp.status, resp.body))
    assert answers[0] == answers[1]


def test_dropped_tsdb_is_freed(made):
    """The telemetry pump, the profiler and the control plane hold their
    TSDB weakly: a TSDB dropped without a shutdown is freed at once."""
    import gc
    gc.collect()
    gc.disable()
    try:
        t = PORT.TSDB(PORT.Config(**{
            **PORT.keys, "tsd.control.enable": "true",
            "tsd.control.qos.enable": "true",
            "tsd.stats.self_interval": "5"}))
        assert t.control is not None
        ref = weakref.ref(t)
        del t
        assert ref() is None
    finally:
        gc.enable()


def test_cli_tsd_logs_to_stderr_and_the_ring(tmp_path):
    """``tools.cli tsd`` writes its log to stderr at INFO (the warmup's
    class count, the unknown key's warning) although the ``/logs``
    ring's handler sits on the root logger before the command sets up
    logging, and ``/logs`` still serves the warning."""
    import http.client
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
         "--tsd.torch.device=cpu", "--tsd.network.port=0",
         "--tsd.network.bind=127.0.0.1", "--tsd.tpu.warmup=true",
         "--tsd.tpu.warmup.budget_s=5", "--tsd.bogus.knob=1"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(root)})
    try:
        line = proc.stdout.readline()
        assert line.startswith("TSD listening on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/logs")
        logs = conn.getresponse().read().decode()
        conn.close()
        assert "unknown config key 'tsd.bogus.knob'" in logs
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert "WARNING config: unknown config key 'tsd.bogus.knob'" in err
    assert "INFO tsd.server: Ready to serve on 127.0.0.1:" in err
    # the warmup's INFO line: its class count, or where the SIGTERM
    # stopped it
    assert re.search(r"INFO warmup: warmup: \d+ classes in|"
                     r"INFO warmup: warmup stopped after", err), err
