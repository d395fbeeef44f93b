"""The port's federated continuous queries against the JAX package's,
live (the reference's battery, ``tests/test_eventtime_cluster.py``,
run on both packages and compared; ``tests/torch_cluster_pair.py``):

- a router at one replica registers a continuous query on every shard;
  its merged ``/result`` pull over integer-valued writes is bit-equal
  to the JAX router's and to one node of the same package holding
  every point (``TestFederatedPullOracle``), over the wire and over
  JSON HTTP; float-valued writes agree with the JAX router within
  ``FLOAT_RTOL``;
- the merged push: a snapshot, then merged ``windows`` frames
  (``TestFederatedPush``);
- a dead shard is a marker-carrying 200 (``shardsDegraded``,
  ``complete: false``), a shard that lost its registry is registered
  again from the stored body on the next pull, a killed shard process
  degrades the pull and never 500s (``TestFederatedChaos``);
- the refusals (rf > 1, an aggregator that does not merge, a body only
  the shards refuse, a duplicate id, a registration while a reshard is
  open), the delete reaching every shard, ``/deltas`` refused on the
  router, the list and the describe, and the ``cluster.cq`` fault site
  (``TestFederatedLifecycle``).

Every cluster gets the 30 s peer timeout that clusters with no
injected failure have in ``tests/test_torch_cluster.py``, and a wire
handshake timeout to match; the chaos ones the reference's 3 s.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PEER_CFG, PORT, SIDES,
                                LiveCluster, LivePeer, req,
                                wake_wire_readers)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

IV_MS = 60_000
END_MS = BASE_MS + 1800 * 1000
CQ = "/api/query/continuous"
N_HOSTS = 12
# no failure injected: a loaded run's first JAX compile must look like
# neither a dead shard nor a dead wire handshake (which would send the
# exchanges over HTTP)
CALM = {"tsd.cluster.timeout_ms": "30000",
        "tsd.cluster.wire.connect_timeout_ms": "30000"}
CHAOS = {"tsd.cluster.timeout_ms": "3000",
         "tsd.cluster.breaker.reset_timeout_ms": "300"}
# float-valued writes: the shards' partials fold in shard order on
# both routers, and the JAX package's float32 CPU pipeline rounds each
# partial to float32's precision
FLOAT_RTOL = 1e-6


def _cq_body(cid, agg="sum", ds="1m-sum", metric="f.m", gb=None,
             window=None, watermark=None):
    sub = {"metric": metric, "aggregator": agg, "downsample": ds}
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb,
                           "filter": "*", "groupBy": True}]
    body = {"id": cid, "start": BASE_MS, "end": END_MS,
            "queries": [sub]}
    if window:
        body["window"] = window
    if watermark:
        body["watermark"] = watermark
    return body


def _points(metric="f.m", n_hosts=N_HOSTS, n_half_min=40, seed=None):
    """Integer values constant within every 1m bucket (the reference's
    ``_points``): per-series partials are exact and any order of
    additions gives the same bits. With ``seed``, seeded float values
    that vary per point."""
    rng = np.random.default_rng(seed) if seed is not None else None
    pts = []
    for i in range(n_half_min):
        for h in range(n_hosts):
            v = (h * 13 + (i // 2) * 7) % 50 if rng is None \
                else float(rng.normal(100.0, 25.0))
            pts.append({"metric": metric, "timestamp": BASE + i * 30,
                        "value": v, "tags": {"host": f"h{h:02d}"}})
    return pts


def _session_points(metric="f.s", n_users=24):
    """One user = one series (the session tag is the only tag), two
    bursts per user far more than the gap apart (the reference's)."""
    pts = []
    for u in range(n_users):
        for t0 in (BASE + 60 * (u % 5), BASE + 900 + 60 * (u % 7)):
            for i in range(4):
                pts.append({"metric": metric, "timestamp": t0 + i * 30,
                            "value": (u * 7 + i // 2) % 31,
                            "tags": {"user": f"u{u:02d}"}})
    return pts


def _index_rows(rows):
    out = {}
    for r in rows:
        key = (int(r.get("index") or 0), r["metric"],
               tuple(sorted(r["tags"].items())))
        assert key not in out, f"duplicate merged row {key}"
        out[key] = r["dps"]
    return out


def _split_marker(rows):
    if rows and "completeness" in rows[-1] and "metric" not in rows[-1]:
        return rows[:-1], rows[-1]["completeness"]
    return rows, None


def _oracle_rows(side, body, points, extra=()):
    """One node of ``side``: the same registration, the same points."""
    t = side.TSDB(side.Config(**{**side.keys, **PEER_CFG}))
    try:
        cq = t.streaming.register(dict(body), now_ms=END_MS)
        for dp in list(points) + list(extra):
            t.add_point(dp["metric"], dp["timestamp"], dp["value"],
                        dp["tags"])
        return _split_marker(t.streaming.current_results(cq,
                                                         now_ms=END_MS))
    finally:
        t.shutdown()


def _call(c, method, path, body=None):
    return c.http.handle(req(c.side, method, path, body))


def _register(c, body):
    resp = _call(c, "POST", CQ, body)
    assert resp.status == 200, resp.body
    return json.loads(resp.body)


def _pull(c, cid):
    resp = _call(c, "GET", f"{CQ}/{cid}/result")
    assert resp.status == 200, resp.body
    return _split_marker(json.loads(resp.body))


def _put(c, pts):
    resp = c.put(pts, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0, \
        resp.body


def both(tmp_path, scenario, **cfg):
    """``scenario(cluster)`` on a JAX and a port cluster (each closed
    after); returns [JAX result, port result]."""
    out = []
    for side in SIDES:
        c = LiveCluster(tmp_path / side.name, side, **{**CALM, **cfg})
        try:
            out.append(scenario(c))
        finally:
            c.close()
    return out


# -- merged pull == one node, == the JAX router ---------------------------

class TestFederatedPullOracle:
    @pytest.mark.parametrize("agg,gb", [
        ("sum", None), ("sum", "host"), ("min", "host"), ("none", None)])
    def test_merged_pull_bit_identical(self, tmp_path, agg, gb):
        body = _cq_body("fed-1", agg=agg, gb=gb,
                        watermark={"allowedLateness": "3m"})
        pts = _points()

        def run(c):
            doc = _register(c, body)
            assert doc["federated"] is True
            assert set(doc["shards"]) == {"s0", "s1", "s2"}
            _put(c, pts)
            rows, marker = _pull(c, "fed-1")
            want, _ = _oracle_rows(c.side, body, pts)
            assert _index_rows(rows) == _index_rows(want)
            assert marker["lateDropped"] == 0
            assert "shardsDegraded" not in marker
            # the exchanges rode the binary wire
            assert c.router.cqs.wire_ops > 0
            assert c.router.cqs.http_fallbacks == 0
            return _index_rows(rows), marker

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_float_writes_within_tolerance(self, tmp_path):
        """Seeded float values: the port's merged pull agrees with the
        JAX router's to ``FLOAT_RTOL``, on the same rows and buckets."""
        body = _cq_body("fed-f", gb="host",
                        watermark={"allowedLateness": "3m"})
        pts = _points(seed=21)

        def run(c):
            _register(c, body)
            _put(c, pts)
            return _pull(c, "fed-f")

        (jrows, jm), (prows, pm) = both(tmp_path, run)
        assert pm == jm
        got, want = _index_rows(prows), _index_rows(jrows)
        assert set(got) == set(want) and len(got) == N_HOSTS
        for key in want:
            assert list(got[key]) == list(want[key])
            np.testing.assert_allclose(list(got[key].values()),
                                       list(want[key].values()),
                                       rtol=FLOAT_RTOL, atol=0)

    def test_completeness_spans_every_shard(self, tmp_path):
        """The merged watermark is the least advanced shard's: final
        only once every shard's event time passed end + lateness."""
        body = _cq_body("fed-wm", watermark={"allowedLateness": "2m"})

        def run(c):
            _register(c, body)
            _put(c, _points())
            _, before = _pull(c, "fed-wm")
            assert before["complete"] is False
            _put(c, [{"metric": "f.m", "timestamp": END_MS // 1000 + 180,
                      "value": 1, "tags": {"host": f"h{h:02d}"}}
                     for h in range(N_HOSTS)])
            _, after = _pull(c, "fed-wm")
            assert after["complete"] is True
            assert after["watermarkMs"] >= END_MS
            return before, after

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_session_windows_federate_per_user(self, tmp_path):
        body = _cq_body("fed-sess", agg="none", metric="f.s",
                        window={"type": "session", "gap": "2m",
                                "by": "user"},
                        watermark={"allowedLateness": "2m"})
        pts = _session_points()

        def run(c):
            _register(c, body)
            _put(c, pts)
            rows, marker = _pull(c, "fed-sess")
            want, om = _oracle_rows(c.side, body, pts)
            assert _index_rows(rows) == _index_rows(want)
            assert len({r["tags"].get("user") for r in rows}) == 24
            assert marker["sessionsOpen"] == om["sessionsOpen"]
            assert marker["sessionsClosed"] == om["sessionsClosed"] > 0
            return _index_rows(rows), marker

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_http_fallback_when_wire_disabled(self, tmp_path):
        """``tsd.cluster.wire.enable=false``: every op rides JSON HTTP
        and the merged pull is the same bits."""
        body = _cq_body("fed-http", watermark={"allowedLateness": "3m"})
        pts = _points()

        def run(c):
            _register(c, body)
            _put(c, pts)
            rows, _ = _pull(c, "fed-http")
            want, _ = _oracle_rows(c.side, body, pts)
            assert _index_rows(rows) == _index_rows(want)
            assert c.router.cqs.wire_ops == 0
            return _index_rows(rows)

        jax, port = both(tmp_path, run,
                         **{"tsd.cluster.wire.enable": "false"})
        assert port == jax


# -- merged push ----------------------------------------------------------

def _parse_frame(fr: bytes):
    ev, data = None, None
    for line in fr.decode().splitlines():
        if line.startswith("event: "):
            ev = line[7:]
        elif line.startswith("data: "):
            data = json.loads(line[6:])
    return ev, data


def _frame_view(doc):
    """A frame without its clock."""
    return {k: v for k, v in doc.items() if k != "ts"}


class TestFederatedPush:
    def test_snapshot_then_merged_delta_frames(self, tmp_path):
        body = _cq_body("fed-sse", watermark={"allowedLateness": "3m"})
        pts = _points(n_half_min=20)

        def run(c):
            _register(c, body)
            _put(c, pts)
            reg = c.router.cqs
            fcq = reg.get("fed-sse")
            sub = reg.subscribe(fcq)
            try:
                ev, snap = _parse_frame(sub.queue.get(timeout=10))
                assert ev == "snapshot"
                want, _ = _oracle_rows(c.side, body, pts)
                assert _index_rows(snap["updates"]) == _index_rows(want)
                assert snap["completeness"]["complete"] is False
                # drain the shards' dirty sets once: a pump with no
                # fold since publishes nothing
                reg.pump(fcq)
                while not sub.queue.empty():
                    sub.queue.get_nowait()
                assert reg.pump(fcq) is False
                late = [{"metric": "f.m", "timestamp": BASE + 1200,
                         "value": 5, "tags": {"host": "h00"}}]
                _put(c, late)
                assert reg.pump(fcq) is True
                ev, frame = _parse_frame(sub.queue.get(timeout=10))
                assert ev == "windows"
                edge = str((BASE + 1200) * 1000 // IV_MS * IV_MS)
                assert any(edge in u["dps"] for u in frame["updates"])
                return _frame_view(snap), _frame_view(frame)
            finally:
                reg.unsubscribe(fcq, sub)

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_stream_endpoint_serves_merged_snapshot(self, tmp_path):
        def run(c):
            _register(c, _cq_body("fed-st"))
            _put(c, _points(n_half_min=4))
            resp = _call(c, "GET", f"{CQ}/fed-st/stream")
            assert resp.status == 200
            assert resp.content_type.startswith("text/event-stream")
            it = iter(resp.body_iter)
            assert next(it).startswith(b"retry:")
            ev, doc = _parse_frame(next(it))
            assert ev == "snapshot" and doc["id"] == "fed-st"
            assert doc["updates"]
            it.close()
            return _frame_view(doc)

        jax, port = both(tmp_path, run)
        assert port == jax


# -- chaos ----------------------------------------------------------------

class TestFederatedChaos:
    def test_shard_death_is_a_marker_carrying_200(self, tmp_path):
        body = _cq_body("fed-chaos", gb="host",
                        watermark={"allowedLateness": "3m"})
        pts = _points()

        def run(c):
            _register(c, body)
            _put(c, pts)
            want = _index_rows(_oracle_rows(c.side, body, pts)[0])
            dead = c.shard_of("f.m", {"host": "h00"})
            c.peer(dead).kill()
            rows, marker = _pull(c, "fed-chaos")
            assert marker["shardsDegraded"] == [dead]
            assert marker["complete"] is False
            got = _index_rows(rows)
            for key, dps in got.items():
                assert dps == want[key]
            survivors = {key for key in want
                         if c.shard_of("f.m", dict(key[2])) != dead}
            assert got and set(got) == survivors
            c.peer(dead).restart()
            rows2, marker2 = _pull(c, "fed-chaos")
            assert marker2.get("shardsDegraded") is None
            assert _index_rows(rows2) == want
            return got, marker, marker2

        jax, port = both(tmp_path, run, **CHAOS)
        assert port == jax

    def test_restart_with_empty_registry_reregisters(self, tmp_path):
        body = _cq_body("fed-rr", gb="host",
                        watermark={"allowedLateness": "3m"})
        pts = _points()
        extra = [{"metric": "f.m", "timestamp": BASE + 1230, "value": 4,
                  "tags": {"host": "h00"}}]

        def run(c):
            _register(c, body)
            _put(c, pts)
            want = _index_rows(_oracle_rows(c.side, body, pts)[0])
            victim = c.shard_of("f.m", {"host": "h00"})
            assert c.peer(victim).tsdb.streaming.delete("fed-rr")
            before = c.router.cqs.reregisters
            rows, marker = _pull(c, "fed-rr")
            assert c.router.cqs.reregisters == before + 1
            assert marker.get("shardsDegraded") is None
            assert _index_rows(rows) == want
            _put(c, extra)
            rows, _ = _pull(c, "fed-rr")
            want2 = _index_rows(_oracle_rows(c.side, body, pts,
                                             extra=extra)[0])
            assert _index_rows(rows) == want2
            return want2

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_sigkill_subprocess_shard_degrades_not_500s(self, tmp_path):
        """One of three shards is a real process, SIGKILLed while the
        query stands: the merged pull answers 200 naming it in
        ``shardsDegraded``, the survivors' rows intact."""
        got = []
        for side in SIDES:
            got.append(_sigkill_scenario(tmp_path / side.name, side))
        assert got[0] == got[1]


PEER_SCRIPTS = {
    "jax": """
import asyncio, sys
from opentsdb_tpu import TSDB, Config
from opentsdb_tpu.tsd.server import TSDServer
port, data_dir = int(sys.argv[1]), sys.argv[2]
t = TSDB(Config(**{"tsd.core.auto_create_metrics": "true",
                   "tsd.tpu.warmup": "false", "tsd.tpu.platform": "cpu",
                   "tsd.cluster.role": "shard",
                   "tsd.storage.data_dir": data_dir,
                   "tsd.storage.wal.enable": "true"}))
asyncio.run(TSDServer(t, host="127.0.0.1", port=port).serve_forever())
""",
    "port": """
import asyncio, sys
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tsd.server import TSDServer
port, data_dir = int(sys.argv[1]), sys.argv[2]
t = TSDB(Config(**{"tsd.core.auto_create_metrics": "true",
                   "tsd.tpu.warmup": "false", "tsd.torch.device": "cpu",
                   "tsd.cluster.role": "shard",
                   "tsd.storage.data_dir": data_dir,
                   "tsd.storage.wal.enable": "true"}))
asyncio.run(TSDServer(t, host="127.0.0.1", port=port).serve_forever())
"""}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_port(port: int, proc, timeout: float = 120) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            time.sleep(0.2)
    return False


def _sigkill_scenario(tmp, side):
    tmp.mkdir(parents=True, exist_ok=True)
    script = tmp / "peer.py"
    script.write_text(PEER_SCRIPTS[side.name])
    port = _free_port()
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(root) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, str(script), str(port), str(tmp / "sub-data")],
        env=env, cwd=str(root), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    inproc = [LivePeer(side, "s0"), LivePeer(side, "s1")]
    try:
        assert _wait_port(port, proc), "the shard process did not start"
        spec = (f"s0=127.0.0.1:{inproc[0].port},"
                f"s1=127.0.0.1:{inproc[1].port},sub=127.0.0.1:{port}")
        rt = side.TSDB(side.Config(**{
            **side.keys, "tsd.cluster.role": "router",
            "tsd.cluster.peers": spec, "tsd.cluster.timeout_ms": "4000",
            "tsd.tpu.warmup": "false"}))
        http = side.http.HttpRpcRouter(rt)
        rt.cluster.start()
        try:
            body = _cq_body("fed-sk", gb="host",
                            watermark={"allowedLateness": "3m"})
            resp = http.handle(req(side, "POST", CQ, body))
            assert resp.status == 200, resp.body
            resp = http.handle(req(side, "POST", "/api/put",
                                   _points(n_half_min=20), summary="true"))
            assert json.loads(resp.body)["failed"] == 0
            resp = http.handle(req(side, "GET", f"{CQ}/fed-sk/result"))
            assert resp.status == 200
            proc.kill()
            proc.wait(10)
            resp = http.handle(req(side, "GET", f"{CQ}/fed-sk/result"))
            assert resp.status == 200
            rows, marker = _split_marker(json.loads(resp.body))
            assert marker["shardsDegraded"] == ["sub"]
            assert marker["complete"] is False
            dead = {f"h{h:02d}" for h in range(N_HOSTS)
                    if rt.cluster.ring.shard_for(
                        "f.m", {"host": f"h{h:02d}"}) == "sub"}
            assert {r["tags"]["host"] for r in rows} == \
                {f"h{h:02d}" for h in range(N_HOSTS)} - dead
            return _index_rows(rows), marker
        finally:
            wake_wire_readers(rt.cluster)
            rt.shutdown()
    finally:
        for p in inproc:
            p.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# -- lifecycle ------------------------------------------------------------

def _shard_ids(c):
    return [[q.id for q in p.tsdb.streaming.list()] for p in c.peers]


class TestFederatedLifecycle:
    def test_rf_gt_1_refused(self, tmp_path):
        def run(c):
            resp = _call(c, "POST", CQ, _cq_body("fed-rf"))
            assert resp.status == 400 and b"rf=1" in resp.body
            assert _shard_ids(c) == [[], [], []]
            return resp.body

        jax, port = both(tmp_path, run, **{"tsd.cluster.rf": "2"})
        assert port == jax

    def test_non_decomposable_aggregator_refused(self, tmp_path):
        def run(c):
            resp = _call(c, "POST", CQ, _cq_body("fed-dev", agg="dev"))
            assert resp.status == 400
            assert b"does not decompose" in resp.body
            assert _shard_ids(c) == [[], [], []]
            return resp.body

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_shard_refusal_rolls_back_every_leg(self, tmp_path):
        """A body only the shards refuse (hopping with no slide) answers
        their 400 and leaves no half-registered query on any shard."""
        def run(c):
            resp = _call(c, "POST", CQ, _cq_body(
                "fed-half", window={"type": "hopping", "size": "10m"}))
            assert resp.status == 400
            assert b"shard s" in resp.body and b"slide" in resp.body
            assert _shard_ids(c) == [[], [], []]
            return resp.body

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_register_refused_during_reshard(self, tmp_path):
        """A registration while a reshard cutover is open answers the
        reference's 400: each package opens a real cutover by ``POST
        /api/cluster/reshard`` (a fourth shard joins, the backfill is
        left unstepped) and the two bodies are compared."""
        got = []
        for side in SIDES:
            c = LiveCluster(tmp_path / side.name, side, durable=True, **{
                **CALM, "tsd.cluster.reshard.interval_ms": "3600000",
                "tsd.cluster.retire.interval_ms": "3600000"})
            extra = LivePeer(side, "s3")
            try:
                spec = c.cfg["tsd.cluster.peers"] + \
                    f",s3=127.0.0.1:{extra.port}"
                resp = _call(c, "POST", "/api/cluster/reshard",
                             {"peers": spec})
                assert resp.status == 200, resp.body
                assert c.router.resharding
                got.append(_call(c, "POST", CQ, _cq_body("fed-rs")))
            finally:
                c.close()
                extra.stop()
        want, port = got
        assert port.status == want.status == 400
        assert port.body == want.body and b"reshard" in port.body

    def test_duplicate_id_refused(self, tmp_path):
        def run(c):
            _register(c, _cq_body("fed-dup"))
            resp = _call(c, "POST", CQ, _cq_body("fed-dup"))
            assert resp.status == 400
            assert b"already registered" in resp.body
            return resp.body

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_delete_propagates_to_every_shard(self, tmp_path):
        def run(c):
            _register(c, _cq_body("fed-del"))
            assert _shard_ids(c) == [["fed-del"]] * 3
            resp = _call(c, "DELETE", f"{CQ}/fed-del")
            assert resp.status == 204
            assert _shard_ids(c) == [[], [], []]
            resp = _call(c, "GET", f"{CQ}/fed-del/result")
            assert resp.status == 404
            return resp.body

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_deltas_surface_refused_on_router(self, tmp_path):
        def run(c):
            _register(c, _cq_body("fed-dl"))
            resp = _call(c, "GET", f"{CQ}/fed-dl/deltas")
            assert resp.status == 400 and b"shard-local" in resp.body
            return resp.body

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_list_and_describe_surface_federation(self, tmp_path):
        def run(c):
            _register(c, _cq_body("fed-ls",
                                  watermark={"allowedLateness": "4m"}))
            docs = json.loads(_call(c, "GET", CQ).body)
            assert [d["id"] for d in docs] == ["fed-ls"]
            assert docs[0]["federated"] is True
            assert docs[0]["watermark"] == {"allowedLatenessMs": 240_000}
            one = json.loads(_call(c, "GET", f"{CQ}/fed-ls").body)
            assert one["shards"] == ["s0", "s1", "s2"]
            return [{k: v for k, v in d.items() if k != "foldBytes"}
                    for d in docs + [one]]

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_armed_cluster_cq_fault_degrades_the_pull(self, tmp_path):
        """``cluster.cq`` covers every exchange: armed on the router for
        three calls, one pull's three legs fail and it answers 503; the
        next pull is whole."""
        def run(c):
            _register(c, _cq_body("fed-ft"))
            _put(c, _points(n_half_min=4))
            c.tsdb.faults.arm("cluster.cq", error_count=3)
            resp = _call(c, "GET", f"{CQ}/fed-ft/result")
            assert resp.status == 503
            assert b"every shard leg failed" in resp.body
            ok = _call(c, "GET", f"{CQ}/fed-ft/result")
            assert ok.status == 200
            return resp.body, json.loads(ok.body)

        jax, port = both(tmp_path, run)
        assert port == jax
