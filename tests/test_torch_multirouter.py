"""Two sibling routers behind one load balancer, the port's against the
JAX package's, live (the reference's battery, ``tests/test_multirouter.py``,
run on both packages and compared; ``tests/torch_cluster_pair.py``):

- ``TestGossipCacheCoherence``: a write or a delete forwarded by one
  router is served stale by its sibling until one gossip push (the
  negative control), and never after it; a sibling that went quiet past
  the stale window degrades the router to cache-bypassed reads, exact,
  with ``cluster_gossip_degraded`` in ``/api/health``, until a push
  lands again;
- ``TestKillFlapMidIngest``: a router's listener dies mid-ingest and
  comes back; every acknowledged write reads back through either router
  and through the load balancer;
- ``TestReadRepair``: at rf=2 a read that sees a diverged replica stages
  the window, and the replica heals with no restart;
- ``TestSigkillRouterMidReshard``: the router that began a reshard is a
  real process (the port's imports only ``opentsdb_tpu_torch``), killed
  with the window open; its sibling, which adopted the window over
  gossip, finishes it alone, and the restarted process converges;
- the :class:`GossipBus` of both packages, driven through the same
  calls (writes, trims past ``log_max``, a restart with a new nonce, a
  receive map that evicts, heartbeats), gives the same push bodies,
  acks, counters and version bumps;
- interop both ways: a port router and a JAX router as siblings, a
  write through one invalidating the other's cache after one push, and
  a reshard begun on one adopted and finalized by the other.

Integer-valued data (``mkpoints``): every answer is held bit for bit to
one port node holding the acknowledged points, and the two packages'
answers to each other. As in the reference, the coherence and interop
tests stop both push loops and push by hand, so "before the push" is a
stable state. Clusters with no injected shard failure take the 30 s
peer and wire-handshake timeouts; the read-repair test keeps the
reference's 2 s deadline, which its hung shard must reach, and warms
the shards first through a throwaway router with the 30 s deadline (a
JAX shard's first query compiles).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PEER_CFG, PORT, QUERIES,
                                SIDES, LivePeer, mkpoints, req, sorted_rows,
                                strip_marker, tsq, wake_wire_readers)

import opentsdb_tpu.cluster.gossip as j_gossip

import opentsdb_tpu_torch.cluster.gossip as t_gossip

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

GOSSIP = {"jax": j_gossip, "port": t_gossip}
ALLOW = {"tsd.http.query.allow_delete": "true"}
# no shard fails in these clusters: a JAX shard's first query compiles,
# which must not be taken for a dead shard
CALM = {"tsd.cluster.timeout_ms": "30000",
        "tsd.cluster.wire.connect_timeout_ms": "30000"}
HOUR_MS = "3600000"
ROUTER_THREADS = ("cluster-gossip", "cluster-replay", "cluster-backfill",
                  "cluster-retire")


@pytest.fixture(autouse=True, scope="module")
def _no_router_thread_left():
    """Every router, bus and shard of the module is closed and its
    threads joined: no router thread started here outlives it."""
    before = {t.ident for t in threading.enumerate()}
    yield
    deadline = time.monotonic() + 10
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive()
                and t.name.startswith(ROUTER_THREADS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, left


# ---------------------------------------------------------------------------
# raw HTTP, the load balancer and the two-router fleet
# ---------------------------------------------------------------------------

_PORTS = random.Random(os.getpid() ^ time.time_ns())


def free_port() -> int:
    """A free port below Linux's ephemeral range (32768 up): a router's
    address is reserved before its server binds it, and meanwhile the
    other router's outgoing connections take ephemeral local ports,
    which an address drawn from that range could be."""
    while True:
        port = _PORTS.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def http_call(port, method, path, body=None, timeout=90):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"}
                     if data is not None else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def until(fn, timeout=30, every=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(every)
    return False


class LB:
    """Round-robin over the routers, failing over on a connection error
    only: an HTTP status is the router's answer (ref: ``LB``)."""

    def __init__(self, ports):
        self.ports = list(ports)
        self._rr = 0

    def request(self, method, path, body=None):
        first = self._rr % len(self.ports)
        self._rr += 1
        last = None
        for k in range(len(self.ports)):
            try:
                return http_call(self.ports[(first + k) % len(self.ports)],
                                 method, path, body)
            except (OSError, http.client.HTTPException) as exc:
                last = exc
        raise AssertionError(f"no router answered {path}: {last}")


def router_cfg(spec, sibling, spool_dir, rf=1, gossip_ms=50,
               stale_ms=60_000, **extra):
    return {"tsd.cluster.role": "router",
            "tsd.cluster.peers": spec,
            "tsd.cluster.rf": str(rf),
            "tsd.cluster.routers": sibling,
            "tsd.cluster.spool.dir": str(spool_dir),
            "tsd.cluster.spool.replay_interval_ms": "100",
            "tsd.cluster.gossip.interval_ms": str(gossip_ms),
            "tsd.cluster.gossip.stale_ms": str(stale_ms),
            "tsd.cluster.breaker.reset_timeout_ms": "300",
            "tsd.http.query.allow_delete": "true",
            **CALM, **extra}


def stop_router(peer: LivePeer) -> None:
    cluster = peer.tsdb._cluster
    if cluster is not None:
        wake_wire_readers(cluster)
    peer.stop()


class Fleet:
    """Shard TSDs of ``shard_side`` and two real-socket routers, r0 of
    ``sides[0]`` and r1 of ``sides[1]``, each naming the other in
    ``tsd.cluster.routers`` (both ports are reserved first: both
    addresses exist before either server does), and the LB (ref:
    ``Fleet``)."""

    def __init__(self, tmp_path, sides, shard_side, n_shards=3, rf=1,
                 **cfg):
        self.sides = sides
        self.shards: list[LivePeer] = []
        self.routers: list[LivePeer] = []
        try:
            self.shards = [LivePeer(shard_side, f"s{i}", **ALLOW)
                           for i in range(n_shards)]
            self.spec = ",".join(f"s{i}=127.0.0.1:{p.port}"
                                 for i, p in enumerate(self.shards))
            ports = [free_port(), free_port()]
            for i in (0, 1):
                self.routers.append(LivePeer(
                    sides[i], f"r{i}", port=ports[i], **router_cfg(
                        self.spec, f"r{1 - i}=127.0.0.1:{ports[1 - i]}",
                        tmp_path / f"r{i}", rf=rf, **cfg)))
        except BaseException:
            self.close()
            raise
        self.lb = LB(ports)

    def cluster(self, i):
        return self.routers[i].tsdb.cluster

    def stop_push_loops(self):
        for i in (0, 1):
            self.cluster(i).gossip.stop()

    def put(self, points, via=None):
        path = "/api/put?summary=true"
        status, body = self.lb.request("POST", path, points) \
            if via is None else http_call(self.routers[via].port, "POST",
                                          path, points)
        return status, (json.loads(body) if body else None)

    def put_ok(self, points, via=None):
        status, out = self.put(points, via=via)
        assert status == 200 and out["failed"] == 0, out
        return points

    def query(self, body, via=None):
        status, out = self.lb.request("POST", "/api/query", body) \
            if via is None else http_call(self.routers[via].port, "POST",
                                          "/api/query", body)
        return status, (json.loads(out) if out else None)

    def rows(self, body, via=None):
        status, out = self.query(body, via=via)
        assert status == 200, out
        rows, degraded = strip_marker(out)
        assert degraded == []
        return sorted_rows(rows)

    def doc(self, i, path):
        status, out = http_call(self.routers[i].port, "GET", path)
        assert status == 200, out
        return json.loads(out)

    def health_causes(self, i):
        return self.doc(i, "/api/health").get("causes") or []

    def close(self):
        for r in self.routers:
            stop_router(r)
        for p in self.shards:
            p.stop()


class Oracle:
    """One port node holding exactly the acknowledged points."""

    def __init__(self, points):
        self.tsdb = PORT.TSDB(PORT.Config(**{**PORT.keys, **PEER_CFG}))
        for dp in points:
            self.tsdb.add_point(dp["metric"], dp["timestamp"], dp["value"],
                                dp["tags"])
        self.http = PORT.http.HttpRpcRouter(self.tsdb)

    def want(self, body):
        resp = self.http.handle(req(PORT, "POST", "/api/query", body))
        assert resp.status == 200, resp.body
        return sorted_rows(strip_marker(json.loads(resp.body))[0])

    def close(self):
        self.tsdb.shutdown()


def want(points, body):
    o = Oracle(points)
    try:
        return o.want(body)
    finally:
        o.close()


def battery(fleet, acked, via=None):
    """Every exact query of :data:`QUERIES` through ``via`` (the LB when
    None) against one node of the acknowledged points; the rows."""
    o = Oracle(acked)
    try:
        out = []
        for qs in QUERIES:
            body = tsq(qs)
            got = fleet.rows(body, via=via)
            assert got == o.want(body), qs
            out.append(got)
        return out
    finally:
        o.close()


def q(metric, **extra):
    return {"start": BASE_MS - 10_000, "end": BASE_MS + 200_000,
            "queries": [{"metric": metric, "aggregator": "sum",
                         "downsample": "10s-sum"}], **extra}


def both(tmp_path, scenario, **cfg):
    """``scenario(fleet)`` on a JAX and a port fleet (each closed after);
    returns [JAX result, port result]."""
    out = []
    for side in SIDES:
        f = Fleet(tmp_path / side.name, (side, side), side, **cfg)
        try:
            out.append(scenario(f))
        finally:
            f.close()
    return out


HAND = {"gossip_ms": HOUR_MS, "stale_ms": HOUR_MS}


# ---------------------------------------------------------------------------
# gossip-coherent caches (push loops stopped, every push by hand)
# ---------------------------------------------------------------------------

class TestGossipCacheCoherence:
    def test_sibling_write_invalidates_after_one_push(self, tmp_path):
        def run(f):
            f.stop_push_loops()
            points = f.put_ok(mkpoints(), via=0)
            body = tsq(QUERIES[0])
            r0 = f.cluster(0)
            first = f.rows(body, via=0)
            assert f.rows(body, via=0) == first
            assert r0.cache_hits >= 1  # the cache is live
            extra = [{"metric": "c.m", "timestamp": BASE + i, "value": 7,
                      "tags": {"host": "h90"}} for i in range(120)]
            f.put_ok(extra, via=1)
            # negative control: r0 has not seen the delta and serves its
            # cached, now stale, answer
            stale = f.rows(body, via=0)
            assert stale == first
            assert stale != want(points + extra, body)
            applied = r0.gossip.deltas_applied
            assert f.cluster(1).gossip.push_once() == 1
            assert r0.gossip.deltas_applied > applied
            assert f.rows(body, via=0) == want(points + extra, body)
            return (first, battery(f, points + extra, via=0),
                    battery(f, points + extra, via=1))

        jax, port = both(tmp_path, run, **HAND)
        assert port == jax

    def test_sibling_delete_leaves_no_servable_stale_entry(self, tmp_path):
        def run(f):
            f.stop_push_loops()
            pts = [{"metric": "c.del", "timestamp": BASE + i, "value": 3,
                    "tags": {"host": f"h{h}"}}
                   for i in range(60) for h in range(4)]
            f.put_ok(pts, via=0)
            assert f.cluster(0).gossip.push_once() == 1
            body = q("c.del")
            cached = f.rows(body, via=1)
            assert cached
            status, _ = f.query(q("c.del", delete=True), via=0)
            assert status == 200
            # negative control: r1 still serves the purged rows
            assert f.rows(body, via=1) == cached
            assert f.cluster(0).gossip.push_once() == 1
            s0, fresh0 = f.query(body, via=0)
            s1, fresh1 = f.query(body, via=1)
            assert (s1, fresh1) == (s0, fresh0)
            if s1 == 200:
                assert strip_marker(fresh1)[0] != cached
            g = f.doc(1, "/api/cluster/status")["gossip"]
            assert g["deltas_applied"] >= 1
            assert g["degraded"] is False
            return cached, s1, fresh1, g["deltas_applied"], g["full_syncs"]

        jax, port = both(tmp_path, run, **HAND)
        assert port == jax

    def test_partitioned_sibling_degrades_to_cache_bypass(self, tmp_path):
        def run(f):
            f.stop_push_loops()
            points = f.put_ok(mkpoints(), via=0)
            body = tsq(QUERIES[0])
            f.rows(body, via=0)  # would be the stale entry
            extra = [{"metric": "c.m", "timestamp": BASE + i, "value": 9,
                      "tags": {"host": "h91"}} for i in range(120)]
            f.put_ok(extra, via=1)
            r0 = f.cluster(0)
            assert until(r0.gossip.degraded, 10)
            bypasses = r0.gossip.cache_bypasses
            got = f.rows(body, via=0)
            assert got == want(points + extra, body)
            assert r0.gossip.cache_bypasses > bypasses
            assert "cluster_gossip_degraded" in f.health_causes(0)
            assert r0.gossip.push_once() == 1
            assert r0.gossip.degraded() is False
            assert "cluster_gossip_degraded" not in f.health_causes(0)
            return got

        jax, port = both(tmp_path, run, gossip_ms=HOUR_MS, stale_ms=300)
        assert port == jax


# ---------------------------------------------------------------------------
# a router's listener killed and flapped mid-ingest
# ---------------------------------------------------------------------------

class TestKillFlapMidIngest:
    def test_router_kill_and_flap_zero_acked_loss(self, tmp_path):
        def run(f):
            pts = mkpoints()
            batches = [[p for p in pts
                        if 30 * b <= p["timestamp"] - BASE < 30 * (b + 1)]
                       for b in range(4)]
            acked = []
            acked += f.put_ok(batches[0])
            body = tsq(QUERIES[0])
            f.rows(body, via=0)  # r0's cache holds the pre-kill answer
            f.routers[0].kill()
            acked += f.put_ok(batches[1])
            acked += f.put_ok(batches[2])
            # the survivor's pushes to r0 fail: it degrades and says so,
            # and its reads bypass the cache and stay exact
            assert until(lambda: "cluster_gossip_degraded" in
                         f.health_causes(1), 15)
            assert f.rows(body, via=1) == want(acked, body)
            f.routers[0].restart()
            acked += f.put_ok(batches[3])
            w = want(acked, body)
            assert until(lambda: f.rows(body, via=0) == w, 15)
            out = [battery(f, acked, via=0), battery(f, acked, via=1),
                   battery(f, acked)]
            assert until(lambda: "cluster_gossip_degraded" not in
                         f.health_causes(1), 15)
            # a write through one router, read through the other, both
            # ways
            acked += f.put_ok([{"metric": "c.m", "timestamp": BASE + 130,
                                "value": 5, "tags": {"host": "h92"}}],
                              via=1)
            w = want(acked, body)
            assert until(lambda: f.rows(body, via=0) == w, 10)
            acked += f.put_ok([{"metric": "c.m", "timestamp": BASE + 140,
                                "value": 6, "tags": {"host": "h93"}}],
                              via=0)
            w = want(acked, body)
            assert until(lambda: f.rows(body, via=1) == w, 10)
            return out, w

        jax, port = both(tmp_path, run, gossip_ms=50, stale_ms=1000)
        assert port == jax


# ---------------------------------------------------------------------------
# a read heals a diverged replica
# ---------------------------------------------------------------------------

def warm_up(f, body) -> None:
    """Send ``body`` to the shards once through a throwaway router of
    r0's package and ring with no deadline to speak of: a JAX shard's
    first query compiles, which under a loaded run can pass r0's 2 s
    deadline (ref: ChaosBase's warm-up). r0 itself reads nothing, so
    its cache, breakers and read-repair queue are untouched."""
    side = f.sides[0]
    t = side.TSDB(side.Config(**{
        **side.keys, "tsd.tpu.warmup": "false", "tsd.cluster.role": "router",
        "tsd.cluster.peers": f.spec,
        "tsd.cluster.rf": f.cluster(0).config.get_string("tsd.cluster.rf"),
        **CALM}))
    try:
        resp = side.http.HttpRpcRouter(t).handle(
            req(side, "POST", "/api/query", body))
        assert resp.status == 200, resp.body
        assert strip_marker(json.loads(resp.body))[1] == []
    finally:
        if t._cluster is not None:
            wake_wire_readers(t._cluster)
        t.shutdown()


class TestReadRepair:
    def test_read_observing_divergence_heals_replica(self, tmp_path):
        def run(f):
            pts = [{"metric": "c.div", "timestamp": BASE + i,
                    "value": (h * 11 + 3) % 40, "tags": {"host": f"h{h}"}}
                   for i in range(60) for h in range(8)]
            f.put_ok(pts, via=0)
            body = q("c.div")
            warm_up(f, body)
            local = {"start": BASE_MS - 10_000, "end": BASE_MS + 200_000,
                     "queries": [{"metric": "c.div", "aggregator": "none"}]}
            s1 = f.shards[1]

            def s1_rows():
                status, out = http_call(s1.port, "POST", "/api/query",
                                        local)
                assert status == 200, out
                return sorted_rows(json.loads(out))

            before = s1_rows()
            assert before  # rf=2 of 3 shards: s1 holds replicas
            status, _ = http_call(s1.port, "POST", "/api/query",
                                  dict(local, delete=True))
            assert status == 200
            assert s1_rows() != before
            r0 = f.cluster(0)
            s1.hang("/api/query")
            try:
                got = f.rows(body, via=0)
                assert got == want(pts, body)
            finally:
                s1.unhang()
            assert r0.read_repair.health_info()["enqueued"] >= 1
            assert until(lambda: s1_rows() == before, 20), \
                r0.read_repair.health_info()
            assert until(lambda: r0.read_repair.health_info()["completed"]
                         >= 1, 10)
            rr = r0.read_repair.health_info()
            assert rr["depth"] == 0 and rr["inflight"] == 0, rr
            assert rr["oldest_pending_age_s"] == 0.0
            assert f.doc(0, "/api/cluster/status")["read_repair"][
                "completed"] >= 1
            assert f.rows(body, via=0) == want(pts, body)
            return before, got

        jax, port = both(tmp_path, run, rf=2, gossip_ms=50,
                         **{"tsd.cluster.timeout_ms": "2000"})
        assert port == jax


# ---------------------------------------------------------------------------
# a real router process killed with its reshard window open
# ---------------------------------------------------------------------------

ROUTER_SCRIPTS = {
    "jax": """
import asyncio, sys
from opentsdb_tpu import TSDB, Config
from opentsdb_tpu.tsd.server import TSDServer
""",
    "port": """
import asyncio, sys
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tsd.server import TSDServer
""",
}
ROUTER_MAIN = """
port, spool_dir, shard_spec, sibling_spec = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
t = TSDB(Config(**{
    **KEYS,
    "tsd.core.auto_create_metrics": "true",
    "tsd.tpu.warmup": "false",
    "tsd.cluster.role": "router",
    "tsd.cluster.peers": shard_spec,
    "tsd.cluster.routers": sibling_spec,
    "tsd.cluster.spool.dir": spool_dir,
    "tsd.cluster.spool.replay_interval_ms": "100",
    "tsd.cluster.reshard.interval_ms": "50",
    "tsd.cluster.gossip.interval_ms": "50",
    "tsd.cluster.gossip.stale_ms": "60000",
    "tsd.cluster.timeout_ms": "30000",
    "tsd.cluster.wire.connect_timeout_ms": "30000",
}))

async def main():
    server = TSDServer(t, host="127.0.0.1", port=port)
    await server.serve_forever()

asyncio.run(main())
"""


def router_script(side) -> str:
    return (ROUTER_SCRIPTS[side.name] + f"KEYS = {side.keys!r}\n"
            + ROUTER_MAIN)


class TestSigkillRouterMidReshard:
    @staticmethod
    def _spawn(script, port, spool_dir, shard_spec, sibling_spec):
        root = Path(__file__).resolve().parent.parent
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = str(root) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        proc = subprocess.Popen(
            [sys.executable, str(script), str(port), str(spool_dir),
             shard_spec, sibling_spec],
            env=env, cwd=str(root), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with socket.create_connection(("127.0.0.1", port), 1):
                    return proc
            except OSError:
                time.sleep(0.2)
        proc.kill()
        proc.wait(10)
        raise AssertionError("the router process did not come up")

    def _scenario(self, tmp, side):
        tmp.mkdir(parents=True, exist_ok=True)
        shards = [LivePeer(side, f"s{i}") for i in range(3)]
        spare = LivePeer(side, "s3")
        spec3 = ",".join(f"s{i}=127.0.0.1:{p.port}"
                         for i, p in enumerate(shards))
        spec4 = spec3 + f",s3=127.0.0.1:{spare.port}"
        r0_port = free_port()
        script = tmp / "router.py"
        script.write_text(router_script(side))
        r1 = LivePeer(side, "r1", **router_cfg(
            spec3, f"r0=127.0.0.1:{r0_port}", tmp / "r1",
            **{"tsd.cluster.reshard.interval_ms": "50"}))
        proc = None

        def status_of(port):
            st, out = http_call(port, "GET", "/api/cluster/status")
            assert st == 200, out
            return json.loads(out)

        def rows_of(port, body):
            st, out = http_call(port, "POST", "/api/query", body)
            if st != 200:
                return None
            rows, degraded = strip_marker(json.loads(out))
            return None if degraded else sorted_rows(rows)

        def final(s):
            return not s["reshard"]["active"] and "s3" in s["ring"]["peers"]

        try:
            proc = self._spawn(script, r0_port, tmp / "r0", spec3,
                               f"r1=127.0.0.1:{r1.port}")
            pts = mkpoints()
            batch_a = [p for p in pts if p["timestamp"] - BASE < 60]
            batch_b = [p for p in pts if p["timestamp"] - BASE >= 60]
            st, out = http_call(r0_port, "POST", "/api/put?summary=true",
                                batch_a)
            assert st == 200 and json.loads(out)["failed"] == 0
            st, out = http_call(r0_port, "POST", "/api/cluster/reshard",
                                {"peers": spec4})
            assert st == 200, out
            epoch = json.loads(out)["epoch"]
            # the sibling adopts the open window over gossip
            assert until(lambda: status_of(r1.port)["epoch"] == epoch, 30)
            # (the counter moves just after the adoption returns)
            assert until(lambda: r1.tsdb.cluster.gossip.topology_adoptions
                         >= 1, 10)
            proc.kill()  # SIGKILL: no flush, no goodbye
            proc.wait(10)
            st, out = http_call(r1.port, "POST", "/api/put?summary=true",
                                batch_b)
            assert st == 200 and json.loads(out)["failed"] == 0
            # the sibling resumes the copy and finalizes alone
            assert until(lambda: final(status_of(r1.port)), 60)
            acked = batch_a + batch_b
            o = Oracle(acked)
            try:
                rows = []
                for qs in QUERIES:
                    body = tsq(qs)
                    got = rows_of(r1.port, body)
                    assert got == o.want(body), qs
                    rows.append(got)
                # the dead router returns over its spool dir and
                # converges to the final epoch
                proc = self._spawn(script, r0_port, tmp / "r0", spec3,
                                   f"r1=127.0.0.1:{r1.port}")
                assert until(lambda: (lambda s: s["epoch"] == epoch and
                                      final(s))(status_of(r0_port)), 60)
                for qs in QUERIES:
                    body = tsq(qs)
                    w = o.want(body)
                    assert until(lambda b=body, w=w:
                                 rows_of(r0_port, b) == w, 30), qs
            finally:
                o.close()
            # the restarted router reflects a write it never saw
            probe = [{"metric": "c.m", "timestamp": BASE + 150, "value": 4,
                      "tags": {"host": "h94"}}]
            st, out = http_call(r1.port, "POST", "/api/put?summary=true",
                                probe)
            assert st == 200 and json.loads(out)["failed"] == 0
            body = tsq(QUERIES[0])
            w = want(acked + probe, body)
            assert until(lambda: rows_of(r0_port, body) == w, 20)
            return epoch, rows, w
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)
            stop_router(r1)
            for p in shards + [spare]:
                p.stop()

    def test_sigkill_initiator_sibling_resumes_reshard(self, tmp_path):
        """The router that began the reshard is a real process, killed
        with the window open; the sibling finishes the reshard alone
        while writes through it keep being acknowledged, every read
        answers as one node of the acknowledged points, and the killed
        router, restarted over its spool dir, converges to the final
        epoch and reflects a write it never saw."""
        jax = self._scenario(tmp_path / "jax", JAX)
        port = self._scenario(tmp_path / "port", PORT)
        assert port == jax
        assert "opentsdb_tpu." not in router_script(PORT)
        assert "jax" not in router_script(PORT).replace(
            "JAX_PLATFORMS", "")


# ---------------------------------------------------------------------------
# the bus itself, both packages through the same calls
# ---------------------------------------------------------------------------

class _StubRouter:
    """What the bus reads of its router, with the version bumps and the
    topology adoptions recorded instead of applied."""

    def __init__(self, side, **cfg):
        self.config = side.Config(**{
            **side.keys, "tsd.cluster.peers": "s0=127.0.0.1:1", **cfg})
        self.state = side.reshard.ReshardState(None)
        self.ring = types.SimpleNamespace(vnodes=64)
        self.tsdb = types.SimpleNamespace(tracer=None, faults=None)
        self.calls: list = []

    def _bump_versions(self, metrics, announce=True):
        self.calls.append(("metrics", sorted(metrics), announce))

    def _bump_global_version(self, announce=True):
        self.calls.append(("global", announce))

    def adopt_topology(self, doc):
        self.calls.append(("topology", doc["epoch"], doc["peers"]))
        return False


def _without_nonce(doc):
    return {k: v for k, v in doc.items() if k != "nonce"}


def _bus_scenario(side):
    mod = GOSSIP[side.name]
    log = []
    ra, rb = _StubRouter(side), _StubRouter(side)
    spec_a, spec_b = "b=127.0.0.1:1", "a=127.0.0.1:2"
    a = mod.GossipBus(ra, spec_a)
    b = mod.GossipBus(rb, spec_b)
    link = {"up": True}

    def wire(sender, receiver):
        def request(method, path, body):
            assert (method, path) == ("POST", "/api/cluster/gossip")
            doc = json.loads(body)
            log.append(("push", _without_nonce(doc)))
            if not link["up"]:
                return 503, b"down"
            ack = receiver.apply_remote(doc)
            assert ack["nonce"] == receiver.nonce
            log.append(("ack", _without_nonce(ack)))
            return 200, json.dumps(ack).encode()
        sib = next(iter(sender.siblings.values()))
        sib.client.request = request
        sib.breaker.failure_threshold = 1 << 30

    def state(bus):
        sib = next(iter(bus.siblings.values()))
        info = _without_nonce(bus.health_info())
        info.pop("siblings")
        return (info, sib.acked_seq, sib.pushes, sib.push_failures,
                sib.deltas_sent, len(bus._log))

    wire(a, b)
    wire(b, a)
    a.record_writes(["m1", "m2", ""])
    a.record_writes([])
    a.record_global()
    log.append(("pushed", a.push_once()))   # a join: one full sync
    log.append(("pushed", a.push_once()))   # a heartbeat
    a.record_writes(["m3"])
    log.append(("pushed", a.push_once()))   # one delta
    log.append(("state", state(a), state(b)))
    # the link fails past log_max: the log trims, and the next push
    # lands with a gap, covered by one global bump
    link["up"] = False
    for i in range(40):
        a.record_writes([f"w{i % 5}"])
    log.append(("pushed", a.push_once()))
    log.append(("state", state(a), state(b)))
    link["up"] = True
    log.append(("pushed", a.push_once()))
    # b pushes back; a has never heard of b: a join
    b.record_writes(["back"])
    log.append(("pushed", b.push_once()))
    # a restarts: a new nonce is a join again
    a2 = mod.GossipBus(ra, spec_a)
    wire(a2, b)
    assert a2.nonce != a.nonce
    a2.record_writes(["after"])
    log.append(("pushed", a2.push_once()))
    log.append(("state", state(a2), state(b)))
    # b's receive map holds 4 * 1 + 8 senders: a thirteenth evicts the
    # oldest, which costs that sender one re-join
    for k in range(13):
        log.append(("ack", _without_nonce(b.apply_remote(
            {"nonce": f"n{k:02d}", "seq": 3,
             "deltas": [{"seq": 3, "metrics": [f"e{k}"]}]}))))
    log.append(("ack", _without_nonce(b.apply_remote(
        {"nonce": "n00", "seq": 4,
         "deltas": [{"seq": 4, "metrics": ["e0"]}]}))))
    log.append(("ack", _without_nonce(b.apply_remote(
        {"nonce": "n12", "seq": 5,
         "deltas": [{"seq": 5, "global": True}]}))))
    for bad in ({"seq": 1, "deltas": []}, {"nonce": "x", "deltas": {"a": 1}},
                ["not", "an", "object"]):
        with pytest.raises(ValueError):
            b.apply_remote(bad)
    log.append(("state", state(a2), state(b)))
    log.append(("calls", ra.calls, rb.calls))
    return log


def test_gossip_bus_state_matches_the_reference():
    """Writes, a trim past ``log_max``, a failed and a landed push, a
    restart with a new nonce, an evicting receive map and heartbeats:
    the same calls on both packages' buses give the same push bodies,
    acks, counters and version bumps."""
    jax, port = (_bus_scenario(side) for side in SIDES)
    assert port == jax
    calls = port[-1][2]  # what b applied
    assert ("metrics", ["m1", "m2"], False) in calls
    assert all(c[-1] is False for c in calls if c[0] != "topology")
    a_state, b_state = [e for e in port if e[0] == "state"][0][1:]
    assert a_state[0]["deltas_logged"] == 3
    assert b_state[0]["full_syncs"] == 1
    assert b_state[0]["heartbeats_in"] == 1


# ---------------------------------------------------------------------------
# interop: a port router and a JAX router as siblings
# ---------------------------------------------------------------------------

def _interop(f):
    f.stop_push_loops()
    r0, r1 = f.cluster(0), f.cluster(1)
    points = f.put_ok(mkpoints(), via=0)
    assert r0.gossip.push_once() == 1  # r1 learns r0 (a join)
    assert r1.gossip.push_once() == 1
    body = tsq(QUERIES[0])
    first = f.rows(body, via=1)
    assert f.rows(body, via=1) == first
    assert r1.cache_hits >= 1
    extra = [{"metric": "c.m", "timestamp": BASE + i, "value": 7,
              "tags": {"host": "h90"}} for i in range(120)]
    f.put_ok(extra, via=0)
    acked = points + extra
    assert f.rows(body, via=1) == first  # stale until the push
    assert r0.gossip.push_once() == 1
    assert f.rows(body, via=1) == want(acked, body)
    # a reshard begun on r0 is adopted by r1, which finalizes it alone,
    # and r0 follows r1's finalize over one push
    spare = LivePeer(f.shards[0].side, "s3", **ALLOW)
    try:
        st, out = http_call(f.routers[0].port, "POST",
                            "/api/cluster/reshard",
                            {"peers": f.spec + f",s3=127.0.0.1:{spare.port}"})
        assert st == 200, out
        assert r0.gossip.push_once() == 1
        assert r1.gossip.topology_adoptions == 1
        assert (r1.state.epoch, r1.resharding) == (1, True)
        # every series covers the new bucket, as the exact queries
        # assume
        tail = [{"metric": "c.m", "timestamp": BASE + 125 + i,
                 "value": 2, "tags": {"host": host}}
                for i in range(3)
                for host in [f"h{h:02d}" for h in range(12)] + ["h90"]]
        acked += f.put_ok(tail, via=1)  # dual-written by r1
        for _ in range(200):
            if r1.backfill_step().get("phase") in ("done", "idle"):
                break
        assert (r1.state.epoch, r1.resharding) == (1, False)
        assert r0.resharding
        assert r1.gossip.push_once() == 1
        assert (r0.state.epoch, r0.resharding) == (1, False)
        assert r0.gossip.topology_adoptions == 1
        assert r0.ring.names == r1.ring.names == ["s0", "s1", "s2", "s3"]
        return (battery(f, acked, via=0), battery(f, acked, via=1),
                f.doc(1, "/api/cluster/reshard")["epoch"])
    finally:
        f.close()
        spare.stop()


@pytest.mark.parametrize("first,second", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-jax", "jax-port"])
def test_sibling_routers_across_packages(tmp_path, first, second):
    """A router of one package and a router of the other as siblings
    over the port's shards: a write through the first invalidates the
    second's cache after one push, and a reshard begun on the first is
    adopted and finalized by the second, which the first then follows.
    Both routers answer as one node of the acknowledged points."""
    f = Fleet(tmp_path, (first, second), PORT,
              **{**HAND, "tsd.cluster.reshard.interval_ms": HOUR_MS,
                 "tsd.cluster.retire.interval_ms": HOUR_MS})
    out = _interop(f)
    assert out[2] == 1


def test_gossip_thread_has_the_cluster_role_and_ends_with_the_router():
    """A port router that names a sibling starts its push loop on a
    thread named ``cluster-gossip``, which both packages' profilers
    give the ``cluster`` role, and joins it when the TSDB shuts down."""
    from opentsdb_tpu.obs import profiler as jprof

    from opentsdb_tpu_torch.obs import profiler as tprof
    before = set(threading.enumerate())
    t = PORT.TSDB(PORT.Config(**{
        **PORT.keys, "tsd.cluster.role": "router",
        "tsd.cluster.peers": "s0=127.0.0.1:1",
        "tsd.cluster.routers": f"r1=127.0.0.1:{free_port()}"}))
    try:
        t.cluster.start()
        names = {th.name for th in threading.enumerate()
                 if th not in before}
        assert "cluster-gossip" in names
        assert tprof.thread_role("cluster-gossip") == \
            jprof.thread_role("cluster-gossip") == "cluster"
    finally:
        t.shutdown()
    left = [th.name for th in threading.enumerate()
            if th not in before and th.is_alive()]
    assert left == []
