"""The port's cluster under failure against the JAX package's, live
(the reference's chaos battery, ``tests/test_cluster.py``, run on both
packages with the same timeouts and breaker settings, and compared):

- a shard killed mid-query and mid-ingest, a hung shard, a flapping
  shard: every read a 200 whose ``shardsDegraded`` names the shard and
  whose rows are the surviving shards' exactly, every write
  acknowledged into the shard's durable spool, and after the replay the
  whole cluster equal to one node holding every point;
- the result cache never keeps a degraded answer, and a complete one
  repopulates it;
- a spool that outlives its router replays from the next one;
- the fault sites ``cluster.peer.<name>`` and ``cluster.wire``;
- ROADMAP Queue 3 item 25: a shard whose device query fails answers a
  500 in the port, which has no host fallback, and the router degrades
  it, where the reference's shard re-answers on its host;
- interop: the port's router over the JAX package's shards, and the
  JAX router over the port's shards, each answering as the reference's
  cluster does.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PORT, QUERIES, SIDES,
                                LiveCluster, mkpoints, req, sorted_rows,
                                strip_marker, tsq)
from torch_pair import ENGINE_KEYS

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

N_HOSTS = 12
# the reference's chaos settings (ChaosBase): a 3 s per-peer deadline
# and a 300 ms breaker reset
CHAOS = {"tsd.cluster.timeout_ms": "3000",
         "tsd.cluster.breaker.reset_timeout_ms": "300"}
SIDE_IDS = [s.name for s in SIDES]


def _warm(c) -> None:
    """Run the chaos query on each shard's engine first, with no
    deadline (ref: ChaosBase): a JAX shard's first query compiles, and
    a 3 s router deadline must not take that for a dead shard."""
    for p in c.peers:
        p.tsdb.execute_query(p.side.TSQuery.from_json(fresh_q()).validate())


def _oracle(points):
    """One port node holding ``points``."""
    t = PORT.TSDB(PORT.Config(**{**PORT.keys,
                                 "tsd.core.auto_create_metrics": "true"}))
    for dp in points:
        t.add_point(dp["metric"], dp["timestamp"], dp["value"], dp["tags"])
    return t


def _oracle_rows(points, body):
    t = _oracle(points)
    try:
        return sorted_rows(json.loads(PORT.http.HttpRpcRouter(t).handle(
            req(PORT, "POST", "/api/query", body)).body))
    finally:
        t.shutdown()


def fresh_q(salt=0, qspec=None):
    return tsq(qspec or {"aggregator": "sum", "downsample": "10s-sum"},
               end=BASE_MS + 300_000 + salt)


@pytest.fixture(params=SIDES, ids=SIDE_IDS)
def chaos(request, tmp_path):
    side = request.param
    c = LiveCluster(tmp_path, side, durable=True, **CHAOS)
    points = mkpoints(n_hosts=N_HOSTS, n_sec=60)
    assert c.put(points, summary="true").status == 200
    _warm(c)
    # warm the whole router path, so no chaos window pays first-query
    # setup (ref)
    resp, out = c.query(fresh_q())
    assert resp.status == 200 and strip_marker(out)[1] == []
    c.points = points
    yield c
    c.close()


def _surviving(c, dead, points=None):
    return [dp for dp in (c.points if points is None else points)
            if c.shard_of(dp["metric"], dp["tags"]) != dead]


def _converged(c, points, salt):
    """Query until no shard is degraded (a breaker may need one probe
    cycle to close), then hold the answer to one node of ``points``."""
    body = fresh_q(salt)
    deadline = time.monotonic() + 10
    while True:
        resp, out = c.query(body)
        rows, degraded = strip_marker(out)
        if not degraded or time.monotonic() > deadline:
            break
        body = fresh_q(int(time.monotonic() * 1000) % 100_000)
        time.sleep(0.2)
    assert resp.status == 200 and degraded == []
    assert sorted_rows(rows) == _oracle_rows(points, body)


def test_kill_mid_query_and_mid_ingest(chaos):
    c = chaos
    dead = "s0"
    hit = c.peer(dead).hang("query")
    result = {}

    def ask():
        result["resp"], result["out"] = c.query(fresh_q(1))

    th = threading.Thread(target=ask)
    th.start()
    assert hit.wait(10), "query never reached the peer"
    c.peer(dead).kill()
    th.join(timeout=30)
    assert not th.is_alive(), "router request hung"
    assert result["resp"].status == 200
    assert strip_marker(result["out"])[1] == [dead]
    c.peer(dead).unhang()
    resp, out = c.query(fresh_q(2))
    rows, degraded = strip_marker(out)
    assert resp.status == 200 and degraded == [dead]
    assert resp.headers["X-OpenTSDB-Shards-Degraded"] == dead
    assert sorted_rows(rows) == _oracle_rows(_surviving(c, dead),
                                             fresh_q(2))
    spool = c.router.peers[dead].spool
    before = spool.pending_records
    extra = [{"metric": "c.m", "timestamp": BASE + 600 + i, "value": i,
              "tags": {"host": f"h{h:02d}"}}
             for i in range(20) for h in range(N_HOSTS)]
    resp = c.put(extra, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    assert spool.pending_records > before and spool.durable
    h = json.loads(c.http.handle(req(c.side, "GET", "/api/health")).body)
    assert h["cluster"]["spool_backlog_records"] > 0
    assert "cluster_spool_backlog" in h["causes"]
    c.peer(dead).restart()
    assert c.wait_spool_drained(dead), c.router.peers[dead].health_info()
    _converged(c, c.points + extra, 3)
    info = c.router.peers[dead].health_info()
    assert info["replayed_batches"] >= 1 and info["replay_point_errors"] == 0


def test_hung_peer_degrades_within_deadline_and_spools(chaos):
    c = chaos
    hung = "s1"
    c.peer(hung).hang("query")
    t0 = time.monotonic()
    resp, out = c.query(fresh_q(10))
    elapsed = time.monotonic() - t0
    rows, degraded = strip_marker(out)
    assert resp.status == 200 and degraded == [hung]
    assert elapsed < 9, elapsed
    assert sorted_rows(rows) == _oracle_rows(_surviving(c, hung),
                                             fresh_q(10))
    c.peer(hung).unhang()
    c.peer(hung).hang("put")
    extra = [{"metric": "c.m", "timestamp": BASE + 900 + i, "value": 1,
              "tags": {"host": f"h{h:02d}"}}
             for i in range(5) for h in range(N_HOSTS)]
    resp = c.put(extra, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    assert c.router.peers[hung].spool.pending_records > 0
    c.peer(hung).unhang()
    assert c.wait_spool_drained(hung)
    _converged(c, c.points + extra, 11)


def test_flapping_peer_never_5xx_and_converges(chaos):
    c = chaos
    flappy = "s2"
    sent = list(c.points)
    statuses = []
    for cycle in range(2):
        c.peer(flappy).kill()
        extra = [{"metric": "c.m",
                  "timestamp": BASE + 1200 + cycle * 50 + i,
                  "value": cycle * 100 + i, "tags": {"host": f"h{h:02d}"}}
                 for i in range(10) for h in range(N_HOSTS)]
        r = c.put(extra, summary="true")
        statuses.append(r.status)
        assert json.loads(r.body)["failed"] == 0
        sent.extend(extra)
        resp, out = c.query(fresh_q(100 + cycle))
        statuses.append(resp.status)
        assert strip_marker(out)[1] in ([], [flappy])
        c.peer(flappy).restart()
        assert c.wait_spool_drained(flappy)
    assert all(s == 200 for s in statuses), statuses
    _converged(c, sent, 999)


def test_degraded_partial_is_never_cached(chaos):
    c = chaos
    body = fresh_q(7)
    _, first = c.query(body)
    stores0 = c.router.cache_stores
    _, again = c.query(body)
    assert again == first and c.router.cache_hits >= 1
    hits0 = c.router.cache_hits
    dead = "s2"
    c.peer(dead).kill()
    body2 = fresh_q(8)
    _, out = c.query(body2)
    assert strip_marker(out)[1] == [dead]
    assert c.router.cache_degraded_skips >= 1
    assert c.router.cache_stores == stores0
    _, cached = c.query(body)
    assert cached == first
    c.peer(dead).restart()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        _, out = c.query(body2)
        if not strip_marker(out)[1]:
            break
        time.sleep(0.2)
    assert strip_marker(out)[1] == []
    assert c.router.cache_stores > stores0
    _, out2 = c.query(body2)
    assert out2 == out and c.router.cache_hits > hits0


def test_spool_survives_a_router_restart(chaos):
    """Durable handoff (ref: ``TestDurableHandoff``): points spooled for
    a dead shard outlive the router that acknowledged them, and the next
    router on the same spool dir replays them."""
    c = chaos
    dead = "s1"
    c.peer(dead).kill()
    extra = [{"metric": "c.m", "timestamp": BASE + 1500 + i, "value": i,
              "tags": {"host": f"h{h:02d}"}}
             for i in range(8) for h in range(N_HOSTS)]
    resp = c.put(extra, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    assert c.router.peers[dead].spool.pending_records > 0
    c.close(peers=False)
    c.peer(dead).restart()
    c.start_router()
    assert c.wait_spool_drained(dead)
    _converged(c, c.points + extra, 21)


def test_fault_sites_trip_breaker_and_spool(tmp_path):
    """``cluster.peer.s1`` fails the exchanges with one shard: its reads
    degrade and its writes spool until the fault is disarmed, in both
    packages alike; ``cluster.wire`` fails every wire exchange."""
    out = []
    for side in SIDES:
        c = LiveCluster(tmp_path / side.name, side, durable=True, **CHAOS)
        try:
            pts = mkpoints(n_hosts=N_HOSTS, n_sec=30)
            assert c.put(pts, summary="true").status == 200
            _warm(c)
            c.tsdb.faults.arm("cluster.peer.s1", error_count=100)
            resp, doc = c.query(fresh_q(41))
            extra = [{"metric": "c.m", "timestamp": BASE + 700,
                      "value": h, "tags": {"host": f"h{h:02d}"}}
                     for h in range(N_HOSTS)]
            put = c.put(extra, summary="true")
            spooled = c.router.peers["s1"].spool.pending_records
            # the breaker's state here depends on whether the replay
            # loop has tried s1 yet (a third failure opens it): count
            # the failures the query and the put recorded instead
            failures = c.router.peers["s1"].breaker.total_failures
            c.tsdb.faults.disarm()
            c.tsdb.faults.arm("cluster.wire", error_count=1)
            resp2, doc2 = c.query(fresh_q(42))
            c.tsdb.faults.disarm()
            assert c.wait_spool_drained("s1")
            out.append((resp.status, strip_marker(doc)[1], put.status,
                        json.loads(put.body), spooled > 0, failures >= 2,
                        resp2.status))
        finally:
            c.close()
    assert out[0] == out[1]
    assert out[1][:2] == (200, ["s1"]) and out[1][4]


def test_a_failing_shard_device_degrades_where_the_reference_answers(
        tmp_path):
    """ROADMAP Queue 3 item 25. With ``device.compile`` failing on shard
    s1, the reference's shard re-answers the query on its host
    (``tsd.query.degraded.host_fallback=true``, its default), so its
    cluster answers in full. The port's shard has no fallback: it
    answers 500, and the router, as the reference's does for any
    non-400 answer, gives a 200 partial with ``shardsDegraded:
    ["s1"]``."""
    answers = {}
    for side in SIDES:
        keys = dict(ENGINE_KEYS)
        c = LiveCluster(tmp_path / side.name, side, peer_cfg=keys, **CHAOS)
        try:
            pts = mkpoints(n_hosts=N_HOSTS, n_sec=30)
            assert c.put(pts, summary="true").status == 200
            _warm(c)
            shard = c.peer("s1").tsdb
            shard.faults.arm("device.compile", error_count=1000)
            # warm the reference's host re-answer on the shard itself,
            # as its battery warms the compile caches before a chaos
            # window (the port's shard raises: it has no such path)
            try:
                shard.execute_query(side.TSQuery.from_json(
                    fresh_q(50)).validate())
            except Exception:  # noqa: BLE001 - the port's 500
                assert side is PORT
            resp, doc = c.query(fresh_q(51))
            answers[side.name] = (resp.status, strip_marker(doc), pts, c)
            c.peer("s1").tsdb.faults.disarm()
        finally:
            c.close()
    jst, (jrows, jdeg), pts, _ = answers["jax"]
    tst, (trows, tdeg), _, tc = answers["port"]
    assert jst == tst == 200
    assert jdeg == [] and sorted_rows(jrows) == _oracle_rows(pts,
                                                             fresh_q(51))
    assert tdeg == ["s1"]
    assert sorted_rows(trows) == _oracle_rows(_surviving(tc, "s1", pts),
                                              fresh_q(51))


@pytest.mark.parametrize("router_side,shard_side", [(PORT, JAX),
                                                    (JAX, PORT)],
                         ids=["port-router-jax-shards",
                              "jax-router-port-shards"])
def test_interop(tmp_path, router_side, shard_side):
    """A router of one package over the other's shards, both ways:
    writes land on the shards the reference's ring names, over the
    wire, and :data:`QUERIES` answer as the reference's cluster over
    the same points (one JAX node holding them)."""
    # no failure is injected: the JAX shards' first queries compile,
    # which a loaded run must not take for a dead shard, nor for a
    # dead wire handshake (the router would fall back to HTTP)
    c = LiveCluster(tmp_path, router_side, shard_side=shard_side,
                    **{"tsd.cluster.timeout_ms": "30000",
                       "tsd.cluster.wire.connect_timeout_ms": "30000"})
    try:
        pts = mkpoints()
        resp = c.put(pts, summary="true")
        assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
        ring = JAX.hashring.HashRing(["s0", "s1", "s2"], vnodes=64)
        for i, p in enumerate(c.peers):
            want = sum(1 for h in range(N_HOSTS)
                       if ring.shard_for("c.m", {"host": f"h{h:02d}"})
                       == f"s{i}")
            assert p.tsdb.store.num_series() == want
        one = JAX.TSDB(JAX.Config(**{**JAX.keys,
                                     "tsd.core.auto_create_metrics":
                                     "true"}))
        for dp in pts:
            one.add_point(dp["metric"], dp["timestamp"], dp["value"],
                          dp["tags"])
        jr = JAX.http.HttpRpcRouter(one)
        for qspec in QUERIES:
            body = tsq(qspec)
            resp, doc = c.query(body)
            rows, degraded = strip_marker(doc)
            assert resp.status == 200 and degraded == []
            want = json.loads(jr.handle(req(JAX, "POST", "/api/query",
                                            body)).body)
            assert sorted_rows(rows) == sorted_rows(want), qspec
        assert all(p["wire"]["connects"] >= 1 and p["wire"]["fallbacks"]
                   == 0 for p in c.router.health_info()["peers"].values())
        one.shutdown()
    finally:
        c.close()
