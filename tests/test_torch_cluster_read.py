"""The router's read side against the JAX package's, live, on the
scatter loop that carries the replica read plan (the reference's
battery, ``tests/test_cluster.py``, run on both packages and compared;
``tests/torch_cluster_pair.py``):

- a shard that 400s a multi-sub scatter for a metric it never saw is
  re-asked per metric, and the subs it owns are not blanked
  (``TestMultiSubPartialKnowledge``);
- a shard that dies during that re-ask contributes nothing
  (``TestPerSubRetryPeerDeath``);
- the per-(shard, metric) memo: one request per shard once it learned,
  a 400 from the memo, and a write that invalidates it
  (``TestPerSubRetryMemoization``);
- a 413 from a shard degrades the answer instead of blanking it
  (``TestNon400PeerAnswerDegrades``);
- a delete with a dead shard answers 503 and its retry completes the
  purge, at one replica and at rf=2, where the delete reaches every
  replica (``TestDegradedDelete``).

Integer-valued data (``mkpoints``): answers are held bit for bit to one
node of the same package and to the JAX cluster.
"""

from __future__ import annotations

import json
import threading

import pytest

from torch_cluster_pair import (BASE, BASE_MS, QUERIES, SIDES, LiveCluster,
                                mkpoints, req, sorted_rows, strip_marker,
                                tsq)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

CALM = {"tsd.cluster.timeout_ms": "30000"}
SINGLE = [{"metric": "c.single", "timestamp": BASE + i, "value": 5,
           "tags": {"host": "only"}} for i in range(60)]


def _oracle_rows(side, points, body):
    """One node of ``side`` holding ``points``, asked ``body``."""
    t = side.TSDB(side.Config(**{**side.keys,
                                 "tsd.core.auto_create_metrics": "true"}))
    try:
        for dp in points:
            t.add_point(dp["metric"], dp["timestamp"], dp["value"],
                        dp["tags"])
        return sorted_rows(json.loads(side.http.HttpRpcRouter(t).handle(
            req(side, "POST", "/api/query", body)).body))
    finally:
        t.shutdown()


def _cluster(tmp_path, side, **cfg):
    c = LiveCluster(tmp_path, side, **{**CALM, **cfg})
    c.points = mkpoints()
    resp = c.put(c.points, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    for p in c.peers:
        p.tsdb.execute_query(side.TSQuery.from_json(
            tsq(QUERIES[0])).validate())
    return c


def both(tmp_path, scenario, **cfg):
    out = []
    for side in SIDES:
        c = _cluster(tmp_path / side.name, side, **cfg)
        try:
            out.append(scenario(c))
        finally:
            c.close()
    return out


def _put_single(c):
    resp = c.put(SINGLE, summary="true")
    assert json.loads(resp.body)["failed"] == 0


def _two_subs(first, salt=0):
    return {"start": BASE_MS - 10_000, "end": BASE_MS + 200_000 + salt,
            "queries": [dict({"metric": "c.m"}, **first),
                        {"metric": "c.single", "aggregator": "sum",
                         "downsample": "10s-sum"}]}


SUM = {"aggregator": "sum", "downsample": "10s-sum"}
AVG = {"aggregator": "avg", "downsample": "30s-avg"}


class TestMultiSubPartialKnowledge:
    @pytest.mark.parametrize("first", [SUM, AVG], ids=["sum", "avg"])
    def test_single_shard_metric_does_not_blank_other_subs(self, tmp_path,
                                                           first):
        """One shard knows ``c.single``; the others 400 the two-sub
        scatter and are re-asked per metric. With an avg sub the
        re-ask keeps its sum and count twins together."""
        def run(c):
            _put_single(c)
            body = _two_subs(first)
            resp, got = c.query(body)
            assert resp.status == 200, resp.body
            rows, degraded = strip_marker(got)
            assert degraded == []
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, c.points + SINGLE, body)
            return sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_sub_unknown_on_every_shard_still_400(self, tmp_path):
        def run(c):
            body = {"start": BASE_MS - 10_000, "end": BASE_MS + 200_000,
                    "queries": [{"metric": "c.m", "aggregator": "sum"},
                                {"metric": "no.such.metric",
                                 "aggregator": "sum"}]}
            resp, out = c.query(body)
            assert resp.status == 400, resp.body
            return out

        jax, port = both(tmp_path, run)
        assert port == jax


class TestPerSubRetryPeerDeath:
    def test_died_mid_retry_contributes_nothing(self, tmp_path):
        """A shard that answered its avg's sum twin, then died during
        the re-ask, contributes neither twin: the answer is the other
        shards' series, named degraded."""
        def run(c):
            _put_single(c)
            owner = c.shard_of("c.single", {"host": "only"})
            target = next(
                n for n in sorted(c.router.peers) if n != owner
                and any(c.shard_of(dp["metric"], dp["tags"]) == n
                        for dp in c.points))
            body = _two_subs(AVG)
            router = c.router
            orig = router._query_peer
            calls = {"n": 0}
            lock = threading.Lock()

            def wrapper(peer, req_body, headers=None):
                if peer.name == target:
                    with lock:
                        calls["n"] += 1
                        n = calls["n"]
                    if n == 2:
                        raise OSError("peer died mid per-sub retry")
                return orig(peer, req_body, headers=headers)

            router._query_peer = wrapper
            try:
                resp, got = c.query(body)
            finally:
                router._query_peer = orig
            assert calls["n"] >= 2
            assert resp.status == 200, resp.body
            rows, degraded = strip_marker(got)
            assert degraded == [target]
            survivors = [dp for dp in c.points + SINGLE
                         if c.shard_of(dp["metric"], dp["tags"]) != target]
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, survivors, body)
            return target, sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax


def _counting(router):
    calls: dict[str, int] = {}
    lock = threading.Lock()
    orig = router._query_peer

    def wrapper(peer, req_body, headers=None):
        with lock:
            calls[peer.name] = calls.get(peer.name, 0) + 1
        return orig(peer, req_body, headers=headers)

    router._query_peer = wrapper
    return calls, orig


class TestPerSubRetryMemoization:
    def test_steady_state_one_request_per_shard(self, tmp_path):
        def run(c):
            _put_single(c)
            router = c.router
            calls, orig = _counting(router)
            try:
                resp, _ = c.query(_two_subs(SUM, 0))
                assert resp.status == 200, resp.body
                first = dict(calls)
                assert any(n > 1 for n in first.values()), first
                calls.clear()
                resp, got = c.query(_two_subs(SUM, 1))
                assert resp.status == 200, resp.body
                second = dict(calls)
            finally:
                router._query_peer = orig
            assert all(n == 1 for n in second.values()), second
            assert router.sub_memo_skips >= 1
            rows, degraded = strip_marker(got)
            assert degraded == []
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, c.points + SINGLE, _two_subs(SUM, 1))
            return first, second, sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_metric_unknown_everywhere_still_400_from_memo(self, tmp_path):
        def run(c):
            out = []
            for salt in (0, 1):
                body = tsq({"aggregator": "sum", "metric": "no.such.m2"},
                           end=BASE_MS + 200_000 + salt)
                resp, doc = c.query(body)
                assert resp.status == 400
                out.append(doc)
            assert "no.such.m2" in out[1]["error"]["message"]
            return out

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_write_invalidates_unknown_memo(self, tmp_path):
        def run(c):
            _put_single(c)
            router = c.router
            resp, _ = c.query(_two_subs(SUM, 2))
            assert resp.status == 200
            owner = c.shard_of("c.single", {"host": "only"})
            others = [n for n in sorted(router.peers) if n != owner]
            assert any(router._memo_lookup(n, "c.single") is not None
                       for n in others)
            extra = []
            for h in range(40):
                tags = {"host": f"inv{h:02d}"}
                if c.shard_of("c.single", tags) != owner:
                    extra = [{"metric": "c.single", "timestamp": BASE + i,
                              "value": 7, "tags": tags}
                             for i in range(30)]
                    break
            assert extra
            resp = c.put(extra, summary="true")
            assert json.loads(resp.body)["failed"] == 0
            assert router.sub_memo_invalidations >= 1
            resp, got = c.query(_two_subs(SUM, 3))
            assert resp.status == 200, resp.body
            rows, degraded = strip_marker(got)
            assert degraded == []
            assert sorted_rows(rows) == _oracle_rows(
                c.side, c.points + SINGLE + extra, _two_subs(SUM, 3))
            return sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax


class TestNon400PeerAnswerDegrades:
    def test_peer_413_degrades_instead_of_blanking(self, tmp_path):
        def run(c):
            target = "s1"
            peer = c.peer(target)
            orig = peer.server.http_router.handle
            err = c.side.http.HttpResponse(
                413, b'{"error":{"code":413,"message":"limit"}}')

            def handler(request):
                if "query" in request.path:
                    return err
                return orig(request)

            body = tsq(SUM, end=BASE_MS + 300_031)
            peer.server.http_router.handle = handler
            skips0 = c.router.cache_degraded_skips
            try:
                resp, out = c.query(body)
            finally:
                peer.server.http_router.handle = orig
            assert resp.status == 200, resp.body
            rows, degraded = strip_marker(out)
            assert degraded == [target]
            assert c.router.cache_degraded_skips == skips0 + 1
            survivors = [dp for dp in c.points
                         if c.shard_of(dp["metric"], dp["tags"]) != target]
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, survivors, body)
            return sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax


ALLOW = {"tsd.http.query.allow_delete": "true"}


class TestDegradedDelete:
    @pytest.mark.parametrize("rf", ["1", "2"])
    def test_delete_with_dead_shard_503_then_retry_completes(self,
                                                             tmp_path, rf):
        """A delete a dead shard missed answers a structured 503 with
        Retry-After; once it is back the retry completes the purge (at
        rf=2 on both replicas of every series), and a read after it
        equals one node given the same delete."""
        def run(c):
            read_q = tsq(SUM)
            resp, first = c.query(read_q)
            assert resp.status == 200 and strip_marker(first)[1] == []
            dead = "s1"
            c.peer(dead).kill()
            del_body = dict(tsq({"aggregator": "sum"}), delete=True)
            resp = c.http.handle(req(c.side, "POST", "/api/query",
                                     del_body))
            assert resp.status == 503, (resp.status, resp.body)
            assert "Retry-After" in resp.headers
            msg = json.loads(resp.body)["error"]["message"]
            assert dead in msg
            c.peer(dead).restart()
            resp = c.http.handle(req(c.side, "POST", "/api/query",
                                     del_body))
            assert resp.status == 200, (resp.status, resp.body)
            # every copy went: no shard holds a point of the window
            for p in c.peers:
                rows = p.tsdb.execute_query(c.side.TSQuery.from_json(
                    tsq({"aggregator": "none"})).validate())
                assert all(not list(r.dps) for r in rows), p.name
            resp, got = c.query(read_q)
            rows, degraded = strip_marker(got)
            assert resp.status == 200 and degraded == []
            t = c.side.TSDB(c.side.Config(**{
                **c.side.keys, "tsd.core.auto_create_metrics": "true",
                **ALLOW}))
            try:
                for dp in c.points:
                    t.add_point(dp["metric"], dp["timestamp"], dp["value"],
                                dp["tags"])
                http = c.side.http.HttpRpcRouter(t)
                assert http.handle(req(c.side, "POST", "/api/query",
                                       del_body)).status == 200
                want = json.loads(http.handle(
                    req(c.side, "POST", "/api/query", read_q)).body)
            finally:
                t.shutdown()
            assert sorted_rows(rows) == sorted_rows(want)
            assert rows != strip_marker(first)[0]
            return msg, sorted_rows(rows)

        jax, port = both(tmp_path, run, peer_cfg=ALLOW, **ALLOW, **{
            "tsd.cluster.rf": rf,
            "tsd.cluster.breaker.reset_timeout_ms": "0"})
        assert port == jax
