"""The port's replication at ``tsd.cluster.rf`` > 1 against the JAX
package's, live (the reference's battery, ``tests/test_cluster.py``,
run on both packages and compared; ``tests/torch_cluster_pair.py``):

- the ring's replica sets (``TestReplicaHashRing``);
- writes reach both owners, a read with one shard down is complete and
  carries no ``shardsDegraded``, a read with a whole replica set down
  is the survivors' partial, and after a flapping shard every replica
  converges (``TestReplicatedRF2``);
- anti-entropy: a lost spool is repaired from the surviving replica,
  and at rf=1 the debt is void (``TestReplicaDivergenceRepair``); a
  point one replica refused marks it dirty
  (``TestReplicaSplitMarksDirty``); a copy scan a shard refuses with
  413 bisects its window (``TestCopyScanBisectsOn413``);
- the shard's read filter: an inverted selector is the complement
  (``TestInvertedReplicaSel``), and the port's ``series_mask`` and the
  engine's memoized mask equal the reference's on a seeded 10k-series
  store at rf=2 and rf=3;
- a name scatter at rf=2 with one shard down is not degraded.

Integer-valued data (``mkpoints``): every answer is held bit for bit,
to one node of the same package and to the JAX cluster. The clusters
take the 30 s peer timeout of clusters with no injected failure where
a shard only dies by a closed listener (refused at once), a breaker
reset of 0 ms and no background replay: each test drains spools and
runs repairs itself, so no wait depends on a clock.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PEER_CFG, PORT, QUERIES,
                                SIDES, LiveCluster, mkpoints, req,
                                sorted_rows, strip_marker, tsq)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

N_HOSTS = 12
RF2 = {"tsd.cluster.rf": "2",
       "tsd.cluster.timeout_ms": "30000",
       "tsd.cluster.breaker.reset_timeout_ms": "0",
       "tsd.cluster.spool.replay_interval_ms": "3600000"}


def fresh_q(salt=0, qspec=None):
    return tsq(qspec or {"aggregator": "sum", "downsample": "10s-sum"},
               end=BASE_MS + 300_000 + salt)


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


def _local_rows(side, tsdb, body):
    """One shard's own answer to ``body``, serialized."""
    q = side.TSQuery.from_json(body).validate()
    return sorted_rows(json.loads(side.http.HttpRpcRouter(tsdb).handle(
        req(side, "POST", "/api/query", q.to_json())).body))


def _owned(c, name, points, rf=2):
    return [dp for dp in points
            if name in c.router.ring.shards_for(dp["metric"], dp["tags"],
                                                rf)]


def _rf2(tmp_path, side, durable=True, n_sec=60, **extra):
    """A 3-shard rf=2 cluster holding ``mkpoints`` (each shard's engine
    and the router's read path warmed first, as the reference's
    ``ReplicaChaosBase``)."""
    c = LiveCluster(tmp_path, side, durable=durable, **{**RF2, **extra})
    c.points = mkpoints(n_hosts=N_HOSTS, n_sec=n_sec)
    resp = c.put(c.points, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    for p in c.peers:
        p.tsdb.execute_query(side.TSQuery.from_json(
            tsq(QUERIES[0])).validate())
    resp, out = c.query(fresh_q())
    assert resp.status == 200 and strip_marker(out)[1] == []
    return c


def both(tmp_path, scenario, **kw):
    out = []
    for side in SIDES:
        c = _rf2(tmp_path / side.name, side, **kw)
        try:
            out.append(scenario(c))
        finally:
            c.close()
    return out


def _drain(c, name):
    """Replay ``name``'s spool now, then run its repair pass."""
    peer = c.router.peers[name]
    c.router.drain_spool(peer)
    assert peer.spool.pending_records == 0
    c.router.maybe_repair(peer)


# -- the ring --------------------------------------------------------------

class TestReplicaHashRing:
    def test_ordered_distinct_replica_sets(self):
        sets = []
        for side in SIDES:
            r = side.hashring.HashRing(["a", "b", "c", "d"])
            got = []
            for i in range(60):
                tags = {"host": f"h{i}"}
                t = r.shards_for("m", tags, 2)
                assert len(t) == 2 and len(set(t)) == 2
                assert t[0] == r.shard_for("m", tags)
                t3 = r.shards_for("m", tags, 3)
                assert t3[:2] == t
                got.append((t, t3))
            sets.append(got)
        assert sets[0] == sets[1]

    def test_rf_clamped_to_shard_count(self):
        for side in SIDES:
            r = side.hashring.HashRing(["a", "b"])
            assert len(r.shards_for("m", {}, 5)) == 2
            one = side.hashring.HashRing(["only"])
            assert one.shards_for("m", {}, 3) == ("only",)

    def test_replica_sets_cover_every_series(self):
        got = []
        for side in SIDES:
            r = side.hashring.HashRing(["a", "b", "c"])
            sets = r.replica_sets(2)
            for i in range(200):
                assert r.shards_for("m", {"host": f"h{i}"}, 2) in sets
            got.append(sets)
        assert got[0] == got[1]

    def test_remap_fraction_stays_small_at_rf2(self):
        got = []
        for side in SIDES:
            key = side.hashring.series_shard_key
            keys = [key("sys.cpu", {"host": f"h{i}"}) for i in range(400)]
            r3 = side.hashring.HashRing(["a", "b", "c"])
            r4 = side.hashring.HashRing(["a", "b", "c", "d"])
            moved = sum(set(r3.shards_for_key(k, 2))
                        != set(r4.shards_for_key(k, 2)) for k in keys)
            assert 0 < moved < len(keys) * 0.75, moved
            got.append(moved)
        assert got[0] == got[1]

    def test_set_indices_place_as_the_reference(self):
        """The port's batched placement (``HashRing.set_indices``, the
        mask's) names for every key the replica set the reference's
        ``shards_for_key`` walks to."""
        keys = [PORT.hashring.series_shard_key("m", {"host": f"h{i}",
                                                     "dc": f"d{i % 7}"})
                for i in range(3000)]
        for rf in (1, 2, 3):
            tr = PORT.hashring.HashRing(["s0", "s1", "s2", "s3"], 16)
            jr = JAX.hashring.HashRing(["s0", "s1", "s2", "s3"], 16)
            sets = tr.replica_sets(rf)
            got = [sets[i] for i in tr.set_indices(keys, rf)]
            assert got == [jr.shards_for_key(k, rf) for k in keys]


# -- rf=2: writes, reads, convergence -------------------------------------

class TestReplicatedRF2:
    def test_writes_fan_out_to_both_replicas(self, tmp_path):
        def run(c):
            out = {}
            for name in sorted(c.router.peers):
                mine = {dp["tags"]["host"]
                        for dp in _owned(c, name, c.points)}
                rows = c.peer(name).tsdb.execute_query(
                    c.side.TSQuery.from_json(
                        tsq({"aggregator": "none"})).validate())
                assert {r.tags["host"] for r in rows} == mine
                out[name] = sorted(mine)
            return out

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_single_death_reads_complete_and_markerless(self, tmp_path):
        def run(c):
            c.peer("s1").kill()
            fallbacks0 = c.router.read_fallbacks
            answers = []
            for i, qspec in enumerate(QUERIES):
                body = tsq(qspec, end=BASE_MS + 300_000 + i)
                resp, out = c.query(body)
                assert resp.status == 200, (qspec, resp.body)
                rows, degraded = strip_marker(out)
                assert degraded == [], qspec
                assert "X-OpenTSDB-Shards-Degraded" not in resp.headers
                assert sorted_rows(rows) == \
                    _oracle_rows(c.side, c.points, body), qspec
                answers.append(sorted_rows(rows))
            assert c.router.read_fallbacks > fallbacks0
            assert c.router.degraded_queries == 0
            return answers, c.router.read_fallbacks - fallbacks0

        jax, port = both(tmp_path, run)
        assert port == jax

    @pytest.mark.parametrize("dead", ["s0", "s1", "s2"])
    def test_any_one_death_reads_equal_the_reference(self, tmp_path, dead):
        """With any one of the three shards down, both aggregations of
        the router's read plan answer complete and marker-less, as the
        JAX cluster does."""
        def run(c):
            c.peer(dead).kill()
            out = []
            for salt, qspec in enumerate((
                    {"aggregator": "sum", "downsample": "10s-sum"},
                    {"aggregator": "max", "downsample": "10s-max",
                     "filters": [{"type": "wildcard", "tagk": "host",
                                  "filter": "*", "groupBy": True}]})):
                resp, doc = c.query(fresh_q(salt + 10, qspec))
                rows, degraded = strip_marker(doc)
                assert resp.status == 200 and degraded == []
                out.append(sorted_rows(rows))
            return out

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_both_replicas_down_degrades_with_marker(self, tmp_path):
        def run(c):
            c.peer("s0").kill()
            c.peer("s1").kill()
            resp, out = c.query(fresh_q(77))
            assert resp.status == 200
            rows, degraded = strip_marker(out)
            assert degraded == ["s0", "s1"]
            survivors = _owned(c, "s2", c.points)
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, survivors, fresh_q(77))
            return sorted_rows(rows), degraded

        jax, port = both(tmp_path, run)
        assert port == jax

    def test_flap_chaos_rf2_acked_never_lost_reads_complete(self,
                                                            tmp_path):
        def run(c):
            sent = list(c.points)
            for cycle in range(3):
                victim = f"s{cycle % 3}"
                c.peer(victim).kill()
                extra = [{"metric": "c.m",
                          "timestamp": BASE + 2000 + cycle * 40 + i,
                          "value": cycle * 10 + i,
                          "tags": {"host": f"h{h:02d}"}}
                         for i in range(10) for h in range(N_HOSTS)]
                r = c.put(extra, summary="true")
                assert r.status == 200
                assert json.loads(r.body)["failed"] == 0
                sent.extend(extra)
                resp, out = c.query(fresh_q(500 + cycle))
                assert resp.status == 200
                assert strip_marker(out)[1] == []
                c.peer(victim).restart()
                _drain(c, victim)
            body = fresh_q(999)
            resp, out = c.query(body)
            rows, degraded = strip_marker(out)
            assert resp.status == 200 and degraded == []
            assert sorted_rows(rows) == _oracle_rows(c.side, sent, body)
            # both replicas of every series converged: each shard's own
            # answer is one node holding just its series
            for name in sorted(c.router.peers):
                assert _local_rows(c.side, c.peer(name).tsdb, body) == \
                    _oracle_rows(c.side, _owned(c, name, sent), body)
            return sorted_rows(rows)

        jax, port = both(tmp_path, run)
        assert port == jax


# -- anti-entropy -----------------------------------------------------------

class TestReplicaDivergenceRepair:
    def test_lost_spool_repairs_from_surviving_replica(self, tmp_path):
        """Kill one replica mid-ingest and LOSE its in-memory spool: the
        repair pass re-copies the dirty window from the surviving
        replica, and both replicas converge."""
        def run(c):
            dead = "s1"
            c.peer(dead).kill()
            extra = [{"metric": "c.m", "timestamp": BASE + 400 + i,
                      "value": 7 + i, "tags": {"host": f"h{h:02d}"}}
                     for i in range(10) for h in range(N_HOSTS)]
            r = c.put(extra, summary="true")
            assert json.loads(r.body)["failed"] == 0
            peer = c.router.peers[dead]
            assert peer.spool.pending_records > 0
            assert c.router.dirty.peek(dead)
            peer.spool._queue.clear()
            peer.spool._mem_bytes = 0
            c.peer(dead).restart()
            assert c.router.maybe_repair(peer) is True
            assert not c.router.dirty.peek(dead)
            assert c.router.repairs >= 1 and c.router.repair_points > 0
            everything = c.points + extra
            body = fresh_q(5)
            assert _local_rows(c.side, c.peer(dead).tsdb, body) == \
                _oracle_rows(c.side, _owned(c, dead, everything), body)
            resp, out = c.query(fresh_q(6))
            rows, degraded = strip_marker(out)
            assert degraded == []
            assert sorted_rows(rows) == \
                _oracle_rows(c.side, everything, fresh_q(6))
            return (c.router.repairs, c.router.repair_points,
                    sorted_rows(rows))

        jax, port = both(tmp_path, run, durable=False, n_sec=30)
        assert port == jax

    def test_rf1_dirty_debt_is_void(self, tmp_path):
        got = []
        for side in SIDES:
            c = LiveCluster(tmp_path / side.name, side, **{
                "tsd.cluster.timeout_ms": "30000"})
            try:
                c.router.dirty.mark("s0", {"c.m"}, BASE_MS)
                got.append(c.router.repair_peer(c.router.peers["s0"]))
                assert not c.router.dirty.peek("s0")
            finally:
                c.close()
        assert got == [True, True]


class TestReplicaSplitMarksDirty:
    def test_partial_refusal_marks_dirty(self, tmp_path):
        """One replica refusing a point its sibling stored is a replica
        split: the point is not acked, the window is marked dirty, and
        repair re-levels it from the sibling."""
        got = []
        for side in SIDES:
            c = LiveCluster(tmp_path / side.name, side, durable=True,
                            **RF2)
            try:
                router = c.router
                victim = sorted(router.peers)[0]
                orig = router._deliver

                def wrapper(peer, dps, headers=None, orig=orig,
                            victim=victim):
                    ok, bad, errs = orig(peer, dps, headers=headers)
                    if peer.name == victim and ok:
                        dp = dps[-1]
                        return ok - 1, bad + 1, errs + [
                            {"datapoint": dict(dp),
                             "error": "injected per-point refusal"}]
                    return ok, bad, errs

                router._deliver = wrapper
                try:
                    pts = [{"metric": "split.m", "timestamp": BASE + i,
                            "value": i, "tags": {"host": f"h{h}"}}
                           for i in range(5) for h in range(6)]
                    ok, bad, _errs = router.forward_writes(pts)
                finally:
                    router._deliver = orig
                assert bad >= 1
                assert "split.m" in router.dirty.peek(victim)
                assert router.repair_peer(router.peers[victim])
                assert not router.dirty.peek(victim)
                got.append((ok, bad, router.repair_points))
            finally:
                c.close()
        assert got[0] == got[1]


class TestCopyScanBisectsOn413:
    def test_413_pages_and_merges(self, tmp_path):
        """A copy scan a shard refuses with 413 bisects its window until
        each page fits, and the pages hold every point once."""
        got = []
        for side in SIDES:
            c = LiveCluster(tmp_path / side.name, side, durable=True,
                            **{"tsd.cluster.timeout_ms": "30000"})
            try:
                pts = [{"metric": "wide.m", "timestamp": BASE + i,
                        "value": i, "tags": {"host": "a"}}
                       for i in range(100)]
                assert c.put(pts, summary="true").status == 200
                router = c.router
                owner = c.shard_of("wide.m", {"host": "a"})
                orig = router._query_peer
                windows = []

                def wrapper(p, body, headers=None, orig=orig,
                            owner=owner, windows=windows):
                    obj = json.loads(body)
                    lo = max(int(str(obj["start"]).rstrip("ms")), BASE_MS)
                    hi = min(int(str(obj["end"]).rstrip("ms")),
                             BASE_MS + 99_000)
                    in_window = max(hi - lo, -1000) // 1000 + 1
                    if p.name == owner and \
                            obj["queries"][0]["metric"] == "wide.m":
                        windows.append((obj["start"], obj["end"]))
                        if in_window > 30:
                            return 413, (b'{"error":{"code":413,'
                                         b'"message":"limit"}}')
                    return orig(p, body, headers=headers)

                router._query_peer = wrapper
                try:
                    rows = [row for page in router.scan_series_pages(
                                router.peers[owner], "wide.m", 1,
                                BASE_MS + 200_000)
                            for row in page]
                finally:
                    router._query_peer = orig
                assert len(windows) > 1, "bisection never triggered"
                ts = sorted(t for r in rows for t, _v in r["dps"])
                assert ts == [BASE_MS + i * 1000 for i in range(100)]
                got.append((windows, ts))
            finally:
                c.close()
        assert got[0] == got[1]


# -- the shard's read filter ------------------------------------------------

class TestInvertedReplicaSel:
    def test_invert_is_the_exact_complement(self):
        names = ["s0", "s1", "s2"]
        kid = {1: "host"}
        vid = {i: f"h{i:02d}" for i in range(40)}
        series = [[(1, i)] for i in range(40)]
        got = []
        for side in SIDES:
            ring = side.hashring.HashRing(names, vnodes=16)
            owned = [t for t in ring.replica_sets(2) if "s1" in t]
            rm = side.replica
            pos = rm.series_mask(rm.parse_sel(rm.sel_doc(names, 16, 2,
                                                         owned)),
                                 "c.m", series, kid.__getitem__,
                                 vid.__getitem__)
            neg = rm.series_mask(
                rm.parse_sel(rm.sel_doc(names, 16, 2, owned, invert=True)),
                "c.m", series, kid.__getitem__, vid.__getitem__)
            assert [not p for p in pos] == neg
            assert any(pos) and any(neg)
            got.append((pos, neg))
        assert got[0] == got[1]

    def test_invert_rides_the_wire_and_cache_key(self):
        got = []
        for side in SIDES:
            rm = side.replica
            sel = rm.sel_doc(["a"], 8, 1, [("a",)], invert=True)
            assert sel["invert"] is True
            q = side.TSQuery.from_json({
                "start": 1, "end": 2, "replicaSel": sel,
                "queries": [{"metric": "c.m", "aggregator": "sum"}]})
            assert q.replica_sel["invert"] is True
            assert q.to_json()["replicaSel"]["invert"] is True
            plain = rm.sel_doc(["a"], 8, 1, [("a",)])
            assert rm.sel_cache_key(q.replica_sel) != \
                rm.sel_cache_key(dict(plain, sets=[("a",)]))
            got.append((q.to_json()["replicaSel"],
                        rm.sel_cache_key(q.replica_sel)))
        assert got[0] == got[1]


def _seeded_series(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tags = {"host": f"web{i:05d}", "dc": f"dc{rng.integers(0, 40)}"}
        if rng.random() < 0.5:
            tags["rack"] = f"r{rng.integers(0, 300)}"
        out.append(tags)
    return out


@pytest.mark.parametrize("rf", [2, 3])
def test_series_mask_equals_the_reference(rf):
    """On a seeded 10k-series store (three to four tags a series, one
    optional), at rf=2 and rf=3 over four shards: the port's
    ``series_mask`` (one batched placement) and the engine's memoized
    ``store_series_mask`` (cold, then from its memo) keep exactly the
    series the reference's ``series_mask`` keeps, for a one-reader
    assignment, a partial one and an inverted one; and a shard query
    carrying each selector reads the same series in both packages."""
    names = ["s0", "s1", "s2", "s3"]
    series = _seeded_series(10_000, seed=7 + rf)
    t = PORT.TSDB(PORT.Config(**{**PORT.keys, **PEER_CFG}))
    j = JAX.TSDB(JAX.Config(**{**JAX.keys, **PEER_CFG}))
    try:
        for side, db in ((PORT, t), (JAX, j)):
            for i, tags in enumerate(series):
                db.add_point("m.mask", BASE, i, tags)
        ring = PORT.hashring.HashRing(names, 64)
        sets = ring.replica_sets(rf)
        selectors = [
            ([s for s in sets if s[0] == "s1"], False),
            (sets[::3], False),
            ([s for s in sets if "s2" in s], True)]
        # the port's store, as the engine reads it
        eng = t.new_query()
        sub = PORT.TSQuery.from_json(tsq({"aggregator": "none"},
                                         metric="m.mask")).validate() \
            .queries[0]
        mid = t.uids.metrics.get_id("m.mask")
        sids, tag_mat = eng._apply_filters(
            mid, sub, t.store.series_ids_for_metric(mid), t.store)
        kname = t.uids.tag_names.get_name
        vname = t.uids.tag_values.get_name
        pairs = [tag_mat.tags_of(i) for i in range(len(sids))]
        for assigned, invert in selectors:
            doc = PORT.replica.sel_doc(names, 64, rf, assigned,
                                       invert=invert)
            want = JAX.replica.series_mask(
                JAX.replica.parse_sel(doc), "m.mask", pairs, kname, vname)
            sel = PORT.replica.parse_sel(doc)
            assert PORT.replica.series_mask(
                sel, "m.mask", pairs, kname, vname) == want
            for _ in range(2):   # cold, then from the memo
                got = PORT.replica.store_series_mask(
                    sel, t.store, "m.mask", sids,
                    tag_mat.kids, tag_mat.vids, t.uids.tag_names.get_names,
                    t.uids.tag_values.get_names)
                assert got.tolist() == want
            assert 0 < sum(want) < len(want)
            body = tsq({"aggregator": "none"}, metric="m.mask",
                       replicaSel=doc)
            read = []
            for side, db in ((PORT, t), (JAX, j)):
                rows = db.execute_query(
                    side.TSQuery.from_json(body).validate())
                read.append(sorted(r.tags["host"] for r in rows))
            assert read[0] == read[1]
            assert len(read[0]) == sum(want)
    finally:
        t.shutdown()
        j.shutdown()


def test_dead_shard_no_header_at_rf2(tmp_path):
    """A suggest scatter at rf=2 with one shard down: every replica set
    still has a live member, so the union is whole and no shard is
    named degraded, as in the reference."""
    got = []
    for side in SIDES:
        c = LiveCluster(tmp_path / side.name, side, durable=True, **RF2)
        try:
            points = mkpoints(n_hosts=10, n_sec=5)
            assert c.put(points, summary="true").status == 200
            c.peer("s2").kill()
            r = c.http.handle(req(side, "GET", "/api/suggest",
                                  type="metrics", max=100))
            assert r.status == 200
            assert "X-OpenTSDB-Shards-Degraded" not in r.headers
            lk = c.http.handle(req(side, "POST", "/api/search/lookup",
                                   {"metric": "c.m", "limit": 100}))
            assert lk.status == 200
            assert "X-OpenTSDB-Shards-Degraded" not in lk.headers
            doc = json.loads(lk.body)
            got.append((sorted(json.loads(r.body)),
                        sorted(json.dumps(x["tags"], sort_keys=True)
                               for x in doc["results"])))
        finally:
            c.close()
    assert got[0] == got[1]
    assert got[0][0] == ["c.m"] and len(got[0][1]) == 10
