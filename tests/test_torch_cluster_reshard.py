"""The port's online resharding and stale-copy retirement against the
JAX package's, live (the reference's battery, ``tests/test_cluster.py``
``ReshardBase`` and its four classes, run on both packages and
compared; ``tests/torch_cluster_pair.py``):

- ``TestOnlineReshard``: a 3-shard cluster grows to 4. The epoch leads
  the result cache's key, a second install is refused while the window
  is open, writes in the window are acknowledged and read back from the
  old ring, and after the backfill finalizes every query of
  :data:`QUERIES` answers as one node holding the same points; the
  joined shard owns series. The refusals of an empty spec, a renamed
  address and a shard's admin surface.
- ``TestKillDuringReshard``: the router dies with the window open (one
  unit copied, one shard dead, in-window writes spooled) and a new
  router over the same spool dir comes back at the same epoch, with
  both rings and the done-markers, drains the spool and finishes.
- ``TestShrinkRingWithDeadShard``: at rf=2 a dead shard leaves a ring
  of 4; it is declared dead and the window finalizes.
- ``TestStaleCopyRetire``: the retire pass deletes every former owner's
  stale copies (the same series counts per shard on both packages) and
  nothing owned, ``mark_retired``'s epoch CAS, the wait on a spool
  backlog, the park without ``allow_delete``, and a dead shard that
  keeps the debt.
- ``reshard.json`` across packages: every transition of
  ``ReshardState`` gives the same document in both, a mid-cutover file
  either writes loads in the other, a router of one package resumes the
  other's cutover, and a port router reshards JAX shards.
- ``Backfiller._copy_rows`` on seeded rows at rf 1 and 2 with a dead
  set: the same responsible shard, targets and batches in order.
- The ``cluster.reshard`` and ``cluster.retire`` fault sites, the
  ``cluster.reshard.*`` and ``cluster.retire.*`` counters of
  ``/api/stats`` and ``/api/health``'s ``reshard`` block.

Integer-valued data (``mkpoints``): every answer is held bit for bit to
one node of the same package and to the other package's cluster. As in
the reference, the backfill and retire loops sleep for an hour and the
tests step them by hand; spools replay by hand too, the breaker resets
at once, and the clusters take the 30 s peer and wire-handshake
timeouts of clusters with no injected failure (a shard dies only by a
closed listener, refused at once), so no wait depends on a clock.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from torch_cluster_pair import (BASE, BASE_MS, JAX, PORT, QUERIES, SIDES,
                                LiveCluster, LivePeer, mkpoints, req,
                                sorted_rows, strip_marker, tsq,
                                volatile_free)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

N_HOSTS = 8
ALLOW = {"tsd.http.query.allow_delete": "true"}
RESHARD = {"tsd.cluster.timeout_ms": "30000",
           "tsd.cluster.wire.connect_timeout_ms": "30000",
           "tsd.cluster.breaker.reset_timeout_ms": "0",
           "tsd.cluster.spool.replay_interval_ms": "3600000",
           "tsd.cluster.reshard.interval_ms": "3600000",
           "tsd.cluster.retire.interval_ms": "3600000"}
SUM = {"aggregator": "sum", "downsample": "10s-sum"}


def make_cluster(tmp_path, side, shard_side=None, n=3, peer_cfg=None,
                 peers=None, **cfg):
    """A durable cluster whose shards allow deletes (the retire pass
    deletes through the shards' delete gate, ref: ``ReshardBase``)."""
    return LiveCluster(tmp_path, side, shard_side=shard_side, n=n,
                       durable=True,
                       peer_cfg=ALLOW if peer_cfg is None else peer_cfg,
                       peers=peers, **{**RESHARD, **cfg})


def ingest(c, n_sec=40, metric="c.m"):
    points = mkpoints(n_hosts=N_HOSTS, n_sec=n_sec, metric=metric)
    resp = c.put(points, summary="true")
    assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
    return points


def in_window(offset, n=10, value=0):
    return [{"metric": "c.m", "timestamp": BASE + offset + i,
             "value": value + i, "tags": {"host": f"h{h:02d}"}}
            for i in range(n) for h in range(N_HOSTS)]


def begin(c, extra):
    """``POST /api/cluster/reshard`` adding ``extra`` as s3."""
    resp = c.http.handle(req(c.side, "POST", "/api/cluster/reshard",
                             {"peers": c.spec
                              + f",s3=127.0.0.1:{extra.port}"}))
    assert resp.status == 200, resp.body
    return json.loads(resp.body)


def run_backfill(c, max_steps=200):
    phases = []
    for _ in range(max_steps):
        info = c.router.backfill_step()
        phases.append(info.get("phase"))
        if info.get("phase") in ("done", "idle"):
            return phases
        assert info.get("phase") != "blocked", info
    raise AssertionError("backfill never completed")


def run_retire(c, max_steps=400):
    phases = []
    for _ in range(max_steps):
        info = c.router.retire_step()
        phases.append(info.get("phase"))
        if info.get("phase") in ("done", "idle"):
            return phases
        assert info.get("phase") != "blocked", info
    raise AssertionError("retire never completed")


def oracle_rows(side, points, body):
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


def ask(c, body):
    """The cluster's complete answer to ``body``, sorted."""
    resp, doc = c.query(body)
    assert resp.status == 200, resp.body
    rows, degraded = strip_marker(doc)
    assert degraded == []
    return sorted_rows(rows)


def warm(c, peers):
    """Run every query shape on every shard once (a first compile
    under a loaded run must not look like a slow shard)."""
    for p in peers:
        for qspec in QUERIES:
            p.tsdb.execute_query(c.side.TSQuery.from_json(
                tsq(qspec)).validate())


def held_series(side, lp, end=BASE_MS + 900_000):
    """Each series ``lp`` holds, as (metric, sorted tags)."""
    rows = lp.tsdb.execute_query(side.TSQuery.from_json(
        tsq({"aggregator": "none"}, end=end)).validate())
    return [("c.m", tuple(sorted(r.tags.items()))) for r in rows]


def stale_counts(c, peers):
    """Per shard: (series held, series held whose current replica set
    does not name the shard, which replicaSel hides and retire
    deletes)."""
    ring = c.router.ring
    rf = min(c.router.rf, len(ring.names))
    out = {}
    for lp in peers:
        if lp.name not in c.router.peers:
            continue
        held = held_series(c.side, lp)
        out[lp.name] = (len(held), sum(
            1 for m, tags in held
            if lp.name not in ring.shards_for(m, dict(tags), rf)))
    return out


def norm(doc):
    """``doc`` without its clock-dependent fields, and with each peer
    spec cut to its shard names: the shards listen on ports the system
    picks, which differ between the two clusters."""
    if isinstance(doc, dict):
        return {k: ([s.split("=")[0] for s in v.split(",")]
                    if k in ("peers", "old_peers", "new_peers")
                    and isinstance(v, str) else norm(v))
                for k, v in doc.items() if k not in ("fence_ms", "eta_s")}
    if isinstance(doc, list):
        return [norm(v) for v in doc]
    return doc


def state_file(c):
    """The router's ``reshard.json``, normalized (:func:`norm`)."""
    return norm(json.loads((Path(c.router._spool_dir) / "reshard.json")
                           .read_text()))


def describe(c):
    return norm(c.router.state.describe())


def twin(tmp_path, scenario, **kw):
    """``scenario(side, tmp)`` on the JAX package, then on the port."""
    out = []
    for side in SIDES:
        out.append(scenario(side, tmp_path / side.name, **kw))
    return out


# -- online reshard ----------------------------------------------------------

class TestOnlineReshard:
    def test_grow_ring_dual_write_window_then_finalize(self, tmp_path):
        def run(side, tmp):
            c = make_cluster(tmp, side)
            extra = LivePeer(side, "s3", **ALLOW)
            try:
                points = ingest(c)
                # a cached complete answer of epoch 0 must never serve
                # after the install (the epoch leads the cache key)
                cached = tsq(SUM, end=BASE_MS + 800_000)
                first = ask(c, cached)
                hits0 = c.router.cache_hits
                assert ask(c, cached) == first
                hit = c.router.cache_hits - hits0
                info = begin(c, extra)
                assert c.router.resharding
                status = c.get("/api/cluster/reshard")[1]
                again = c.http.handle(req(side, "POST",
                                          "/api/cluster/reshard",
                                          {"peers": c.spec}))
                hits1 = c.router.cache_hits
                post = ask(c, cached)
                missed = c.router.cache_hits == hits1
                # the window: acknowledged, and read back from the old
                # ring with the history
                during = in_window(500)
                r = c.put(during, summary="true")
                assert json.loads(r.body)["failed"] == 0
                body = tsq(SUM, end=BASE_MS + 900_000)
                window = ask(c, body)
                assert window == oracle_rows(side, points + during, body)
                phases = run_backfill(c)
                after = {"epoch": c.router.epoch,
                         "resharding": c.router.resharding,
                         "ring": list(c.router.ring.names)}
                warm(c, c.peers + [extra])
                answers = []
                for i, qspec in enumerate(QUERIES):
                    body = tsq(qspec, end=BASE_MS + 900_100 + i)
                    rows = ask(c, body)
                    assert rows == oracle_rows(side, points + during,
                                               body), qspec
                    answers.append(rows)
                joined = extra.tsdb.store.num_series()
                assert joined > 0
                r = c.put([{"metric": "c.m", "timestamp": BASE + 900,
                            "value": 1, "tags": {"host": "h00"}}],
                          summary="true")
                return (norm(info), hit,
                        norm(status),
                        again.status, again.body, post == first, missed,
                        window, phases, after, answers, joined,
                        json.loads(r.body))
            finally:
                c.close()
                extra.stop()

        jax, port = twin(tmp_path, run)
        assert port == jax
        (info, hit, status, again, _body, _same, missed, *_rest) = port
        assert info["epoch"] == 1 and info["active"] and hit == 1
        assert status["active"] and status["epoch"] == 1
        assert again == 400 and missed
        assert port[9] == {"epoch": 1, "resharding": False,
                           "ring": ["s0", "s1", "s2", "s3"]}
        assert port[12]["failed"] == 0

    def test_reshard_requires_router_and_spec(self, tmp_path):
        def run(side, tmp):
            c = make_cluster(tmp, side)
            try:
                got = []
                renamed = c.spec.replace(f":{c.peers[0].port}", ":1", 1)
                for body in ({}, {"peers": "nonsense"},
                             {"peers": renamed}):
                    resp = c.http.handle(req(side, "POST",
                                             "/api/cluster/reshard", body))
                    got.append((resp.status, json.loads(resp.body)))
                # shards expose no cluster admin surface
                h = c.peers[0].server.http_router.handle(
                    req(side, "GET", "/api/cluster"))
                got.append((h.status, json.loads(h.body)))
                got.append(c.router.resharding)
                return got
            finally:
                c.close()

        jax, port = twin(tmp_path, run)
        # the renamed-address message names the shards' live ports
        for doc in (jax, port):
            doc[2][1]["error"].pop("message")
        assert port == jax
        assert [s for s, _ in port[:4]] == [400] * 4
        assert port[4] is False


# -- a router killed during the cutover --------------------------------------

class TestKillDuringReshard:
    def test_router_death_mid_backfill_recovers_and_converges(
            self, tmp_path):
        """One unit copied, s0 dead with in-window writes spooled for
        it, the router dropped and rebuilt from the same spool dir: the
        same epoch, both rings and the done-markers come back, the
        spool drains, the backfill finishes, and the answer is one
        node's over every acknowledged point."""
        def run(side, tmp):
            c = make_cluster(tmp, side)
            extra = LivePeer(side, "s3", **ALLOW)
            try:
                points = ingest(c)
                begin(c, extra)
                first = c.router.backfill_step()
                c.peer("s0").kill()
                during = in_window(600, n=8, value=3)
                r = c.put(during, summary="true")
                assert json.loads(r.body)["failed"] == 0
                spooled = c.router.peers["s0"].spool.pending_records
                assert spooled >= 1
                before = (c.router.epoch, describe(c), state_file(c))
                c.close(peers=False)
                c.start_router()
                back = (c.router.epoch, describe(c), state_file(c))
                assert back == before
                rings = (list(c.router.ring.names),
                         list(c.router.old_ring.names),
                         c.router.resharding)
                c.peer("s0").restart()
                c.router.drain_spool(c.router.peers["s0"])
                assert c.router.peers["s0"].spool.pending_records == 0
                phases = run_backfill(c)
                warm(c, c.peers + [extra])
                body = tsq(SUM, end=BASE_MS + 900_000)
                rows = ask(c, body)
                assert rows == oracle_rows(side, points + during, body)
                return (first, back, rings, phases, rows,
                        c.router.resharding, c.router.epoch)
            finally:
                c.close()
                extra.stop()

        jax, port = twin(tmp_path, run)
        assert port == jax
        first, back, rings, _phases, _rows, resharding, epoch = port
        assert first["phase"] == "copied" and first["peer"] == "s0"
        assert back[0] == 1 and back[2]["reshard"]["done"] == \
            {"s0": ["c.m"]}
        assert rings == (["s0", "s1", "s2", "s3"], ["s0", "s1", "s2"],
                         True)
        assert resharding is False and epoch == 1


# -- a shrink that drops a dead shard ---------------------------------------

class TestShrinkRingWithDeadShard:
    def test_rf2_shrink_drops_dead_shard_and_finalizes(self, tmp_path):
        """At rf=2 every series of a dead shard has a live replica, so
        shrinking the ring to drop it declares it dead (its
        done-markers reset) and still finalizes."""
        def run(side, tmp):
            c = make_cluster(tmp, side, n=4, **{"tsd.cluster.rf": "2"})
            try:
                points = ingest(c, n_sec=30)
                c.peer("s3").kill()
                for _ in range(3):
                    c.router.peers["s3"].breaker.record_failure()
                spec = ",".join(f"s{i}=127.0.0.1:{c.peers[i].port}"
                                for i in range(3))
                resp = c.http.handle(req(side, "POST",
                                         "/api/cluster/reshard",
                                         {"peers": spec}))
                assert resp.status == 200, resp.body
                phases = run_backfill(c)
                dead = sorted(c.router.backfiller.dead)
                warm(c, c.peers[:3])
                body = tsq(SUM, end=BASE_MS + 700_000)
                rows = ask(c, body)
                assert rows == oracle_rows(side, points, body)
                return (phases, dead, c.router.resharding,
                        sorted(c.router.peers), rows,
                        c.router.backfiller.health_info())
            finally:
                c.close()

        jax, port = twin(tmp_path, run)
        assert port == jax
        assert port[1] == ["s3"] and port[2] is False
        assert port[3] == ["s0", "s1", "s2"]


# -- the stale-copy retire pass ----------------------------------------------

class TestStaleCopyRetire:
    def test_retire_reclaims_former_owner_bytes(self, tmp_path):
        def run(side, tmp):
            c = make_cluster(tmp, side)
            extra = LivePeer(side, "s3", **ALLOW)
            try:
                points = ingest(c)
                begin(c, extra)
                run_backfill(c)
                c.peers.append(extra)
                before = stale_counts(c, c.peers)
                assert sum(s for _, s in before.values()) > 0
                assert c.router.retirer.pending()
                phases = run_retire(c)
                after = stale_counts(c, c.peers)
                persisted = side.reshard.ReshardState(
                    str(tmp / "spool")).retired_epoch
                idle = c.router.retire_step()["phase"]
                warm(c, c.peers)
                answers = []
                for i, qspec in enumerate(QUERIES[:3]):
                    body = tsq(qspec, end=BASE_MS + 900_200 + i)
                    rows = ask(c, body)
                    assert rows == oracle_rows(side, points, body), qspec
                    answers.append(rows)
                status = c.get("/api/cluster/reshard")[1]
                return (before, phases, after,
                        c.router.retirer.health_info(), persisted, idle,
                        answers, status)
            finally:
                c.close()
                extra.stop()

        jax, port = twin(tmp_path, run)
        assert port == jax
        before, phases, after, health, persisted, idle, _a, status = port
        assert phases[-1] == "done"
        # each former owner lost exactly its stale series
        assert after == {n: (held - stale, 0)
                         for n, (held, stale) in before.items()}
        assert health["retired_series"] == \
            sum(s for _, s in before.values())
        assert persisted == 1 and idle == "idle"
        assert status["retired_epoch"] == 1
        assert status["retire"]["pending"] is False

    def test_retire_never_touches_owned_series(self, tmp_path):
        """At epoch 0 nothing moved: a pass forced as if an epoch were
        pending deletes nothing."""
        def run(side, tmp):
            c = make_cluster(tmp, side)
            try:
                ingest(c, n_sec=20)
                held = stale_counts(c, c.peers)
                pending0 = c.router.retirer.pending()
                idle = c.router.retire_step()["phase"]
                c.router.state.epoch = 1
                phases = run_retire(c)
                return (held, pending0, idle, phases,
                        stale_counts(c, c.peers),
                        c.router.retirer.retired_series)
            finally:
                c.close()

        jax, port = twin(tmp_path, run)
        assert port == jax
        held, pending0, idle, phases, after, retired = port
        assert pending0 is False and idle == "idle"
        assert phases[-1] == "done" and after == held and retired == 0

    def test_mark_retired_is_epoch_cas(self, tmp_path):
        """A reshard that begins while the previous pass finishes must
        not have its reclaim stamped done."""
        got = []
        for side in SIDES:
            st = side.reshard.ReshardState(str(tmp_path / side.name))
            st.begin("a=1:1", 8, "b=1:1", 8)   # epoch 1
            st.finish()
            st.begin("c=1:1", 8, "a=1:1", 8)   # epoch 2 mid-pass
            st.finish()
            st.mark_retired(1)                 # the epoch the pass ran
            stale = st.retired_epoch
            st.mark_retired(2)
            got.append((stale, st.retired_epoch, st.describe()))
        assert got[0] == got[1]
        assert got[1][:2] == (0, 2)

    def test_retire_waits_for_spool_backlog(self, tmp_path):
        """An undrained spool can put a moved series back on its former
        owner after the pass: the pass waits."""
        def run(side, tmp):
            c = make_cluster(tmp, side)
            try:
                c.router.state.epoch = 1  # as after a finalized reshard
                peer = c.router.peers["s0"]
                peer.spool.append(b"[]")
                info = None
                for _ in range(50):
                    info = c.router.retire_step()
                    if info["phase"] in ("blocked", "done"):
                        break
                marked = c.router.state.retired_epoch
                peer.spool.replay(lambda body: None, 10)
                phases = run_retire(c)
                return info, marked, phases, c.router.state.retired_epoch
            finally:
                c.close()

        jax, port = twin(tmp_path, run)
        assert port == jax
        info, marked, phases, retired = port
        assert info["phase"] == "blocked" and "spool" in info["error"]
        assert marked == 0 and phases[-1] == "done" and retired == 1

    def test_retire_parks_when_shard_delete_is_disabled(self, tmp_path):
        """Shards without ``tsd.http.query.allow_delete``: the pass
        parks (phase ``disabled``) and the epoch stays pending."""
        def run(side, tmp):
            c = make_cluster(tmp, side, peer_cfg={})
            try:
                ingest(c, n_sec=10)
                c.router.state.epoch = 1
                info = c.router.retire_step()
                return (info, c.router.state.retired_epoch,
                        c.router.retirer.pending(),
                        c.router.retirer.health_info())
            finally:
                c.close()

        jax, port = twin(tmp_path, run)
        assert port == jax
        info, retired, pending, health = port
        assert info["phase"] == "disabled" and "allow_delete" in \
            info["error"]
        assert retired == 0 and pending is True
        assert health["failed_steps"] == 1

    def test_retire_blocks_on_dead_shard_and_keeps_debt(self, tmp_path):
        def run(side, tmp):
            c = make_cluster(tmp, side)
            extra = LivePeer(side, "s3", **ALLOW)
            try:
                ingest(c, n_sec=20)
                begin(c, extra)
                run_backfill(c)
                c.peers.append(extra)
                c.peer("s0").kill()
                seen = []
                for _ in range(40):
                    info = c.router.retire_step()
                    seen.append(info.get("phase"))
                    if info.get("phase") == "blocked":
                        break
                    assert info.get("phase") != "done"
                kept = (c.router.state.retired_epoch,
                        c.router.retirer.pending())
                c.peer("s0").restart()
                phases = run_retire(c)
                return (seen, kept, phases, c.router.state.retired_epoch,
                        stale_counts(c, c.peers))
            finally:
                c.close()
                extra.stop()

        jax, port = twin(tmp_path, run)
        assert port == jax
        seen, kept, phases, retired, counts = port
        assert seen[-1] == "blocked" and kept == (0, True)
        assert phases[-1] == "done" and retired == 1
        assert all(stale == 0 for _, stale in counts.values())


# -- reshard.json across packages -------------------------------------------

def _transitions(side, d):
    """Every transition of ``ReshardState`` in one sequence: each step's
    return, ``describe()`` and the file (fences dropped)."""
    st = side.reshard.ReshardState(str(d))
    out = []

    def snap(ret=None):
        doc = json.loads((d / "reshard.json").read_text()) \
            if (d / "reshard.json").exists() else None
        if doc and "reshard" in doc:
            doc["reshard"].pop("fence_ms")
        out.append((ret, volatile_free(st.describe(), keys=("fence_ms",)),
                    doc, st.active))

    snap(st.begin("s0=h:1,s1=h:2,s2=h:3", 32, "s0=h:1,s1=h:2", 16))
    st.mark_done("s0", "a.m")
    st.mark_done("s0", "a.m")
    st.mark_done("s1", "b.m")
    snap((st.is_done("s0", "a.m"), st.is_done("s1", "a.m")))
    st.reset_done()
    snap(st.is_done("s0", "a.m"))
    snap(st.adopt(1, "x=h:9", 8, "s0=h:1", 8, 5))       # not ahead
    snap(st.adopt(3, "s0=h:1,s3=h:4", 24, "s0=h:1,s1=h:2", 16, 7))
    snap(st.adopt_final(2, "s0=h:1", 8))                # behind
    snap(st.adopt_final(3, "s0=h:1,s3=h:4", 24))        # closes it
    snap(st.adopt_final(3, "s0=h:1,s3=h:4", 24))        # no change
    snap(st.begin("s3=h:4", 0, "s0=h:1,s3=h:4", 24))
    st.finish()
    st.mark_retired(4)
    snap()
    return out


def test_reshard_state_transitions_match(tmp_path):
    """``begin``, ``mark_done``, ``is_done``, ``reset_done``, ``adopt``,
    ``adopt_final``, ``finish`` and ``mark_retired``: the same returns,
    descriptions and ``reshard.json`` in both packages."""
    got = []
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        got.append(_transitions(side, d))
    assert got[0] == got[1]
    assert got[1][-1][1] == {"epoch": 4, "active": False,
                             "retired_epoch": 4}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-writes", "port-writes"])
def test_mid_cutover_state_crosses_packages(tmp_path, writer, reader):
    """A cutover with done-markers, written by one package's
    ``ReshardState``, loads in the other's with the same description."""
    st = writer.reshard.ReshardState(str(tmp_path))
    st.begin("s0=h:1,s1=h:2,s3=h:4", 64, "s0=h:1,s1=h:2", 64)
    st.mark_done("s0", "c.m")
    st.mark_done("s1", "d.m")
    back = reader.reshard.ReshardState(str(tmp_path))
    assert back.describe() == st.describe()
    assert (back.done, back.fence_ms, back.old_vnodes) == \
        (st.done, st.fence_ms, st.old_vnodes)
    assert back.is_done("s1", "d.m") and not back.is_done("s1", "c.m")


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-then-port", "port-then-jax"])
def test_router_resumes_the_other_package_s_cutover(tmp_path, first,
                                                    second):
    """A router of one package opens a cutover over port shards and
    copies one unit; a router of the other package, over the same
    spool dir, resumes it at the same epoch with the same done-markers,
    finishes the copy and the retire pass, and answers as one node."""
    peers = [LivePeer(PORT, f"s{i}", **ALLOW) for i in range(3)]
    extra = LivePeer(PORT, "s3", **ALLOW)
    try:
        c = make_cluster(tmp_path, first, peers=peers)
        points = ingest(c)
        begin(c, extra)
        assert c.router.backfill_step()["phase"] == "copied"
        left = (describe(c), state_file(c))
        c.close(peers=False)
        c2 = make_cluster(tmp_path, second, peers=peers)
        try:
            assert (describe(c2), state_file(c2)) == left
            assert c2.router.resharding and c2.router.epoch == 1
            assert c2.router.state.is_done("s0", "c.m")
            run_backfill(c2)
            assert run_retire(c2)[-1] == "done"
            c2.peers = peers + [extra]
            assert all(stale == 0 for _, stale in
                       stale_counts(c2, c2.peers).values())
            warm(c2, c2.peers)
            body = tsq(SUM, end=BASE_MS + 900_000)
            assert ask(c2, body) == oracle_rows(PORT, points, body)
        finally:
            c2.close(peers=False)
    finally:
        for p in peers + [extra]:
            p.stop()


def test_port_router_reshards_jax_shards(tmp_path):
    """The interop case: a port router grows a cluster of JAX shards
    to 4 over the wire, finalizes, retires the stale copies, and
    answers as one JAX node before and after the pass."""
    c = make_cluster(tmp_path, PORT, shard_side=JAX)
    extra = LivePeer(JAX, "s3", **ALLOW)
    try:
        points = ingest(c)
        begin(c, extra)
        during = in_window(500)
        assert json.loads(c.put(during, summary="true").body)["failed"] \
            == 0
        run_backfill(c)
        c.peers.append(extra)
        warm(c, c.peers)
        body = tsq(SUM, end=BASE_MS + 900_000)
        want = oracle_rows(JAX, points + during, body)
        assert ask(c, body) == want
        assert run_retire(c)[-1] == "done"
        assert all(stale == 0 for _, stale in
                   stale_counts(c, c.peers).values())
        body = tsq(SUM, end=BASE_MS + 900_001)
        assert ask(c, body) == oracle_rows(JAX, points + during, body)
        assert all(p["wire"]["connects"] >= 1 and p["wire"]["fallbacks"]
                   == 0 for p in c.router.health_info()["peers"].values())
    finally:
        c.close()
        extra.stop()


# -- Backfiller._copy_rows ----------------------------------------------------

class _StubRouter:
    """What ``Backfiller._copy_rows`` reads of a router."""

    def __init__(self, side, rf, old_names, new_names):
        self.rf = rf
        self.old_ring = side.hashring.HashRing(old_names, vnodes=16)
        self.ring = side.hashring.HashRing(new_names, vnodes=16)


@pytest.mark.parametrize("rf,dead", [(1, ()), (2, ()), (2, ("s1",)),
                                     (2, ("s0", "s2"))])
def test_copy_rows_matches_the_reference(rf, dead):
    """Rows from a seeded generator through each package's
    ``_copy_rows``, scanned from every old shard in turn: the same
    responsible shard per row, the same targets, and the same batches
    flushed in the same order."""
    rng = np.random.default_rng(7 + rf + len(dead))
    rows = [{"tags": {"host": f"h{int(rng.integers(0, 400))}",
                      "dc": f"d{int(rng.integers(0, 7))}"},
             "dps": [[BASE_MS + int(t), float(rng.integers(0, 99))]
                     for t in sorted(rng.choice(10_000, 3,
                                                replace=False))]}
            for _ in range(300)]
    got = []
    for side in SIDES:
        stub = _StubRouter(side, rf, ["s0", "s1", "s2"],
                           ["s0", "s1", "s2", "s3", "s4"])
        bf = side.reshard.Backfiller(stub)
        bf.dead = set(dead)
        flushed, moved = [], []
        for scanning in ("s0", "s1", "s2"):
            bf._scanning = scanning
            per_target: dict[str, list[dict]] = {}

            def flush(target, per_target=per_target):
                dps = per_target.pop(target, None)
                if dps:
                    flushed.append((scanning, target,
                                    [(d["tags"]["host"], d["timestamp"])
                                     for d in dps]))

            bf._copy_rows(rows, "c.m", per_target, flush, 50)
            for target in list(per_target):
                flush(target)
            moved.append(bf._moved_last)
        got.append((flushed, moved, bf.backfilled_points))
    assert got[0] == got[1]
    assert sum(got[1][1]) > 0


# -- fault sites, counters, health ------------------------------------------

def test_reshard_and_retire_fault_sites_arm(tmp_path):
    """``tsd.faults.cluster.reshard_error_count`` and
    ``tsd.faults.cluster.retire_error_count`` arm the sites on both
    packages: the step raises the injected fault before it touches a
    unit, the unit stays pending, and the next step does it."""
    def run(side, tmp):
        c = make_cluster(tmp, side, **{
            "tsd.faults.cluster.reshard_error_count": "1",
            "tsd.faults.cluster.retire_error_count": "1"})
        extra = LivePeer(side, "s3", **ALLOW)
        try:
            ingest(c, n_sec=10)
            begin(c, extra)
            out = []
            with pytest.raises(OSError, match="cluster.reshard") as e:
                c.router.backfill_step()
            out.append((type(e.value).__name__, str(e.value),
                        describe(c),
                        c.router.backfiller.failed_steps))
            out.append(run_backfill(c))
            with pytest.raises(OSError, match="cluster.retire") as e:
                c.router.retire_step()
            out.append((type(e.value).__name__, str(e.value),
                        c.router.retirer.pending(),
                        c.router.retirer.failed_steps))
            out.append(run_retire(c))
            return out
        finally:
            c.close()
            extra.stop()

    jax, port = twin(tmp_path, run)
    assert port == jax
    assert port[0][0] == "InjectedFault"
    assert port[0][2]["backfilled_metrics"] == 0
    assert port[1][0] == "copied" and port[3][-1] == "done"


def test_stats_and_health_during_window_and_after_retire(tmp_path):
    """``/api/stats`` on a router carries the ``cluster.reshard.*`` and
    ``cluster.retire.*`` counters, and ``/api/health``'s ``reshard``
    block equals the reference's in the window and after the retire
    pass; ``/api/cluster/status`` shows the backfill window."""
    def stats(c):
        doc = c.get("/api/stats/raw")[1]
        return sorted((r["metric"], r["value"]) for r in doc["records"]
                      if r["metric"].startswith(("tsd.cluster.reshard.",
                                                 "tsd.cluster.retire.")))

    def health(c):
        h = c.get("/api/health")[1]
        return norm(volatile_free(h["cluster"]["reshard"]))

    def window(c):
        doc = c.get("/api/cluster/status")[1]
        return norm(doc["backfill"])

    def run(side, tmp):
        c = make_cluster(tmp, side)
        extra = LivePeer(side, "s3", **ALLOW)
        try:
            ingest(c, n_sec=10)
            begin(c, extra)
            c.router.backfill_step()
            during = (health(c), window(c), stats(c))
            run_backfill(c)
            run_retire(c)
            return during, (health(c), stats(c))
        finally:
            c.close()
            extra.stop()

    jax, port = twin(tmp_path, run)
    assert port == jax
    (h0, w0, s0), (h1, s1) = port
    assert h0["active"] and h0["epoch"] == 1 and "backfill" in h0
    assert w0["done_units"] == 1 and w0["total_known"] is False
    assert {m for m, _ in s1} == {
        "tsd.cluster.reshard.backfilled_points",
        "tsd.cluster.reshard.backfilled_series",
        "tsd.cluster.retire.retired_series", "tsd.cluster.retire.queries",
        "tsd.cluster.retire.failed_steps"}
    assert h1["retired_epoch"] == 1 and not h1["active"]
    assert dict(s1)["tsd.cluster.retire.retired_series"] > 0
