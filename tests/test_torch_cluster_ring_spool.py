"""The port's cluster formats that outlive a process, held to the JAX
package's byte for byte (``opentsdb_tpu_torch/cluster/``):

- the hash ring: the owner of every key of 100k seeded series, at
  several vnode counts, batched and one by one, ``distribution`` and
  ``replica_sets`` at rf=1; the peer spec's parse and its errors;
- the spool: the file and its offset sidecar after the same appends and
  replays, a torn tail, a corrupt record, compaction, ``SpoolFull`` at
  the same size, ``health_info``, and a spool directory written by one
  package's spool and replayed by the other's, both ways;
- the router's sidecar files: the dirty tracker's ``replica_dirty.json``
  and the topology's ``reshard.json``, read across packages, a router
  of each package built from a ``reshard.json`` past epoch 0, and a
  router of each package over a spool directory the other's router left
  (the spooled points replay into a live shard).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from torch_cluster_pair import (BASE, JAX, PORT, SIDES, LiveCluster,
                                LivePeer, mkpoints, tsq)


def _series_keys(side, n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    dcs = rng.integers(0, 100, n)
    racks = rng.integers(0, 2000, n)
    return [side.hashring.series_shard_key(
        f"m{i % 7}", {"host": f"h{i}", "dc": f"dc{d}", "rack": f"r{r}"})
        for i, (d, r) in enumerate(zip(dcs.tolist(), racks.tolist()))]


@pytest.mark.parametrize("vnodes", [1, 16, 64, 256])
def test_ring_places_every_key_as_the_reference(vnodes):
    names = ["s0", "s1", "s2", "s3", "s4"]
    keys = _series_keys(PORT, 100_000, seed=vnodes)
    assert keys == _series_keys(JAX, 100_000, seed=vnodes)
    jr = JAX.hashring.HashRing(names, vnodes=vnodes)
    tr = PORT.hashring.HashRing(names, vnodes=vnodes)
    assert tr._points == jr._points and tr._owners == jr._owners
    assert tr.shards_for_keys(keys) == jr.shards_for_keys(keys)
    assert [tr.shard_for_key(k) for k in keys[:2000]] == \
        [jr.shard_for_key(k) for k in keys[:2000]]
    assert tr.distribution(keys) == jr.distribution(keys)
    assert tr.replica_sets(1) == jr.replica_sets(1)


def test_series_key_and_tag_order():
    for side in SIDES:
        r = side.hashring.HashRing(["a", "b", "c"], vnodes=64)
        assert r.shard_for("m", {"x": "1", "y": "2"}) == \
            r.shard_for("m", {"y": "2", "x": "1"})
    assert PORT.hashring.series_shard_key("m", {"b": "2", "a": "é"}) == \
        JAX.hashring.series_shard_key("m", {"b": "2", "a": "é"})
    for side in SIDES:
        with pytest.raises(ValueError, match="at least one shard"):
            side.hashring.HashRing([])


@pytest.mark.parametrize("spec", [
    "s0=127.0.0.1:4242,s1=10.0.0.2:4243", "127.0.0.1:1, ,h:2",
    "a=h:1,a=h:2", "bad", "h:port", ""])
def test_parse_peer_spec(spec):
    out = []
    for side in SIDES:
        try:
            out.append(side.client.parse_peer_spec(spec))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


# -- the spool ---------------------------------------------------------------


def _spool_files(d) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _payloads(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [json.dumps([{"metric": "c.m", "timestamp": BASE + i,
                         "value": int(v), "tags": {"host": f"h{i % 5}"}}
                        for i, v in enumerate(rng.integers(0, 99, k))]
                       ).encode()
            for k in rng.integers(1, 30, n).tolist()]


@pytest.mark.parametrize("seed", [0, 1])
def test_spool_files_are_the_reference_s(tmp_path, seed):
    """The same appends and partial replays leave the same spool file
    and offset sidecar, step by step, with compaction on the way."""
    payloads = _payloads(seed, 40)
    spools = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        spools[side.name] = (d, side.spool.PeerSpool(
            str(d), "s1", compact_bytes=2048))
    done = {side.name: 0 for side in SIDES}
    for step in range(4):
        for side in SIDES:
            d, s = spools[side.name]
            for p in payloads[step * 10:(step + 1) * 10]:
                s.append(p)
            got = []
            assert s.replay(got.append, 7) == 7
            at = done[side.name]
            assert got == payloads[at:at + 7]
            done[side.name] = at + 7
        (jd, js), (td, ts) = spools["jax"], spools["port"]
        assert _spool_files(td) == _spool_files(jd)
        assert ts.health_info() == js.health_info()
        assert ts.pending_records == js.pending_records
    for side in SIDES:
        spools[side.name][1].close()


def test_spool_torn_tail_and_corrupt_record(tmp_path):
    for side in SIDES:
        d = tmp_path / side.name
        s = side.spool.PeerSpool(str(d), "p1")
        s.append(b"aaaa")
        s.append(b"bbbb")
        os.truncate(s.path, os.path.getsize(s.path) - 2)
        s.close()
    out = []
    for side in SIDES:
        s2 = side.spool.PeerSpool(str(tmp_path / side.name), "p1")
        got = []
        n = s2.pending_records
        s2.replay(got.append)
        s2.append(b"cccc")
        with open(s2.path, "r+b") as fh:
            fh.seek(len(side.spool.MAGIC) + 16 + 1)
            fh.write(b"X")
        got2 = []
        s2.replay(got2.append)
        out.append((n, got, got2, s2.pending_records,
                    _spool_files(tmp_path / side.name)))
        s2.close()
    assert out[0] == out[1]
    assert out[0][1] == [b"aaaa"]


def test_spool_full_at_the_same_size(tmp_path):
    outs = []
    for side in SIDES:
        res = []
        for directory in (str(tmp_path / side.name), None):
            s = side.spool.PeerSpool(directory, "p1", max_bytes=200)
            n = 0
            try:
                while True:
                    s.append(b"y" * 37)
                    n += 1
            except side.spool.SpoolFull as e:
                res.append((n, str(e), s.rejected_full, s.durable,
                            s.health_info()))
            s.close()
        outs.append(res)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_spool_dir_crosses_packages(tmp_path, writer, reader):
    """A spool one package left half replayed replays its remaining
    records, in order, in the other's."""
    payloads = _payloads(7, 12)
    s = writer.spool.PeerSpool(str(tmp_path), "s2")
    for p in payloads:
        s.append(p)
    s.replay(lambda b: None, 5)
    s.close()
    r = reader.spool.PeerSpool(str(tmp_path), "s2")
    assert r.pending_records == 7
    got = []
    r.replay(got.append)
    assert got == payloads[5:]
    r.close()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_dirty_and_reshard_files_cross_packages(tmp_path, writer,
                                                reader):
    w = writer.replica.DirtyTracker(str(tmp_path))
    w.mark("s1", ["a.m", "b.m"], 1_356_998_400_000)
    w.mark("s2", ["a.m"], 1_356_998_500_000)
    r = reader.replica.DirtyTracker(str(tmp_path))
    assert r.peek("s1") == w.peek("s1") and r.peek("s2") == w.peek("s2")
    assert r.total_entries == w.total_entries == 3
    r.clear("s1", ["a.m"])
    assert writer.replica.DirtyTracker(str(tmp_path)).peek("s1") == \
        {"b.m": 1_356_998_400_000}
    st = writer.reshard.ReshardState(str(tmp_path))
    st.peers_spec, st.vnodes = "s0=h:1,s1=h:2", 32
    with st._lock:
        st._save_locked()
    back = reader.reshard.ReshardState(str(tmp_path))
    assert (back.epoch, back.peers_spec, back.vnodes, back.active) == \
        (0, "s0=h:1,s1=h:2", 32, False)
    assert back.describe() == st.describe()


@pytest.mark.parametrize("state", [
    {"epoch": 2, "peers": "s0=127.0.0.1:1", "vnodes": 64},
    {"epoch": 1, "peers": "s0=127.0.0.1:1", "vnodes": 64,
     "reshard": {"old_peers": "s0=127.0.0.1:1,s1=127.0.0.1:2",
                 "old_vnodes": 64, "fence_ms": 1, "done": {}}}],
    ids=["past-epoch-0", "open-cutover"])
def test_router_refuses_a_resharded_spool_dir(tmp_path, state):
    """No longer refused: a router over a spool directory past epoch
    0, or with an open cutover, builds the installed ring (and the old
    ring of an open cutover) from ``reshard.json`` rather than the boot
    ring of its config, as the reference's does."""
    got = []
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        (d / "reshard.json").write_text(json.dumps(state))
        t = side.TSDB(side.Config(**{
            **side.keys, "tsd.cluster.role": "router",
            "tsd.cluster.peers": "s9=127.0.0.1:9",
            "tsd.cluster.spool.dir": str(d)}))
        try:
            r = t.cluster
            got.append((r.reshard_info(), sorted(r.peers),
                        r.resharding))
        finally:
            t.shutdown()
    assert got[0] == got[1]
    assert got[1][0]["epoch"] == state["epoch"]
    assert got[1][0]["ring"]["peers"] == ["s0"]


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-then-port", "port-then-jax"])
def test_router_spool_dir_crosses_packages(tmp_path, first, second):
    """A router of one package spools a dead shard's points into its
    spool dir and stops; a router of the other package opens the same
    dir and replays every point into the shard once it listens."""
    peer = LivePeer(PORT, "s0")
    try:
        peer.kill()
        c = LiveCluster(tmp_path, first, peers=[peer], durable=True,
                        **{"tsd.cluster.timeout_ms": "500",
                           "tsd.cluster.spool.replay_interval_ms":
                           "60000"})
        pts = mkpoints(n_hosts=4, n_sec=20)
        resp = c.put(pts, summary="true")
        assert resp.status == 200 and json.loads(resp.body)["failed"] == 0
        assert c.router.peers["s0"].spool.pending_records >= 1
        c.close(peers=False)
        peer.restart()
        c2 = LiveCluster(tmp_path, second, peers=[peer], durable=True,
                         **{"tsd.cluster.timeout_ms": "30000"})
        try:
            assert c2.wait_spool_drained("s0")
            _, doc = c2.query(tsq({"aggregator": "none"}))
            assert sum(len(r["dps"]) for r in doc) == len(pts)
        finally:
            c2.close(peers=False)
    finally:
        peer.stop()
