"""Configuration keys the port settles against the JAX package:

- the chunked-body key's two spellings (``tsd.http.request.enable_chunked``
  and the reference's legacy alias ``tsd.http.request_enable_chunked``):
  a chunked ``/api/put`` over a real socket answers the same status in
  both packages and stores the same points;
- keys declared with no behaviour (``tsd.lifecycle.compact``,
  ``tsd.lifecycle.pack_timestamps``: the port's stores have nothing to
  compact, ROADMAP recorded divergence 22);
- the keys of the ``/q`` graphs and the ``/s`` static files
  (``tsd.http.staticroot``, ``tsd.http.cachedir``,
  ``tsd.http.graph.auto_pixels``), read as the reference reads them;
- the sibling routers' gossip keys (``tsd.cluster.gossip.*``), read
  with the reference's defaults;
- ``tsd.cluster.reshard.backfill_batch``, read by the router's repair
  and backfill, and the reshard and retire loops' keys
  (``tsd.cluster.reshard.interval_ms``, ``tsd.cluster.retire.enable``,
  ``tsd.cluster.retire.interval_ms``), read with the reference's
  defaults.
"""

from __future__ import annotations

import json
import logging
import socket

import pytest

from torch_cluster_pair import BASE, JAX, PORT, SIDES, LivePeer

CHUNK_KEYS = ("tsd.http.request_enable_chunked",
              "tsd.http.request.enable_chunked", None)


def _chunked(body: bytes, size: int = 100) -> bytes:
    out = b""
    for i in range(0, len(body), size):
        part = body[i:i + size]
        out += f"{len(part):x}\r\n".encode() + part + b"\r\n"
    return out + b"0\r\n\r\n"


def _raw(port: int, data: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), 30) as s:
        s.sendall(data)
        out = b""
        while chunk := s.recv(65536):
            out += chunk
    return out


def _put_body(n: int) -> bytes:
    return json.dumps([{"metric": "chunk.m", "timestamp": BASE + i,
                        "value": i * 3, "tags": {"host": f"h{i % 4}"}}
                       for i in range(n)]).encode()


def _stored(tsdb, side) -> list:
    q = side.TSQuery.from_json({
        "start": BASE - 10, "end": BASE + 100,
        "queries": [{"metric": "chunk.m", "aggregator": "none"}]})
    try:
        rows = tsdb.execute_query(q.validate())
    except ValueError:   # no such name: nothing was stored
        return []
    return sorted((tuple(sorted(r.tags.items())),
                   [(int(t), float(v)) for t, v in r.dps])
                  for r in rows)


@pytest.mark.parametrize("key", CHUNK_KEYS)
def test_a_chunked_put_under_either_spelling(key):
    """A chunked ``/api/put``: 204 with the points stored under either
    spelling of the key, the reference's 400 with nothing stored when
    neither is set, in both packages alike."""
    # a standalone TSD (the pair's peers are shards by default)
    cfg = {"tsd.cluster.role": "", **({key: "true"} if key else {})}
    got = []
    for side in SIDES:
        peer = LivePeer(side, "c", **cfg)
        try:
            head = (b"POST /api/put HTTP/1.1\r\nHost: x\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Transfer-Encoding: chunked\r\n"
                    b"Connection: close\r\n\r\n")
            out = _raw(peer.port, head + _chunked(_put_body(40)))
            status = int(out.split(b" ", 2)[1])
            got.append((status, _stored(peer.tsdb, side)))
        finally:
            peer.stop()
    assert got[0] == got[1]
    status, stored = got[1]
    if key is None:
        assert status == 400 and stored == []
    else:
        assert status == 204
        assert sum(len(dps) for _t, dps in stored) == 40


def test_lifecycle_compaction_keys_are_declared():
    """``tsd.lifecycle.compact`` and ``.pack_timestamps`` are read by
    nothing in the port (nothing to compact) and warn about nothing; a
    lifecycle TSDB with them builds in both packages."""
    keys = {"tsd.lifecycle.compact": "false",
            "tsd.lifecycle.pack_timestamps": "false"}
    assert PORT.Config(**keys).unknown_keys() == []
    assert JAX.Config(**keys).unknown_keys() == []
    full = {**keys, "tsd.lifecycle.enable": "true",
            "tsd.rollups.enable": "true"}
    for side in SIDES:
        side.TSDB(side.Config(**{**side.keys, **full})).shutdown()


@pytest.mark.parametrize("key,value", [
    ("tsd.http.staticroot", "/srv/tsd/static"),
    ("tsd.http.cachedir", "/srv/tsd/cache"),
    ("tsd.http.graph.auto_pixels", "false")])
def test_the_graph_and_static_keys_are_read(caplog, key, value):
    """The keys of ``/q`` and ``/s`` are read: neither package calls one
    unknown, both give back the value set, and the port's warnings name
    only the typo set beside it, as a typo."""
    for side in SIDES:
        cfg = side.Config(**{key: value, "tsd.bogus.key": "1"})
        assert cfg.unknown_keys() == ["tsd.bogus.key"]
        assert cfg.get_string(key) == value
    cfg = PORT.Config(**{key: value, "tsd.bogus.key": "1"})
    with caplog.at_level(logging.WARNING, logger="config"):
        assert cfg.warn_unknown_keys() == ["tsd.bogus.key"]
    lines = [r.getMessage() for r in caplog.records]
    assert not [m for m in lines if repr(key) in m]
    bogus = [m for m in lines if "'tsd.bogus.key'" in m]
    assert len(bogus) == 1 and "typo" in bogus[0]


@pytest.mark.parametrize("key,value", [
    ("tsd.cluster.gossip.interval_ms", "100"),
    ("tsd.cluster.gossip.stale_ms", "700"),
    ("tsd.cluster.gossip.log_max", "64"),
    ("tsd.cluster.gossip.timeout_ms", "900"),
    ("tsd.cluster.gossip.fanout", None)])
def test_the_reference_s_gossip_keys_are_read(key, value):
    """The sibling routers' keys are the reference's and are read with
    its defaults (interval 250 ms, stale 5000 ms, a log of 4096, a
    2000 ms push deadline): the two packages' buses take the same
    settings. A key of the family the reference does not have
    (``.fanout``) is unknown to both."""
    peers = "s0=127.0.0.1:1,s1=127.0.0.1:2"
    if value is None:
        for side in SIDES:
            assert side.Config(**{key: "1"}).unknown_keys() == [key]
        return
    got = []
    for over in ({}, {key: value}):
        for side in SIDES:
            tsdb = side.TSDB(side.Config(**{
                **side.keys, "tsd.cluster.role": "router",
                "tsd.cluster.peers": peers,
                "tsd.cluster.routers": "r1=127.0.0.1:9", **over}))
            try:
                assert tsdb.config.unknown_keys() == []
                bus = tsdb.cluster.gossip
                got.append((bus.interval_s, bus.stale_s, bus.log_max,
                            bus.siblings["r1"].client.timeout_s))
            finally:
                tsdb.shutdown()
    assert got[0] == got[1] == (0.25, 5.0, 4096, 2.0)
    assert got[2] == got[3] != got[0]


def test_backfill_batch_is_read_by_the_router():
    """``tsd.cluster.reshard.backfill_batch`` chunks a repair's
    deliveries, 4000 points by default, as in the reference."""
    peers = "s0=127.0.0.1:1,s1=127.0.0.1:2"
    got = []
    for value in (None, "7"):
        for side in SIDES:
            keys = {**side.keys, "tsd.cluster.role": "router",
                    "tsd.cluster.peers": peers}
            if value is not None:
                keys["tsd.cluster.reshard.backfill_batch"] = value
            t = side.TSDB(side.Config(**keys))
            try:
                got.append(t.cluster.backfill_batch)
            finally:
                t.shutdown()
    assert got == [4000, 4000, 7, 7]
    assert PORT.Config(**{"tsd.cluster.reshard.backfill_batch": "7"}
                       ).unknown_keys() == []


@pytest.mark.parametrize("key,attr,value,default,set_to", [
    ("tsd.cluster.reshard.interval_ms", "reshard_interval_s", "40",
     0.25, 0.04),
    ("tsd.cluster.retire.interval_ms", "retire_interval_s", "50",
     1.0, 0.05),
    ("tsd.cluster.retire.enable", "retire_enabled", "false", True,
     False)])
def test_reshard_and_retire_keys_are_read(key, attr, value, default,
                                          set_to):
    """The backfill and retire loops' keys are read by the router with
    the reference's defaults (250 ms, 1000 ms, on), and the registry
    declares them, so neither package warns about them."""
    peers = "s0=127.0.0.1:1,s1=127.0.0.1:2"
    got = []
    for v in (None, value):
        for side in SIDES:
            keys = {**side.keys, "tsd.cluster.role": "router",
                    "tsd.cluster.peers": peers}
            if v is not None:
                keys[key] = v
            t = side.TSDB(side.Config(**keys))
            try:
                got.append(getattr(t.cluster, attr))
            finally:
                t.shutdown()
    assert got == [default, default, set_to, set_to]
    assert PORT.Config(**{key: value}).unknown_keys() == []
