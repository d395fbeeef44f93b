"""Shared helpers of the port's cluster parity tests
(``tests/test_torch_cluster_*.py``).

:data:`PORT` and :data:`JAX` hold each package's cluster modules and
front end under the same names, so one scenario runs on both. A
:class:`LiveCluster` is the reference's harness (``tests/test_cluster.py``
``LiveCluster``): three shard TSDs (``tsd.cluster.role = shard``), each
a real ``TSDServer`` on 127.0.0.1 on an event loop of its own thread,
behind a router TSDB (``tsd.cluster.role = router``) driven through its
HTTP router in process. The router and the shards may come from
different packages (the interop cases). :meth:`LiveCluster.close` stops
the router and every shard and joins their threads, so no thread of a
test outlives it.

The data of :func:`mkpoints` is the reference's: integer values,
constant within every 30 s bucket, so each per-series partial of
:data:`QUERIES` is an exact integer and any summation order gives the
same bits. :data:`QUERIES_APPROX` (a rate, an average of varying
values) merge in another order than one node's engine, and are held to
:data:`APPROX_RTOL`.
"""

import asyncio
import json
import socket
import threading
import time
import types

import numpy as np

import torch_pair  # noqa: F401 - the JAX package's private native build

import opentsdb_tpu.cluster.client as j_client
import opentsdb_tpu.cluster.fleet as j_fleet
import opentsdb_tpu.cluster.hashring as j_hashring
import opentsdb_tpu.cluster.merge as j_merge
import opentsdb_tpu.cluster.replica as j_replica
import opentsdb_tpu.cluster.reshard as j_reshard
import opentsdb_tpu.cluster.router as j_router
import opentsdb_tpu.cluster.spool as j_spool
import opentsdb_tpu.cluster.wire as j_wire
import opentsdb_tpu.query.engine as j_engine
import opentsdb_tpu.tsd.http_api as j_http
import opentsdb_tpu.tsd.server as j_server
import opentsdb_tpu.tsd.telnet as j_telnet
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery

import opentsdb_tpu_torch.cluster.client as t_client
import opentsdb_tpu_torch.cluster.fleet as t_fleet
import opentsdb_tpu_torch.cluster.hashring as t_hashring
import opentsdb_tpu_torch.cluster.merge as t_merge
import opentsdb_tpu_torch.cluster.replica as t_replica
import opentsdb_tpu_torch.cluster.reshard as t_reshard
import opentsdb_tpu_torch.cluster.router as t_router
import opentsdb_tpu_torch.cluster.spool as t_spool
import opentsdb_tpu_torch.cluster.wire as t_wire
import opentsdb_tpu_torch.query.engine as t_engine
import opentsdb_tpu_torch.tsd.http_api as t_http
import opentsdb_tpu_torch.tsd.server as t_server
import opentsdb_tpu_torch.tsd.telnet as t_telnet
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery

PORT = types.SimpleNamespace(
    name="port", TSDB=TSDB, Config=Config, TSQuery=TSQuery,
    keys={"tsd.torch.device": "cpu", "tsd.torch.dtype": "float64"},
    client=t_client, fleet=t_fleet, hashring=t_hashring, merge=t_merge,
    replica=t_replica, reshard=t_reshard, router=t_router, spool=t_spool,
    wire=t_wire, engine=t_engine, http=t_http, server=t_server,
    telnet=t_telnet)
JAX = types.SimpleNamespace(
    name="jax", TSDB=JTSDB, Config=JConfig, TSQuery=JQuery,
    keys={"tsd.tpu.platform": "cpu", "tsd.query.compile_cache_dir": "off"},
    client=j_client, fleet=j_fleet, hashring=j_hashring, merge=j_merge,
    replica=j_replica, reshard=j_reshard, router=j_router, spool=j_spool,
    wire=j_wire, engine=j_engine, http=j_http, server=j_server,
    telnet=j_telnet)
SIDES = (JAX, PORT)

BASE = 1356998400
BASE_MS = BASE * 1000
PEER_CFG = {"tsd.core.auto_create_metrics": "true",
            "tsd.tpu.warmup": "false",
            "tsd.cluster.role": "shard"}

# exact per-series pipelines over mkpoints' data: every cluster's merge
# is bit-equal to the other's and to one node (ref: QUERIES)
QUERIES = [
    {"aggregator": "sum", "downsample": "10s-sum"},
    {"aggregator": "max", "downsample": "10s-max"},
    {"aggregator": "min", "downsample": "15s-min"},
    {"aggregator": "avg", "downsample": "30s-avg"},
    {"aggregator": "sum", "downsample": "10s-count"},
    {"aggregator": "none"},
    {"aggregator": "sum", "downsample": "30s-sum",
     "filters": [{"type": "wildcard", "tagk": "host", "filter": "*",
                  "groupBy": True}]},
]
# inexact intermediates (rate deltas, averages of varying values): the
# merge adds them in another order than the other package's merge and
# than one node's engine (ref: QUERIES_APPROX); the JAX package computes
# in float32 on the CPU, so the two agree to float32's precision
QUERIES_APPROX = [
    {"aggregator": "sum", "downsample": "10s-sum", "rate": True},
    {"aggregator": "avg", "downsample": "10s-avg"},
]
APPROX_RTOL = 1e-6


def req(side, method, path, body=None, **params):
    """One in-process request to ``side``'s HTTP router."""
    return side.http.HttpRequest(
        method=method, path=path,
        params={k: [str(v)] for k, v in params.items()},
        body=json.dumps(body).encode() if body is not None else b"")


def mkpoints(n_hosts=12, n_sec=120, metric="c.m", seed=None):
    """The reference's data (``_mkpoints``): integer values constant
    within every 30 s bucket. With ``seed``, values drawn from a seeded
    generator vary per second (for :data:`QUERIES_APPROX`)."""
    rng = np.random.default_rng(seed) if seed is not None else None
    pts = []
    for i in range(n_sec):
        for h in range(n_hosts):
            v = (h * 13 + (i // 30) * 7) % 50 if rng is None \
                else int(rng.integers(0, 1000))
            pts.append({"metric": metric, "timestamp": BASE + i,
                        "value": v, "tags": {"host": f"h{h:02d}"}})
    return pts


def tsq(qspec, start=BASE_MS - 10_000, end=BASE_MS + 200_000,
        metric="c.m", **extra):
    return {"start": start, "end": end,
            "queries": [dict({"metric": metric}, **qspec)], **extra}


def strip_marker(doc):
    """(rows, degraded shard names) of a query answer."""
    if doc and isinstance(doc[-1], dict) and "shardsDegraded" in doc[-1]:
        return doc[:-1], doc[-1]["shardsDegraded"]
    return doc, []


def sorted_rows(doc):
    return sorted(doc, key=lambda r: (r["metric"],
                                      sorted(r["tags"].items())))


def assert_rows_close(got, want, rtol=APPROX_RTOL):
    """Rows equal in shape, tags and timestamps, values within rtol."""
    got, want = sorted_rows(got), sorted_rows(want)
    assert [(r["metric"], r["tags"], r["aggregateTags"]) for r in got] \
        == [(r["metric"], r["tags"], r["aggregateTags"]) for r in want]
    for a, b in zip(got, want):
        assert list(a["dps"]) == list(b["dps"])
        va = np.asarray(list(a["dps"].values()), dtype=np.float64)
        vb = np.asarray(list(b["dps"].values()), dtype=np.float64)
        np.testing.assert_allclose(va, vb, rtol=rtol, atol=0)


class LivePeer:
    """One shard TSD of ``side`` on a real socket, with kill, restart
    and hang (ref: ``LivePeer``). ``kill`` closes the listener (the
    network died) and the TSDB keeps its data; ``restart`` opens a
    listener on the same address again."""

    def __init__(self, side, name: str, port: int = 0, **cfg):
        self.side = side
        self.name = name
        self.tsdb = side.TSDB(side.Config(**{**side.keys, **PEER_CFG,
                                             **cfg}))
        self.loop = asyncio.new_event_loop()
        self.server = side.server.TSDServer(self.tsdb, host="127.0.0.1",
                                            port=port)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.server.start())
            started.set()
            self.loop.run_forever()

        self._thread = threading.Thread(target=run, name="tsd-server",
                                        daemon=True)
        self._thread.start()
        assert started.wait(60), f"peer {name} did not start"
        self.port = self.server._server.sockets[0].getsockname()[1]
        self.server.port = self.port
        self._orig_handle = self.server.http_router.handle
        self._unhang: threading.Event | None = None

    def _call(self, coro, timeout=30):
        return asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def kill(self):
        async def close():
            srv = self.server._server
            if srv is not None:
                srv.close()
                await srv.wait_closed()
                self.server._server = None
        self._call(close())

    def restart(self):
        async def reopen():
            self.server._server = await asyncio.start_server(
                self.server._handle_connection, "127.0.0.1", self.port,
                reuse_address=True)
        self._call(reopen())

    def hang(self, needle: str) -> threading.Event:
        """Requests whose path holds ``needle`` block until
        :meth:`unhang` (a hung peer: the socket accepts, no answer
        comes). Returns an event set when the first one is caught."""
        hit = threading.Event()
        self._unhang = threading.Event()
        orig = self._orig_handle

        def handler(request):
            if needle in request.path:
                hit.set()
                self._unhang.wait(30)
            return orig(request)

        self.server.http_router.handle = handler
        return hit

    def unhang(self):
        if self._unhang is not None:
            self._unhang.set()
        self.server.http_router.handle = self._orig_handle

    def stop(self):
        if self.loop.is_closed():
            return
        self.unhang()
        self._call(self.server.stop(), timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        self.loop.close()


class LiveCluster:
    """A router of ``side`` over ``n`` shards of ``shard_side`` (by
    default the same package; ref: ``LiveCluster``)."""

    def __init__(self, tmp_path, side, shard_side=None, n=3,
                 durable=False, peer_cfg=None, peers=None, **router_cfg):
        self.side = side
        self.peers = peers if peers is not None else [
            LivePeer(shard_side or side, f"s{i}", **(peer_cfg or {}))
            for i in range(n)]
        self.spec = ",".join(f"s{i}=127.0.0.1:{p.port}"
                             for i, p in enumerate(self.peers))
        cfg = {**side.keys,
               "tsd.cluster.role": "router",
               "tsd.cluster.peers": self.spec,
               "tsd.cluster.spool.replay_interval_ms": "100",
               "tsd.tpu.warmup": "false",
               **router_cfg}
        if durable:
            cfg.setdefault("tsd.cluster.spool.dir", str(tmp_path / "spool"))
        self.cfg = cfg
        self.start_router()

    def start_router(self):
        self.tsdb = self.side.TSDB(self.side.Config(**self.cfg))
        self.http = self.side.http.HttpRpcRouter(self.tsdb)
        self.router = self.tsdb.cluster
        self.router.start()

    def put(self, points, **params):
        return self.http.handle(req(self.side, "POST", "/api/put", points,
                                    **params))

    def query(self, body=None, **params):
        if body is not None:
            resp = self.http.handle(req(self.side, "POST", "/api/query",
                                        body))
        else:
            resp = self.http.handle(req(self.side, "GET", "/api/query",
                                        **params))
        return resp, (json.loads(resp.body) if resp.body else None)

    def get(self, path, **params):
        resp = self.http.handle(req(self.side, "GET", path, **params))
        return resp, (json.loads(resp.body) if resp.body else None)

    def peer(self, name) -> LivePeer:
        return self.peers[int(name[1:])]

    def shard_of(self, metric, tags) -> str:
        return self.router.ring.shard_for(metric, tags)

    def wait_spool_drained(self, name, timeout=20) -> bool:
        peer = self.router.peers[name]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if peer.spool.pending_records == 0:
                return True
            time.sleep(0.05)
        return False

    def close(self, peers=True):
        wake_wire_readers(self.router)
        self.tsdb.shutdown()
        if peers:
            for p in self.peers:
                p.stop()


def wake_wire_readers(router) -> None:
    """Shut the router's wire sockets down before its stop: the JAX
    package's stop closes them without a shutdown, and a reader thread
    blocked in ``recv`` then holds it for the socket's timeout."""
    for slot in list(router.wire._slots.values()):
        conn = slot.conn
        if conn is not None:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def volatile_free(doc, keys=("uptime_seconds", "ts", "oldest_age_s",
                             "oldest_pending_age_s", "age_s",
                             "dirty_oldest_age_s", "address")):
    """``doc`` with its clock- and address-dependent fields dropped, at
    any depth (health, fleet and status documents)."""
    if isinstance(doc, dict):
        return {k: volatile_free(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [volatile_free(v, keys) for v in doc]
    return doc
