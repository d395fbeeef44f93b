"""Shared helpers of the parity tests of the operator surface: the
plugin slots, authentication, meta, search, trees and their durability
(``tests/test_torch_{plugins,auth,meta,search,tree,memory_durability}
.py``).

:data:`PORT` and :data:`JAX` hold each package's modules under the same
names, so one scenario runs on both (:func:`both`) and the two answers
are compared whole. The TSDBs run on the CPU, with the fan-out pool off
(no ``tsd-subq`` thread outlives a test) and the JAX package's plugins
loaded as its command line loads them (``initialize_plugins``; the
port loads them when the TSDB is built). :func:`frozen_clock` pins the
clock the meta documents and the trees read, so their JSON compares
exactly.

Tolerance: none. Metadata, JSON bodies, statuses and headers compare
exactly; query values compare bit for bit.
"""

import json
import types

import torch_pair  # noqa: F401 - the JAX package's private native build

import opentsdb_tpu.auth.simple as j_auth
import opentsdb_tpu.meta.annotation as j_annotation
import opentsdb_tpu.meta.meta_store as j_meta
import opentsdb_tpu.plugins as j_plugins
import opentsdb_tpu.search.lookup as j_lookup
import opentsdb_tpu.tree.tree as j_tree
import opentsdb_tpu.tsd.http_api as j_http
import opentsdb_tpu.tsd.json_serializer as j_serializer
import opentsdb_tpu.tsd.telnet as j_telnet
import opentsdb_tpu.utils.plugin as j_loader
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery

import opentsdb_tpu_torch.auth.simple as t_auth
import opentsdb_tpu_torch.meta.annotation as t_annotation
import opentsdb_tpu_torch.meta.meta_store as t_meta
import opentsdb_tpu_torch.plugins as t_plugins
import opentsdb_tpu_torch.search.lookup as t_lookup
import opentsdb_tpu_torch.tree.tree as t_tree
import opentsdb_tpu_torch.tsd.http_api as t_http
import opentsdb_tpu_torch.tsd.json_serializer as t_serializer
import opentsdb_tpu_torch.tsd.telnet as t_telnet
import opentsdb_tpu_torch.utils.plugin as t_loader
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery

T0 = 1356998400
FROZEN = 1700000000
COMMON = {"tsd.core.auto_create_metrics": "true",
          "tsd.query.fanout.workers": "0"}

PORT = types.SimpleNamespace(
    name="port", TSDB=TSDB, Config=Config, TSQuery=TSQuery,
    keys={"tsd.torch.device": "cpu", "tsd.torch.dtype": "float64"},
    auth=t_auth, annotation=t_annotation, meta=t_meta, plugins=t_plugins,
    lookup=t_lookup, tree=t_tree, http=t_http, serializer=t_serializer,
    telnet=t_telnet, loader=t_loader)
JAX = types.SimpleNamespace(
    name="jax", TSDB=JTSDB, Config=JConfig, TSQuery=JQuery,
    keys={"tsd.tpu.platform": "cpu", "tsd.query.compile_cache_dir": "off"},
    auth=j_auth, annotation=j_annotation, meta=j_meta, plugins=j_plugins,
    lookup=j_lookup, tree=j_tree, http=j_http, serializer=j_serializer,
    telnet=j_telnet, loader=j_loader)


def both(scenario):
    """``scenario(side)`` on the port and on the JAX package."""
    return scenario(PORT), scenario(JAX)


def tsdb(side, **keys):
    """A TSDB of ``side`` on the CPU with its plugins loaded."""
    t = side.TSDB(side.Config(**side.keys, **COMMON, **keys))
    if side is JAX:
        t.initialize_plugins()
    return t


def router(side, t):
    return side.http.HttpRpcRouter(t)


def request(side, method: str, path: str, params: dict | None = None,
            body=b"", auth=None):
    """An HttpRequest of ``side``; a dict or list body goes as JSON."""
    if not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = side.http.HttpRequest(
        method, path, {k: [str(v)] for k, v in (params or {}).items()},
        {}, body)
    req.auth = auth
    return req


def answer(resp) -> tuple:
    """A response as (status, body, content type, headers), the body
    parsed when it is JSON. The reference's request-trace header is left
    out: tracing (``obs/``) is not ported (ROADMAP Queue 1)."""
    body = resp.body
    if body and "json" in (resp.content_type or ""):
        body = json.loads(body)
    headers = {k: v for k, v in resp.headers.items()
               if k != "X-TSD-Trace-Id"}
    return resp.status, body, resp.content_type, headers


def call(side, t, method: str, path: str, params=None, body=b"",
         auth=None) -> tuple:
    return answer(router(side, t).handle(
        request(side, method, path, params, body, auth)))


def tsuid_of(t, metric: str, tags: dict) -> str:
    uids = t.uids
    return uids.tsuid(uids.metrics.get_id(metric), sorted(
        (uids.tag_names.get_id(k), uids.tag_values.get_id(v))
        for k, v in tags.items())).hex().upper()


def frozen_clock(monkeypatch) -> None:
    """Pin the clock of both packages' meta documents and trees."""
    clock = types.SimpleNamespace(time=lambda: float(FROZEN))
    for side in (PORT, JAX):
        monkeypatch.setattr(side.meta, "time", clock)
        monkeypatch.setattr(side.tree, "time", clock)
