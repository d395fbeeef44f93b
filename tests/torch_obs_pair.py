"""Shared helpers of the parity tests of the observability layer and the
control plane (``tests/test_torch_{trace,obs,control}.py``).

:data:`PORT` and :data:`JAX` hold each package's modules under the same
names, so one scenario runs on both (:func:`both`) and the answers are
compared. The TSDBs run on the CPU, with the fan-out pool off unless a
test asks for it, and :func:`shutdown` joins every thread a TSDB
started (the JAX package's fan-out pool included), so no thread of a
test outlives it.

:func:`tree_shape` reduces a ``GET /api/trace/<id>`` tree to what the
two packages must agree on: each span's name, its tags (less the
clock-dependent ones in :data:`VOLATILE_TAGS`) and its children, with
ids, start times and durations left out; siblings sort by name and
tags, so the order the fan-out's threads finish in does not count.
"""

import json
import types

import torch_pair  # noqa: F401 - the JAX package's private native build

import opentsdb_tpu.control.miner as j_miner
import opentsdb_tpu.control.qos as j_qos
import opentsdb_tpu.control.shapes as j_shapes
import opentsdb_tpu.obs.openmetrics as j_openmetrics
import opentsdb_tpu.obs.profiler as j_profiler
import opentsdb_tpu.obs.slo as j_slo
import opentsdb_tpu.obs.telemetry as j_telemetry
import opentsdb_tpu.obs.trace as j_trace
import opentsdb_tpu.stats.stats as j_stats
import opentsdb_tpu.tsd.http_api as j_http
import opentsdb_tpu.tsd.server as j_server
import opentsdb_tpu.tsd.telnet as j_telnet
import opentsdb_tpu.utils.config as j_config
import opentsdb_tpu.utils.logring as j_logring
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery

import opentsdb_tpu_torch.control.miner as t_miner
import opentsdb_tpu_torch.control.qos as t_qos
import opentsdb_tpu_torch.control.shapes as t_shapes
import opentsdb_tpu_torch.obs.openmetrics as t_openmetrics
import opentsdb_tpu_torch.obs.profiler as t_profiler
import opentsdb_tpu_torch.obs.slo as t_slo
import opentsdb_tpu_torch.obs.telemetry as t_telemetry
import opentsdb_tpu_torch.obs.trace as t_trace
import opentsdb_tpu_torch.stats.stats as t_stats
import opentsdb_tpu_torch.tsd.http_api as t_http
import opentsdb_tpu_torch.tsd.server as t_server
import opentsdb_tpu_torch.tsd.telnet as t_telnet
import opentsdb_tpu_torch.utils.config as t_config
import opentsdb_tpu_torch.utils.logring as t_logring
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery

T0 = 1356998400
T0_MS = T0 * 1000
COMMON = {"tsd.core.auto_create_metrics": "true",
          "tsd.query.fanout.workers": "0",
          "tsd.tpu.warmup": "false",
          "tsd.trace.sample": "1"}
# the point path with nothing cached (the port's K1/K2 path on a card)
ENGINE_KEYS = dict(torch_pair.ENGINE_KEYS)

PORT = types.SimpleNamespace(
    name="port", TSDB=TSDB, Config=Config, TSQuery=TSQuery,
    keys={"tsd.torch.device": "cpu", "tsd.torch.dtype": "float64"},
    trace=t_trace, stats=t_stats, openmetrics=t_openmetrics,
    profiler=t_profiler, slo=t_slo, telemetry=t_telemetry, http=t_http,
    server=t_server, telnet=t_telnet, config=t_config,
    logring=t_logring, shapes=t_shapes, miner=t_miner, qos=t_qos)
JAX = types.SimpleNamespace(
    name="jax", TSDB=JTSDB, Config=JConfig, TSQuery=JQuery,
    keys={"tsd.tpu.platform": "cpu", "tsd.query.compile_cache_dir": "off"},
    trace=j_trace, stats=j_stats, openmetrics=j_openmetrics,
    profiler=j_profiler, slo=j_slo, telemetry=j_telemetry, http=j_http,
    server=j_server, telnet=j_telnet, config=j_config,
    logring=j_logring, shapes=j_shapes, miner=j_miner, qos=j_qos)
SIDES = (PORT, JAX)

# tags that read a clock: a relative query window's bounds
VOLATILE_TAGS = frozenset({"start", "end"})


def both(scenario):
    """``scenario(side)`` on the port and on the JAX package."""
    return scenario(PORT), scenario(JAX)


def tsdb(side, **keys):
    """A TSDB of ``side`` on the CPU."""
    return side.TSDB(side.Config(**{**side.keys, **COMMON, **keys}))


def shutdown(t) -> None:
    """Shut ``t`` down and join its fan-out pool (the reference's
    shutdown does not wait for it)."""
    t.shutdown()
    pool = getattr(t, "_fanout_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


def request(side, method: str, path: str, body=None, headers=None,
            **params):
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    return side.http.HttpRequest(
        method, path, {k: [str(v)] for k, v in params.items()},
        dict(headers or {}), body or b"")


def call(side, router, method: str, path: str, body=None, headers=None,
         **params):
    return router.handle(request(side, method, path, body, headers,
                                 **params))


def put_body(metric="sys.obs", n=10, host="a", base=T0):
    return [{"metric": metric, "timestamp": base + i, "value": i,
             "tags": {"host": host}} for i in range(n)]


def query_obj(metric="sys.obs", ds="10s-avg", subs=1, **extra):
    q = {"start": T0_MS - 10_000, "end": T0_MS + 600_000,
         "queries": [{"metric": metric, "aggregator": "sum",
                      **({"downsample": ds} if ds else {})}] * subs}
    q.update(extra)
    return q


def _node_shape(node: dict) -> tuple:
    tags = {k: v for k, v in (node.get("tags") or {}).items()
            if k not in VOLATILE_TAGS}
    kids = sorted((_node_shape(c) for c in node["children"]),
                  key=repr)
    return (node["name"], node["status"],
            json.dumps(tags, sort_keys=True), tuple(kids))


def tree_shape(doc: dict) -> list:
    """A trace document's tree without ids, clocks and durations."""
    return sorted((_node_shape(n) for n in doc["tree"]), key=repr)


def trace_doc(side, router, trace_id: str) -> dict:
    resp = call(side, router, "GET", f"/api/trace/{trace_id}")
    assert resp.status == 200, resp.body
    return json.loads(resp.body)


def last_trace(t, name: str) -> str:
    """The id of the newest retained trace rooted at ``name``."""
    return next(r["traceId"] for r in t.tracer.recent(limit=500)
                if r["name"] == name)
