"""Server warmup on the port (``opentsdb_tpu_torch/tsd/warmup.py``),
held against the JAX package's (``opentsdb_tpu/tsd/warmup.py``).

- ``warmup_shapes`` is the reference's class list before its shape
  bucketing, on the same stores (raw, rollup tiers, preagg), and
  bucketed by the reference's rule it gives the reference's classes;
- ``run_warmup`` on the CPU runs each class once, through the port's
  ``execute_grid`` and ``execute_avg_divide``, and counts it;
- a set ``_warmup_stop`` stops it between classes;
- the TSD server starts the warmup at start (``tsd.tpu.warmup``),
  joins it at stop, and a failing warmup is logged and switches
  nothing.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.ops import shapes as jshapes
from opentsdb_tpu.tsd import warmup as jwarmup
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.ops import pipeline
from opentsdb_tpu_torch.tsd import warmup
from test_torch_streaming import no_fold_thread_survives  # noqa: F401

BASE = 1356998400
KEYS = {"tsd.core.auto_create_metrics": "true", "tsd.rollups.enable": "true"}


def load(t, n_hosts=12):
    """Raw points of two metrics, 1m sum and count tier points and
    preagg points, the same on either package."""
    rng = np.random.default_rng(4)
    for i in range(n_hosts):
        tags = {"host": f"h{i:02d}", "dc": f"dc{i % 3}", "rack": f"r{i % 5}"}
        ts = BASE + 60 * np.arange(10, dtype=np.int64)
        t.add_points("sys.cpu", ts, rng.normal(50, 5, 10), tags)
        if i % 2:
            t.add_points("sys.mem", ts, rng.normal(9, 1, 10),
                         {"host": f"h{i:02d}"})
    for i in range(4):
        for agg, val in (("sum", 10.0 + i), ("count", 2.0)):
            t.add_aggregate_point("sys.cpu", BASE, val, {"host": f"h{i}"},
                                  False, "1m", agg)
    for dc in range(3):
        t.add_aggregate_point("sys.cpu", BASE, 1.0, {"dc": f"dc{dc}"},
                              True, None, "SUM")


@pytest.fixture
def tsdbs():
    made = []

    def make(jax=False, **extra):
        t = (JTSDB(JConfig(**{**KEYS, "tsd.tpu.platform": "cpu",
                              **extra})) if jax else
             TSDB(Config(**{**KEYS, "tsd.torch.device": "cpu", **extra})))
        made.append(t)
        return t
    yield make
    for t in made:
        t.shutdown()


@pytest.mark.parametrize("buckets", ["", "5000, 40"])
def test_warmup_shapes_are_the_reference_classes(tsdbs, buckets):
    jt = tsdbs(jax=True, **{"tsd.tpu.warmup.buckets": buckets})
    tt = tsdbs(**{"tsd.tpu.warmup.buckets": buckets})
    load(jt)
    load(tt)
    # the reference's combos before its bucketing (ref: warmup_shapes)
    per_store = [(max(st.num_series(), 1), jwarmup._group_classes(st))
                 for st in jwarmup._resident_stores(jt)]
    per_store += [(int(tok), set()) for tok in buckets.split(",")
                  if tok.strip()]
    want = sorted({(s, b, int(g)) for s, gset in per_store
                   for g in gset | {1, min(s, 100)} for b in (60, 288)})
    got = warmup.warmup_shapes(tt)
    assert got == want
    # raw, the 1m sum and count tiers, preagg
    assert len(warmup._resident_stores(tt)) == 4
    # bucketed by the reference's rule, the same classes it compiles
    sb = jshapes.shape_bucket
    assert {(sb(s), sb(b), sb(g + 1)) for s, b, g in got} == \
        {(s, b, sb(g + 1)) for s, b, g in jwarmup.warmup_shapes(jt)}


def spy_on_tails(monkeypatch, stop_after=None, tsdb=None):
    """Record every tail the warmup runs: (function, S, B, G, agg,
    rate, emit_raw). ``stop_after`` sets the TSDB's stop event once
    that many classes ran."""
    calls = []

    def wrap(name, fn):
        def spy(grid, *args, **kw):
            spec = args[3]
            calls.append((name, grid.shape[0], grid.shape[1],
                          spec.num_groups, spec.agg_name, spec.rate,
                          spec.emit_raw))
            out = fn(grid, *args, **kw)
            if stop_after is not None and len(calls) == stop_after:
                tsdb._warmup_stop.set()
            return out
        return spy
    monkeypatch.setattr(pipeline, "execute_grid",
                        wrap("grid", pipeline.execute_grid))
    monkeypatch.setattr(pipeline, "execute_avg_divide",
                        wrap("avgdiv", pipeline.execute_avg_divide))
    return calls


@pytest.mark.parametrize("pct", ["true", "false"])
def test_run_warmup_runs_each_class_once(tsdbs, monkeypatch, pct):
    tt = tsdbs(**{"tsd.tpu.warmup.percentiles": pct})
    load(tt)
    calls = spy_on_tails(monkeypatch)
    ran = warmup.run_warmup(tt)
    aggs = [("sum", False), ("sum", True), ("avg", False), ("avg", True)]
    if pct == "true":
        aggs += [("p95", False), ("p99", False)]
    want = []
    for s, b, g in warmup.warmup_shapes(tt):
        want += [("grid", s, b, g, a, r, False) for a, r in aggs]
        want.append(("grid", s, b, g, "sum", False, True))
        # the sum and count tiers of 1m are resident
        want += [("avgdiv", s, b, g, a, False, False)
                 for a in ("sum", "avg")]
    assert calls == want
    assert len(set(calls)) == len(calls), "a class ran twice"
    assert ran == len(want)


def test_warmup_stop_stops_between_classes(tsdbs, monkeypatch):
    import threading
    tt = tsdbs()
    load(tt)
    tt._warmup_stop = threading.Event()
    calls = spy_on_tails(monkeypatch, stop_after=5, tsdb=tt)
    assert warmup.run_warmup(tt) == 5
    assert len(calls) == 5


def test_budget_bounds_the_run(tsdbs, monkeypatch):
    tt = tsdbs(**{"tsd.tpu.warmup.budget_s": "1"})
    load(tt)
    clock = iter(np.arange(0.0, 1e6, 0.4))
    monkeypatch.setattr(warmup.time, "monotonic", lambda: next(clock))
    spy_on_tails(monkeypatch)
    ran = warmup.run_warmup(tt)
    assert 0 < ran < 10


def test_server_runs_and_joins_the_warmup(tsdbs, monkeypatch):
    from opentsdb_tpu_torch.tsd.server import ServerThread
    tt = tsdbs()
    load(tt)
    calls = spy_on_tails(monkeypatch)
    st = ServerThread(tt).start()
    th = st.server._warmup_thread
    assert th is not None and th.name == "shape-warmup"
    th.join(60)
    st.stop()
    assert not th.is_alive()
    assert len(calls) == len(warmup.warmup_shapes(tt)) * 9
    off = tsdbs(**{"tsd.tpu.warmup": "false"})
    st = ServerThread(off).start()
    assert st.server._warmup_thread is None
    st.stop()


def test_failed_warmup_is_logged_and_switches_nothing(tsdbs, monkeypatch,
                                                       caplog):
    """A warmup that raises (here: the library load) ends its thread
    with a log line; the server serves as before, and nothing was
    switched to another path."""
    import http.client
    import json
    from opentsdb_tpu_torch.tsd.server import ServerThread

    def broken(_t):
        raise RuntimeError("no CUDA toolchain")
    monkeypatch.setattr(warmup, "load_libraries", broken)
    tt = tsdbs()
    load(tt)
    with caplog.at_level(logging.ERROR, logger="warmup"):
        st = ServerThread(tt).start()
        st.server._warmup_thread.join(60)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", st.port,
                                              timeout=30)
            conn.request("GET", f"/api/query?start={BASE}&end="
                         f"{BASE + 599}&m=sum:1m-avg:sys.cpu")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200 and body[0]["dps"]
        finally:
            st.stop()
    assert any("warmup failed" in r.getMessage() for r in caplog.records)
