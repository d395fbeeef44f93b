"""The data lifecycle on the port (``opentsdb_tpu_torch/lifecycle/``)
held against the JAX package's (``opentsdb_tpu/lifecycle/``): the same
seeded writes go into one TSDB of each package, both sweep at the same
``now``, and the sweep reports, the stores after it and the stitched
query rows are compared, on both stores. Cases mirror
``tests/test_lifecycle.py`` and ``tests/test_lifecycle_persist.py``:
policies and their 400s, ``/api/lifecycle``, retention of raw points,
tier cells and histogram arenas, demotion and the first-demotion pin,
stitched rows for ``sum``/``count``/``min``/``max``/``avg`` (and rate,
group-by, the 1h tier) and ``ROLLUP_RAW``, ``lifecycle.json`` read by
the other package, the sweep's faults and breaker, and one case on a
query mesh (``series:8`` over ``[cpu] * 8`` against the JAX package's
8 virtual devices). Queries pin ``torch_pair.ENGINE_KEYS``, so the port
answers on the point path's kernels (their plain versions on the CPU).

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|
(``torch_pair.assert_rows_close``); timestamps (the emit masks), tags
and NaN positions equal. Sweep reports' data fields are equal exactly.

ROADMAP Queue 3 item 22 is pinned here: the reference's memory store
reports the bytes its ``compact_series`` reclaims; the port's memory
store keeps no per-series buffers and reports 0, as both native stores
do.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import torch_pair  # noqa: F401 - the JAX package's private native build
from torch_pair import (ENGINE_KEYS, GRID_ON, JConfig, JQuery, JTSDB,
                        assert_rows_close, rows)

from opentsdb_tpu.core.histogram import SimpleHistogram as JHist
from opentsdb_tpu.lifecycle.policy import LifecyclePolicy as JPolicy
from opentsdb_tpu.lifecycle.policy import PolicySet as JPolicySet
from opentsdb_tpu.query.model import BadRequestError as JBadRequest
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.histogram import SimpleHistogram
from opentsdb_tpu_torch.lifecycle.policy import LifecyclePolicy, PolicySet
from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter

BASE = 1356998400
BASE_MS = BASE * 1000
SPAN_S = 7200                       # 2 h of raw data
STEP_S = 10
NOW_MS = BASE_MS + SPAN_S * 1000    # the sweep's "now"
STORES = ("memory", "native")
LC_KEYS = {"tsd.core.auto_create_metrics": "true",
           "tsd.rollups.enable": "true",
           "tsd.lifecycle.enable": "true",
           "tsd.lifecycle.demote_after": "30m",
           "tsd.lifecycle.demote_tiers": "1m,1h"}
# report fields that are clocks, not data
CLOCK_FIELDS = ("durationMs", "lastSweepDurationMs", "lastSweepTime")
CPU = torch.device("cpu")


class Pair:
    """One TSDB of each package with the same keys and writes."""

    def __init__(self, backend="memory", data_dirs=None, mesh=False,
                 **keys):
        k = {**LC_KEYS, **ENGINE_KEYS, "tsd.storage.backend": backend,
             **keys}
        jd, td = data_dirs or ("", "")
        self.jt = JTSDB(JConfig(**{**k, "tsd.tpu.platform": "cpu",
                                   "tsd.storage.data_dir": jd}))
        self.tt = TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                                 "tsd.torch.dtype": "float64",
                                 "tsd.storage.data_dir": td}),
                       **({"mesh_devices": [CPU] * 8} if mesh else {}))

    @property
    def both(self):
        return self.jt, self.tt

    def ingest(self, n_series=6, metric="sys.cpu", span_s=SPAN_S,
               seed=0, start=BASE):
        ts = np.arange(start, start + span_s, STEP_S, dtype=np.int64)
        rng = np.random.default_rng(seed)
        for i in range(n_series):
            vals = rng.normal(100, 10, len(ts))
            tags = {"host": f"h{i:02d}", "dc": f"dc{i % 3}"}
            for t in self.both:
                t.add_points(metric, ts, vals, tags)

    def sweep(self, now_ms=NOW_MS):
        reports = [t.lifecycle.sweep(now_ms=now_ms) for t in self.both]
        for r in reports:
            for f in CLOCK_FIELDS:
                r.pop(f, None)
        return reports

    def run(self, query: dict):
        want = rows(self.jt.execute_query(
            JQuery.from_json(query).validate()))
        got = rows(self.tt.execute_query(
            TSQuery.from_json(query).validate()))
        return got, want

    def shutdown(self):
        for t in self.both:
            t.shutdown()


def q(ds="1m-sum", agg="sum", start=BASE_MS, end=NOW_MS, gb="dc",
      **extra):
    sub = {"metric": "sys.cpu", "aggregator": agg, "downsample": ds,
           **extra}
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb, "filter": "*",
                           "groupBy": True}]
    return {"start": start, "end": end, "queries": [sub]}


@pytest.fixture(scope="module", params=STORES)
def demoted(request):
    """A demoted pair on each store: 6 series x 2 h at 10 s, swept at
    ``NOW_MS`` (boundary 1 h: the first hour lives in the 1m and 1h
    tiers)."""
    p = Pair(request.param)
    p.ingest()
    p.reports = p.sweep()
    yield p
    p.shutdown()


# -- policies ----------------------------------------------------------------

POLICY_CONFIGS = [
    {},
    {"tsd.lifecycle.retention": "90d", "tsd.lifecycle.demote_after": "6h",
     "tsd.lifecycle.demote_tiers": "1m,1h",
     "tsd.lifecycle.policy.sys.cpu.retention": "30d",
     "tsd.lifecycle.policy.sys.cpu.demote_after": "1h"},
    {"tsd.lifecycle.demote_after": "1h", "tsd.lifecycle.spill_after": "2d",
     "tsd.lifecycle.policy.a.b.c.retention": "7d"},
]


@pytest.mark.parametrize("keys", POLICY_CONFIGS)
def test_policies_from_config_equal_reference(keys):
    got = PolicySet.from_config(Config(**keys))
    want = JPolicySet.from_config(JConfig(**keys))
    assert got.to_json() == want.to_json()
    for metric in ("sys.cpu", "a.b.c", "other"):
        g, w = got.for_metric(metric), want.for_metric(metric)
        assert (g is None) == (w is None)
        if g is not None:
            assert g.to_json() == w.to_json()


BAD_POLICIES = [
    {"metric": "m", "retention": "1h", "demoteAfter": "2h"},
    {"metric": "m", "retention": "bogus"},
    {"retention": "1h"},
    {"metric": "m", "spillAfter": "1d"},
    {"metric": "m", "demoteAfter": "2h", "spillAfter": "1h"},
    {"metric": "m", "retention": "1d", "demoteAfter": "1h",
     "spillAfter": "2d"},
    {"metric": "m", "demoteTiers": [1, 2]},
    "not an object",
]


@pytest.mark.parametrize("body", BAD_POLICIES)
def test_invalid_policy_400_as_reference(body):
    with pytest.raises(JBadRequest) as want:
        JPolicy.from_json(body)
    with pytest.raises(BadRequestError) as got:
        LifecyclePolicy.from_json(body)
    assert str(got.value) == str(want.value)


def _routers(p):
    return (JRouter(p.jt), JRequest), (HttpRpcRouter(p.tt), HttpRequest)


def _answer(router, cls, method, path, body=None):
    resp = router.handle(cls(method=method, path=path,
                             body=json.dumps(body).encode()
                             if body is not None else b""))
    doc = json.loads(resp.body) if resp.body else None
    if isinstance(doc, dict):
        for part in (doc, doc.get("counters") or {}):
            for f in CLOCK_FIELDS:
                part.pop(f, None)
        if isinstance(doc.get("error"), dict):
            doc["error"].pop("trace", None)
    return resp.status, doc


LIFECYCLE_REQUESTS = [
    ("GET", "/api/lifecycle", None),
    ("POST", "/api/lifecycle", {"policies": [
        {"metric": "*", "retention": "90d"},
        {"metric": "sys.cpu", "demoteAfter": "30m",
         "demoteTiers": ["1m"]}]}),
    ("PUT", "/api/lifecycle", {"policies": []}),
    ("POST", "/api/lifecycle", {"policies": [
        {"metric": "m", "retention": "1h", "demoteAfter": "2h"}]}),
    ("POST", "/api/lifecycle", {"nope": 1}),
    ("POST", "/api/lifecycle/sweep", None),
    ("GET", "/api/lifecycle/sweep", None),
    ("GET", "/api/lifecycle/other", None),
    ("DELETE", "/api/lifecycle", None),
]


@pytest.mark.parametrize("method,path,body", LIFECYCLE_REQUESTS)
def test_api_lifecycle_equals_reference(method, path, body):
    """``/api/lifecycle`` answers as the JAX router does: the status and
    the JSON document (clocks left out). On the native store, where
    neither package compacts (ROADMAP Queue 3 item 22)."""
    p = Pair("native")
    p.ingest(n_series=2, span_s=1800)
    (jr, jreq), (tr, treq) = _routers(p)
    want = _answer(jr, jreq, method, path, body)
    got = _answer(tr, treq, method, path, body)
    assert got == want
    p.shutdown()


def test_api_lifecycle_disabled_400_as_reference():
    jt = JTSDB(JConfig(**{"tsd.tpu.platform": "cpu"}))
    tt = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    want = _answer(JRouter(jt), JRequest, "GET", "/api/lifecycle")
    got = _answer(HttpRpcRouter(tt), HttpRequest, "GET", "/api/lifecycle")
    assert got == want and got[0] == 400


# -- the sweep ---------------------------------------------------------------

def test_demotion_report_equals_reference(demoted):
    got, want = demoted.reports[1], demoted.reports[0]
    assert want["demoted"] > 0 and want["tierPointsWritten"] > 0
    if demoted.tt.store.backend == "memory":
        # ROADMAP Queue 3 item 22: the reference's memory store reports
        # what compact_series reclaimed; the port's has no such buffers
        assert want["bytesReclaimed"] > 0 and got["bytesReclaimed"] == 0
        want = {**want, "bytesReclaimed": 0}
    assert got == want
    for t in demoted.both:
        mid = t.uids.metrics.get_id("sys.cpu")
        assert t.lifecycle.demote_boundary(mid) == BASE_MS + 3600_000


def test_demoted_stores_hold_the_same_points(demoted):
    jt, tt = demoted.both
    counts = []
    for t in (jt, tt):
        mid = t.uids.metrics.get_id("sys.cpu")
        per = [int(t.store.count_range(t.store.series_ids_for_metric(mid),
                                       1, NOW_MS).sum())]
        for iv in ("1m", "1h"):
            for agg in ("sum", "count", "min", "max"):
                st = t.rollup_store.tier(iv, agg)
                per.append(int(st.count_range(
                    st.series_ids_for_metric(mid), 1, NOW_MS).sum()))
        counts.append(per)
    assert counts[0] == counts[1]
    assert counts[1][0] == 6 * 360      # the raw tail: 1 h at 10 s


@pytest.mark.parametrize("ds,agg,extra", [
    ("1m-sum", "sum", {}), ("1m-count", "sum", {}), ("1m-min", "min", {}),
    ("1m-max", "max", {}), ("1m-avg", "avg", {}), ("1h-sum", "sum", {}),
    ("5m-avg", "sum", {"rate": True}), ("1m-sum", "sum",
                                        {"rollupUsage": "ROLLUP_RAW"})])
def test_stitched_rows_equal_reference(demoted, ds, agg, extra):
    got, want = demoted.run(q(ds, agg, **extra))
    assert_rows_close(got, want)
    first = min(min(r[3]) for r in got)
    if extra.get("rollupUsage") == "ROLLUP_RAW":
        # raw only: nothing before the boundary
        assert first >= BASE_MS + 3600_000 - 60_000
    elif not extra.get("rate"):
        assert first == BASE_MS


@pytest.mark.parametrize("start,end", [
    (BASE_MS, BASE_MS + 1800_000),                     # tier only
    (BASE_MS + 3600_000, NOW_MS),                      # raw only
    (BASE_MS + 1800_000, BASE_MS + 5400_000)])         # across
def test_stitched_windows_equal_reference(demoted, start, end):
    got, want = demoted.run(q("1m-sum", start=start, end=end))
    assert_rows_close(got, want)


@pytest.mark.parametrize("gb,kernel", [("dc", "span"),
                                       ("host", "onehot")])
def test_stitched_history_takes_the_point_kernels(demoted, monkeypatch,
                                                  gb, kernel):
    """A tier-eligible query over the demoted history reads the stitched
    view through the point path's fused wrappers (their plain versions
    on the CPU): one cell per bucket is the regular layout they take.
    ``{dc=*}`` (group-sorted spans) reaches ``span_reduce`` (K1), a
    group per series with ``tsd.query.span_max`` 0 reaches
    ``onehot_reduce`` (K2). A window across the boundary holds one cell
    per bucket before it and six raw points per bucket after it: that
    batch is irregular and takes the padded path, in both packages."""
    calls = {"span": 0, "onehot": 0}
    real_span, real_onehot = fused.span_reduce, fused.onehot_reduce

    def span(*a, **k):
        calls["span"] += 1
        return real_span(*a, **k)

    def onehot(*a, **k):
        calls["onehot"] += 1
        return real_onehot(*a, **k)
    monkeypatch.setattr(fused, "span_reduce", span)
    monkeypatch.setattr(fused, "onehot_reduce", onehot)
    if kernel == "onehot":
        monkeypatch.setattr(fused, "SPAN_MAX", 0, raising=False)
    got, want = demoted.run(q("1m-sum", gb=gb,
                              end=BASE_MS + 3600_000 - 1))
    assert_rows_close(got, want)
    assert calls[kernel] == 1, calls
    got, want = demoted.run(q("1m-sum", gb=gb))
    assert_rows_close(got, want)
    assert calls[kernel] == 1, calls


def test_stitched_view_is_selected_and_versioned(demoted):
    """The engine selects the lifecycle's stitched view for a tier
    sub-query; its version holds the tier, the cold part and both
    boundaries, and a write to the raw tail changes it."""
    from opentsdb_tpu_torch.lifecycle.stitch import StitchedStore
    from opentsdb_tpu_torch.query.engine import QueryEngine
    tt = demoted.tt
    sub = TSQuery.from_json(q()).validate().queries[0]
    store = QueryEngine(tt)._select_store(sub)[0]
    assert isinstance(store, StitchedStore)
    v0 = store.version
    assert v0[-2:] == (BASE_MS + 3600_000, 0)
    tt.add_point("sys.cpu", BASE + SPAN_S + 5, 1.0,
                 {"host": "h00", "dc": "dc0"})
    demoted.jt.add_point("sys.cpu", BASE + SPAN_S + 5, 1.0,
                         {"host": "h00", "dc": "dc0"})
    assert QueryEngine(tt)._select_store(sub)[0].version != v0


def test_grid_path_stitched_rows_equal_reference():
    p = Pair("native", **GRID_ON)
    p.ingest(n_series=4)
    p.sweep()
    for ds, agg in (("1m-sum", "sum"), ("1m-avg", "avg"),
                    ("1m-count", "sum")):
        got, want = p.run(q(ds, agg))
        assert_rows_close(got, want)
    p.shutdown()


def test_first_demotion_in_flight_pins_raw():
    """While a first demotion is mid-flight (tier cells written, no
    boundary yet) the engine reads raw, in both packages."""
    p = Pair()
    p.ingest(n_series=2)
    for t in p.both:
        mid = t.uids.metrics.get_id("sys.cpu")
        t.add_aggregate_point("sys.cpu", BASE, 1.0,
                              {"host": "h00", "dc": "dc0"}, False, "1m",
                              "SUM")
        with t.lifecycle._lock:
            t.lifecycle._first_demotions.add(mid)
        assert t.lifecycle.first_demotion_in_flight(mid)
    got, want = p.run(q(gb="host"))
    raw_got, raw_want = p.run(q(gb="host", rollupUsage="ROLLUP_RAW"))
    assert_rows_close(got, want)
    assert_rows_close(got, raw_got)
    p.shutdown()


def test_retention_report_and_stores_equal_reference():
    p = Pair(**{"tsd.lifecycle.retention": "1h",
                "tsd.lifecycle.demote_after": ""})
    p.ingest(n_series=3)
    for t in p.both:
        cutoff = NOW_MS - 3600_000
        cell = (cutoff - 1800_000) // 3600_000 * 3600_000
        for ts in (cell, cell - 7200_000):
            t.add_aggregate_point("sys.cpu", ts // 1000, 9.0,
                                  {"host": "h00", "dc": "dc0"}, False,
                                  "1h", "SUM")
    jr, tr = p.sweep()
    assert tr == {**jr, "bytesReclaimed": 0} and jr["purged"] > 0
    for ds in ("1m-sum", "1h-sum"):
        got, want = p.run(q(ds))
        assert_rows_close(got, want)
    for t in p.both:
        tier = t.rollup_store.tier("1h", "sum")
        tsids = tier.series_ids_for_metric(t.uids.metrics.get_id("sys.cpu"))
        b = tier.materialize(tsids, 0, NOW_MS)
        assert b.ts_ms.tolist() == [(NOW_MS - 5400_000) // 3600_000
                                    * 3600_000]
    assert [t.lifecycle.scan_expired(now_ms=NOW_MS + 600_000)
            for t in p.both][0] == \
        p.tt.lifecycle.scan_expired(now_ms=NOW_MS + 600_000)
    p.shutdown()


def _hist_pair(n=120):
    p = Pair(**{"tsd.lifecycle.retention": "1h",
                "tsd.lifecycle.demote_after": ""})
    for t, cls in zip(p.both, (JHist, SimpleHistogram)):
        for i in range(n):
            h = cls([0.0, 1.0, 2.0, 4.0])
            h.add(1.5, i + 1)
            t.add_histogram_point("lat.h", BASE + i * 60,
                                  t.histogram_manager.encode(h),
                                  {"host": "a"})
    return p


def test_histogram_retention_equals_reference():
    p = _hist_pair()
    vers = [t._histogram_version for t in p.both]
    jr, tr = p.sweep()
    assert tr == {**jr, "bytesReclaimed": 0}
    assert jr["histogramPurged"] == 60
    for t, v in zip(p.both, vers):
        assert t._histogram_version > v
        arena = t._histogram_arenas[t.uids.metrics.get_id("lat.h")]
        assert arena.total_points == 60
    got, want = p.run({"start": BASE_MS, "end": NOW_MS, "queries": [
        {"metric": "lat.h", "aggregator": "sum", "percentiles": [50, 99]}]})
    assert_rows_close(got, want)
    p.shutdown()
    p = _hist_pair(n=10)     # every point behind the TTL
    p.sweep()
    for t in p.both:
        assert t.uids.metrics.get_id("lat.h") not in t._histogram_arenas
    p.shutdown()


@pytest.mark.parametrize("site", ["lifecycle.sweep", "lifecycle.demote",
                                  "lifecycle.histogram"])
def test_sweep_faults_equal_reference(site):
    """An armed lifecycle site fails the sweep (counted, the breaker
    trips at its threshold), leaves raw intact and no boundary, and the
    next sweep after disarming demotes, in both packages."""
    p = Pair(**{"tsd.lifecycle.retention": "3h",
                "tsd.lifecycle.breaker.failure_threshold": "2"})
    p.ingest(n_series=2)
    for t in p.both:
        t.faults.arm(site, error_rate=1.0)
    reps = [p.sweep(), p.sweep(), p.sweep()]
    for jr, tr in reps:
        assert tr == jr
    assert reps[0][0]["error"].startswith("InjectedFault")
    assert reps[2][0]["skipped"] == "breaker open"
    for t in p.both:
        assert t.lifecycle.sweep_errors == 2
        assert t.lifecycle.breaker.state == "open"
        mid = t.uids.metrics.get_id("sys.cpu")
        assert t.lifecycle.demote_boundary(mid) == 0
        assert int(t.store.count_range(t.store.series_ids_for_metric(mid),
                                       1, NOW_MS).sum()) == 2 * 720
        t.faults.disarm()
        t.lifecycle.breaker = None
    jr, tr = p.sweep()
    assert tr == {**jr, "bytesReclaimed": 0} and jr["demoted"] > 0
    p.shutdown()


# -- persistence -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lifecycle_json_is_read_by_the_other_package(tmp_path, writer):
    """A data_dir swept by one package (snapshot, WAL, ``lifecycle.json``)
    restarts in the other with the same demotion boundary and the same
    stitched rows."""
    d = str(tmp_path / "d")
    p = Pair("native", data_dirs=(d, "") if writer == "jax" else ("", d))
    p.ingest(n_series=3)
    p.sweep()
    src = p.jt if writer == "jax" else p.tt
    want_rows = p.run(q())[0 if writer == "port" else 1]
    src.shutdown()
    doc = json.load(open(os.path.join(d, "lifecycle.json")))
    assert doc == {"boundaries": {"sys.cpu": BASE_MS + 3600_000}}
    keys = {**LC_KEYS, **ENGINE_KEYS, "tsd.storage.backend": "native",
            "tsd.storage.data_dir": d}
    other = TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                           "tsd.torch.dtype": "float64"})) \
        if writer == "jax" else \
        JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"}))
    mid = other.uids.metrics.get_id("sys.cpu")
    assert other.lifecycle.demote_boundary(mid) == BASE_MS + 3600_000
    model = TSQuery if isinstance(other, TSDB) else JQuery
    assert_rows_close(rows(other.execute_query(
        model.from_json(q()).validate())), want_rows)
    other.shutdown()
    (p.tt if writer == "jax" else p.jt).shutdown()


def test_replay_after_sweep_does_not_resurrect(tmp_path):
    """(ref: ``tests/test_lifecycle_persist.py``) The sweep flushes a
    snapshot and truncates the WAL: a restart serves the demoted state,
    not the purged raw points, in both packages."""
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    p = Pair("native", data_dirs=(dj, dt))
    p.ingest(n_series=2)
    p.sweep()
    before = p.run(q())
    p.shutdown()
    p2 = Pair("native", data_dirs=(dj, dt))
    after = p2.run(q())
    assert_rows_close(after[0], after[1])
    assert_rows_close(after[0], before[0])
    for t in p2.both:
        mid = t.uids.metrics.get_id("sys.cpu")
        assert int(t.store.count_range(t.store.series_ids_for_metric(mid),
                                       1, BASE_MS + 3600_000 - 1).sum()) == 0
    p2.shutdown()


# -- the mesh ----------------------------------------------------------------

def test_stitched_rows_over_a_mesh_equal_reference():
    """``series:8`` over ``[cpu] * 8`` against the JAX package's 8
    virtual devices: the mesh branches read the stitched view."""
    p = Pair("native", mesh=True, **{"tsd.query.mesh": "series:8"})
    assert p.jt.query_mesh is not None
    p.ingest(n_series=16)
    p.sweep()
    for ds, agg in (("1m-sum", "sum"), ("5m-avg", "avg")):
        got, want = p.run(q(ds, agg))
        assert_rows_close(got, want)
    p.shutdown()


def test_server_starts_the_sweeper_and_shutdown_stops_it():
    """``TSDServer.start`` starts the sweeper thread at
    ``tsd.lifecycle.interval_s`` > 0 (ref: the server's start), which
    sweeps on its own; the server's stop (``TSDB.shutdown``) joins it."""
    import threading
    import time
    from opentsdb_tpu_torch.tsd.server import ServerThread
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.tpu.warmup": "false",
                       **LC_KEYS, "tsd.lifecycle.interval_s": "0.05"}))
    st = ServerThread(t, host="127.0.0.1", port=0).start()
    try:
        deadline = time.monotonic() + 10
        while t.lifecycle.sweeps < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert t.lifecycle.sweeps >= 2
        assert any(th.name == "tsd-lifecycle"
                   for th in threading.enumerate())
    finally:
        st.stop()
    assert not any(th.name == "tsd-lifecycle" and th.is_alive()
                   for th in threading.enumerate())


def test_sweep_rate_tool_times_the_sweep_with_the_fold_off_and_on():
    """``tools/sweep_rate.py`` at a few series on the CPU: each mode
    demotes the raw points before ``T0 + 2 h`` and spills the 58 1m
    cells and the one 1h cell before ``T0 + 1 h`` of every series, the
    same report with the sketch tier off and on; the fold is timed only
    when the tier is on."""
    import subprocess
    import sys
    n = 12
    tool = os.path.join(os.path.dirname(__file__), os.pardir,
                        "opentsdb_tpu_torch", "tools", "sweep_rate.py")
    proc = subprocess.run(
        [sys.executable, tool, "--series", str(n), "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True)
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = doc["modes"]
    assert (off["sketch"], on["sketch"]) == ("off", "on")
    for mode in (off, on):
        rep = mode["report"]
        assert "error" not in rep
        assert rep["demoted"] == n * (7200 - 120)
        assert rep["spilled"] == n * (58 + 1)
        assert mode["sweep_s"] >= mode["fold_s"] + mode["spill_s"]
    assert off["fold_s"] == 0.0 < on["fold_s"]
    assert {k: v for k, v in off["report"].items() if k != "durationMs"} \
        == {k: v for k, v in on["report"].items() if k != "durationMs"}
