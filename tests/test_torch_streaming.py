"""Continuous queries on the port (``opentsdb_tpu_torch/streaming/``),
held against the JAX package's (``opentsdb_tpu/streaming/``).

Each paired test does the same sequence against both packages on the
CPU (the same writes from a numpy seed, the same registrations, pulls
and SSE frames) and compares the answers; the port runs float64 and
the JAX package x64, so values agree within the reference's tolerance
(``rel=1e-9, abs=1e-9``, as ``tests/test_streaming.py``). The port's
streamed answers are also held to its own batch engine.

Besides ``tests/test_streaming.py``'s battery this file holds the tap
on every raw write path of the port, the breaker's state machine, the
``tsd.query.mesh`` check, the event stream over a socket, and the one
divergence: an exception out of the streaming tail propagates in the
port where the reference answers from its batch engine (ROADMAP
Queue 3). Every TSDB a test builds is shut down, and no
``tsd-stream-fold-*`` thread started here outlives the module.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import torch_pair  # noqa: F401 - the JAX package's private native build
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu.streaming import plan as jplan
from opentsdb_tpu.streaming.sse import sse_stream as jsse_stream
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu.utils.faults import CircuitBreaker as JBreaker
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.streaming import plan as tplan
from opentsdb_tpu_torch.streaming.sse import sse_stream
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from opentsdb_tpu_torch.utils.faults import CircuitBreaker

BASE = 1356998400
BASE_MS = BASE * 1000
IV_MS = 60_000               # 1m downsample interval
RANGE_S = 1800               # 30m window
END_MS = BASE_MS + RANGE_S * 1000

J_KEYS = {"tsd.core.auto_create_metrics": "true",
          "tsd.tpu.platform": "cpu"}
T_KEYS = {"tsd.core.auto_create_metrics": "true",
          "tsd.torch.device": "cpu", "tsd.torch.dtype": "float64"}


@pytest.fixture(autouse=True, scope="module")
def no_fold_thread_survives():
    """No ``tsd-stream-fold-*`` thread started while the module ran is
    alive after it (threads other test files leaked are not counted:
    the JAX package's own streaming tests do not shut their TSDBs
    down)."""
    before = set(threading.enumerate())
    yield
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()
            and t.name.startswith("tsd-stream-fold-")]
    assert not left, f"fold workers outlived their TSDBs: {left}"


class Pair:
    """One TSDB of each package with the same keys."""

    def __init__(self, made: list, **extra):
        self.jt = JTSDB(JConfig(**{**J_KEYS, **extra}))
        made.append(self.jt)
        self.tt = TSDB(Config(**{**T_KEYS, **extra}))
        made.append(self.tt)

    @property
    def both(self):
        return (self.jt, self.tt)


@pytest.fixture
def pair():
    """``pair(**keys)`` -> :class:`Pair`; every TSDB made is shut down
    (joining its fold workers) when the test ends."""
    made: list = []
    yield lambda **extra: Pair(made, **extra)
    for t in made:
        t.shutdown()


@pytest.fixture
def port():
    """``port(**keys)`` -> a port TSDB, shut down when the test ends."""
    made: list = []

    def make(**extra):
        t = TSDB(Config(**{**T_KEYS, **extra}))
        made.append(t)
        return t
    yield make
    for t in made:
        t.shutdown()


def is_port(t) -> bool:
    return isinstance(t, TSDB)


def qobj(agg="sum", ds="1m-sum", rate=False, gb=None, start=BASE_MS,
         end=END_MS, metric="s.m", window=None, watermark=None):
    sub = {"metric": metric, "aggregator": agg, "downsample": ds}
    if rate:
        sub["rate"] = True
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb,
                           "filter": "*", "groupBy": True}]
    q = {"start": start, "queries": [sub]}
    if end is not None:
        q["end"] = end
    if window:
        q["window"] = window
    if watermark:
        q["watermark"] = watermark
    return q


SERIES = [
    {"host": "h0", "dc": "east"},
    {"host": "h1", "dc": "east"},
    {"host": "h2", "dc": "west"},
    {"host": "h3", "dc": "west"},
]


def ingest(t, tags_list, t0_s, n, step_s=20, seed=0, metric="s.m"):
    rng = np.random.default_rng(seed)
    for i, tags in enumerate(tags_list):
        ts = np.arange(t0_s, t0_s + n * step_s, step_s,
                       dtype=np.int64) + (i % 3)
        vals = rng.normal(50.0 + 10 * i, 5.0, len(ts))
        if i == 1:
            # one gappy series exercises interpolation / fill
            ts, vals = ts[::2], vals[::2]
        t.add_points(metric, ts, vals, tags)


def register(t, q, now_ms=END_MS, cid=None):
    obj = dict(q)
    if cid:
        obj["id"] = cid
    return t.streaming.register(obj, now_ms=now_ms)


def run(t, q):
    model = TSQuery if is_port(t) else JQuery
    return t.execute_query(model.from_json(q).validate())


def run_batch(t, q):
    """The batch engine with the streaming lookup and the result cache
    off."""
    t.config.override_config("tsd.streaming.serve", "false")
    t.config.override_config("tsd.query.cache.enable", "false")
    try:
        return run(t, q)
    finally:
        t.config.override_config("tsd.streaming.serve", "true")
        t.config.override_config("tsd.query.cache.enable", "true")


def as_map(results):
    out = {}
    for r in results:
        key = (r.metric, tuple(sorted(r.tags.items())),
               tuple(sorted(r.aggregated_tags)))
        assert key not in out
        out[key] = dict(r.dps)
    return out


def assert_value_identical(got, want):
    """The same groups and timestamps; values within rel=1e-9,
    abs=1e-9, NaN where NaN (ref: ``_assert_value_identical``)."""
    gm, wm = as_map(got), as_map(want)
    assert gm.keys() == wm.keys()
    for key in gm:
        dg, dw = gm[key], wm[key]
        assert set(dg) == set(dw), key
        for ts in dg:
            va, vb = dg[ts], dw[ts]
            if va != va and vb != vb:
                continue
            assert va == pytest.approx(vb, rel=1e-9, abs=1e-9), \
                (key, ts, va, vb)


def assert_rows_equal(got: list, want: list):
    """``/result`` rows (or SSE updates) of the two packages: the same
    series and timestamps, values within the tolerance."""
    def key(row):
        return (row.get("metric"), sorted((row.get("tags") or {}).items()))
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [key(r) for r in got] == [key(r) for r in want]
    for g, w in zip(got, want):
        if "completeness" in w:
            assert g == w
            continue
        assert set(g["dps"]) == set(w["dps"]), key(w)
        for ts, vb in w["dps"].items():
            va = g["dps"][ts]
            if vb is None or va is None:
                assert va is vb is None, (ts, va, vb)
            else:
                assert va == pytest.approx(vb, rel=1e-9, abs=1e-9)


def events(frames: bytes) -> list[tuple[str, dict]]:
    out = []
    for block in frames.decode().split("\n\n"):
        lines = [ln for ln in block.strip().splitlines()
                 if ln and not ln.startswith(":")]
        ev = data = None
        for ln in lines:
            if ln.startswith("event: "):
                ev = ln[7:]
            elif ln.startswith("data: "):
                data = json.loads(ln[6:])
        if ev:
            out.append((ev, data))
    return out


def events_with_ids(frames: bytes):
    out = []
    for block in frames.decode().split("\n\n"):
        ev = data = eid = None
        for ln in block.strip().splitlines():
            if ln.startswith("event: "):
                ev = ln[7:]
            elif ln.startswith("data: "):
                data = json.loads(ln[6:])
            elif ln.startswith("id: "):
                eid = int(ln[4:])
        if ev:
            out.append((ev, eid, data))
    return out


def router_of(t):
    return HttpRpcRouter(t) if is_port(t) else JRouter(t)


def request(t, method, path, body=None, headers=None):
    cls = HttpRequest if is_port(t) else JRequest
    return cls(method=method, path=path, headers=headers or {},
               body=json.dumps(body).encode() if body is not None
               else b"")


def sse_of(t):
    return sse_stream if is_port(t) else jsse_stream


# -- the batch-equivalence battery (ref: tests/test_streaming.py CASES) --

CASES = [
    ("sum", "1m-avg", False, None),
    ("avg", "1m-sum", False, "host"),
    ("min", "1m-max", False, None),
    ("max", "1m-min", False, "host"),
    ("count", "1m-count", False, None),
    ("dev", "1m-avg", False, "host"),
    ("sum", "2m-sum", False, "dc"),
    ("sum", "1m-sum", True, None),
    ("avg", "1m-avg", True, "host"),
    ("mimmax", "1m-max", False, None),
    ("zimsum", "1m-sum", False, "host"),
    ("none", "1m-avg", False, None),
]


@pytest.mark.parametrize("agg,ds,rate,gb", CASES)
def test_matches_batch(pair, agg, ds, rate, gb):
    """Half the data before registration (the bootstrap scan), half
    after with a series the plan has never seen (membership growth
    through the tap): the port's pull is served from the maintained
    windows, equals the JAX package's streamed answer and the port's
    own batch answer."""
    p = pair()
    q = qobj(agg=agg, ds=ds, rate=rate, gb=gb)
    streamed = []
    for t in p.both:
        ingest(t, SERIES[:3], BASE, 40, seed=1)
        register(t, q)
        ingest(t, SERIES, BASE + 900, 40, seed=2)
        hits0 = t.streaming.serve_hits
        streamed.append(run(t, q))
        assert t.streaming.serve_hits == hits0 + 1, \
            "query was not served from the maintained windows"
    assert streamed[1], "empty result would be a vacuous pass"
    assert_value_identical(streamed[1], streamed[0])
    assert_value_identical(streamed[1], run_batch(p.tt, q))


def test_matches_independent_oracle(port):
    """The port's streamed answer against ``tests/oracle.py``, which
    shares no code with either engine."""
    from oracle import run_oracle
    t = port()
    ingest(t, SERIES[:2], BASE, 40, seed=3)
    q = qobj(agg="sum", ds="1m-avg")
    register(t, q)
    ingest(t, SERIES[:2], BASE + 900, 40, seed=4)
    streamed = run(t, q)
    mid = t.uids.metrics.get_id("s.m")
    sids = t.store.series_ids_for_metric(mid)
    batch = t.store.materialize(sids, 0, 2**62)
    series = [(batch.ts_ms[batch.series_idx == i],
               batch.values[batch.series_idx == i])
              for i in range(len(sids))]
    expected = run_oracle(series, "sum", IV_MS, "avg", BASE_MS, END_MS)
    got = dict(streamed[0].dps)
    assert set(got) == set(expected)
    for ts, v in expected.items():
        assert got[ts] == pytest.approx(v, rel=1e-9), ts


def test_fold_batches_equal_point_writes(pair):
    """Bulk taps and single-point taps fold to the same partials."""
    p = pair()
    q = qobj()
    out = []
    for t in p.both:
        register(t, q)
        ts = np.arange(BASE, BASE + 600, 30, dtype=np.int64)
        vals = np.linspace(1.0, 20.0, len(ts))
        t.add_points("s.m", ts, vals, {"host": "bulk"})
        for ts_i, v in zip(ts.tolist(), vals.tolist()):
            t.add_point("s.m", int(ts_i), float(v), {"host": "single"})
        out.append(run(t, q))
    assert_value_identical(out[1], out[0])
    assert_value_identical(out[1], run_batch(p.tt, q))


# -- the pull path ---------------------------------------------------------

def test_fresh_under_sustained_ingest(pair):
    p = pair()
    q = qobj(agg="sum", ds="1m-sum")
    totals = []
    for t in p.both:
        ingest(t, SERIES[:2], BASE, 20, seed=5)
        register(t, q)
        last, seen = None, []
        for round_i in range(5):
            t.add_point("s.m", BASE + 1000 + round_i, 100.0,
                        {"host": "h0"})
            res = run(t, q)
            total = sum(v for _, v in res[0].dps if v == v)
            if last is not None:
                assert total == pytest.approx(last + 100.0), \
                    "refresh did not observe the acknowledged write"
            last = total
            seen.append(total)
        assert t.streaming.serve_hits == 5
        totals.append(seen)
    assert totals[1] == pytest.approx(totals[0], rel=1e-9)


def test_relative_window_serves(pair):
    """The live-dashboard shape: start=30m-ago, end=now."""
    p = pair()
    now_s = int(time.time())
    q = qobj(start="30m-ago", end=None)
    for t in p.both:
        t0 = now_s - 1500
        ts = np.arange(t0, now_s - 10, 30, dtype=np.int64)
        t.add_points("s.m", ts, np.ones(len(ts)), {"host": "h0"})
        register(t, q, now_ms=int(time.time() * 1000))
        res = run(t, q)
        assert t.streaming.serve_hits == 1
        assert res and res[0].num_dps > 0
        t.add_point("s.m", now_s, 1.0, {"host": "h0"})
        res2 = run(t, q)
        assert t.streaming.serve_hits == 2
        assert sum(v for _, v in res2[0].dps) == \
            pytest.approx(sum(v for _, v in res[0].dps) + 1.0)


@pytest.mark.parametrize("start,end", [
    (BASE_MS + 1, END_MS - IV_MS),                  # unaligned start
    (BASE_MS - 86_400_000, BASE_MS - 82_800_000),   # outside horizon
])
def test_window_it_cannot_serve_sheds_to_batch(pair, start, end):
    """A mid-bucket start or a window outside the horizon is not
    served from the windows; the batch engine answers it, on both."""
    p = pair()
    off = qobj(start=start, end=end)
    answers = []
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 20, seed=6)
        register(t, qobj())
        answers.append(run(t, off))
        assert t.streaming.serve_hits == 0
    if answers[0]:
        assert_value_identical(answers[1], answers[0])
    else:
        assert answers[1] == []


def test_unaligned_end_past_the_newest_point_sheds(pair):
    """An absolute window whose end is not on a bucket edge is served
    only while nothing newer than the end has folded."""
    p = pair()
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 20, seed=7)
        register(t, qobj())
        t.add_point("s.m", BASE + 1000, 1.0, {"host": "h0"})
        fb0 = t.streaming.serve_fallbacks
        run(t, qobj(end=BASE_MS + 600_000 + 30_000))
        assert t.streaming.serve_hits == 0
        assert t.streaming.serve_fallbacks == fb0 + 1


def test_delete_invalidates_maintained_windows(pair):
    """Partials cannot unfold removed points: a ``delete=true`` query
    bumps the store's mutation epoch and the next pull rebuilds before
    serving (as the reference test)."""
    p = pair()
    q = qobj(agg="sum", ds="1m-sum")
    after = []
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 20, seed=12)
        register(t, q)
        before = run(t, q)
        assert t.streaming.serve_hits == 1
        dq = qobj(start=BASE_MS, end=BASE_MS + 300_000)
        dq["delete"] = True
        run(t, dq)
        after.append(run(t, q))
        assert t.streaming.rebuilds == 1
        assert t.streaming.serve_hits == 2
        assert sum(v for _, v in after[-1][0].dps) < \
            sum(v for _, v in before[0].dps)
    assert_value_identical(after[1], after[0])
    assert_value_identical(after[1], run_batch(p.tt, q))


def test_drop_caches_forces_rebuild(pair):
    p = pair()
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 20, seed=13)
        register(t, qobj())
        t.drop_caches()
        run(t, qobj())
        assert t.streaming.rebuilds == 1
        assert t.streaming.serve_hits == 1


def test_same_identity_survivor_keeps_serving_after_delete(pair):
    p = pair()
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 10, seed=14)
        register(t, qobj(), cid="a")
        register(t, qobj(), cid="b")
        run(t, qobj())
        assert t.streaming.serve_hits == 1
        assert t.streaming.delete("a")
        run(t, qobj())
        assert t.streaming.serve_hits == 2, \
            "surviving same-identity query lost the pull path"


def test_delete_query_never_reaches_streaming(pair):
    """Both packages run a ``delete=true`` query past the streaming
    lookup: the batch engine answers it (the same rows in both) and
    deletes what it read, so the next pull rebuilds and finds nothing
    of the window."""
    p = pair(**{"tsd.http.query.allow_delete": "true"})
    q = dict(qobj())
    q["delete"] = True
    answers, pulls = [], []
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 20, seed=8)
        register(t, qobj())
        answers.append(run(t, q))
        assert t.streaming.serve_hits == 0
        pulls.append(run(t, qobj()))
        assert t.streaming.rebuilds == 1
    assert_value_identical(answers[1], answers[0])
    assert answers[0] and not pulls[0] and not pulls[1]


def test_streaming_hit_in_query_stats(port):
    """``/api/query`` answered from the windows records streamingHit
    in its QueryStats."""
    from opentsdb_tpu_torch.stats.stats import QueryStat, QueryStats
    t = port()
    ingest(t, SERIES[:2], BASE, 20, seed=15)
    register(t, qobj())
    tsq = TSQuery.from_json(qobj()).validate()
    stats = QueryStats("test", tsq)
    t.new_query().run(tsq, stats)
    stats.mark_complete()
    assert stats.stats.get(QueryStat.STREAMING_HIT.value) == 1


# -- the HTTP surface -------------------------------------------------------

def test_register_list_get_delete(pair):
    p = pair()
    docs = []
    for t in p.both:
        r = router_of(t)
        resp = r.handle(request(t, "POST", "/api/query/continuous",
                                qobj()))
        assert resp.status == 200
        cid = json.loads(resp.body)["id"]
        resp = r.handle(request(t, "GET", "/api/query/continuous"))
        assert resp.status == 200
        assert [c["id"] for c in json.loads(resp.body)] == [cid]
        resp = r.handle(request(t, "GET",
                                f"/api/query/continuous/{cid}"))
        assert resp.status == 200
        doc = json.loads(resp.body)
        assert doc["intervalMs"] == [IV_MS] and "plans" in doc
        docs.append(doc)
        resp = r.handle(request(t, "DELETE",
                                f"/api/query/continuous/{cid}"))
        assert resp.status == 204
        resp = r.handle(request(t, "DELETE",
                                f"/api/query/continuous/{cid}"))
        assert resp.status == 404
    for k in ("id", "query", "intervalMs", "windows", "series",
              "windowSpec", "sharedPlan", "foldBytes"):
        assert docs[1][k] == docs[0][k], k
    # the port has no lifecycle: its plan info leaves out the
    # reference's seedBoundaryMs, and says the rest alike
    jplan_info, tplan_info = docs[0]["plans"][0], docs[1]["plans"][0]
    jplan_info.pop("seedBoundaryMs")
    assert tplan_info == jplan_info


@pytest.mark.parametrize("breakage", [
    "no-downsample", "run-all", "not-decomposable", "pct-sliding",
    "explicit-tags", "delete"])
def test_unmaintainable_queries_400(pair, breakage):
    p = pair()
    q = qobj()
    sub = q["queries"][0]
    if breakage == "no-downsample":
        sub.pop("downsample")
    elif breakage == "run-all":
        sub["downsample"] = "0all-sum"
    elif breakage == "not-decomposable":
        sub["downsample"] = "1m-p95"
    elif breakage == "pct-sliding":
        sub["percentiles"] = [99.0]
        q["window"] = {"type": "sliding", "size": "5m"}
    elif breakage == "explicit-tags":
        sub["explicitTags"] = True
    else:
        q["delete"] = True
    bodies = []
    for t in p.both:
        resp = router_of(t).handle(request(
            t, "POST", "/api/query/continuous", q))
        assert resp.status == 400
        bodies.append(resp.body)
    assert bodies[1] == bodies[0]


def test_stats_export(pair):
    p = pair()
    for t in p.both:
        r = router_of(t)
        r.handle(request(t, "POST", "/api/query/continuous", qobj()))
        ingest(t, SERIES[:1], BASE, 10, seed=9)
        run(t, qobj())
        resp = r.handle(request(t, "GET", "/api/stats"))
        stats = {(s["metric"], tuple(sorted(s["tags"].items()))):
                 s["value"] for s in json.loads(resp.body)}
        assert stats[("tsd.streaming.queries", ())] == 1
        assert stats[("tsd.streaming.serve.hits", ())] == 1
        assert ("tsd.breaker.state", (("breaker", "stream.fold"),)) \
            in stats
        health = t.streaming.health_info()
        assert health["queries"] == 1 and health["serve_hits"] == 1
        assert health["breaker"]["state"] == "closed"


def test_disabled_registry_400(pair):
    p = pair(**{"tsd.streaming.enable": "false"})
    bodies = []
    for t in p.both:
        assert t.streaming is None
        resp = router_of(t).handle(request(
            t, "POST", "/api/query/continuous", qobj()))
        assert resp.status == 400
        bodies.append(resp.body)
    assert bodies[1] == bodies[0]


def test_unknown_ids_404(pair):
    p = pair()
    for t in p.both:
        r = router_of(t)
        for path in ("nope", "nope/result", "nope/deltas", "nope/stream"):
            resp = r.handle(request(t, "GET",
                                    f"/api/query/continuous/{path}"))
            assert resp.status == 404, path


# -- SSE push -----------------------------------------------------------------

def sse_setup(pair, **extra):
    p = pair(**{"tsd.streaming.heartbeat_s": "0.05", **extra})
    cqs = []
    for t in p.both:
        ingest(t, SERIES[:2], BASE, 10, seed=10)
        cqs.append(register(t, qobj(agg="sum", ds="1m-sum")))
    return p, cqs


def test_snapshot_then_incremental_updates(pair):
    p, cqs = sse_setup(pair)
    got = []
    for t, cq in zip(p.both, cqs):
        gen = sse_of(t)(t.streaming, cq)
        assert next(gen).startswith(b"retry:")
        ev, snap = events(next(gen))[0]
        assert ev == "snapshot"
        assert snap["id"] == cq.id and snap["updates"]
        t.add_point("s.m", BASE + 700, 123.0, {"host": "h0"})
        t.streaming.flush()
        ev, data = events(next(gen))[0]
        assert ev == "windows"
        bucket = (BASE + 700) * 1000 // IV_MS * IV_MS // 1000 * 1000
        dps = data["updates"][0]["dps"]
        assert str(bucket) in dps
        assert len(dps) == 1, "emitted more than the dirty window"
        gen.close()
        assert cq.subscribers == []
        got.append((snap["updates"], data["updates"]))
    assert_rows_equal(got[1][0], got[0][0])
    assert_rows_equal(got[1][1], got[0][1])


def test_slow_consumer_is_shed(pair):
    p, cqs = sse_setup(pair, **{
        "tsd.streaming.queue_events": "2",
        "tsd.streaming.publish_min_interval_ms": "0"})
    for t, cq in zip(p.both, cqs):
        gen = sse_of(t)(t.streaming, cq)
        next(gen)   # subscribed; the consumer now stalls
        for i in range(6):
            t.add_point("s.m", BASE + 700 + i, 1.0, {"host": "h0"})
            t.streaming.flush()
        assert t.streaming.sse_shed >= 1
        assert cq.subscribers == []
        seen = []
        for fr in gen:
            seen.extend(e for e, _ in events(fr))
            if "shed" in seen:
                break
        assert "shed" in seen, "stream did not end with a shed event"


def test_delete_ends_stream(pair):
    p, cqs = sse_setup(pair)
    for t, cq in zip(p.both, cqs):
        gen = sse_of(t)(t.streaming, cq)
        next(gen)
        t.streaming.delete(cq.id)
        seen = []
        for fr in gen:
            seen.extend(e for e, _ in events(fr))
            if any(e in ("deleted", "end") for e in seen):
                break
        assert any(e in ("deleted", "end") for e in seen)


def test_http_stream_endpoint(pair):
    p, cqs = sse_setup(pair)
    for t, cq in zip(p.both, cqs):
        resp = router_of(t).handle(request(
            t, "GET", f"/api/query/continuous/{cq.id}/stream"))
        assert resp.status == 200
        assert resp.content_type.startswith("text/event-stream")
        assert resp.headers["Cache-Control"] == "no-cache"
        assert resp.close_connection
        it = iter(resp.body_iter)
        assert next(it).startswith(b"retry:")
        assert events(next(it))[0][0] == "snapshot"
        it.close()
        assert cq.subscribers == []


def resume_setup(pair, **extra):
    return sse_setup(pair, **{"tsd.streaming.publish_min_interval_ms":
                              "0", **extra})


def test_reconnect_replays_only_missed_windows(pair):
    p, cqs = resume_setup(pair)
    replayed = []
    for t, cq in zip(p.both, cqs):
        reg = t.streaming
        g1 = sse_of(t)(reg, cq)
        assert next(g1).startswith(b"retry:")
        ev, eid0, _ = events_with_ids(next(g1))[0]
        assert ev == "snapshot" and eid0 is not None
        t.add_point("s.m", BASE + 700, 3.0, {"host": "h0"})
        reg.flush()
        _, id1, _ = events_with_ids(next(g1))[0]
        t.add_point("s.m", BASE + 760, 4.0, {"host": "h0"})
        reg.flush()
        _, id2, d2 = events_with_ids(next(g1))[0]
        g1.close()
        g2 = sse_of(t)(reg, cq, last_event_id=id1)
        assert next(g2).startswith(b"retry:")
        ev, eid, data = events_with_ids(next(g2))[0]
        assert (ev, eid, data) == ("windows", id2, d2)
        assert reg.sse_resumes == 1
        g2.close()
        g3 = sse_of(t)(reg, cq, last_event_id=id2)
        assert next(g3).startswith(b"retry:")
        t.add_point("s.m", BASE + 820, 5.0, {"host": "h0"})
        reg.flush()
        ev, eid, _ = events_with_ids(next(g3))[0]
        assert ev == "windows" and eid > id2
        g3.close()
        replayed.append(d2["updates"])
    assert_rows_equal(replayed[1], replayed[0])


def test_aged_out_id_falls_back_to_snapshot(pair):
    p, cqs = resume_setup(pair, **{"tsd.streaming.resume_events": "1"})
    for t, cq in zip(p.both, cqs):
        reg = t.streaming
        g1 = sse_of(t)(reg, cq)
        next(g1)
        _, first_id, _ = events_with_ids(next(g1))[0]
        for i in range(3):
            t.add_point("s.m", BASE + 700 + i * 60, 1.0, {"host": "h0"})
            reg.flush()
        g1.close()
        g2 = sse_of(t)(reg, cq, last_event_id=first_id)
        next(g2)
        assert events_with_ids(next(g2))[0][0] == "snapshot"
        assert reg.sse_resume_snapshots >= 1
        g2.close()


def test_http_stream_honors_last_event_id_header(pair):
    p, cqs = resume_setup(pair)
    for t, cq in zip(p.both, cqs):
        reg = t.streaming
        g1 = sse_of(t)(reg, cq)
        next(g1)
        next(g1)   # the snapshot
        t.add_point("s.m", BASE + 700, 3.0, {"host": "h0"})
        reg.flush()
        _, id1, _ = events_with_ids(next(g1))[0]
        t.add_point("s.m", BASE + 760, 4.0, {"host": "h0"})
        reg.flush()
        _, id2, d2 = events_with_ids(next(g1))[0]
        g1.close()
        r = router_of(t)
        resp = r.handle(request(
            t, "GET", f"/api/query/continuous/{cq.id}/stream",
            headers={"last-event-id": str(id1)}))
        assert resp.status == 200 and resp.body_iter is not None
        it = iter(resp.body_iter)
        assert next(it).startswith(b"retry:")
        assert events_with_ids(next(it))[0] == ("windows", id2, d2)
        resp.body_iter.close()
        # a bogus id is ignored (a snapshot), never a 400
        resp = r.handle(request(
            t, "GET", f"/api/query/continuous/{cq.id}/stream",
            headers={"last-event-id": "not-a-number"}))
        assert resp.status == 200
        it = iter(resp.body_iter)
        next(it)
        assert events_with_ids(next(it))[0][0] == "snapshot"
        resp.body_iter.close()


def test_event_stream_over_a_socket(port):
    """The TSD server writes an event stream chunked, with no gzip
    even when the client accepts it, and a client that goes away
    leaves the query's subscribers; an HTTP/1.0 stream request is a
    400."""
    from opentsdb_tpu_torch.tsd.server import ServerThread
    t = port(**{"tsd.streaming.heartbeat_s": "0.05",
                "tsd.streaming.publish_min_interval_ms": "0",
                "tsd.tpu.warmup": "false"})
    ingest(t, SERIES[:2], BASE, 10, seed=16)
    cq = register(t, qobj())
    st = ServerThread(t).start()
    try:
        path = f"/api/query/continuous/{cq.id}/stream"
        with socket.create_connection(("127.0.0.1", st.port),
                                      timeout=10) as s:
            s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                      "Accept-Encoding: gzip\r\n\r\n".encode())
            buf = b""
            while b"event: snapshot" not in buf:
                chunk = s.recv(65536)
                assert chunk, buf
                buf += chunk
            head = buf.split(b"\r\n\r\n", 1)[0].decode().lower()
            assert "transfer-encoding: chunked" in head
            assert "content-encoding" not in head
            assert "text/event-stream" in head
            t.add_point("s.m", BASE + 700, 9.0, {"host": "h0"})
            while b"event: windows" not in buf:
                chunk = s.recv(65536)
                assert chunk, buf
                buf += chunk
        deadline = time.monotonic() + 10
        while cq.subscribers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert cq.subscribers == [], "a gone client stayed subscribed"
        with socket.create_connection(("127.0.0.1", st.port),
                                      timeout=10) as s:
            s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
            buf = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        assert buf.startswith(b"HTTP/1.0 400"), buf[:80]
        assert b"Event streams require HTTP/1.1" in buf
    finally:
        st.stop()


# -- the window ring ----------------------------------------------------------

def test_tumbling_evicts_and_late_points_drop(pair):
    p = pair()
    q = qobj(start=BASE_MS, end=BASE_MS + 300_000)   # 5m -> 7 windows
    for t in p.both:
        cq = register(t, q, now_ms=BASE_MS + 300_000)
        view = cq.plans[0]
        w = view.n_windows
        t.add_point("s.m", BASE + 60, 1.0, {"host": "h0"})
        # jump far past the horizon: every old window tumbles out
        t.add_point("s.m", BASE + 60 + w * 60 * 3, 2.0, {"host": "h0"})
        t.streaming.flush()
        # the original point's window is gone; a late write there drops
        t.add_point("s.m", BASE + 61, 5.0, {"host": "h0"})
        t.streaming.flush()
        assert view.late_dropped >= 1
        assert view.covered_from_ms > BASE_MS


def test_new_series_join_and_filters_apply(pair):
    p = pair()
    q = qobj(gb="host")
    q["queries"][0]["filters"].append(
        {"type": "literal_or", "tagk": "dc", "filter": "east",
         "groupBy": False})
    out = []
    for t in p.both:
        ingest(t, SERIES[:1], BASE, 10, seed=11)
        cq = register(t, q)
        view = cq.plans[0]
        assert len(view._sids) == 1
        t.add_point("s.m", BASE + 700, 1.0, {"host": "hx", "dc": "east"})
        t.add_point("s.m", BASE + 700, 1.0, {"host": "hy", "dc": "west"})
        t.streaming.flush()
        assert len(view._sids) == 2
        out.append(run(t, q))
    assert_value_identical(out[1], out[0])
    assert_value_identical(out[1], run_batch(p.tt, q))


# -- percentile continuous queries (the sketch channel) -----------------------

def pct_qobj(qs, gb=None):
    q = qobj(agg="sum", ds="1m-avg", gb=gb)
    q["queries"][0]["percentiles"] = qs
    return q


@pytest.mark.parametrize("qs,gb", [([99.0], None), ([50.0, 99.0], "dc")])
def test_percentile_pull_bit_identical(pair, qs, gb):
    """A percentile pull from the sketch channel equals the batch
    sketch path bit for bit, on each package, and the port's equals
    the JAX package's."""
    p = pair()
    q = pct_qobj(qs, gb)
    streamed = []
    for t in p.both:
        ingest(t, SERIES[:3], BASE, 40, seed=3)
        register(t, q)
        ingest(t, SERIES, BASE + 900, 40, seed=4)
        hits0 = t.streaming.serve_hits
        out = run(t, q)
        assert t.streaming.serve_hits == hits0 + 1
        assert {r.metric for r in out} == {f"s.m_pct_{x:g}" for x in qs}
        batch = run_batch(t, q)
        assert as_map(out) == as_map(batch)
        streamed.append(out)
    assert_value_identical(streamed[1], streamed[0])


def test_describe_round_trips_percentiles(pair):
    p = pair()
    for t in p.both:
        cq = register(t, pct_qobj([50.0, 99.0]))
        sub = cq.describe()["query"]["queries"][0]
        assert sub["percentiles"] == [50.0, 99.0]
        model = TSQuery if is_port(t) else JQuery
        reborn = model.from_json(cq.describe()["query"]).validate(END_MS)
        assert tuple(reborn.queries[0].percentiles) == (50.0, 99.0)


def test_disabled_sketch_registry_400(port):
    t = port(**{"tsd.sketch.enable": "false"})
    with pytest.raises(BadRequestError):
        register(t, pct_qobj([99.0]))


# -- the tap on every raw write path ------------------------------------------

WRITE_PATHS = [(path, backend)
               for path in ("add_point", "add_points", "add_point_groups",
                            "add_series_points", "import_buffer")
               for backend in ("native", "memory")
               if not (path == "import_buffer" and backend == "memory")]


@pytest.mark.parametrize("path,backend", WRITE_PATHS)
def test_every_write_path_feeds_the_registry(port, path, backend):
    """Points written after registration by each raw write path of the
    port (on each store it runs on) are in the next pull, which is
    served from the windows and equals the batch answer."""
    t = port(**{"tsd.storage.backend": backend})
    q = qobj(agg="sum", ds="1m-sum", gb="host")
    ingest(t, SERIES[:2], BASE, 10, seed=17)
    register(t, q)
    before = sum(v for r in run(t, q) for _, v in r.dps)
    hosts = ("h0", "h9")          # an existing series and a new one
    ts = BASE + 600 + np.arange(5, dtype=np.int64) * 30
    vals = np.arange(1.0, 6.0)
    if path == "add_point":
        for h in hosts:
            for a, b in zip(ts.tolist(), vals.tolist()):
                t.add_point("s.m", a, b, {"host": h})
    elif path == "add_points":
        for h in hosts:
            t.add_points("s.m", ts, vals, {"host": h})
    elif path == "add_point_groups":
        groups = [("s.m", {"host": h}, list(range(5)), ts.tolist(),
                   vals.tolist()) for h in hosts]
        t.add_point_groups(groups)
    elif path == "add_series_points":
        t.add_series_points("s.m", [{"host": h} for h in hosts],
                            np.stack([ts, ts]), np.stack([vals, vals]))
    else:
        lines = [f"s.m {a} {b} host={h}" for h in hosts
                 for a, b in zip(ts.tolist(), vals.tolist())]
        lines.insert(3, "s.m notatime 1 host=h0")    # a rejected line
        written, errors = t.import_buffer("\n".join(lines).encode())
        assert written == 10 and len(errors) == 1
    hits0 = t.streaming.serve_hits
    after = run(t, q)
    assert t.streaming.serve_hits == hits0 + 1
    assert sum(v for r in after for _, v in r.dps) == \
        pytest.approx(before + 2 * vals.sum())
    assert_value_identical(after, run_batch(t, q))


def test_tap_never_fails_an_acknowledged_write(port):
    """A tap that raises is counted in ``hooks.errors``, and the write
    it follows still lands (ref: ``TSDB._run_hook``)."""
    t = port()
    register(t, qobj())

    def broken(*_a):
        raise RuntimeError("tap")
    t.streaming.offer = broken
    t.add_point("s.m", BASE, 1.0, {"host": "h0"})
    assert t.datapoints_added == 1
    assert t.hook_errors == {"stream.tap": 1}


@pytest.mark.parametrize("path", ["add_point", "add_points"])
def test_failed_tap_rebuilds_before_the_next_pull(pair, path):
    """A tap that raises marks every partial for rebuild in the port, so
    the next pull re-seeds from the store and still has the points the
    failed offer dropped: served from the windows, equal to batch. The
    reference serves the stale windows, without them (ROADMAP Queue 3
    item 12)."""
    p = pair()
    q = qobj(agg="sum", ds="1m-sum", gb="host")
    ts = BASE + 600 + np.arange(5, dtype=np.int64) * 30
    vals = np.arange(1.0, 6.0)
    for t in p.both:
        ingest(t, SERIES[:2], BASE, 10, seed=17)
        register(t, q)
        reg = t.streaming
        before = sum(v for r in run(t, q) for _, v in r.dps)

        def broken(*_a):
            raise RuntimeError("tap")
        name = ("offer" if path == "add_point" else
                "offer_lines" if is_port(t) else "offer_many")
        setattr(reg, name, broken)
        if path == "add_point":
            for a, b in zip(ts.tolist(), vals.tolist()):
                t.add_point("s.m", a, b, {"host": "h0"})
        else:
            t.add_points("s.m", ts, vals, {"host": "h0"})
        delattr(reg, name)
        assert t.hook_errors == {
            "stream.tap": 5 if path == "add_point" else 1}
        hits0, rebuilds0 = reg.serve_hits, reg.rebuilds
        after = run(t, q)
        assert reg.serve_hits == hits0 + 1
        got = sum(v for r in after for _, v in r.dps)
        if is_port(t):
            assert reg.rebuilds == rebuilds0 + 1
            assert got == pytest.approx(before + vals.sum())
            assert_value_identical(after, run_batch(t, q))
        else:
            assert reg.rebuilds == rebuilds0
            assert got == pytest.approx(before)


@pytest.mark.parametrize("backend", ["native", "memory"])
def test_reseed_during_a_write_counts_its_points_once(pair, backend):
    """A re-seed that starts after a write's points reached the store
    but before the write offered them waits, in the port, for the
    offer (the TSDB's tap gate) and then clears it: the points are
    counted once, by the scan, and the next pull equals batch. The
    reference's re-seed does not wait, so it scans the points and the
    late offer folds them again (ROADMAP Queue 3 item 12)."""
    p = pair(**{"tsd.storage.backend": backend})
    q = qobj(agg="sum", ds="1m-sum", gb="host")
    vals = np.arange(1.0, 6.0)
    for t in p.both:
        ingest(t, SERIES[:2], BASE, 10, seed=17)
        register(t, q)
        before = sum(v for r in run(t, q) for _, v in r.dps)
        group = t.streaming._partials[0]
        landed, reseeding = threading.Event(), threading.Event()
        append = t.store.append_many

        def append_then_stall(*args, append=append, landed=landed,
                              reseeding=reseeding):
            out = append(*args)
            landed.set()
            assert reseeding.wait(5)
            time.sleep(0.3)  # a re-seed that does not wait is done by now
            return out
        t.store.append_many = append_then_stall

        def reseed(group=group, landed=landed, reseeding=reseeding):
            assert landed.wait(5)
            reseeding.set()
            group.bootstrap(END_MS)
        th = threading.Thread(target=reseed)
        th.start()
        try:
            t.add_points("s.m",
                         BASE + 600 + np.arange(5, dtype=np.int64) * 30,
                         vals, {"host": "h0"})
        finally:
            th.join(10)
            del t.store.append_many
        assert not th.is_alive()
        hits0 = t.streaming.serve_hits
        after = run(t, q)
        assert t.streaming.serve_hits == hits0 + 1
        got = sum(v for r in after for _, v in r.dps)
        if is_port(t):
            assert got == pytest.approx(before + vals.sum())
            assert_value_identical(after, run_batch(t, q))
        else:
            assert got == pytest.approx(before + 2 * vals.sum())


def test_a_write_cannot_seal_the_tap_gate(port):
    """Inside a write the gate is held shared: sealing it there would
    wait on itself, so it raises, and the registry's rebuild leaves
    the partial marked for the next pull instead."""
    t = port(**{"tsd.streaming.workers.count": "0"})
    q = qobj()
    ingest(t, SERIES[:1], BASE, 10)
    register(t, q)
    reg = t.streaming
    group = reg._partials[0]
    seen = []

    def offer(*args):
        seen.append(t.tap_gate.in_write())
        with pytest.raises(RuntimeError):
            with t.tap_gate.sealed():
                pass
        seen.append(reg._rebuild_group(group, END_MS))
    reg.offer = offer
    t.add_point("s.m", BASE + 700, 5.0, {"host": "h0"})
    del reg.offer
    assert seen == [True, False] and not t.tap_gate.in_write()
    assert t.hook_errors == {}


# -- fold faults (ref: tests/test_streaming_faults.py:63-120) -----------------

def fault_seed(t, n=20):
    ts = np.arange(BASE, BASE + n * 30, 30, dtype=np.int64)
    t.add_points("s.m", ts, np.ones(n), {"host": "h0"})


def total(results):
    return sum(v for _, v in results[0].dps if v == v)


def test_transient_fold_fault_rebuilds_and_recovers(pair):
    p = pair()
    for t in p.both:
        fault_seed(t)
        register(t, qobj())
        reg = t.streaming
        t.faults.arm("stream.fold", error_count=1)
        t.add_point("s.m", BASE + 700, 5.0, {"host": "h0"})
        r1 = run(t, qobj())
        assert reg.fold_errors == 1 and reg.serve_fallbacks >= 1
        assert total(r1) == pytest.approx(25.0)
        r2 = run(t, qobj())
        assert reg.rebuilds == 1 and reg.serve_hits == 1
        assert total(r2) == pytest.approx(25.0)


def test_persistent_fold_faults_trip_breaker_never_500(pair):
    p = pair(**{"tsd.streaming.breaker.failure_threshold": "2",
                "tsd.faults.stream.fold_error_rate": "1.0"})
    for t in p.both:
        fault_seed(t)
        register(t, qobj())
        reg = t.streaming
        r = router_of(t)
        for i in range(4):
            t.add_point("s.m", BASE + 700 + i, 5.0, {"host": "h0"})
            resp = r.handle(request(t, "POST", "/api/query", qobj()))
            assert resp.status == 200, resp.body
        assert reg.serve_hits == 0
        assert reg.serve_fallbacks >= 2
        assert reg.breaker.state == reg.breaker.OPEN
        out = json.loads(resp.body)
        assert sum(out[0]["dps"].values()) == pytest.approx(40.0)
        assert reg.health_info()["breaker"]["state"] == "open"


def test_ingest_unaffected_by_fold_faults(pair):
    p = pair(**{"tsd.faults.stream.fold_error_rate": "1.0",
                "tsd.streaming.buffer_points": "1"})
    for t in p.both:
        register(t, qobj())
        for i in range(10):
            t.add_point("s.m", BASE + i, 1.0, {"host": "h0"})
        assert t.datapoints_added == 10
        assert t.store.points_written == 10


# -- the one divergence: a failing tail propagates in the port ----------------

def test_failing_tail_propagates_where_the_reference_answers_batch(
        pair, monkeypatch):
    """ROADMAP Queue 3: an exception out of the view's serve (here the
    tail) is caught by the reference's ``_run_sub_cached``, which
    answers from its batch engine; the port lets it propagate (no
    ``try`` gives way to another path). The registry's deliberate sheds
    (covered above) are unchanged on both sides."""
    def fail(*_a, **_k):
        raise RuntimeError("device failure in the streaming tail")
    monkeypatch.setattr(jplan.PlanView, "_tail_locked", fail)
    monkeypatch.setattr(tplan.PlanView, "_tail_locked", fail)
    p = pair()
    for t in p.both:
        ingest(t, SERIES[:2], BASE, 20, seed=18)
        register(t, qobj())
    want = run_batch(p.jt, qobj())
    got = run(p.jt, qobj())
    assert_value_identical(got, want)
    assert p.jt.streaming.serve_hits == 0
    with pytest.raises(RuntimeError, match="device failure"):
        run(p.tt, qobj())
    assert p.tt.streaming.serve_hits == 0


# -- the breaker (ref: utils/faults.py CircuitBreaker) ------------------------

def test_breaker_state_machine_matches_the_reference():
    """One script of calls on the same fake clock: the same answers,
    states and counters after every step."""
    now = [0.0]
    clock = lambda: now[0]   # noqa: E731
    j = JBreaker("x", failure_threshold=2, reset_timeout_ms=100.0,
                 clock=clock)
    t = CircuitBreaker("x", failure_threshold=2, reset_timeout_ms=100.0,
                       clock=clock)
    script = ["allow", "fail", "allow", "fail", "blocking", "allow",
              ("tick", 0.05), "allow", "blocking", ("tick", 0.06),
              "blocking", "allow", "allow", "fail", "allow",
              ("tick", 0.2), "allow", "ok", "allow", "fail", "ok",
              "fail", "fail", ("tick", 0.1), "allow", "ok", "blocking"]
    for step in script:
        if isinstance(step, tuple):
            now[0] += step[1]
            continue
        out = []
        for b in (j, t):
            if step == "allow":
                out.append(b.allow())
            elif step == "blocking":
                out.append(b.blocking())
            elif step == "fail":
                out.append(b.record_failure())
            else:
                out.append(b.record_success())
        assert out[1] == out[0], step
        assert t.health_info() == j.health_info(), step
        assert t.state == j.state, step


# -- tsd.query.mesh is checked at construction --------------------------------

@pytest.mark.parametrize("spec,outcome", [
    ("", None), ("auto", None), ("series:2", "past the devices"),
    ("series:1,time:2", "past the devices"), ("seires:2", ValueError)])
def test_query_mesh_key_is_checked(spec, outcome):
    """The reference parses ``tsd.query.mesh`` at boot (a typo raises
    ValueError); the port does the same. ``""`` and ``"auto"`` on one
    device leave the mesh off. A shape past the device list (here the
    one CPU) raises ValueError in the port, where the reference degrades
    to one device (ROADMAP Queue 3 item 16); the same shape over a
    device list that holds it builds the mesh."""
    cfg = Config(**{**T_KEYS, "tsd.query.mesh": spec})
    if outcome is None:
        t = TSDB(cfg)
        assert t.query_mesh is None
        t.shutdown()
        return
    with pytest.raises(ValueError) as exc:
        TSDB(cfg)
    if outcome == "past the devices":
        assert "1 available" in str(exc.value)
        t = TSDB(cfg, mesh_devices=[torch.device("cpu")] * 2)
        assert t.query_mesh.size == 2
        t.shutdown()
    else:
        with pytest.raises(ValueError):
            JTSDB(JConfig(**{**J_KEYS, "tsd.query.mesh": spec}))
