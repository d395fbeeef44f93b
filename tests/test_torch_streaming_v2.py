"""Continuous queries on the port, part two: plan sharing, the fold
workers, sliding, hopping and session windows, and event time (ref:
``tests/test_streaming_v2.py`` without its tier-seeded tests, which
need the lifecycle, and ``tests/test_eventtime.py``).

Paired as ``tests/test_torch_streaming.py`` is (its helpers are used
here): the same sequence against both packages, the answers compared
within ``rel=1e-9, abs=1e-9``, and the windowed answers also held to a
combine of the batch engine's tumbling grids, the oracle of the
reference's tests.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from opentsdb_tpu.query.model import BadRequestError as JBadRequest
from opentsdb_tpu.streaming.eventtime import \
    WatermarkPolicy as JWatermarkPolicy
from opentsdb_tpu_torch.query.model import BadRequestError
from opentsdb_tpu_torch.streaming.eventtime import WatermarkPolicy
from test_torch_streaming import (BASE, BASE_MS, END_MS, IV_MS,  # noqa: F401
                                  assert_rows_equal,
                                  assert_value_identical, is_port,
                                  no_fold_thread_survives, pair, port,
                                  qobj, register, request, router_of,
                                  run, run_batch)


def ingest_hosts(t, n_hosts=3, n=40, step_s=20, seed=0, metric="s.m"):
    rng = np.random.default_rng(seed)
    for i in range(n_hosts):
        ts = np.arange(BASE, BASE + n * step_s, step_s,
                       dtype=np.int64) + i
        t.add_points(metric, ts, rng.normal(50.0 + 10 * i, 5.0, len(ts)),
                     {"host": f"h{i}"})


def wait_idle(reg, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and (
            reg.workers._queued
            or any(g.pending_points for g in reg._partials)):
        time.sleep(0.01)


def bad_request(t):
    return BadRequestError if is_port(t) else JBadRequest


# -- plan sharing ------------------------------------------------------------

def test_same_metric_cqs_share_one_partial(pair):
    specs = [("sum", "1m-sum", None), ("avg", "1m-avg", None),
             ("max", "1m-max", "host"), ("min", "1m-min", None),
             ("sum", "1m-count", "host"), ("avg", "2m-avg", None),
             ("sum", "2m-sum", None), ("max", "1m-avg", None)]
    p = pair()
    answers = []
    for t in p.both:
        reg = t.streaming
        cqs = [reg.register(qobj(agg=a, ds=d, gb=g), now_ms=END_MS)
               for a, d, g in specs * 2]
        assert len(cqs) == 16
        # one partial per membership-filter identity, not per query
        assert len(reg._partials) == 2
        assert sum(len(g.views) for g in reg._partials) == 16
        ingest_hosts(t, n_hosts=3, n=40, seed=1)
        reg.flush()
        assert sum(g.points_folded for g in reg._partials) == 2 * 3 * 40
        out = []
        for a, d, g in specs:
            q = qobj(agg=a, ds=d, gb=g)
            hits0 = reg.serve_hits
            streamed = run(t, q)
            assert reg.serve_hits == hits0 + 1, (a, d, g)
            assert streamed
            if is_port(t):
                assert_value_identical(streamed, run_batch(t, q))
            out.append(streamed)
        answers.append(out)
    for got, want in zip(answers[1], answers[0]):
        assert_value_identical(got, want)


def test_incompatible_filters_and_intervals_get_own_partials(pair):
    p = pair()
    for t in p.both:
        reg = t.streaming
        reg.register(qobj(ds="1m-sum"), now_ms=END_MS)
        q = qobj(ds="1m-sum")
        q["queries"][0]["filters"] = [
            {"type": "literal_or", "tagk": "host", "filter": "h0",
             "groupBy": False}]
        reg.register(q, now_ms=END_MS)
        reg.register(qobj(ds="90s-sum"), now_ms=END_MS)
        assert len(reg._partials) == 3


def test_groupby_only_difference_shares_membership(pair):
    def q(group_by):
        obj = qobj(agg="sum", ds="1m-sum")
        obj["queries"][0]["filters"] = [
            {"type": "wildcard", "tagk": "host", "filter": "*",
             "groupBy": group_by}]
        return obj

    p = pair()
    grouped = []
    for t in p.both:
        ingest_hosts(t, n_hosts=3, n=30, seed=2)
        reg = t.streaming
        reg.register(q(False), now_ms=END_MS)
        reg.register(q(True), now_ms=END_MS)
        assert len(reg._partials) == 1
        flat = run(t, q(False))
        grouped.append(run(t, q(True)))
        assert reg.serve_hits == 2
        assert len(flat) == 1 and len(grouped[-1]) == 3
    assert_value_identical(grouped[1], grouped[0])
    assert_value_identical(grouped[1], run_batch(p.tt, q(True)))


def test_attaching_a_view_does_not_grow_the_shared_ring(pair):
    """ROADMAP Queue 3: the reference sizes an attach by the shared
    ring's span plus 2, so each of 16 same-identity registrations grows
    the ring by one column and re-scans the store; the port keeps the
    32 windows the first registration sized (30 minutes at 1m, plus
    2), after one scan. The answers agree."""
    p = pair()
    windows, scans, answers = [], [], []
    for t in p.both:
        ingest_hosts(t, n_hosts=3, n=40, seed=4)
        reg = t.streaming
        for i in range(16):
            reg.register({**qobj(), "id": f"q{i}"}, now_ms=END_MS)
        assert len(reg._partials) == 1
        g = reg._partials[0]
        windows.append(g.n_windows)
        scans.append(g.bootstrap_points // (3 * 40))
        answers.append(run(t, qobj()))
        assert reg.serve_hits == 1
    assert windows == [32 + 15, 32]
    assert scans == [16, 1]
    assert_value_identical(answers[1], answers[0])


def test_group_dropped_when_last_view_deleted(pair):
    p = pair()
    for t in p.both:
        reg = t.streaming
        a = reg.register(qobj(), now_ms=END_MS)
        b = reg.register(qobj(agg="avg", ds="1m-avg"), now_ms=END_MS)
        assert len(reg._partials) == 1
        reg.delete(a.id)
        assert len(reg._partials) == 1
        reg.delete(b.id)
        assert reg._partials == []
        assert reg._by_mid == {} and reg._unresolved == []


# -- the write path never folds -----------------------------------------------

N_CQS = 50


def register_many(t):
    reg = t.streaming
    aggs = ["sum", "avg", "max", "min", "count"]
    fns = ["1m-sum", "1m-avg", "1m-max", "1m-min", "1m-count",
           "2m-sum", "2m-avg", "3m-max", "5m-min", "2m-count"]
    for i in range(N_CQS):
        reg.register(qobj(agg=aggs[i % len(aggs)], ds=fns[i % len(fns)],
                          gb="host" if i % 3 == 0 else None),
                     now_ms=END_MS)
    return reg


def test_no_folds_on_the_writer_thread(pair):
    """50 standing queries share two partials, every fold runs on a
    ``tsd-stream-fold-*`` worker and never on the writer, and the pull
    still sees every point."""
    p = pair(**{"tsd.streaming.buffer_points": "64"})
    for t in p.both:
        reg = register_many(t)
        assert len(reg._partials) == 2
        groups = list(reg._partials)
        writer = threading.get_ident()
        fold_threads = set()
        origs = [g.fold for g in groups]

        def make_spy(orig):
            def spy(*a, **kw):
                fold_threads.add(threading.current_thread().name)
                return orig(*a, **kw)
            return spy

        for g, orig in zip(groups, origs):
            g.fold = make_spy(orig)
        for i in range(400):
            t.add_point("s.m", BASE + i, 1.0, {"host": f"h{i % 3}"})
        wait_idle(reg)
        for g, orig in zip(groups, origs):
            g.fold = orig
        assert t.datapoints_added == 400
        assert reg.workers.drains >= 1
        assert fold_threads, "no folds executed at all"
        assert all(n.startswith("tsd-stream-fold-")
                   for n in fold_threads), fold_threads
        assert threading.current_thread().name not in fold_threads
        assert writer == threading.get_ident()
        streamed = run(t, qobj(agg="sum", ds="1m-sum"))
        assert sum(v for _, v in streamed[0].dps if v == v) == \
            pytest.approx(400.0)


def test_durable_ingest_p50_bounded_vs_zero_cq(port, tmp_path):
    """The timing half, with the reference test's generous bound:
    durable per-point ingest (native store, WAL at fsync=always) with
    50 standing queries within 3x of ingest with none."""
    def p50_write_us(with_cqs: bool, d) -> float:
        t = port(**{"tsd.storage.data_dir": str(d)})
        if with_cqs:
            register_many(t)
        times = []
        for i in range(300):
            t0 = time.perf_counter()
            t.add_point("s.m", BASE + i, 1.0, {"host": f"h{i % 3}"})
            times.append(time.perf_counter() - t0)
        return float(np.percentile(np.asarray(times), 50)) * 1e6

    base_us = p50_write_us(False, tmp_path / "a")
    cq_us = p50_write_us(True, tmp_path / "b")
    assert cq_us <= max(3.0 * base_us, base_us + 200.0), (base_us, cq_us)


# -- worker faults and backpressure -----------------------------------------

def test_backpressure_degrades_lagging_partial(pair):
    p = pair(**{"tsd.streaming.workers.count": "0",
                "tsd.streaming.buffer_points": "1000000",
                "tsd.streaming.workers.max_pending_points": "10"})
    for t in p.both:
        reg = t.streaming
        reg.register(qobj(agg="sum", ds="1m-sum"), now_ms=END_MS)
        for i in range(50):
            t.add_point("s.m", BASE + i, 1.0, {"host": "h0"})
        assert t.datapoints_added == 50
        assert reg.backpressure_events >= 1
        assert reg.backpressure_drops > 0
        assert reg._partials[0].needs_rebuild
        out = run(t, qobj(agg="sum", ds="1m-sum"))
        assert reg.rebuilds == 1 and reg.serve_hits == 1
        assert sum(v for _, v in out[0].dps if v == v) == \
            pytest.approx(50.0), "backpressure produced a stale serve"


def test_stream_worker_fault_never_fails_writes(pair):
    """Every off-path drain fails: writes keep landing, the breaker
    trips, and pulls shed to the batch engine with the exact answer."""
    p = pair(**{"tsd.streaming.buffer_points": "5",
                "tsd.streaming.breaker.failure_threshold": "2",
                "tsd.faults.stream.worker_error_rate": "1.0"})
    for t in p.both:
        reg = t.streaming
        reg.register(qobj(agg="sum", ds="1m-sum"), now_ms=END_MS)
        for i in range(40):
            t.add_point("s.m", BASE + i, 1.0, {"host": "h0"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and reg.workers._queued:
            time.sleep(0.01)
        assert t.datapoints_added == 40
        assert t.store.points_written == 40
        assert reg.fold_errors >= 1
        resp = router_of(t).handle(request(t, "POST", "/api/query",
                                           qobj(agg="sum", ds="1m-sum")))
        assert resp.status == 200, resp.body
        out = json.loads(resp.body)
        assert sum(v for v in out[0]["dps"].values()
                   if v is not None) == pytest.approx(40.0)
        health = reg.health_info()
        assert health["fold_errors"] >= 1
        assert health["workers"]["workers"] == 2


def test_transient_worker_fault_heals_by_rebuild(pair):
    p = pair(**{"tsd.streaming.buffer_points": "5"})
    for t in p.both:
        reg = t.streaming
        reg.register(qobj(agg="sum", ds="1m-sum"), now_ms=END_MS)
        t.faults.arm("stream.worker", error_count=1)
        for i in range(10):
            t.add_point("s.m", BASE + i, 1.0, {"host": "h0"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                (reg.workers._queued or reg.fold_errors == 0):
            time.sleep(0.01)
        assert reg.fold_errors >= 1
        out = run(t, qobj(agg="sum", ds="1m-sum"))
        assert reg.rebuilds >= 1
        assert sum(v for _, v in out[0].dps if v == v) == \
            pytest.approx(10.0)


def test_shutdown_stops_workers(port):
    t = port(**{"tsd.streaming.buffer_points": "1"})
    reg = t.streaming
    reg.register(qobj(), now_ms=END_MS)
    t.add_point("s.m", BASE, 1.0, {"host": "h0"})
    assert reg.workers.started
    assert any(th.name.startswith("tsd-stream-fold-")
               for th in threading.enumerate())
    t.shutdown()
    assert not reg.workers.started
    assert not any(th in reg.workers._threads
                   for th in threading.enumerate())


# -- sliding windows ---------------------------------------------------------

def batch_channels(t, metric="s.m"):
    """The batch engine's tumbling 1m grids by statistic, keyed
    (series key, edge ms): the oracle's input."""
    out = {}
    for fn in ("sum", "count", "min", "max"):
        ch = {}
        for r in run_batch(t, qobj(agg="none", ds=f"1m-{fn}",
                                   metric=metric)):
            key = tuple(sorted(r.tags.items()))
            for ts, v in r.dps:
                if v == v:
                    ch[(key, int(ts))] = v
        out[fn] = ch
    return out


def trailing(ch, key, win, fn):
    s = sum(ch["sum"].get((key, w), 0.0) for w in win)
    c = sum(ch["count"].get((key, w), 0.0) for w in win)
    mn = min((ch["min"][(key, w)] for w in win if (key, w) in ch["min"]),
             default=float("inf"))
    mx = max((ch["max"][(key, w)] for w in win if (key, w) in ch["max"]),
             default=float("-inf"))
    return c, {"sum": s, "count": c, "avg": s / c if c else None,
               "min": mn if c else None, "max": mx if c else None}[fn]


K = 5    # a 5m sliding window over 1m buckets


def sliding_setup(t, fn="sum"):
    ingest_hosts(t, n_hosts=2, n=50, step_s=25, seed=3)
    ts = np.arange(BASE, BASE + 1500, 240, dtype=np.int64)
    t.add_points("s.m", ts, np.linspace(5, 9, len(ts)), {"host": "gap"})
    return t.streaming.register(
        qobj(agg="none", ds=f"1m-{fn}",
             window={"type": "sliding", "size": "5m"}), now_ms=END_MS)


@pytest.mark.parametrize("fn", ["sum", "avg", "min", "max", "count"])
def test_sliding_matches_batch_combine_oracle(pair, fn):
    """Each sliding output is the trailing-k combine of the batch
    engine's tumbling grids (sums of sums, mins of mins, avg as the
    windowed sum over the windowed count)."""
    p = pair()
    rows = []
    for t in p.both:
        cq = sliding_setup(t, fn)
        rows.append(t.streaming.current_results(cq, now_ms=END_MS))
    assert rows[1], "no sliding results"
    assert_rows_equal(rows[1], rows[0])
    ch = batch_channels(p.tt)
    edges = list(range(BASE_MS, END_MS, IV_MS))
    checked = 0
    for row in rows[1]:
        key = tuple(sorted(row["tags"].items()))
        for i, e in enumerate(edges):
            win = [edges[j] for j in range(max(0, i - K + 1), i + 1)]
            c, want = trailing(ch, key, win, fn)
            got = row["dps"].get(str(e))
            if not c:
                assert got is None or got != got, (e, got)
                continue
            assert got == pytest.approx(want, rel=1e-9), (key, e)
            checked += 1
    assert checked > 50, "vacuous oracle"


def test_sliding_count_checked_against_limits_once(pair):
    """Query limits see the real point count, not the k-fold overlap
    of the sliding count channel."""
    p = pair(**{"tsd.query.limits.data_points.default": "200"})
    for t in p.both:
        ts = np.arange(BASE, BASE + 1500, 10, dtype=np.int64)   # 150
        t.add_points("s.m", ts, np.ones(len(ts)), {"host": "h0"})
        cq = t.streaming.register(
            qobj(agg="sum", ds="1m-sum",
                 window={"type": "sliding", "size": "5m"}),
            now_ms=END_MS)
        rows = t.streaming.current_results(cq, now_ms=END_MS)
        assert rows and rows[0]["dps"]


@pytest.mark.parametrize("gap_ms,partials", [
    (86_400_000, 1),        # 1 day: the ring stretches over both
    (180 * 86_400_000, 2),  # 180 days > max_windows: its own partial
])
def test_disjoint_past_range_view_still_covered(pair, gap_ms, partials):
    p = pair()
    far = END_MS + gap_ms
    for t in p.both:
        ts = np.arange(BASE, BASE + 1200, 30, dtype=np.int64)
        t.add_points("s.m", ts, np.ones(len(ts)), {"host": "h0"})
        reg = t.streaming
        reg.register(qobj(agg="sum", ds="1m-sum", start=far - 1800_000,
                          end=far), now_ms=far)
        cq = reg.register(qobj(agg="sum", ds="1m-sum",
                               window={"type": "sliding", "size": "5m"}),
                          now_ms=far)
        assert len(reg._partials) == partials
        rows = reg.current_results(cq, now_ms=far)
        assert rows and any(v for v in rows[0]["dps"].values())


def test_sliding_excluded_from_pull_path(pair):
    p = pair()
    for t in p.both:
        sliding_setup(t)
        assert run(t, qobj(agg="none", ds="1m-sum"))
        assert t.streaming.serve_hits == 0


def test_sliding_sse_frames_fan_out_dirty_buckets(pair):
    p = pair()
    frames = []
    for t in p.both:
        cq = sliding_setup(t)
        reg = t.streaming
        sub = reg.subscribe(cq)
        while not sub.queue.empty():
            sub.queue.get_nowait()      # drop the snapshot
        t.add_point("s.m", BASE + 720, 100.0, {"host": "h0"})
        reg.flush()
        fr = sub.queue.get(timeout=5).decode()
        data = json.loads(fr.split("data: ", 1)[1].split("\n")[0])
        dirty = (BASE + 720) * 1000 // IV_MS * IV_MS
        touched = {dirty + i * IV_MS for i in range(K)}
        emitted = {int(k) for u in data["updates"] for k in u["dps"]}
        assert emitted == {e for e in touched if e < END_MS}
        reg.unsubscribe(cq, sub)
        frames.append(data["updates"])
    assert_rows_equal(frames[1], frames[0])


# -- session windows ----------------------------------------------------------

def session_setup(t, gap="2m"):
    # bursts more than the gap apart: [0..2m], quiet 5m, [7m..8m],
    # quiet 10m, one point at 18m
    for s, n in ((0, 5), (420, 3)):
        ts = BASE + s + np.arange(n, dtype=np.int64) * 30
        t.add_points("s.m", ts, np.arange(n, dtype=float) + 1,
                     {"host": "h0"})
    t.add_point("s.m", BASE + 1080, 42.0, {"host": "h0"})
    return t.streaming.register(
        qobj(agg="none", ds="1m-sum",
             window={"type": "session", "gap": gap}), now_ms=END_MS)


def test_sessions_match_batch_combine_oracle(pair):
    p = pair()
    rows = []
    for t in p.both:
        cq = session_setup(t)
        rows.append(t.streaming.current_results(cq, now_ms=END_MS))
    assert_rows_equal(rows[1], rows[0])
    assert len(rows[1]) == 1
    got = {int(k): v for k, v in rows[1][0]["dps"].items()
           if v is not None}
    ch = batch_channels(p.tt)
    key = (("host", "h0"),)
    present = sorted(e for (k, e) in ch["sum"] if k == key)
    sessions = [[present[0]]]
    for prev, cur in zip(present, present[1:]):
        if cur - prev > 120_000:
            sessions.append([])
        sessions[-1].append(cur)
    want = {s[0]: sum(ch["sum"][(key, e)] for e in s) for s in sessions}
    assert got == {k: pytest.approx(v) for k, v in want.items()}
    assert len(want) == 3


def test_session_grows_and_merges_under_live_ingest(pair):
    p = pair()
    afters = []
    for t in p.both:
        cq = session_setup(t)
        reg = t.streaming

        def sessions():
            return {int(k): v for k, v in reg.current_results(
                cq, now_ms=END_MS)[0]["dps"].items() if v is not None}
        before = sessions()
        assert len(before) == 3
        for m in range(3, 7):   # bridge the 5-minute quiet zone
            t.add_point("s.m", BASE + m * 60 + 5, 1.0, {"host": "h0"})
        after = sessions()
        assert len(after) == 2, "bridged sessions did not merge"
        assert min(after) == min(before)
        afters.append(after)
    assert afters[1] == pytest.approx(afters[0])


def test_result_endpoint_503_when_partials_known_stale(pair):
    """While the rebuild keeps failing (the breaker trips), ``/result``
    answers a structured 503 with Retry-After, never stale windows;
    after the fault clears and the reset window passes, the probe
    rebuilds and it answers 200."""
    p = pair()
    for t in p.both:
        cq = session_setup(t)
        t.faults.arm("stream.fold", error_rate=1.0)
        t.add_point("s.m", BASE + 1200, 1.0, {"host": "h0"})
        reg = t.streaming
        reg._partials[0].needs_rebuild = True
        r = router_of(t)
        path = f"/api/query/continuous/{cq.id}/result"
        for _ in range(4):
            resp = r.handle(request(t, "GET", path))
            assert resp.status == 503, resp.status
        assert "Retry-After" in resp.headers
        assert json.loads(resp.body)["error"]["code"] == 503
        t.faults.disarm("stream.fold")
        reg.breaker.reset_timeout_ms = 0.0
        resp = r.handle(request(t, "GET", path))
        assert resp.status == 200, resp.body


@pytest.mark.parametrize("window", [
    {"type": "session"}, {"type": "session", "gap": "90s"},
    {"type": "sliding", "size": "1m"}, {"type": "sliding", "size": "90s"},
    {"type": "hopping", "size": "5m"}, "5m"])
def test_window_validation_400(pair, window):
    p = pair()
    bodies = []
    for t in p.both:
        resp = router_of(t).handle(request(
            t, "POST", "/api/query/continuous", qobj(window=window)))
        assert resp.status == 400, window
        bodies.append(resp.body)
    assert bodies[1] == bodies[0]


def test_result_endpoint_and_describe(pair):
    p = pair()
    rows = []
    for t in p.both:
        cq = session_setup(t)
        r = router_of(t)
        resp = r.handle(request(t, "GET",
                                f"/api/query/continuous/{cq.id}/result"))
        assert resp.status == 200
        rows.append(json.loads(resp.body))
        assert rows[-1] and rows[-1][0]["metric"] == "s.m"
        doc = json.loads(r.handle(request(
            t, "GET", f"/api/query/continuous/{cq.id}")).body)
        assert doc["windowSpec"] == {"type": "session", "gapMs": 120_000}
    assert_rows_equal(rows[1], rows[0])


# -- event time: the watermark policy (ref: tests/test_eventtime.py) --------

def test_policy_from_json_shapes():
    for cls, bad in ((WatermarkPolicy, BadRequestError),
                     (JWatermarkPolicy, JBadRequest)):
        assert cls.from_json(None) is None
        assert cls.from_json({}) is None
        pol = cls.from_json({"allowedLateness": "5m"})
        assert pol.lateness_ms == 300_000
        assert pol.to_json() == {"allowedLatenessMs": 300_000}
        for obj in ("5m", {"allowedLateness": ""},
                    {"allowedLateness": "0s"},
                    {"allowedLateness": "nonsense"}):
            with pytest.raises(bad):
                cls.from_json(obj)
        pol = cls(150_000)
        assert pol.lateness_buckets(60_000) == 3
        assert pol.lateness_buckets(150_000) == 1


@pytest.mark.parametrize("window,needle", [
    ({"type": "hopping", "size": "10m"}, "slide"),
    ({"type": "hopping", "size": "10m", "slide": "1m"},
     "exceed the downsample"),
    ({"type": "hopping", "size": "2m", "slide": "2m"}, "exceed its slide"),
    ({"type": "session", "gap": "2m", "by": 7}, "by"),
])
def test_window_spec_refusals(pair, window, needle):
    p = pair()
    for t in p.both:
        with pytest.raises(bad_request(t), match=needle):
            register(t, qobj(metric="e.m", window=window))


def test_describe_roundtrips_policy_and_window(pair):
    p = pair()
    docs = []
    for t in p.both:
        cq = register(t, qobj(metric="e.m",
                              window={"type": "hopping", "size": "10m",
                                      "slide": "2m"},
                              watermark={"allowedLateness": "3m"}))
        doc = cq.describe()
        assert doc["watermark"] == {"allowedLatenessMs": 180_000}
        assert doc["windowSpec"]["slideMs"] == 120_000
        assert doc["foldBytes"] > 0
        docs.append(doc)
    assert docs[1]["foldBytes"] == docs[0]["foldBytes"]


LATENESS_S = 180


def watermark_setup(t):
    cq = register(t, qobj(metric="e.m", watermark={
        "allowedLateness": f"{LATENESS_S}s"}))
    # one series at a time: both hosts' chunks fold in one drain pass
    # and the watermark commits per pass
    for h in range(2):
        ts = BASE + np.arange(50, dtype=np.int64) * 30 + h
        t.add_points("e.m", ts, (np.arange(50) % 7 + h).astype(float),
                     {"host": f"h{h}"})
    t.streaming.flush()
    return cq


def split_marker(rows):
    assert rows and "completeness" in rows[-1], \
        "a policy query answered without a completeness marker"
    return rows[:-1], rows[-1]["completeness"]


def row_dps(row):
    return {int(k): v for k, v in row["dps"].items()
            if v is not None and v == v}


def matches_batch(t, cq):
    rows, marker = split_marker(
        t.streaming.current_results(cq, now_ms=END_MS))
    want = {int(ts): v for r in run_batch(t, qobj(metric="e.m"))
            for ts, v in r.dps if v == v}
    assert row_dps(rows[0]) == pytest.approx(want), "streamed != batch"
    return rows, marker


def test_refold_within_lateness_matches_cold_batch(pair):
    p = pair()
    markers = []
    for t in p.both:
        cq = watermark_setup(t)
        _, marker = matches_batch(t, cq)
        assert marker["lateDropped"] == 0
        # ~2m behind the newest event time, off the raw grid by 15 s
        t.add_point("e.m", BASE + 49 * 30 - 105, 100.0, {"host": "h0"})
        t.streaming.flush()
        _, marker = matches_batch(t, cq)
        assert marker["lateRefolded"] >= 1
        assert marker["lateDropped"] == 0
        assert marker["latenessMs"] == LATENESS_S * 1000
        markers.append(marker)
    assert markers[1] == markers[0]


def test_past_horizon_drop_is_counted_never_silent(pair):
    p = pair()
    for t in p.both:
        cq = watermark_setup(t)
        before, _ = split_marker(
            t.streaming.current_results(cq, now_ms=END_MS))
        bucket = BASE_MS // IV_MS * IV_MS
        t.add_point("e.m", BASE, 9999.0, {"host": "h0"})
        t.streaming.flush()
        rows, marker = split_marker(
            t.streaming.current_results(cq, now_ms=END_MS))
        assert marker["lateDropped"] == 1
        assert row_dps(rows[0])[bucket] == row_dps(before[0])[bucket]
        batch = {int(ts): v for r in run_batch(t, qobj(metric="e.m"))
                 for ts, v in r.dps if v == v}
        assert batch[bucket] == \
            pytest.approx(row_dps(before[0])[bucket] + 9999.0)


def test_completeness_flag_follows_watermark(pair):
    p = pair()
    for t in p.both:
        cq = watermark_setup(t)
        _, marker = matches_batch(t, cq)
        assert marker["complete"] is False
        assert marker["watermarkMs"] == \
            (BASE + 49 * 30) * 1000 + 1000 - LATENESS_S * 1000
        t.add_point("e.m", END_MS // 1000 + LATENESS_S + 60, 1.0,
                    {"host": "h0"})
        t.streaming.flush()
        _, marker = split_marker(
            t.streaming.current_results(cq, now_ms=END_MS))
        assert marker["complete"] is True


def test_policy_cq_excluded_from_query_fast_path(pair):
    p = pair()
    for t in p.both:
        watermark_setup(t)
        assert run(t, qobj(metric="e.m"))
        assert t.streaming.serve_hits == 0


# -- hopping windows ---------------------------------------------------------

SIZE_MS, SLIDE_MS = 600_000, 120_000


def hopping_setup(t, fn="sum"):
    for h in range(2):
        ts = BASE + np.arange(60, dtype=np.int64) * 25 + h
        t.add_points("e.m", ts, np.linspace(1, 9, 60) + h,
                     {"host": f"h{h}"})
    ts = np.arange(BASE, BASE + 1500, 300, dtype=np.int64)
    t.add_points("e.m", ts, np.ones(len(ts)) * 5, {"host": "gap"})
    return register(t, qobj(agg="none", ds=f"1m-{fn}", metric="e.m",
                            window={"type": "hopping", "size": "10m",
                                    "slide": "2m"}))


@pytest.mark.parametrize("fn", ["sum", "avg", "min", "max", "count"])
def test_hopping_matches_sliding_subsample_oracle(pair, fn):
    p = pair()
    rows = []
    for t in p.both:
        cq = hopping_setup(t, fn)
        rows.append(t.streaming.current_results(cq, now_ms=END_MS))
    assert rows[1], "no hopping results"
    assert_rows_equal(rows[1], rows[0])
    ch = batch_channels(p.tt, metric="e.m")
    k = SIZE_MS // IV_MS
    checked = 0
    for row in rows[1]:
        key = tuple(sorted(row["tags"].items()))
        got = row_dps(row)
        assert got and all(e % SLIDE_MS == 0 for e in got)
        for e in got:
            c, want = trailing(ch, key, [e - j * IV_MS for j in range(k)],
                               fn)
            assert c, (key, e)
            assert got[e] == pytest.approx(want, rel=1e-9), (key, e)
            checked += 1
    assert checked > 20, "vacuous oracle"


def test_hopping_excluded_from_query_fast_path(pair):
    p = pair()
    for t in p.both:
        hopping_setup(t)
        run(t, qobj(agg="none", ds="1m-sum", metric="e.m"))
        assert t.streaming.serve_hits == 0


# -- sessions by tag ----------------------------------------------------------

N_USERS = 40


def session_by_setup(t, watermark=None):
    rng = np.random.default_rng(5)
    for u in range(N_USERS):
        ts0 = BASE + (u % 7) * 30
        for burst, n in ((0, 4), (420 + (u % 3) * 60, 3))[
                : 2 if u % 2 == 0 else 1]:
            ts = ts0 + burst + np.arange(n, dtype=np.int64) * 30
            t.add_points("e.m", ts, rng.integers(1, 9, n).astype(float),
                         {"user": f"u{u:03d}"})
    return register(t, qobj(agg="none", ds="1m-sum", metric="e.m",
                            window={"type": "session", "gap": "2m",
                                    "by": "user"}, watermark=watermark))


def test_sessions_match_batch_gap_split_per_user(pair):
    p = pair()
    rows = []
    for t in p.both:
        cq = session_by_setup(t)
        rows.append(t.streaming.current_results(cq, now_ms=END_MS))
    assert_rows_equal(rows[1], rows[0])
    got = {row["tags"]["user"]: row_dps(row) for row in rows[1]}
    per_user: dict = {}
    for r in run_batch(p.tt, qobj(agg="none", ds="1m-sum",
                                  metric="e.m")):
        grid = per_user.setdefault(r.tags.get("user"), {})
        for ts, v in r.dps:
            if v == v:
                grid[int(ts)] = grid.get(int(ts), 0.0) + v
    want = {}
    for user, grid in per_user.items():
        edges = sorted(grid)
        sessions = [[edges[0]]]
        for e in edges[1:]:
            if e - sessions[-1][-1] > 120_000:
                sessions.append([])
            sessions[-1].append(e)
        want[user] = {s[0]: sum(grid[e] for e in s) for s in sessions}
    assert set(got) == set(want)
    for user in want:
        assert got[user] == pytest.approx(want[user]), user
    assert len(got["u000"]) == 2 and len(got["u001"]) == 1


def test_member_series_collide_into_one_user_row(pair):
    p = pair()
    for t in p.both:
        t.add_point("e.m", BASE, 3.0, {"user": "u1", "host": "a"})
        t.add_point("e.m", BASE + 10, 4.0, {"user": "u1", "host": "b"})
        cq = register(t, qobj(agg="none", ds="1m-sum", metric="e.m",
                              window={"type": "session", "gap": "2m",
                                      "by": "user"}))
        t.add_point("e.m", BASE + 20, 5.0, {"user": "u1", "host": "c"})
        t.streaming.flush()
        rows = t.streaming.current_results(cq, now_ms=END_MS)
        assert len(rows) == 1 and rows[0]["tags"] == {"user": "u1"}
        assert row_dps(rows[0]) == {BASE_MS // IV_MS * IV_MS: 12.0}
        g = cq.plans[0].shared
        assert len(g._vid_rows) == 1 and len(g._member_sids) == 3


def test_series_without_session_tag_never_joins(pair):
    p = pair()
    for t in p.both:
        cq = session_by_setup(t)
        t.add_point("e.m", BASE + 60, 1000.0, {"host": "stray"})
        t.streaming.flush()
        rows = t.streaming.current_results(cq, now_ms=END_MS)
        assert all(r["tags"].get("user") for r in rows)
        assert not any(1000.0 in row_dps(r).values() for r in rows)


def test_gap_close_driven_by_watermark(pair):
    p = pair()
    markers = []
    for t in p.both:
        cq = session_by_setup(t, watermark={"allowedLateness": "1m"})
        rows, marker = split_marker(
            t.streaming.current_results(cq, now_ms=END_MS))
        assert marker["sessionsOpen"] + marker["sessionsClosed"] \
            == N_USERS
        assert sum(len(row_dps(r)) for r in rows) > N_USERS
        assert marker["sessionsOpen"] > 0
        t.add_point("e.m", BASE + 3000, 1.0, {"user": "u000"})
        t.streaming.flush()
        _, marker = split_marker(
            t.streaming.current_results(cq, now_ms=END_MS))
        assert marker["sessionsOpen"] == 1
        assert marker["sessionsClosed"] == N_USERS - 1
        markers.append(marker)
    assert markers[1] == markers[0]


def test_session_percentile_refused(pair):
    p = pair()
    for t in p.both:
        with pytest.raises(bad_request(t)):
            register(t, qobj(agg="none", ds="1m-p95", metric="e.m",
                             window={"type": "session", "gap": "2m",
                                     "by": "user"}))


# -- the completeness marker's fault site ------------------------------------

def marker_setup(t):
    cq = register(t, qobj(metric="e.m",
                          watermark={"allowedLateness": "2m"}))
    t.add_point("e.m", BASE, 1.0, {"host": "h0"})
    t.streaming.flush()
    return cq


def test_armed_watermark_fault_503s_the_pull(pair):
    p = pair()
    for t in p.both:
        cq = marker_setup(t)
        r = router_of(t)
        path = f"/api/query/continuous/{cq.id}/result"
        t.faults.arm("stream.watermark", error_count=1)
        resp = r.handle(request(t, "GET", path))
        assert resp.status == 503
        assert b"marker unavailable" in resp.body
        resp = r.handle(request(t, "GET", path))
        assert resp.status == 200
        rows = json.loads(resp.body)
        assert "watermarkMs" in rows[-1]["completeness"]


def test_armed_watermark_fault_degrades_the_push_marker(pair):
    p = pair()
    for t in p.both:
        cq = marker_setup(t)
        t.faults.arm("stream.watermark", error_count=1)
        out = t.streaming.delta_updates(cq)
        assert out["completeness"] == {"degraded": True}
        out = t.streaming.delta_updates(cq)
        assert out["completeness"].get("degraded") is None
        assert "watermarkMs" in out["completeness"]


def test_delta_updates_drain_dirty_windows(pair):
    p = pair()
    drained = []
    for t in p.both:
        cq = marker_setup(t)
        first = t.streaming.delta_updates(cq, now_ms=END_MS)
        t.add_point("e.m", BASE + 90, 7.0, {"host": "h0"})
        out = t.streaming.delta_updates(cq, now_ms=END_MS)
        assert out["seq"] > first["seq"]
        edges = {int(k) for u in out["updates"] for k in u["dps"]}
        assert (BASE + 90) * 1000 // IV_MS * IV_MS in edges
        again = t.streaming.delta_updates(cq, now_ms=END_MS)
        assert again["updates"] == [] and again["clean"] is True
        resp = router_of(t).handle(request(
            t, "GET", f"/api/query/continuous/{cq.id}/deltas"))
        assert resp.status == 200
        body = json.loads(resp.body)
        assert body["id"] == cq.id and "completeness" in body
        drained.append(out)
    assert_rows_equal(drained[1]["updates"], drained[0]["updates"])
    assert drained[1]["completeness"] == drained[0]["completeness"]
