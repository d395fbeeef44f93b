"""Continuous queries over demoted history on the port: the tier-seeded
bootstrap (ref: ``tests/test_streaming_v2.py::TestTierSeededBootstrap``),
each case run on both packages with the same writes, sweep and
registrations, the answers compared within ``rel=1e-9, abs=1e-9`` and
each package's streamed answer held to its own batch engine (whose
stitched store is the oracle).

A partial whose horizon reaches behind the metric's demotion boundary
seeds the pre-boundary part channel-wise from the stitched tier views,
serves it without a batch fallback, drops later backfills behind the
boundary as the stitched batch read does, rebuilds when a sweep moves
the boundary, and without a tier that nests in its buckets sheds those
windows to the batch engine. ``seedBoundaryMs`` rides the plan info.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from test_torch_streaming import (BASE, BASE_MS,  # noqa: F401
                                  assert_value_identical,
                                  no_fold_thread_survives, pair, qobj,
                                  request, router_of, run, run_batch)

SPAN_S = 7200
NOW_MS = BASE_MS + SPAN_S * 1000
LC_KEYS = {"tsd.storage.backend": "memory",
           "tsd.rollups.enable": "true",
           "tsd.lifecycle.enable": "true",
           "tsd.lifecycle.demote_after": "30m",
           "tsd.lifecycle.demote_tiers": "1m"}


def demoted(pair):
    p = pair(**LC_KEYS)
    rng = np.random.default_rng(7)
    ts = np.arange(BASE, BASE + SPAN_S, 5, dtype=np.int64)
    for i in range(3):
        vals = rng.normal(100, 10, len(ts))
        for t in p.both:
            t.add_points("sys.cpu", ts, vals, {"host": f"h{i}"})
    reps = [t.lifecycle.sweep(now_ms=NOW_MS) for t in p.both]
    for r in reps:
        r.pop("durationMs")
    assert reps[0] == {**reps[1], "bytesReclaimed":
                       reps[0]["bytesReclaimed"]}
    assert reps[0]["demoted"] > 0
    return p


def q(agg="sum", ds="5m-avg", start=BASE_MS, end=NOW_MS):
    return qobj(agg=agg, ds=ds, metric="sys.cpu", start=start, end=end)


def both_equal(p, query):
    """Each package's streamed answer equals its batch answer, and the
    two packages' answers agree. Returns the port's streamed rows."""
    out = []
    for t in p.both:
        streamed = run(t, query)
        assert_value_identical(streamed, run_batch(t, query))
        out.append(streamed)
    assert_value_identical(out[1], out[0])
    return out[1]


@pytest.mark.parametrize("agg,ds", [
    ("sum", "5m-avg"), ("max", "5m-min"), ("avg", "5m-sum"),
    ("min", "5m-max"), ("sum", "5m-count")])
def test_preboundary_window_serves_without_fallback(pair, agg, ds):
    p = demoted(pair)
    for t in p.both:
        reg = t.streaming
        reg.register(q(agg, ds), now_ms=NOW_MS)
        group = reg._partials[0]
        assert group.tier_seeded
        assert group.seed_boundary_ms == \
            t.lifecycle.demote_boundary_for("sys.cpu")
        fallbacks = reg.serve_fallbacks
        assert run(t, q(agg, ds))
        assert reg.serve_hits == 1 and reg.serve_fallbacks == fallbacks
        assert reg.tier_seeded_bootstraps == 1
    both_equal(p, q(agg, ds))


def test_live_folds_ride_on_the_seeded_ring(pair):
    p = demoted(pair)
    before = []
    for t in p.both:
        t.streaming.register(q(), now_ms=NOW_MS)
        before.append(run(t, q()))
        t.add_point("sys.cpu", BASE + SPAN_S - 7, 1000.0, {"host": "h0"})
    after = both_equal(p, q())
    for t in p.both:
        assert t.streaming.serve_hits >= 2
    assert sum(v for _, v in after[0].dps if v == v) > \
        sum(v for _, v in before[1][0].dps if v == v)


def test_preboundary_backfill_dropped_like_stitched_reads(pair):
    p = demoted(pair)
    for t in p.both:
        reg = t.streaming
        reg.register(q(), now_ms=NOW_MS)
        run(t, q())
        t.add_point("sys.cpu", BASE + 60, 999.0, {"host": "h0"})
        reg.flush()
        assert reg._partials[0].preboundary_dropped >= 1
    both_equal(p, q())


def test_sweep_moves_boundary_and_partial_rebuilds(pair):
    p = demoted(pair)
    later = q(end=NOW_MS + 1800_000)
    for t in p.both:
        reg = t.streaming
        reg.register(q(), now_ms=NOW_MS)
        run(t, q())
        b0 = t.lifecycle.demote_boundary_for("sys.cpu")
        t.lifecycle.sweep(now_ms=NOW_MS + 1800_000)
        assert t.lifecycle.demote_boundary_for("sys.cpu") > b0
        run(t, later)
        assert reg.rebuilds >= 1
        assert reg._partials[0].seed_boundary_ms > b0
    both_equal(p, later)


def test_no_nesting_tier_keeps_the_batch_fallback(pair):
    """90 s buckets: no 1m tier nests, so the pre-boundary window sheds
    to the batch engine, whose stitched store answers."""
    p = demoted(pair)
    answers = []
    for t in p.both:
        reg = t.streaming
        reg.register(q(ds="90s-sum"), now_ms=NOW_MS)
        assert not reg._partials[0].tier_seeded
        answers.append(run(t, q(ds="90s-sum")))
        assert reg.serve_hits == 0 and reg.serve_fallbacks >= 1
    assert_value_identical(answers[1], answers[0])


def test_plan_info_and_stats_carry_the_seed(pair):
    p = demoted(pair)
    infos, names = [], []
    for t in p.both:
        cq = t.streaming.register(q(), now_ms=NOW_MS)
        r = router_of(t)
        resp = r.handle(request(t, "GET",
                                f"/api/query/continuous/{cq.id}"))
        infos.append(json.loads(resp.body)["plans"][0])
        stats = json.loads(r.handle(request(t, "GET",
                                            "/api/stats")).body)
        names.append({s["metric"]: s["value"] for s in stats
                      if s["metric"].startswith("tsd.streaming.")})
    assert infos[1] == infos[0]
    assert infos[1]["tierSeeded"] is True
    assert infos[1]["seedBoundaryMs"] == NOW_MS - 1800_000
    assert names[1]["tsd.streaming.rebuilds.tier_seeded"] == \
        names[0]["tsd.streaming.rebuilds.tier_seeded"] == 1


@pytest.mark.parametrize("ds", ["5m-avg", "30m-sum"])
def test_percentile_view_seeds_from_the_sketch_zones(pair, ds):
    """A percentile view's sketch channel seeds from the sketch tier
    (the demoted cells nest in its buckets) and the raw tail."""
    p = demoted(pair)
    query = {"start": BASE_MS, "end": NOW_MS, "queries": [{
        "metric": "sys.cpu", "aggregator": "sum", "downsample": ds,
        "percentiles": [50.0, 99.0]}]}
    out = []
    for t in p.both:
        t.streaming.register(query, now_ms=NOW_MS)
        group = t.streaming._partials[0]
        assert group.want_sketch
        assert group.sketch_from_ms <= BASE_MS
        out.append(run(t, query))
    assert_value_identical(out[1], out[0])
