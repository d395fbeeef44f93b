"""The port's quantile sketches and the percentile sub-query over scalar
metrics against the JAX package's, on the CPU.

- ``DDSketch``: bytes, ``merge``, ``collapse``, ``quantile``, the base64
  form and the blob errors equal the reference's, over seeds.
- ``fold_cells`` / ``fold_series_cells``: the same cells, each sketch's
  bytes equal.
- A percentile sub-query on a scalar metric (no histogram series): the
  rows equal the reference's bit for bit (both fold on the host in
  float64), with group-by, filters, downsample and a partial window;
  each value lies within ``alpha`` of the exact order statistic; with
  ``tsd.sketch.enable=false`` both answer nothing. ``sketchPartials``
  (a cluster router's request) gives each group's per-bucket sketches,
  their bytes equal to the reference's.
"""

import numpy as np
import pytest

from torch_pair import ENGINE_KEYS, T0

from opentsdb_tpu import TSDB as JTSDB  # noqa: E402  (after torch_pair)
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.ops import sketch_fold as jfold
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu.sketch import ddsketch as jdd
from opentsdb_tpu.sketch import query as jsq
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.ops import sketch_fold as tfold
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.sketch import ddsketch as tdd
from opentsdb_tpu_torch.sketch import query as tsq_mod


def values(rng, n: int) -> np.ndarray:
    """Latency-like values with zeros, negatives and NaNs mixed in."""
    v = rng.lognormal(3.0, 0.8, n)
    v[rng.random(n) < 0.05] = 0.0
    v[rng.random(n) < 0.05] *= -1
    v[rng.random(n) < 0.02] = np.nan
    return v


@pytest.mark.parametrize("alpha", [0.01, 0.05])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ddsketch_equals_reference(seed, alpha):
    rng = np.random.default_rng(seed)
    parts = [values(rng, int(rng.integers(1, 300))) for _ in range(4)]
    js, ts = [], []
    for p in parts:
        j, t = jdd.DDSketch(alpha), tdd.DDSketch(alpha)
        j.add_values(p)
        t.add_values(p)
        assert t.to_bytes() == j.to_bytes()
        js.append(j)
        ts.append(t)
    w = rng.integers(1, 5, 40).astype(float)
    mids = rng.uniform(-5, 500, 40)
    js[0].add_weighted(mids, w)
    ts[0].add_weighted(mids, w)
    js[1].add(3.5)
    ts[1].add(3.5)
    jm, tm = jdd.merge_all(js), tdd.merge_all(ts)
    assert tm.to_bytes() == jm.to_bytes()
    assert tm.to_b64() == jm.to_b64()
    assert tdd.DDSketch.from_b64(jm.to_b64()).to_bytes() == jm.to_bytes()
    qs = [0, 1, 25, 50, 75, 99, 99.9, 100]
    assert np.asarray(tm.quantiles(qs)).view(np.int64).tolist() == \
        np.asarray(jm.quantiles(qs)).view(np.int64).tolist()
    for cap in (64, 8, 1):
        jc, tc = jm.copy(), tm.copy()
        jc.collapse(cap)
        tc.collapse(cap)
        assert tc.to_bytes() == jc.to_bytes()
    assert np.isnan(tdd.DDSketch(alpha).quantile(50))
    assert tdd.merge_all([], alpha).to_bytes() == \
        jdd.merge_all([], alpha).to_bytes()
    with pytest.raises(tdd.SketchError, match="alpha mismatch"):
        tm.merge(_one(alpha * 2))


def _one(alpha):
    s = tdd.DDSketch(alpha)
    s.add(1.0)
    return s


def test_ddsketch_blob_errors_equal_reference():
    good = jdd.DDSketch()
    good.add_values(np.arange(1.0, 50.0))
    blob = good.to_bytes()
    for bad in (blob[:10], b"XXXX" + blob[4:], blob + b"\x00",
                blob[:-4]):
        with pytest.raises(jdd.SketchError) as je:
            jdd.DDSketch.from_bytes(bad)
        with pytest.raises(tdd.SketchError) as te:
            tdd.DDSketch.from_bytes(bad)
        assert str(te.value) == str(je.value)
    for a in (0.0, 1.0, -0.1):
        with pytest.raises(tdd.SketchError):
            tdd.DDSketch(a)


@pytest.mark.parametrize("max_buckets", [None, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_fold_cells_equal_reference(seed, max_buckets):
    rng = np.random.default_rng(seed)
    n = 2000
    ts = T0 * 1000 + np.sort(rng.integers(0, 3_600_000, n))
    v = values(rng, n)
    want = jfold.fold_cells(ts, v, 300_000, 0.01, max_buckets)
    got = tfold.fold_cells(ts, v, 300_000, 0.01, max_buckets)
    assert got.keys() == want.keys() and got
    for k in want:
        assert got[k].to_bytes() == want[k].to_bytes()
    sidx = rng.integers(0, 7, n)
    want = jfold.fold_series_cells(sidx, ts, v, 600_000, 0.02, max_buckets)
    got = tfold.fold_series_cells(sidx, ts, v, 600_000, 0.02, max_buckets)
    assert got.keys() == want.keys() and got
    for k in want:
        assert got[k].to_bytes() == want[k].to_bytes()
    assert tfold.fold_cells(ts[:0], v[:0], 60_000, 0.01) == {}
    assert tfold.fold_series_cells(sidx[:0], ts[:0], v[:0], 60_000,
                                   0.01) == {}
    a, b = tdd.DDSketch(), tdd.DDSketch()
    a.add_values(v[:100])
    b.add_values(v[100:300])
    got = tfold.merge_sorted_counts(a.pos_idx, a.pos_cnt, b.pos_idx,
                                    b.pos_cnt)
    want = jfold.merge_sorted_counts(a.pos_idx, a.pos_cnt, b.pos_idx,
                                     b.pos_cnt)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# -- the scalar percentile sub-query ------------------------------------------

KEYS = {"tsd.core.auto_create_metrics": "true", **ENGINE_KEYS}
SM = "sys.lat"


def make_pair(**extra):
    jt = JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", **KEYS, **extra}))
    tt = TSDB(Config(**{"tsd.torch.device": "cpu", "tsd.torch.dtype":
                        "float64", **KEYS, **extra}))
    rng = np.random.default_rng(0)
    for i in range(30):
        ts = T0 + 60 * np.arange(60)
        v = rng.lognormal(3.0, 0.8, 60)
        keep = rng.random(60) >= 0.03
        tags = {"host": f"h{i:02d}", "dc": f"dc{i % 3}", "rack": f"r{i % 4}"}
        for t in (jt, tt):
            t.add_points(SM, ts[keep], v[keep], tags)
    return jt, tt


@pytest.fixture(scope="module")
def pair():
    jt, tt = make_pair()
    yield jt, tt
    tt.shutdown()


def rows(results):
    return [(r.metric, r.tags, sorted(r.aggregated_tags),
             [t for t, _ in r.dps],
             np.asarray([v for _, v in r.dps]).view(np.int64).tolist())
            for r in results]


def q(sub: dict, start=T0, end=T0 + 3599, **extra) -> dict:
    return {"start": str(start), "end": str(end),
            "queries": [{"aggregator": "sum", "metric": SM, **sub}],
            **extra}


SCALAR_QUERIES = {
    "whole": q({"percentiles": [50.0, 99.0]}),
    "downsample": q({"percentiles": [50.0, 99.0], "downsample": "5m-avg"}),
    "group-by": q({"percentiles": [10.0, 99.9], "downsample": "15m-avg",
                   "filters": [{"type": "wildcard", "tagk": "dc",
                                "filter": "*", "groupBy": True}]}),
    "filtered": q({"percentiles": [75.0], "downsample": "10m-sum",
                   "filters": [{"type": "literal_or", "tagk": "rack",
                                "filter": "r1|r2", "groupBy": True}]}),
    "partial": q({"percentiles": [50.0], "downsample": "1m-avg"},
                 start=T0 + 600, end=T0 + 1199, msResolution=True),
    "empty": q({"percentiles": [50.0]}, start=T0 + 7200, end=T0 + 9000),
}


@pytest.mark.parametrize("name", sorted(SCALAR_QUERIES))
def test_scalar_percentiles_equal_reference(pair, name):
    jt, tt = pair
    body = SCALAR_QUERIES[name]
    got = rows(tt.execute_query(TSQuery.from_json(body).validate()))
    want = rows(jt.execute_query(JQuery.from_json(body).validate()))
    assert got == want
    assert bool(got) == (name != "empty")
    assert all(r[0].startswith(f"{SM}_pct_") for r in got)


def test_scalar_percentiles_within_alpha_of_exact(pair):
    """Each value lies within the documented alpha of the exact order
    statistic of the bucket's points (rank ``q/100 * (n - 1)``, as the
    sketch ranks)."""
    _, tt = pair
    body = q({"percentiles": [50.0, 99.0], "downsample": "5m-avg"})
    got = tt.execute_query(TSQuery.from_json(body).validate())
    alpha = tsq_mod.documented_alpha(tt)
    mid = tt.uids.metrics.get_id(SM)
    batch = tt.store.materialize(tt.store.series_ids_for_metric(mid),
                                 T0 * 1000, (T0 + 3599) * 1000)
    cell = (batch.ts_ms - T0 * 1000) // 300_000
    for r, qv in zip(got, (50.0, 99.0)):
        for ts, v in r.dps:
            pts = np.sort(batch.values[cell == (ts - T0 * 1000) // 300_000])
            exact = pts[int(np.floor(qv / 100 * (len(pts) - 1)))]
            assert abs(v - exact) <= alpha * abs(exact) + 1e-12


def test_two_calls_same_bits(pair):
    _, tt = pair
    body = SCALAR_QUERIES["group-by"]
    a = rows(tt.execute_query(TSQuery.from_json(body).validate()))
    b = rows(tt.execute_query(TSQuery.from_json(body).validate()))
    assert a == b


def test_sketch_disabled_answers_as_reference():
    jt, tt = make_pair(**{"tsd.sketch.enable": "false"})
    body = SCALAR_QUERIES["downsample"]
    assert tt.execute_query(TSQuery.from_json(body).validate()) == []
    assert jt.execute_query(JQuery.from_json(body).validate()) == []
    assert tsq_mod.run_sketch_percentiles(
        tt, TSQuery.from_json(body).validate(),
        TSQuery.from_json(body).validate().queries[0]) is None
    tt.shutdown()


def test_unknown_metric_and_partials(pair):
    jt, tt = pair
    body = q({"percentiles": [50.0]})
    body["queries"][0]["metric"] = "no.such"
    with pytest.raises(BadRequestError) as te:
        tt.execute_query(TSQuery.from_json(body).validate())
    with pytest.raises(ValueError) as je:
        jt.execute_query(JQuery.from_json(body).validate())
    assert str(te.value) == str(je.value)
    # a router's sketchPartials: one row per group with its per-bucket
    # sketches, the reference's bytes
    parts = []
    for side, t, Q in (("port", tt, TSQuery), ("jax", jt, JQuery)):
        tq = Q.from_json({**SCALAR_QUERIES["group-by"],
                          "sketchPartials": True}).validate()
        assert tq.sketch_partials
        mod = tsq_mod if side == "port" else jsq
        got = mod.run_sketch_percentiles(t, tq, tq.queries[0],
                                         partials=True)
        parts.append(sorted((r.metric, sorted(r.tags.items()),
                             [(int(ts), bytes(b)) for ts, b in r.sketches])
                            for r in got))
    assert parts[0] == parts[1] and parts[0]
    assert tsq_mod._config_sketch(tt) == jsq._config_sketch(jt)
