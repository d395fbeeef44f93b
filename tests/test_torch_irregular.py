"""The port's irregular point paths against the JAX package on the same
seeded inputs: the padded layout (``bucketize_padded``,
``run_pipeline_padded``), the flat layout (``bucketize``,
``run_pipeline``, ``prepare_flat``/``execute``), their host helpers
(``detect_dense``, ``flatten_padded``, ``TimeSeriesStore.materialize``),
the layout dispatch of ``execute_auto``/``prepare_auto``, and whole
queries through both ``TSDB.execute_query`` over jittered data with
dropped points, NaN values and a skewed batch that the engine
materializes flat.

Tolerance: float64 on both sides (conftest enables x64), rtol 1e-9 and
atol 1e-9 * max|x|; NaN positions and emit masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.core.store import PaddedBatch as JPadded
from opentsdb_tpu.core.store import TimeSeriesStore as JStore
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu.query import engine as jengine
from opentsdb_tpu_torch.core.store import PaddedBatch as TPadded
from opentsdb_tpu_torch.core.store import TimeSeriesStore
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import rate as trate
from opentsdb_tpu_torch.query import engine as tengine
from torch_pair import (ENGINE_KEYS, GRID_ON, T0, irregular, port_tsdb,
                        reference_tsdb, run_both, uri_query)

PADDED_FNS = sorted(tds.PADDED_FNS)
B = 12                      # 5-minute buckets over the hour


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


def _padded(s=40, p=60, seed=0, nan=0.05):
    """(values2d, bucket_idx2d, counts, ts2d ms, bucket_ts) of jittered
    rows with dropped points and NaN values; two rows hold signed
    zeros and one row is empty."""
    _, ts2d, v2d, counts = irregular(s, p, seed, nan=nan)
    counts[5] = 0
    v2d[5], ts2d[5] = np.nan, 0
    v2d[3, :counts[3]] = np.where(np.arange(counts[3]) % 2, 0.0, -0.0)
    v2d[4, :8] = -0.0
    spec = tds.DownsamplingSpecification.parse("5m-sum")
    bidx, bts = tds.assign_buckets_padded(ts2d * 1000, counts, spec,
                                          T0 * 1000, T0 * 1000 + 3599_999)
    return v2d, bidx, counts, ts2d * 1000, bts


@pytest.mark.parametrize("fn", PADDED_FNS)
def test_bucketize_padded(fn):
    v2d, bidx, _, _, _ = _padded()
    jg, jc = jds.bucketize_padded(jnp.asarray(v2d), jnp.asarray(bidx), B,
                                  fn)
    tg, tc = tds.bucketize_padded(torch.as_tensor(v2d),
                                  torch.as_tensor(bidx), B, fn)
    _assert_close(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("fn", PADDED_FNS)
def test_bucketize_flat(fn):
    v2d, bidx, counts, _, _ = _padded(seed=1)
    vals, sidx, fbidx = tpipe.flatten_padded(v2d, bidx, counts)
    s = v2d.shape[0]
    jg, jc = jds.bucketize(jnp.asarray(vals), jnp.asarray(sidx),
                           jnp.asarray(fbidx), s, B, fn)
    tg, tc = tds.bucketize(torch.as_tensor(vals), torch.as_tensor(sidx),
                           torch.as_tensor(fbidx), s, B, fn)
    _assert_close(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_bucket_bands_cover_each_bucket():
    """A bucket's band holds every column where its points sit, and the
    jittered layout keeps the bands narrow."""
    _, bidx, counts, _, _ = _padded(s=200, seed=2)
    bands = tds.bucket_bands(torch.as_tensor(bidx), B)
    # a bucket's 5 slots, shifted left by the points a row dropped
    width = 5 + int((60 - counts[counts > 0]).max())
    for b, (lo, hi) in enumerate(bands):
        cols = np.nonzero((bidx == b).any(axis=0))[0]
        assert lo <= cols.min() and cols.max() < hi
        assert hi - lo <= width
    empty = tds.bucket_bands(torch.as_tensor(bidx), B + 3)
    assert empty[-1] == (0, 0)


def test_helpers_match_reference():
    v2d, bidx, counts, _, _ = _padded(seed=3)
    for a, b in zip(tpipe.flatten_padded(v2d, bidx, counts),
                    jpipe.flatten_padded(v2d, bidx, counts)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    s, k = 7, 3
    sidx = np.repeat(np.arange(s, dtype=np.int32), B * k)
    fb = np.tile(np.repeat(np.arange(B, dtype=np.int32), k), s)
    for fn, args in (("avg", (sidx, fb)), ("median", (sidx, fb)),
                     ("sum", (sidx[:-1], fb[:-1])),
                     ("sum", (sidx, np.roll(fb, 1)))):
        assert tpipe.detect_dense(s, B, *args, fn) == \
            jpipe.detect_dense(s, B, *args, fn)
    assert tpipe.detect_dense(s, B, sidx, fb, "avg") == k


def test_store_materialize_matches_reference():
    """The flat read of jittered rows, a series of no points and a
    window that cuts rows, as the reference's store reads it."""
    tags, ts2d, v2d, counts = irregular(30, 60, seed=4)
    counts[7] = 0
    j, t = JStore(), TimeSeriesStore()
    for st in (j, t):
        for i in range(30):
            st.get_or_create_series(1, [(1, i)])
    for i in range(30):
        n = counts[i]
        j.append_many(i, ts2d[i, :n] * 1000, v2d[i, :n])
        t.append_many(i, ts2d[i, :n] * 1000, v2d[i, :n])
    sids = np.array([9, 7, 0, 29, 3])
    for lo, hi in ((0, 2**62), ((T0 + 600) * 1000, (T0 + 1799) * 1000)):
        want, got = j.materialize(sids, lo, hi), t.materialize(sids, lo, hi)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got.num_points == want.num_points


def _run(jfn, tfn, *args, jkw=None, tkw=None):
    want, want_emit = jfn(*args, **(jkw or {}))
    got, got_emit = tfn(*args, **(tkw or {}))
    _assert_close(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_emit.numpy(), np.asarray(want_emit))


def _specs(fill="none", **kw):
    fv = {"zero": 0.0, "scalar": -3.5}.get(fill, float("nan"))
    return (jpipe.PipelineSpec(fill_policy=jds.FillPolicy(fill),
                               fill_value=fv, **kw),
            tpipe.PipelineSpec(fill_policy=tds.FillPolicy(fill),
                               fill_value=fv, **kw))


@pytest.mark.parametrize("ds_fn,agg,rate,fill", [
    ("last", "sum", True, "none"),
    ("avg", "avg", False, "none"),
    ("max", "min", False, "zero"),
    ("first", "dev", True, "nan"),
    ("sum", "zimsum", False, "scalar"),
    ("diff", "mimmax", False, "none"),
    ("dev", "count", False, "none"),
    ("multiply", "squareSum", False, "none"),
    ("count", "p99", False, "none"),
    ("min", "median", True, "none"),
    ("avg", "none", True, "none"),
])
def test_execute_auto_padded(ds_fn, agg, rate, fill):
    """Irregular rows of a padded function: both packages take their
    padded layout."""
    v2d, bidx, counts, ts2d, bts = _padded(seed=5)
    s, g = v2d.shape[0], 6
    gids = (np.arange(s) % g).astype(np.int32)
    emit_raw = agg == "none"
    jspec, tspec = _specs(fill, num_series=s, num_buckets=B,
                          num_groups=s if emit_raw else g,
                          ds_function=ds_fn, agg_name=agg, rate=rate,
                          emit_raw=emit_raw)
    if emit_raw:
        gids = np.arange(s, dtype=np.int32)
    prep = tpipe.prepare_auto(TPadded(np.arange(s), v2d, ts2d, counts),
                              bidx, tspec, dtype=torch.float64,
                              device="cpu")
    assert prep.kind == "padded"
    _run(jpipe.execute_auto, tpipe.execute_auto,
         JPadded(np.arange(s), v2d, ts2d, counts), bidx, bts, gids,
         jkw={"spec": jspec, "rate_options": None},
         tkw={"spec": tspec, "rate_options": None,
              "dtype": torch.float64, "device": "cpu"})


@pytest.mark.parametrize("ds_fn", ["median", "p99", "ep95r3", "ep95r7"])
def test_execute_auto_rank_downsample_takes_flat(ds_fn):
    """A rank downsample function is not a padded one: the batch is
    flattened, as in the reference."""
    v2d, bidx, counts, ts2d, bts = _padded(seed=6)
    s = v2d.shape[0]
    gids = (np.arange(s) % 40).astype(np.int32)
    jspec, tspec = _specs(num_series=s, num_buckets=B, num_groups=40,
                          ds_function=ds_fn, agg_name="p99")
    prep = tpipe.prepare_auto(TPadded(np.arange(s), v2d, ts2d, counts),
                              bidx, tspec, dtype=torch.float64,
                              device="cpu")
    assert prep.kind == "flat"
    _run(jpipe.execute_auto, tpipe.execute_auto,
         JPadded(np.arange(s), v2d, ts2d, counts), bidx, bts, gids,
         jkw={"spec": jspec, "rate_options": None},
         tkw={"spec": tspec, "rate_options": None,
              "dtype": torch.float64, "device": "cpu"})


def test_execute_auto_over_the_padded_budget_takes_flat(monkeypatch):
    """Past ``_PADDED_EINSUM_MAX_CELLS`` both packages flatten a padded
    function's batch."""
    v2d, bidx, counts, ts2d, bts = _padded(seed=7)
    s = v2d.shape[0]
    monkeypatch.setattr(jpipe, "_PADDED_EINSUM_MAX_CELLS", 100)
    monkeypatch.setattr(tpipe, "_PADDED_EINSUM_MAX_CELLS", 100)
    gids = (np.arange(s) % 6).astype(np.int32)
    jspec, tspec = _specs(num_series=s, num_buckets=B, num_groups=6,
                          ds_function="avg", agg_name="sum", rate=True)
    prep = tpipe.prepare_auto(TPadded(np.arange(s), v2d, ts2d, counts),
                              bidx, tspec, dtype=torch.float64,
                              device="cpu")
    assert prep.kind == "flat"
    _run(jpipe.execute_auto, tpipe.execute_auto,
         JPadded(np.arange(s), v2d, ts2d, counts), bidx, bts, gids,
         jkw={"spec": jspec, "rate_options": None},
         tkw={"spec": tspec, "rate_options": None,
              "dtype": torch.float64, "device": "cpu"})


@pytest.mark.parametrize("ds_fn,agg,ro", [
    ("sum", "sum", None),
    ("last", "avg", dict(counter=True, counter_max=2**32)),
    ("median", "max", None),
    ("first", "p50", None),
])
def test_execute_skewed_flat_batch(ds_fn, agg, ro):
    """A skewed flat batch (one series of 600 points among short ones)
    through both ``execute``."""
    rng = np.random.default_rng(8)
    lens = np.r_[600, rng.integers(0, 6, 30)]
    s = len(lens)
    series_idx = np.repeat(np.arange(s, dtype=np.int32), lens)
    ts = np.concatenate([np.sort(rng.choice(3600, n, replace=False))
                         for n in lens]).astype(np.int64) * 1000
    vals = rng.normal(50.0, 10.0, len(ts))
    vals[rng.random(len(ts)) < 0.05] = np.nan
    spec_ds = tds.DownsamplingSpecification.parse("5m-sum")
    bidx, bts = tds.assign_buckets(ts, spec_ds, 0, 3_599_999)
    gids = (np.arange(s) % 4).astype(np.int32)
    jspec, tspec = _specs(num_series=s, num_buckets=len(bts), num_groups=4,
                          ds_function=ds_fn, agg_name=agg,
                          rate=ro is not None,
                          rate_counter=bool(ro and ro["counter"]))
    prep = tpipe.prepare_flat(vals, series_idx, bidx, tspec,
                              dtype=torch.float64, device="cpu")
    assert prep.kind == "flat"
    _run(jpipe.execute, tpipe.execute, vals, series_idx, bidx, bts, gids,
         jkw={"spec": jspec,
              "rate_options": jrate.RateOptions(**ro) if ro else None},
         tkw={"spec": tspec,
              "rate_options": trate.RateOptions(**ro) if ro else None,
              "dtype": torch.float64, "device": "cpu"})


def test_prepare_flat_orders_an_unsorted_batch():
    """A flat batch out of (series, time) order answers as the same
    batch in order."""
    rng = np.random.default_rng(9)
    s, n = 6, 80
    series_idx = np.sort(rng.integers(0, s, n)).astype(np.int32)
    bidx = rng.integers(0, 4, n).astype(np.int32)
    order = np.lexsort((bidx, series_idx))
    vals = rng.normal(size=n)
    _, spec = _specs(num_series=s, num_buckets=4, num_groups=2,
                     ds_function="sum", agg_name="sum")
    gids = np.arange(s) % 2
    a = tpipe.execute(vals, series_idx, bidx, np.arange(4) * 60_000,
                      gids, spec, None, dtype=torch.float64, device="cpu")
    b = tpipe.execute(vals[order], series_idx[order], bidx[order],
                      np.arange(4) * 60_000, gids, spec, None,
                      dtype=torch.float64, device="cpu")
    _assert_close(a[0].numpy(), b[0].numpy())


def test_padded_path_is_deterministic_without_scatter(monkeypatch):
    """The padded and flat reductions and the group stage use no
    atomic scatter, and two calls give the same bits."""
    def atomic(*a, **k):
        raise AssertionError("an order-free scatter ran")

    for name in ("index_add_", "scatter_add_", "scatter_reduce_"):
        monkeypatch.setattr(torch.Tensor, name, atomic)
    v2d, bidx, counts, ts2d, bts = _padded(seed=10)
    s = v2d.shape[0]
    for ds_fn in ("avg", "median"):
        _, spec = _specs(num_series=s, num_buckets=B, num_groups=5,
                         ds_function=ds_fn, agg_name="sum", rate=True)
        outs = [tpipe.execute_auto(TPadded(np.arange(s), v2d, ts2d, counts),
                                   bidx, bts, np.arange(s) % 5, spec, None,
                                   dtype=torch.float64, device="cpu")[0]
                for _ in range(2)]
        assert torch.equal(outs[0].view(torch.int64),
                           outs[1].view(torch.int64))


# -- whole queries ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    metrics = {"j": irregular(120, 60, seed=11, nan=0.01)}
    jt = reference_tsdb(metrics)
    return jt, port_tsdb(jt, metrics)


QUERIES = [
    "sum:5m-last:rate:j{dc=*}",
    "avg:5m-avg:j{dc=*}",
    "sum:j{dc=dc1|dc3}",                  # union grid
    "zimsum:10m-count:j",
    "mimmax:5m-diff:j{dc=*}",
    "max:5m-multiply:j{rack=r1|r2|r3}",
    "min:1m-squareSum:j{dc=*}",
    "dev:10m-dev:j{dc=*}",
    "count:10m-first-zero:j{dc=*}",
    "sum:5m-sum-nan:j",
    "avg:5m-max-scalar#2.5:rate:j{dc=*}",
    "none:15m-avg:j{rack=r5}",
    "pfsum:5m-last:rate{counter,1000,100}:j{dc=*}",
]


@pytest.mark.parametrize("grid", ["off", "on"])
@pytest.mark.parametrize("m", QUERIES)
def test_query_matches_reference(pair, m, grid, monkeypatch):
    """Each query through both engines at the point-path keys, and with
    the grid reduction on (its functions take the grid path there, the
    others the point path)."""
    jt, tt = pair
    keys = GRID_ON if grid == "on" else ENGINE_KEYS
    for key, value in keys.items():
        jt.config.override_config(key, value)
        tt.config.override_config(key, value)
    kinds = []
    orig = tengine.run_prepared
    monkeypatch.setattr(tengine, "run_prepared", lambda prep, *a, **k:
                        kinds.append(prep.kind) or orig(prep, *a, **k))
    run_both(jt, tt, uri_query(m))
    assert set(kinds) <= {"padded", "flat"}


def test_skewed_batch_is_materialized_flat(pair, monkeypatch):
    """One series of 720 points among 60-point ones: with the padded
    layout's minimum cut to 1000 cells, both engines materialize the
    window flat and agree."""
    monkeypatch.setattr(jengine, "_PADDED_MIN_CELLS", 1000)
    monkeypatch.setattr(tengine, "_PADDED_MIN_CELLS", 1000)
    long_ts = T0 + 5 * np.arange(720, dtype=np.int64)
    metrics = {"k": irregular(20, 60, seed=12)}
    jt = reference_tsdb(metrics)
    jt.add_points("k", long_ts, np.random.default_rng(13).normal(
        size=720), {"host": "long", "dc": "dc0", "rack": "r0"})
    tt = port_tsdb(jt, metrics)
    calls = []
    orig = tt.store.materialize
    monkeypatch.setattr(tt.store, "materialize", lambda *a, **k:
                        calls.append(1) or orig(*a, **k))
    for m in ("sum:5m-avg:k{dc=*}", "p90:1m-median:k{dc=*}", "sum:k"):
        run_both(jt, tt, uri_query(m))
    assert len(calls) == 3
