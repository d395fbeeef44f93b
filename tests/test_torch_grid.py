"""The port's grid path against the JAX reference on the same inputs.

- ``TimeSeriesStore.bucket_reduce`` against the reference's portable
  store and its native store: counts, min and max bit-equal, sums at
  rtol 1e-12 (the port adds a bucket's points pairwise, the reference
  left to right).
- ``execute_grid`` (``put_grid`` + the tail) against the reference's
  ``execute_grid`` over fill policies, rate options, ``emit_raw`` and
  the ported aggregators: float64 on both sides (conftest enables x64),
  rtol 1e-9 and atol 1e-9 * max|x|, NaN positions and emit masks equal.
- Whole queries through both ``TSDB.execute_query`` at the reference's
  defaults (grid reduction and device cache on; the host-CPU tail and
  the result cache off on both sides, so a repeat reaches the device
  cache), and with
  ``grid_reduce=false`` and the cache on, cold and warm: same
  tolerance.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.core.store import TimeSeriesStore as JStore
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.store import TimeSeriesStore
from opentsdb_tpu_torch.core.state import load_arrays
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import rate as trate
from opentsdb_tpu_torch.query.model import TSQuery
from torch_pair import export as _export, jax_native_library, rows as _rows

T0 = 1356998400
BASE_MS = T0 * 1000
HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}
LINEAR_AGGS = ["sum", "zimsum", "pfsum", "avg", "count", "min", "max",
               "mimmin", "mimmax", "multiply", "squareSum", "dev",
               "first", "last", "diff"]


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


# -- bucket_reduce -----------------------------------------------------------

def _reference_store(backend: str):
    if backend == "memory":
        return JStore()
    from opentsdb_tpu.native.store_backend import NativeTimeSeriesStore
    if jax_native_library() is None:
        pytest.skip("no C++ compiler on this host: the reference's native "
                    "store cannot be built")
    # a library that fails to load fails the test
    return NativeTimeSeriesStore()


def _stores(backend: str, nan: bool):
    """The same writes into the port's store and a reference store: 40
    series of ms timestamps with duplicates (last write wins), out of
    order, some NaN values, in three write batches."""
    rng = np.random.default_rng(11)
    mine, ref = TimeSeriesStore(), _reference_store(backend)
    s = 40
    tags = [[(1, i)] for i in range(s)]
    for st in (mine, ref):
        st.get_or_create_series_bulk(7, tags)
    for _ in range(3):
        n = 3000
        sid = rng.integers(0, s, n)
        ts = BASE_MS + rng.integers(-30_000, 630_000, n)
        vals = rng.normal(10.0, 4.0, n)
        if nan:
            vals[rng.random(n) < 0.1] = np.nan
        mine.append_lines(sid, ts, vals)
        ref.append_lines(sid, ts, vals, np.zeros(n, dtype=bool))
    # points exactly on bucket edges, at end_ms and before t0
    for sid, off in ((3, 0), (3, 60_000), (4, 599_999), (5, -1),
                     (6, 600_000), (7, 17_000)):
        for st, extra in ((mine, ()), (ref, (False,))):
            st.append_many(sid, np.array([BASE_MS + off]),
                           np.array([float(off)]), *extra)
    return mine, ref, s


# (start_ms, end_ms, t0, interval_ms, nbuckets) relative to BASE_MS
WINDOWS = [
    (0, 599_999, 0, 60_000, 10),           # aligned hour of minutes
    (17_001, 400_000, 0, 7_000, 58),       # start not aligned
    (0, 600_000, 0, 60_000, 10),           # end on a bucket edge
    (-40_000, 700_000, 0, 50_000, 6),      # points before t0 / past B
    (100_000, 100_000, 60_000, 60_000, 3),  # one millisecond
    (650_000, 900_000, 600_000, 1_000, 30),  # empty window
    (-30_000, 650_000, -600_000, 2_000_000, 1),  # one bucket holds all
    (60_000, 60_000, 0, 60_000, 2),        # one point, on an edge
]


@pytest.mark.parametrize("backend", ["memory", "native"])
@pytest.mark.parametrize("want_minmax", [False, True])
@pytest.mark.parametrize("nan", [False, True])
def test_bucket_reduce_matches_reference(backend, want_minmax, nan):
    mine, ref, s = _stores(backend, nan)
    rng = np.random.default_rng(3)
    for start, end, t0, iv, nb in WINDOWS:
        for sids in (np.arange(s), rng.permutation(s)[:17],
                     np.array([s - 1]), np.array([], dtype=np.int64)):
            args = (sids, BASE_MS + start, BASE_MS + end, BASE_MS + t0,
                    iv, nb)
            got = mine.bucket_reduce(*args, want_minmax=want_minmax)
            want = ref.bucket_reduce(*args, want_minmax=want_minmax)
            assert got[0].shape == got[1].shape == (len(sids), nb)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-12,
                                       atol=0)
            if want_minmax:
                np.testing.assert_array_equal(got[2], want[2])
                np.testing.assert_array_equal(got[3], want[3])
            else:
                assert got[2] is None and got[3] is None


def test_bucket_reduce_irregular_rows_bisect():
    """Rows whose points are not evenly spaced miss the first guess of
    the edge search and are bisected: a bucket holding many points
    next to empty ones, and one-point rows."""
    mine, ref = TimeSeriesStore(), JStore()
    for st in (mine, ref):
        st.get_or_create_series_bulk(1, [[(1, i)] for i in range(4)])
    ts = BASE_MS + np.concatenate([np.arange(50) * 10,
                                   [300_000, 590_000]])
    writes = [(0, ts), (1, ts[::-1]), (2, ts[:1]), (3, ts[-1:])]
    for sid, t in writes:
        vals = np.sin(t / 1000.0)
        mine.append_many(sid, t, vals)
        ref.append_many(sid, t, vals)
    args = (np.arange(4), BASE_MS, BASE_MS + 599_999, BASE_MS, 60_000, 10)
    got = mine.bucket_reduce(*args, want_minmax=True)
    want = ref.bucket_reduce(*args, want_minmax=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[1][:2], [[50, 0, 0, 0, 0, 1, 0,
                                                0, 0, 1]] * 2)


def test_bucket_reduce_threads_over_row_chunks(monkeypatch):
    """Chunks of rows go to worker threads; the answer does not depend
    on the chunk size."""
    from opentsdb_tpu_torch.core import store as store_mod
    mine, ref, s = _stores("memory", nan=True)
    args = (np.arange(s), BASE_MS, BASE_MS + 599_999, BASE_MS, 60_000, 10)
    whole = mine.bucket_reduce(*args, want_minmax=True)
    monkeypatch.setattr(store_mod, "_REDUCE_CELLS", 3 * 11)
    chunked = mine.bucket_reduce(*args, want_minmax=True)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


# -- execute_grid ------------------------------------------------------------

def _grid(s=12, b=9, seed=0, counter=False):
    """[S, B] grid with interior, leading and trailing holes, an empty
    row and a single-value row."""
    rng = np.random.default_rng(seed)
    if counter:
        grid = np.cumsum(rng.uniform(1, 50, (s, b)), axis=1)
        grid[s // 2, b // 2:] -= grid[s // 2, b // 2] * 0.8
    else:
        grid = rng.normal(50.0, 20.0, (s, b))
    grid[rng.random((s, b)) < 0.3] = np.nan
    grid[0, :3] = np.nan
    grid[1, -3:] = np.nan
    grid[2, :] = np.nan
    grid[3, :] = np.nan
    grid[3, 4] = 7.0
    return grid


def _run_grid_both(grid, spec_kw, ro_kw=None, g=3):
    s, b = grid.shape
    has_data = ~np.isnan(grid)
    bucket_ts = BASE_MS + 60_000 * np.arange(b, dtype=np.int64)
    gids = (np.arange(s) % g).astype(np.int32)
    if spec_kw.get("emit_raw"):
        gids, g = np.arange(s, dtype=np.int32), s
    fill = spec_kw.pop("fill", "none")
    jspec = jpipe.PipelineSpec(
        num_series=s, num_buckets=b, num_groups=g, ds_function="avg",
        fill_policy=jds.FillPolicy.from_string(fill), **spec_kw)
    tspec = tpipe.PipelineSpec(
        num_series=s, num_buckets=b, num_groups=g, ds_function="avg",
        fill_policy=tds.FillPolicy.from_string(fill), **spec_kw)
    ro_kw = ro_kw or {}
    want = jpipe.execute_grid(grid, has_data, bucket_ts, gids, jspec,
                              jrate.RateOptions(**ro_kw))
    tgrid, thas = tpipe.put_grid(grid, has_data, torch.float64, "cpu")
    got = tpipe.execute_grid(tgrid, thas, bucket_ts, gids, tspec,
                             trate.RateOptions(**ro_kw))
    _assert_close(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("agg", LINEAR_AGGS)
@pytest.mark.parametrize("fill", ["none", "nan", "null", "zero", "scalar"])
def test_execute_grid_fill_and_aggs(agg, fill):
    kw = {"agg_name": agg, "fill": fill}
    if fill == "scalar":
        kw["fill_value"] = -3.5
    _run_grid_both(_grid(seed=LINEAR_AGGS.index(agg)), kw)


@pytest.mark.parametrize("ro", [
    {}, {"counter": True, "counter_max": 2.0**32, "reset_value": 0.0},
    {"counter": True, "counter_max": 500.0, "reset_value": 100.0},
    {"counter": True, "drop_resets": True}])
@pytest.mark.parametrize("agg", ["sum", "avg", "zimsum", "max"])
def test_execute_grid_rate(agg, ro):
    kw = {"agg_name": agg, "rate": True,
          "rate_counter": ro.get("counter", False),
          "rate_drop_resets": ro.get("drop_resets", False)}
    _run_grid_both(_grid(counter=bool(ro), seed=5), kw, ro)


@pytest.mark.parametrize("rate", [False, True])
def test_execute_grid_emit_raw(rate):
    _run_grid_both(_grid(seed=9), {"agg_name": "none", "emit_raw": True,
                                   "rate": rate})


def test_grid_from_reduce_matches_reference_choices():
    """The grid of each downsample function from the same statistics
    (the reference builds it inline in ``_grid_pipeline``)."""
    mine, _, s = _stores("memory", nan=True)
    args = (np.arange(s), BASE_MS, BASE_MS + 599_999, BASE_MS, 60_000, 10)
    sums, cnts, mins, maxs = mine.bucket_reduce(*args, want_minmax=True)
    present = cnts > 0
    expect = {"sum": sums, "zimsum": sums, "pfsum": sums, "count": cnts,
              "avg": sums / np.maximum(cnts, 1.0), "min": mins,
              "mimmin": mins, "max": maxs, "mimmax": maxs}
    for fn, want in expect.items():
        grid, has = tpipe.grid_from_reduce(fn, sums, cnts, mins, maxs)
        np.testing.assert_array_equal(has, present)
        np.testing.assert_array_equal(grid,
                                      np.where(present, want, np.nan))
    with pytest.raises(ValueError):
        tpipe.grid_from_reduce("last", sums, cnts, mins, maxs)


# -- whole queries -----------------------------------------------------------

S, P = 120, 60


def _write_reference(extra: dict):
    """A reference TSDB holding gauges, counters with rollovers and
    gauges with NaN holes, S series x P points at one a minute."""
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu",
                          "tsd.query.cache.enable": "false",
                          **HOST_TAIL_OFF, **extra}))
    rng = np.random.default_rng(42)
    ts = T0 + 60 * np.arange(P, dtype=np.int64)
    gauge = rng.normal(100.0, 15.0, (S, P))
    counter = np.cumsum(rng.uniform(0, 40, (S, P)), axis=1)
    counter[7, 30:] -= counter[7, 30] * 0.95
    holed = gauge + 5.0
    holed[rng.random((S, P)) < 0.2] = np.nan
    holed[3, :10] = np.nan
    for metric, vals in (("m", gauge), ("c", counter), ("h", holed)):
        for i in range(S):
            jt.add_points(metric, ts, vals[i],
                          {"host": f"web{i:03d}", "dc": f"dc{i % 6}",
                           "rack": f"r{i % 40}"})
    return jt


def _pair(extra: dict):
    jt = _write_reference(extra)
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64",
                        "tsd.query.cache.enable": "false",
                        **HOST_TAIL_OFF, **extra}))
    for metric in ("m", "c", "h"):
        load_arrays(tt, metric, *_export(jt, metric))
    return jt, tt


@pytest.fixture(scope="module")
def defaults():
    """Both TSDBs at the reference's defaults (host-CPU tail off)."""
    return _pair({})


@pytest.fixture(scope="module")
def no_grid():
    """Both TSDBs with grid_reduce=false and the device cache on."""
    return _pair({"tsd.query.grid_reduce": "false"})


def _assert_same_rows(a, b):
    """Equal rows, NaN values equal."""
    assert [r[:4] for r in a] == [r[:4] for r in b]
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra[4], rb[4])


def _run_both(pair, m: str, start=T0, end=T0 + P * 60 - 1):
    jt, tt = pair
    query = {"start": str(start), "end": str(end), "queries": [
        _query_json(m)]}
    want = _rows(jt.execute_query(JQuery.from_json(query).validate()))
    got = _rows(tt.execute_query(TSQuery.from_json(query).validate()))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        _assert_close(g[4], w[4])
    return got


def _query_json(m):
    from opentsdb_tpu_torch.query.model import parse_uri_subquery
    sub = parse_uri_subquery(m)
    out = {"aggregator": sub.aggregator, "metric": sub.metric,
           "rate": sub.rate,
           "filters": [{"type": f.filter_name, "tagk": f.tagk,
                        "filter": f.filter_expr, "groupBy": f.group_by}
                       for f in sub.filters]}
    if sub.downsample:
        out["downsample"] = sub.downsample
    if sub.rate_options.counter:
        ro = sub.rate_options
        out["rateOptions"] = {"counter": True,
                              "counterMax": ro.counter_max,
                              "resetValue": ro.reset_value,
                              "dropResets": ro.drop_resets}
    return out


GRID_QUERIES = [
    "sum:5m-avg:rate:m{dc=*}",
    "sum:5m-avg:rate:m{rack=*}",
    "avg:1m-max:m{host=*}",
    "zimsum:5m-sum:rate{counter,1000,100}:c{dc=*}",
    "sum:5m-avg:h{dc=*}",
    "avg:10m-avg-zero:rate:h{rack=*}",
    "max:5m-min:m{rack=*}",
    "count:15m-count:m",
    "dev:30m-avg-nan:h{dc=wildcard(dc*)}",
    "mimmax:7m-mimmin-null:h{dc=dc1|dc3}",
    "pfsum:5m-pfsum-scalar#2.5:h{dc=*}",
    "none:5m-zimsum:rate:h{dc=dc2}{rack=r2|r8}",
    "sum:2m-sum:rate{counter,,,dropResets}:c{dc=*}",
]
# queries the grid path declines: no downsample, or first/last
POINT_QUERIES = [
    "sum:m{dc=dc1|dc3}",
    "pfsum:5m-last:rate:c{dc=*}{rack=r1|r2|r7}",
    "squareSum:5m-first:m{dc=*}{host=not_literal_or(web001|web002)}",
]


@pytest.mark.parametrize("m", GRID_QUERIES)
def test_grid_query_matches_reference(defaults, m, monkeypatch):
    """At the defaults a grid query reduces in the store and runs no
    kernel wrapper nor the point path's materialize."""
    _, tt = defaults
    calls = []
    orig = tt.store.materialize_padded
    monkeypatch.setattr(tt.store, "materialize_padded",
                        lambda *a: calls.append(1) or orig(*a))
    launches = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    _run_both(defaults, m)
    # a window whose start is not aligned to the interval
    _run_both(defaults, m, start=T0 + 17 * 60 + 13, end=T0 + 3000)
    assert calls == []
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == launches


@pytest.mark.parametrize("m", POINT_QUERIES)
def test_point_query_at_defaults_matches_reference(defaults, m):
    """Queries the grid path declines take the point path, through the
    prepared-batch cache: a warm repeat is a hit and answers alike."""
    _, tt = defaults
    cold = _run_both(defaults, m)
    hits = tt.device_grid_cache.hits
    _assert_same_rows(_run_both(defaults, m), cold)
    assert tt.device_grid_cache.hits == hits + 1


@pytest.mark.parametrize("m", GRID_QUERIES[:6] + POINT_QUERIES)
def test_prepared_batch_cold_and_warm_match_reference(no_grid, m):
    """grid_reduce=false with the cache on: every query takes the point
    path; the first run uploads and caches the batch (unless a query
    over the same series and downsample did), the second is a hit. Both
    answer as the reference does."""
    _, tt = no_grid
    cold = _run_both(no_grid, m)
    hits = tt.device_grid_cache.hits
    _assert_same_rows(_run_both(no_grid, m), cold)
    assert tt.device_grid_cache.hits == hits + 1


def test_grid_over_budget_takes_the_point_path(monkeypatch):
    """A grid of more cells than tsd.query.max_device_cells leaves the
    grid path, as in the reference; the point path answers alike."""
    jt, tt = _pair({"tsd.query.max_device_cells": str(S * 12 - 1)})
    calls = []
    orig = tt.store.bucket_reduce
    monkeypatch.setattr(tt.store, "bucket_reduce",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _run_both((jt, tt), "sum:5m-avg:rate:m{dc=*}")
    assert calls == []
    _run_both((jt, tt), "sum:10m-avg:rate:m{dc=*}")
    assert len(calls) == 1
