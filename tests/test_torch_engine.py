"""The port's query path as a whole: the same stored data queried through
the reference's ``TSDB.execute_query`` and the port's.

Both TSDBs run with the five keys that put the engine on the point path
(no storage-side grid reduction, no device batch cache, no host-CPU
tail, no result cache), so the reference's queries reach
``execute_auto`` and the Pallas kernels (interpret mode on the CPU)
and the port's reach its kernel wrappers. The grid path and the caches, the port's defaults, are held
against the reference in ``test_torch_grid.py``. The reference's store
and UID tables are exported to numpy in the tests
(``torch_pair.export``) and loaded into the port with
``core.state.load_arrays``. Results must agree in metric,
tags, aggregateTags and dps (float64 on both sides, rtol 1e-9, NaN
equal).
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.state import load_arrays
from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
from torch_pair import export as _export, rows as _rows

# the result cache off as well: a repeat must reach the engine's paths
CACHE_OFF = {"tsd.query.cache.enable": "false"}
# the host tail off: every tail on the TSDB's device
HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}
ENGINE_KEYS = {"tsd.query.grid_reduce": "false",
               "tsd.query.device_cache_mb": "0",
               **HOST_TAIL_OFF, **CACHE_OFF}
T0 = 1356998400
S, P = 240, 60


def _write_reference():
    """A reference TSDB holding three metrics of S series x P points at
    one a minute: gauges, counters with rollovers, and gauges with NaN
    holes."""
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu", **ENGINE_KEYS}))
    rng = np.random.default_rng(42)
    ts = T0 + 60 * np.arange(P, dtype=np.int64)
    gauge = rng.normal(100.0, 15.0, (S, P))
    counter = np.cumsum(rng.uniform(0, 40, (S, P)), axis=1)
    counter[7, 30:] -= counter[7, 30] * 0.95    # counter resets
    counter[100, 12:] -= counter[100, 12] * 0.5
    holed = gauge + 5.0
    holed[rng.random((S, P)) < 0.2] = np.nan
    holed[3, :10] = np.nan
    holed[4, -15:] = np.nan
    for metric, vals in (("m", gauge), ("c", counter), ("h", holed)):
        for i in range(S):
            jt.add_points(metric, ts, vals[i],
                          {"host": f"web{i:03d}", "dc": f"dc{i % 6}",
                           "rack": f"r{i % 40}"})
    return jt


@pytest.fixture(scope="module")
def engines():
    jt = _write_reference()
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **ENGINE_KEYS}))
    for metric in ("m", "c", "h"):
        load_arrays(tt, metric, *_export(jt, metric))
    return jt, tt


def _run_both(engines, query: dict):
    jt, tt = engines
    want = _rows(jt.execute_query(JQuery.from_json(query).validate()))
    got = _rows(tt.execute_query(TSQuery.from_json(query).validate()))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        gv, wv = np.asarray(g[4]), np.asarray(w[4])
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=1e-9 * max(
            np.nanmax(np.abs(wv), initial=0.0), 1.0), equal_nan=True)
    return got


QUERIES = [
    "sum:5m-avg:rate:m{dc=*}",
    "avg:1m-max:m{host=*}",
    "zimsum:5m-sum:rate{counter,1000,100}:c{dc=*}",
    "sum:5m-avg:h{dc=*}",                  # NaN holes: dense tail
    "avg:10m-avg-zero:rate:h{rack=*}",
    "max:5m-min:m{rack=*}",
    "count:15m-count:m",
    "sum:m{dc=dc1|dc3}",                   # no downsample: union grid
    "pfsum:5m-last:rate:c{dc=*}{rack=r1|r2|r7}",
    "squareSum:5m-first:m{dc=*}{host=not_literal_or(web001|web002)}",
    "dev:30m-avg-nan:h{dc=wildcard(dc*)}",
]


def _query_json(m):
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


@pytest.mark.parametrize("m", QUERIES)
def test_query_matches_reference(engines, m, monkeypatch):
    """Each query through both engines; on the CPU the port's kernel
    wrappers take their plain versions and launch nothing."""
    plain_calls = []
    orig = fused._transform_plain
    monkeypatch.setattr(fused, "_transform_plain",
                        lambda *a, **kw: plain_calls.append(1)
                        or orig(*a, **kw))
    launches = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    query = {"start": str(T0), "end": str(T0 + P * 60 - 1),
             "queries": [_query_json(m)]}
    _run_both(engines, query)
    assert (fused.span_reduce.launches,
            fused.onehot_reduce.launches) == launches == (0, 0)
    complete = not m.split(":")[-1].startswith("h")
    fused_ok = ":5m-avg:rate:m" in m or ":5m-sum:rate" in m \
        or m.startswith(("count:", "sum:m"))
    if complete and fused_ok:
        assert plain_calls, "the fused path's plain version never ran"


def test_uri_query_parses_alike():
    from opentsdb_tpu.query.model import parse_uri_subquery as jparse
    for m in QUERIES:
        j, t = jparse(m), parse_uri_subquery(m)
        assert (t.aggregator, t.metric, t.downsample, t.rate,
                t.rate_options.counter, t.rate_options.counter_max,
                t.rate_options.reset_value) == \
            (j.aggregator, j.metric, j.downsample, j.rate,
             j.rate_options.counter, j.rate_options.counter_max,
             j.rate_options.reset_value)
        assert [(f.filter_name, f.tagk, f.filter_expr, f.group_by)
                for f in t.filters] == \
            [(f.filter_name, f.tagk, f.filter_expr, f.group_by)
             for f in j.filters]


def test_show_tsuids_ms_and_explicit_tags(engines):
    jt, tt = engines
    query = {"start": str(T0), "end": str(T0 + 1799),
             "msResolution": True, "showTSUIDs": True,
             "queries": [{"aggregator": "sum", "metric": "m",
                          "downsample": "5m-avg", "explicitTags": True,
                          "filters": [{"type": "literal_or",
                                       "tagk": "host",
                                       "filter": "web005|web006",
                                       "groupBy": True},
                                      {"type": "iwildcard", "tagk": "dc",
                                       "filter": "*", "groupBy": False},
                                      {"type": "iwildcard",
                                       "tagk": "rack", "filter": "*",
                                       "groupBy": False}]}]}
    _run_both(engines, query)
    want = jt.execute_query(JQuery.from_json(query).validate())
    got = tt.execute_query(TSQuery.from_json(query).validate())
    assert [r.tsuids for r in got] == [r.tsuids for r in want]


def test_ingest_through_facade_matches_load(engines):
    """add_point / add_points / add_point_groups land the same data as
    the bulk load."""
    jt, tt = engines
    t2 = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64",
                        "tsd.core.auto_create_metrics": "true",
                        **ENGINE_KEYS}))
    tags_list, ts2d, vals, counts = _export(jt, "m")
    groups = []
    for i, tags in enumerate(tags_list[:S // 2]):
        groups.append(("m", tags, list(range(P)),
                       (ts2d[i] // 1000).tolist(), vals[i].tolist()))
    written, errors = t2.add_point_groups(groups)
    assert (written, errors) == ((S // 2) * P, [])
    for i, tags in enumerate(tags_list[S // 2:], start=S // 2):
        t2.add_points("m", ts2d[i, :-1] // 1000, vals[i, :-1], tags)
        t2.add_point("m", int(ts2d[i, -1]), float(vals[i, -1]), tags)
    q = {"start": str(T0), "end": str(T0 + P * 60 - 1),
         "queries": [_query_json("sum:5m-avg:rate:m{dc=*}")]}
    a = _rows(t2.execute_query(TSQuery.from_json(q).validate()))
    b = _rows(tt.execute_query(TSQuery.from_json(q).validate()))
    assert a == b


def test_overwrite_and_out_of_order_writes():
    """Duplicate timestamps resolve last-write-wins and out-of-order
    writes read back sorted, as in the reference store."""
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true",
                       **ENGINE_KEYS}))
    j = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                         "tsd.tpu.platform": "cpu", **ENGINE_KEYS}))
    writes = [(T0 + 120, 3.0), (T0, 1.0), (T0 + 60, 2.0), (T0, 10.0),
              (T0 + 180, 4.0), (T0 + 60, 20.0)]
    for db in (t, j):
        for ts, v in writes:
            db.add_point("x", ts, v, {"host": "a"})
        db.add_point("x", T0, 5.0, {"host": "b"})
    q = {"start": str(T0), "end": str(T0 + 600),
         "queries": [{"aggregator": "sum", "metric": "x",
                      "tags": {"host": "a"}}]}
    got = _rows(t.execute_query(TSQuery.from_json(q).validate()))
    want = _rows(j.execute_query(JQuery.from_json(q).validate()))
    assert got == want
    sid = t.store.series_ids_for_metric(t.uids.metrics.get_id("x"))[0]
    padded = t.store.materialize_padded([sid], 0, 2**62)
    np.testing.assert_array_equal(padded.values2d[0], [10, 20, 3, 4])


def test_write_validation():
    t = TSDB(Config(**{"tsd.torch.device": "cpu", **ENGINE_KEYS}))
    with pytest.raises(LookupError):       # auto_create_metrics off
        t.add_point("nope", T0, 1.0, {"host": "a"})
    t2 = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.core.auto_create_metrics": "true",
                        **ENGINE_KEYS}))
    with pytest.raises(ValueError):
        t2.add_point("m", T0, 1.0, {})
    with pytest.raises(ValueError):
        t2.add_point("m", T0, 1.0, {"ho st": "a"})
    with pytest.raises(ValueError):
        t2.add_point("m", 0, 1.0, {"host": "a"})
    written, errors = t2.add_point_groups(
        [("m", {"host": "a"}, [0, 1, 2], [T0, -5, T0 + 60],
          [1.0, 2.0, 3.0])])
    assert written == 2 and len(errors) == 1


@pytest.mark.parametrize("key,value", [
    ("tsd.query.grid_reduce", "true"),
    ("tsd.query.device_cache_mb", "1024"),
    ("tsd.query.host_tail_max_cells", "0"),
    ("tsd.query.host_tail_max_cells_linear", "0")])
def test_unported_engine_paths_raise(engines, key, value):
    """Every engine path these keys select is ported: the grid path, the
    device cache and, since the host-tail keys left -1, the host tail
    (its default budgets place this query's tail on the host). Each
    answers as the reference's point path does."""
    jt, tt = engines
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.torch.dtype": "float64",
                       **ENGINE_KEYS, key: value}))
    load_arrays(t, "m", *_export(jt, "m"))
    q = TSQuery.from_json({"start": str(T0), "end": str(T0 + P * 60 - 1),
                           "queries": [_query_json(
                               "sum:5m-avg:rate:m{dc=*}")]}).validate()
    got, want = _rows(t.execute_query(q)), _rows(tt.execute_query(q))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        np.testing.assert_allclose(g[4], w[4], rtol=1e-9)


@pytest.mark.parametrize("keys,path", [
    (ENGINE_KEYS, "point"),
    ({**CACHE_OFF, **HOST_TAIL_OFF}, "grid"),
    ({"tsd.query.grid_reduce": "false", **CACHE_OFF}, "prepared"),
    (CACHE_OFF, "host-grid")])
def test_engine_keys_select_the_path(engines, keys, path, monkeypatch):
    """Spies on the store and the pipeline show which path a
    fixed-interval query took, run twice: the point path materializes
    and uploads each time; the grid path on the device reduces in the
    store once and then reads the cached grid; at the defaults this
    small grid's tail is host-placed, which skips the device cache and
    reduces in the store again; grid_reduce=false with the cache on
    materializes once and serves the repeat from the cached batch (the
    host pool's, for this small query)."""
    from opentsdb_tpu_torch.query import engine as engine_mod
    jt, _ = engines
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.torch.dtype": "float64", **keys}))
    load_arrays(t, "m", *_export(jt, "m"))
    calls = []
    for obj, name in ((t.store, "materialize_padded"),
                      (t.store, "bucket_reduce"),
                      (engine_mod, "prepare_auto"),
                      (engine_mod, "run_prepared")):
        orig = getattr(obj, name)
        monkeypatch.setattr(obj, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    q = TSQuery.from_json({"start": str(T0), "end": str(T0 + P * 60 - 1),
                           "queries": [_query_json(
                               "sum:5m-avg:rate:m{dc=*}")]}).validate()
    first = _rows(t.execute_query(q))
    assert first == _rows(t.execute_query(q))
    assert calls == {
        "point": ["materialize_padded", "prepare_auto",
                  "run_prepared"] * 2,
        "grid": ["bucket_reduce"],
        "host-grid": ["bucket_reduce"] * 2,
        "prepared": ["materialize_padded", "prepare_auto",
                     "run_prepared", "run_prepared"]}[path]
    assert (t.device_grid_cache is None) == (path == "point")


def test_unported_query_features_raise(engines):
    """The query features that raised NotImplementedError before their
    port answer as the reference does: a ``p99`` aggregator (the rank
    aggregators), a pixel budget, tsuid sub-queries and ``delete=true``
    (the last on a fresh pair, with the window read back from both)."""
    jt, tt = engines
    end = str(T0 + P * 60 - 1)
    _run_both(engines, {"start": str(T0), "end": end,
                        "queries": [{"aggregator": "p99",
                                     "metric": "m"}]})
    _run_both(engines, {"start": str(T0), "end": end, "pixels": 12,
                        "queries": [{"aggregator": "sum", "metric": "m",
                                     "tags": {"dc": "*"}}]})
    tsuids = []
    for db in (jt, tt):
        uids = db.uids
        mid = uids.metrics.get_id("m")
        tsuids.append([uids.tsuid(mid, [
            (uids.tag_names.get_id(k), uids.tag_values.get_id(v))
            for k, v in (("host", f"web{i:03d}"), ("dc", f"dc{i % 6}"),
                         ("rack", f"r{i % 40}"))]).hex().upper()
            for i in (3, 5, 11)])
    assert tsuids[0] == tsuids[1]
    got = _run_both(engines, {"start": str(T0), "end": end, "queries": [
        {"aggregator": "sum", "tsuids": tsuids[0]}]})
    assert got[0][0] == "m"
    dj = _write_reference()
    dt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **ENGINE_KEYS}))
    load_arrays(dt, "m", *_export(dj, "m"))
    delete = {"start": str(T0), "end": end, "delete": True, "queries": [
        {"aggregator": "sum", "metric": "m", "tags": {"dc": "dc1"}}]}
    _run_both((dj, dt), delete)
    after = _run_both((dj, dt), {"start": str(T0), "end": end, "queries": [
        {"aggregator": "sum", "metric": "m", "tags": {"dc": "*"}}]})
    assert [r[1]["dc"] for r in after] == ["dc0", "dc2", "dc3", "dc4",
                                           "dc5"]
    dj.shutdown()
    assert torch.device("cpu") == tt.device


@pytest.mark.parametrize("case", ["window_ms", "jittered", "one",
                                  "empty", "wide_span", "repeated"])
def test_distinct_timestamps_equal_np_unique(case):
    """The union grid's distinct timestamps (a bitmap over a short span,
    a sort over a long one) are ``np.unique``'s, with its inverse."""
    from opentsdb_tpu_torch.query.engine import _distinct
    rng = np.random.default_rng(7)
    ts = {"window_ms": T0 * 1000 + 60_000 * rng.integers(0, 60, 5000),
          "jittered": T0 * 1000 + rng.integers(0, 3_600_000, 20_000),
          "one": np.array([T0 * 1000]),
          "empty": np.array([], dtype=np.int64),
          "wide_span": rng.integers(0, 1 << 45, 3000),
          "repeated": np.full(50, -5)}[case].astype(np.int64)
    got_ts, got_inv = _distinct(ts)
    want_ts, want_inv = np.unique(ts, return_inverse=True)
    assert got_ts.dtype == want_ts.dtype
    np.testing.assert_array_equal(got_ts, want_ts)
    assert got_inv.dtype == np.int32
    np.testing.assert_array_equal(got_inv, want_inv)
