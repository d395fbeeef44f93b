"""The port's device cache (``query/device_cache.py``) and its versioning
by the store: a hit must answer exactly as a fresh scan would.

These mirror ``tests/test_device_cache.py::TestDeviceCacheInvalidation``
on the port: a write invalidates a cached grid or prepared batch,
``drop_caches`` empties the cache, a cache of 0 MB is None, cached
results equal uncached ones, two aggregators share one prepared batch,
an entry larger than the cache is not stored and the LRU evicts in
order. Results are compared exactly (NaN equal): the same port code
runs on both sides.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.state import load_arrays
from opentsdb_tpu_torch.ops.pipeline import PreparedBatch
from opentsdb_tpu_torch.query.device_cache import (DeviceGridCache,
                                                   array_digest)
from opentsdb_tpu_torch.query.model import TSQuery

BASE = 1356998400
NO_GRID = {"tsd.query.grid_reduce": "false"}


def _tsdb(**extra):
    # the result cache off, so that a repeat reaches the device cache,
    # and the host tail off, so that these small queries' tails are
    # device-placed (as the reference's tests/test_device_cache.py pins)
    return TSDB(Config(**{"tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64",
                          "tsd.core.auto_create_metrics": "true",
                          "tsd.query.cache.enable": "false",
                          "tsd.query.host_tail_max_cells": "-1",
                          "tsd.query.host_tail_max_cells_linear": "-1",
                          **extra}))


def _q(agg="sum", ds="1m-avg", gb=None, start=BASE, end=BASE + 2999):
    sub = {"metric": "m", "aggregator": agg}
    if ds:
        sub["downsample"] = ds
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb, "filter": "*",
                           "groupBy": True}]
    return TSQuery.from_json({"start": start * 1000, "end": end * 1000,
                              "queries": [sub]}).validate()


def _seed(t, n=6, pts=50):
    """n series of pts points at one a minute (a regular cadence, so the
    point path's batch is dense), tagged host and dc."""
    rng = np.random.default_rng(0)
    ts = BASE + 60 * np.arange(pts)
    for i in range(n):
        t.add_points("m", ts, rng.normal(10, 3, pts),
                     {"host": f"h{i}", "dc": f"d{i % 2}"})


def _dps(results):
    return [(r.tags, r.dps_arrays[0].tolist(), r.dps_arrays[1])
            for r in results]


def _assert_same(a, b):
    assert [x[:2] for x in a] == [x[:2] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[2], y[2])


@pytest.mark.parametrize("extra", [{}, NO_GRID], ids=["grid", "prepared"])
def test_write_invalidates(extra):
    t = _tsdb(**extra)
    _seed(t)
    r1 = _dps(t.execute_query(_q()))
    r1b = _dps(t.execute_query(_q()))          # warm hit
    _assert_same(r1, r1b)
    assert t.device_grid_cache.hits >= 1
    # a new point must change the answer (no stale entry)
    t.add_point("m", BASE + 60, 1000.0, {"host": "h0", "dc": "d0"})
    r2 = _dps(t.execute_query(_q()))
    assert not np.array_equal(r2[0][2], r1[0][2])


def test_every_write_path_bumps_the_version():
    """The cache keys its entries on the store's version: each way of
    writing a point must change it."""
    t = _tsdb()
    seen = [t.store.version]

    def moved():
        seen.append(t.store.version)
        return seen[-1] != seen[-2]

    t.add_point("m", BASE, 1.0, {"host": "a"})
    assert moved()
    t.add_points("m", [BASE + 60, BASE + 120], [2.0, 3.0], {"host": "a"})
    assert moved()
    t.add_point_groups([("m", {"host": "b"}, [0], [BASE], [4.0])])
    assert moved()
    t.add_series_points("m", [{"host": "c"}], np.array([[BASE]]),
                        np.array([[5.0]]))
    assert moved()
    load_arrays(t, "m", [{"host": "d"}], np.array([[BASE * 1000]]),
                np.array([[6.0]]), np.array([1]))
    assert moved()
    assert t.store.mutation_epoch == 0


def test_drop_caches_clears():
    t = _tsdb()
    _seed(t)
    t.execute_query(_q())
    assert len(t.device_grid_cache) == 1
    t.drop_caches()
    assert len(t.device_grid_cache) == 0 and t.device_grid_cache.nbytes == 0
    m0 = t.device_grid_cache.misses
    t.execute_query(_q())
    assert t.device_grid_cache.misses == m0 + 1


def test_disabled_by_config():
    t = _tsdb(**{"tsd.query.device_cache_mb": "0"})
    _seed(t)
    assert t.device_grid_cache is None
    r1 = t.execute_query(_q())
    assert r1 and r1[0].dps
    t.drop_caches()
    # made when first needed: an override turns it on and off
    t.config.override_config("tsd.query.device_cache_mb", "8")
    assert t.device_grid_cache.max_bytes == 8 << 20
    t.config.override_config("tsd.query.device_cache_mb", "0")
    assert t.device_grid_cache is None


@pytest.mark.parametrize("extra", [{}, NO_GRID], ids=["grid", "prepared"])
def test_cache_matches_uncached_results(extra):
    a = _tsdb(**extra)
    b = _tsdb(**{"tsd.query.device_cache_mb": "0", **extra})
    _seed(a)
    _seed(b)
    for agg, ds, gb in (("sum", "1m-avg", None), ("avg", "5m-max", "dc"),
                        ("max", "1m-count", "host"),
                        ("dev", "2m-min", "dc"), ("sum", "5m-last", "dc"),
                        ("zimsum", None, "dc")):
        ra = _dps(a.execute_query(_q(agg, ds, gb)))
        ra2 = _dps(a.execute_query(_q(agg, ds, gb)))    # warm
        rb = _dps(b.execute_query(_q(agg, ds, gb)))
        _assert_same(ra, rb)
        _assert_same(ra2, rb)
    assert a.device_grid_cache.hits >= 6


def test_different_agg_reuses_prepared_batch():
    """The prepared-batch key holds the series, window and downsample,
    not the aggregator: sum and max over the same window share one
    upload (union grid, no downsample)."""
    t = _tsdb()
    _seed(t)
    t.execute_query(_q("sum", None))
    h0 = t.device_grid_cache.hits
    t.execute_query(_q("max", None))
    assert t.device_grid_cache.hits == h0 + 1
    assert len(t.device_grid_cache) == 1


def test_group_bys_share_one_grid():
    """The grid key leaves the group-by out: {dc=*} and {host=*} over
    the same series read one cached grid."""
    t = _tsdb()
    _seed(t)
    t.execute_query(_q("sum", "5m-avg", "dc"))
    h0 = t.device_grid_cache.hits
    t.execute_query(_q("sum", "5m-avg", "host"))
    assert t.device_grid_cache.hits == h0 + 1
    assert len(t.device_grid_cache) == 1
    (key,) = t.device_grid_cache._entries
    assert key[0] == "grid"


def test_cached_grid_is_on_the_tsdb_device():
    t = _tsdb(**{"tsd.torch.dtype": "float32"})
    _seed(t)
    t.execute_query(_q())
    (entry,) = t.device_grid_cache._entries.values()
    grid, has_data = entry[1]
    assert grid.dtype == torch.float32 and has_data.dtype == torch.bool
    assert grid.device.type == "cpu" and grid.shape == (6, 50)
    assert t.device_grid_cache.nbytes == 6 * 50 * 4 + 6 * 50


def test_entry_larger_than_cache_not_stored():
    cache = DeviceGridCache(100)
    cache.put("big", 1, (torch.zeros(26),), {})          # 104 bytes
    assert len(cache) == 0 and cache.nbytes == 0
    cache.put("fits", 1, (PreparedBatch("dense", (torch.zeros(25),), 1),),
              {})
    assert len(cache) == 1 and cache.nbytes == 100
    # through the engine: a 1 MB cache and a batch of 2 MB
    t = _tsdb(**{"tsd.query.device_cache_mb": "1", **NO_GRID})
    _seed(t, n=5300)
    assert t.execute_query(_q())
    assert len(t.device_grid_cache) == 0


def test_lru_evicts_in_order_and_drops_stale():
    cache = DeviceGridCache(3 * 40)
    for k in "abc":
        cache.put(k, 0, (torch.zeros(10),), {"k": k})
    assert cache.get("a", 0)[1] == {"k": "a"}     # a is now newest
    cache.put("d", 0, (torch.zeros(10),), {})
    assert list(cache._entries) == ["c", "a", "d"]
    assert cache.nbytes == 120
    # an entry of another store version is stale: dropped on get
    assert cache.get("c", 1) is None
    assert list(cache._entries) == ["a", "d"] and cache.nbytes == 80
    assert (cache.hits, cache.misses) == (1, 1)
    cache.put("a", 0, (torch.zeros(20),), {})     # replace in place
    assert cache.nbytes == 120 and len(cache) == 2


def test_array_digest_is_content_keyed():
    a = np.arange(10, dtype=np.int64)
    assert array_digest(a) == array_digest(a.copy())
    assert array_digest(a) != array_digest(a[::-1].copy())
