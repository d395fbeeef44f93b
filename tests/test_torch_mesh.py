"""The port's sharded pipeline (``opentsdb_tpu_torch/parallel/``) against
the JAX package's (``opentsdb_tpu/parallel/``), function by function:
twins of ``tests/test_sharded.py`` on the CPU.

The JAX side runs on the 8 virtual XLA CPU devices of
``tests/conftest.py``; the port's mesh is drawn from ``[cpu] * 8``, the
same device eight times, so every shard runs on the CPU one after
another and every collective is the port's own (``parallel/
collectives.py``). The same seeded numpy batches go through both:

- the meshes (8, 1), (4, 2), (2, 4) and (1, 8) with the reducible
  aggregators; first, last, multiply and diff; the percentiles and
  median, port mesh against JAX mesh (the same histogram estimator, so
  within the tolerance, and both within the estimator's bound of the
  exact single-device answer);
- the blocked streaming twin (a gap over a whole middle block; rate,
  LERP and a percentile over 3 blocks), rate and LERP carries across
  time shards, a counter rate, a zero fill, an uneven series count and
  first/last/diff picking by global series index;
- the grid-tail step (``run_sharded_grid``), aggregated and per series;
- reproducibility: two runs give the same bits.

Tolerance: float64 on both sides (conftest enables x64), rtol 1e-9 and
atol 1e-9 * max|x|; NaN positions and emit masks equal.
"""

import numpy as np
import pytest
import torch

import torch_pair  # noqa: F401  (the JAX package's private native build)
from test_sharded import random_batch

from opentsdb_tpu.ops.pipeline import PipelineSpec as JSpec
from opentsdb_tpu.ops.pipeline import execute as jexecute
from opentsdb_tpu.ops.rate import RateOptions as JRate
from opentsdb_tpu.parallel import mesh as jmesh
from opentsdb_tpu.parallel import sharded_pipeline as jsp
from opentsdb_tpu_torch.ops.downsample import FillPolicy
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.parallel import collectives as coll
from opentsdb_tpu_torch.parallel import mesh as tmesh
from opentsdb_tpu_torch.parallel import sharded_pipeline as tsp
from opentsdb_tpu.ops.downsample import FillPolicy as JFill

CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def port_mesh(shape) -> tmesh.Mesh:
    return tmesh.make_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))


def specs(**kw):
    """The same spec in both packages (fill policies by name)."""
    jkw = dict(kw)
    if "fill_policy" in kw:
        jkw["fill_policy"] = JFill(kw["fill_policy"].value)
    return PipelineSpec(**kw), JSpec(**jkw)


def rates(rate_kw):
    if rate_kw is None:
        return None, None
    return RateOptions(**rate_kw), JRate(**rate_kw)


def assert_close(got, want, got_emit, want_emit):
    want = np.asarray(want)
    np.testing.assert_array_equal(got_emit, np.asarray(want_emit))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * max(
        np.nanmax(np.abs(want), initial=0.0), 1.0), equal_nan=True)


def both_sharded(shape, kw, batch, group_ids, rate_kw=None):
    """Port mesh and JAX mesh on one batch -> (port, jax) results."""
    values, sidx, bidx, bts = batch
    s, g = kw["num_series"], kw["num_groups"]
    pspec, jspec = specs(**kw)
    pro, jro = rates(rate_kw)
    jb = jsp.prepare_sharded_batch(values, sidx, bidx, bts, group_ids, s,
                                   g, *shape)
    want = jsp.run_sharded(jmesh.make_mesh(*shape), jspec, jb, jro)
    pb = tsp.prepare_sharded_batch(values, sidx, bidx, bts, group_ids, s,
                                   g, *shape)
    got = tsp.run_sharded(port_mesh(shape), pspec, pb, pro,
                          dtype=torch.float64)
    return got, want


def compare(shape, num_series, num_buckets, num_groups, seed=0,
            points_per=30, rate_kw=None, **kw):
    batch = random_batch(num_series, num_buckets, points_per, seed)
    group_ids = (np.arange(num_series) % num_groups).astype(np.int32)
    kw = dict(num_series=num_series, num_buckets=num_buckets,
              num_groups=num_groups, **kw)
    got, want = both_sharded(shape, kw, batch, group_ids, rate_kw)
    assert_close(got[0], want[0], got[1], want[1])
    return got, batch, group_ids


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("agg", ["sum", "avg", "max", "count", "dev"])
def test_reducible_aggs_match_reference_mesh(mesh_shape, agg):
    compare(mesh_shape, 24, 40, 3, seed=sum(map(ord, agg)) % 1000,
            ds_function="avg", agg_name=agg)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
@pytest.mark.parametrize("agg", ["first", "last", "multiply", "diff"])
def test_gathered_aggs_match_reference_mesh(mesh_shape, agg):
    # first/last: the edge-candidate merge; multiply/diff: the
    # all-gather of the series axis
    compare(mesh_shape, 16, 24, 2, seed=sum(map(ord, agg)) % 1000,
            points_per=20, ds_function="sum", agg_name=agg)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
@pytest.mark.parametrize("agg", ["p95", "p50", "median", "ep99r7"])
def test_percentiles_match_reference_mesh_estimator(mesh_shape, agg):
    """The bucketed-histogram estimate (``_group_percentile_hist``)
    equals the JAX mesh's, and both lie within the estimator's bound
    (2 x value range / PERCENTILE_BINS) of the exact single-device
    answer."""
    got, (values, sidx, bidx, bts), gids = compare(
        mesh_shape, 32, 24, 2, seed=sum(map(ord, agg)), points_per=20,
        ds_function="sum", agg_name=agg)
    _, jspec = specs(num_series=32, num_buckets=24, num_groups=2,
                     ds_function="sum", agg_name=agg)
    exact, _ = jexecute(values, sidx, bidx, bts, gids, jspec)
    exact = np.asarray(exact)
    assert np.array_equal(np.isnan(got[0]), np.isnan(exact))
    m = ~np.isnan(exact)
    tol = 2.0 * (values.max() - values.min() + 1e-9) / tsp.PERCENTILE_BINS
    assert np.max(np.abs(got[0][m] - exact[m])) <= tol


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_rate_across_time_blocks(mesh_shape):
    """Rate carries cross time-shard boundaries exactly."""
    compare(mesh_shape, 12, 32, 2, seed=7, points_per=10, rate_kw={},
            ds_function="avg", agg_name="sum", rate=True)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_lerp_across_time_blocks(mesh_shape):
    """Sparse series whose gaps span several time shards lerp alike."""
    compare(mesh_shape, 6, 64, 1, seed=11, points_per=4,
            ds_function="sum", agg_name="sum")


def test_counter_rate_sharded():
    compare((4, 2), 8, 16, 1, seed=3, points_per=12,
            rate_kw={"counter": True, "counter_max": 1e9},
            ds_function="last", agg_name="sum", rate=True,
            rate_counter=True)


def test_zero_fill_sharded():
    compare((2, 4), 8, 24, 2, seed=5, points_per=6, ds_function="sum",
            agg_name="sum", fill_policy=FillPolicy.ZERO)


def test_uneven_series_count():
    """A series count the shards do not divide pads with dummies."""
    compare((8, 1), 13, 17, 4, seed=13, points_per=9, ds_function="avg",
            agg_name="avg")


@pytest.mark.parametrize("agg,expected", [("first", 101.0),
                                          ("last", 108.0),
                                          ("diff", 7.0)])
def test_series_order_preserved_across_shards(agg, expected):
    """first/last/diff pick by GLOBAL series index: series {1, 8} of one
    group sit on two shards of an (8, 1) mesh, constant values 100 + s
    make the pick visible, and both packages give ``expected``."""
    num_series, b = 16, 4
    values = np.repeat(100.0 + np.arange(num_series), b)
    sidx = np.repeat(np.arange(num_series, dtype=np.int32), b)
    bidx = np.tile(np.arange(b, dtype=np.int32), num_series)
    bts = np.arange(b, dtype=np.int64) * 1000
    gids = np.zeros(num_series, dtype=np.int32)
    gids[1] = gids[8] = 1
    kw = dict(num_series=num_series, num_buckets=b, num_groups=2,
              ds_function="sum", agg_name=agg)
    got, want = both_sharded((8, 1), kw, (values, sidx, bidx, bts), gids)
    assert_close(got[0], want[0], got[1], want[1])
    np.testing.assert_allclose(got[0][1], expected)


def test_out_of_order_batch_is_sorted_first():
    """A batch not in (series, bucket) order answers as the sorted one
    (the per-shard bucketize reads sorted segment ids)."""
    values, sidx, bidx, bts = random_batch(12, 16, 10, seed=2)
    perm = np.random.default_rng(0).permutation(len(values))
    gids = (np.arange(12) % 2).astype(np.int32)
    spec = PipelineSpec(num_series=12, num_buckets=16, num_groups=2,
                        ds_function="avg", agg_name="sum", rate=True)
    mesh = port_mesh((2, 2))

    def run(v, s, bk):
        b = tsp.prepare_sharded_batch(v, s, bk, bts, gids, 12, 2, 2, 2)
        return tsp.run_sharded(mesh, spec, b, RateOptions(),
                               dtype=torch.float64)

    got, want = run(values[perm], sidx[perm], bidx[perm]), \
        run(values, sidx, bidx)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_blocked_sharded_gap_spans_whole_block(mesh_shape):
    """A series with points in blocks 0 and 2 but none in block 1 still
    lerps across the empty middle block (the next-carries accumulate
    over every later block)."""
    num_series, g, b = 8, 2, 48
    rows = []
    for s in range(num_series):
        if s == 3:
            rows += [(s, 2, 10.0), (s, 40, 90.0)]
        else:
            rows += [(s, bb, float(100 + s + bb)) for bb in range(48)]
    arr = np.asarray(rows)
    values = arr[:, 2].astype(np.float64)
    sidx = arr[:, 0].astype(np.int32)
    bidx = arr[:, 1].astype(np.int32)
    bts = np.arange(b, dtype=np.int64) * 60_000
    gids = (np.arange(num_series) % g).astype(np.int32)
    pspec, jspec = specs(num_series=num_series, num_buckets=b,
                         num_groups=g, ds_function="avg", agg_name="sum")
    want = jsp.execute_blocked_sharded(
        jmesh.make_mesh(*mesh_shape), values, sidx, bidx, bts, gids,
        jspec, block_buckets=16)
    got = tsp.execute_blocked_sharded(
        port_mesh(mesh_shape), values, sidx, bidx, bts, gids, pspec,
        dtype=torch.float64, block_buckets=16)
    assert_close(got[0], want[0], got[1], want[1])


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("agg,rate", [("sum", False), ("avg", True),
                                      ("p95", False)])
def test_blocked_sharded_matches_reference(mesh_shape, agg, rate):
    """Over-budget ranges stream time blocks while keeping the mesh, in
    both packages alike (3 blocks), and the port's blocked answer
    equals its own unblocked mesh answer within the tolerance."""
    num_series, g, b = 24, 3, 48
    values, sidx, bidx, bts = random_batch(num_series, b, 30, seed=11)
    gids = (np.arange(num_series) % g).astype(np.int32)
    kw = dict(num_series=num_series, num_buckets=b, num_groups=g,
              ds_function="avg", agg_name=agg, rate=rate)
    pspec, jspec = specs(**kw)
    pro, jro = rates({} if rate else None)
    want = jsp.execute_blocked_sharded(
        jmesh.make_mesh(*mesh_shape), values, sidx, bidx, bts, gids,
        jspec, jro, block_buckets=16)
    runs = tsp.execute_blocked_sharded.runs
    got = tsp.execute_blocked_sharded(
        port_mesh(mesh_shape), values, sidx, bidx, bts, gids, pspec, pro,
        dtype=torch.float64, block_buckets=16)
    assert tsp.execute_blocked_sharded.runs == runs + 1
    assert_close(got[0], want[0], got[1], want[1])
    whole = tsp.run_sharded(
        port_mesh(mesh_shape), pspec, tsp.prepare_sharded_batch(
            values, sidx, bidx, bts, gids, num_series, g, *mesh_shape),
        pro, dtype=torch.float64)
    assert_close(got[0], whole[0], got[1], whole[1])


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
@pytest.mark.parametrize("agg,rate,emit_raw", [
    ("sum", True, False), ("p95", False, False), ("last", False, False),
    ("sum", True, True)])
def test_grid_step_matches_reference(mesh_shape, agg, rate, emit_raw):
    """The grid-tail step over a cut [S, B] grid (``prepare_sharded_grid``,
    ``sharded_grid_gids``, ``run_sharded_grid``), aggregated and per
    series (``emit_raw``)."""
    s, b, g = 24, 40, 3
    values, sidx, bidx, bts = random_batch(s, b, 30, seed=4)
    grid = np.full((s, b), np.nan)
    grid[sidx, bidx] = values
    has = ~np.isnan(grid)
    gids = (np.arange(s) % g).astype(np.int32)
    pspec, jspec = specs(num_series=s, num_buckets=b, num_groups=g,
                         ds_function="avg", agg_name=agg, rate=rate,
                         emit_raw=emit_raw)
    pro, jro = rates({} if rate else None)
    jm = jmesh.make_mesh(*mesh_shape)
    args, s_loc, b_loc, s_pad = jsp.prepare_sharded_grid(jm, grid, has, bts)
    want = jsp.run_sharded_grid(jm, jspec,
                                args + (jsp.sharded_grid_gids(
                                    jm, gids, s_pad, g),),
                                s_loc, b_loc, g, jro)
    pm = port_mesh(mesh_shape)
    args, s_loc, b_loc, s_pad = tsp.prepare_sharded_grid(
        pm, grid, has, bts, torch.float64)
    got = tsp.run_sharded_grid(
        pm, pspec, args + (tsp.sharded_grid_gids(pm, gids, s_pad, g),),
        s_loc, b_loc, g, pro)
    assert got[0].shape == ((s, b) if emit_raw else (g, b))
    assert_close(got[0], want[0], got[1], want[1])


@pytest.mark.parametrize("agg", ["sum", "dev", "p99", "last"])
def test_two_runs_give_the_same_bits(agg):
    """Fixed-order collectives: two runs of the same step are equal bit
    for bit (float32, where an unordered sum would show)."""
    values, sidx, bidx, bts = random_batch(40, 24, 20, seed=9)
    gids = (np.arange(40) % 3).astype(np.int32)
    spec = PipelineSpec(num_series=40, num_buckets=24, num_groups=3,
                        ds_function="avg", agg_name=agg, rate=True)
    mesh = port_mesh((4, 2))
    batch = tsp.prepare_sharded_batch(values, sidx, bidx, bts, gids, 40, 3,
                                      4, 2)
    runs = [tsp.run_sharded(mesh, spec, batch, RateOptions(),
                            dtype=torch.float32) for _ in range(2)]
    assert runs[0][0].dtype == np.float32
    assert np.array_equal(runs[0][0].view(np.int32),
                          runs[1][0].view(np.int32))
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_collectives_fixed_order():
    """``psum`` adds in shard order in float64 and rounds once;
    ``ppermute`` sends zeros where nothing arrives; ``all_gather``
    stacks or concatenates in shard order."""
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([1.0], dtype=torch.float32),
             torch.tensor([-1e8], dtype=torch.float32)]
    out = coll.psum(parts)
    assert [float(o) for o in out] == [1.0, 1.0, 1.0]
    assert all(o.dtype == torch.float32 for o in out)
    assert [float(o) for o in coll.pmin(parts)] == [-1e8] * 3
    moved = coll.ppermute(parts, [(0, 1), (1, 2)])
    assert [float(m) for m in moved] == [0.0, 1e8, 1.0]
    assert coll.all_gather(parts)[2].shape == (3, 1)
    assert coll.all_gather(parts, tiled=True)[0].tolist() == \
        [1e8, 1.0, -1e8]


@pytest.mark.parametrize("agg,cls", [("sum", "safe"), ("first", "safe"),
                                     ("p99", "pct"), ("median", "pct"),
                                     ("diff", "gather"),
                                     ("multiply", "gather")])
def test_agg_mesh_class(agg, cls):
    assert tsp.agg_mesh_class(agg) == jsp.agg_mesh_class(agg) == cls
    for g, b in ((3, 60), (70_000, 60)):
        assert tsp.mesh_memory_safe(agg, g, b) == \
            jsp.mesh_memory_safe(agg, g, b)


@pytest.mark.parametrize("spec,want", [
    ("", None), ("auto", "auto"), ("series:4", (4, 1)),
    ("series:2,time:4", (2, 4)), ("TIME:3", (1, 3))])
def test_parse_mesh_spec(spec, want):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec) == \
        want


@pytest.mark.parametrize("spec", ["seires:2", "series:x", "series:0"])
def test_parse_mesh_spec_typos(spec):
    for parse in (tmesh.parse_mesh_spec, jmesh.parse_mesh_spec):
        with pytest.raises(ValueError):
            parse(spec)


def test_mesh_from_spec_over_a_repeated_device():
    """``[cpu] * 8`` lays out as the reference's 8 virtual devices;
    ``auto`` over one device is None; a shape past the list raises."""
    devs = [CPU] * 8
    m = tmesh.mesh_from_spec("series:2,time:4", devs)
    assert m.shape == jmesh.mesh_from_spec("series:2,time:4").shape
    assert m.positions() == [(i, j) for i in range(2) for j in range(4)]
    assert tmesh.mesh_from_spec("auto", devs).shape == \
        {"series": 8, "time": 1}
    assert tmesh.mesh_from_spec("auto", [CPU]) is None
    assert tmesh.mesh_from_spec("", devs) is None
    with pytest.raises(ValueError, match="wants 16 devices, 8 available"):
        tmesh.mesh_from_spec("series:16", devs)
