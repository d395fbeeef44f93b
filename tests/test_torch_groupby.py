"""The port's fixed-order group reduction (``ops/groupby.py``) against the
JAX package's ``_group_reduce`` on the same seeded numpy inputs.

Cases cover skewed group sizes (one group holding most series, deep
enough for three and four levels of the reduction tree), empty groups,
NaN holes, a group whose every cell is missing, one series, and series
counts that are multiples of nothing in particular. Every aggregator
the port's group stage supports is held to the reference: float64 on
both sides (conftest enables x64), rtol 1e-9 and atol 1e-9 * max|x|,
NaN positions equal. Two calls must give identical bits, and no
reduction may take an atomic scatter path (a min or max by atomics
could return either zero's sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import groupby as jgb
from opentsdb_tpu_torch.ops import groupby as tgb

LINEAR_AGGS = ["sum", "zimsum", "pfsum", "avg", "count", "min", "max",
               "mimmin", "mimmax", "multiply", "squareSum", "dev",
               "first", "last", "diff"]


def _case(name: str):
    """(values [S, B] float64 with NaN holes, group ids [S], G)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "skewed":
        # 90% of the series in group 0 (three tree levels); groups 4
        # and 7 empty; S = 1009 is prime
        s, b, g = 1009, 7, 9
        gids = np.where(rng.random(s) < 0.9, 0,
                        rng.choice([1, 2, 3, 5, 6, 8], s))
    elif name == "deep":
        # one group of ~39,000 series: four tree levels
        s, b, g = 40_003, 3, 5
        gids = np.where(rng.random(s) < 0.97, 2, rng.integers(0, g, s))
    elif name == "sparse":
        # more groups than series: most groups empty
        s, b, g = 50, 5, 64
        gids = rng.integers(0, g, s)
    elif name == "one_group":
        s, b, g = 777, 4, 1
        gids = np.zeros(s, dtype=np.int64)
    else:  # "one_series"
        s, b, g = 1, 6, 3
        gids = np.array([1])
    x = rng.normal(1.0, 0.05, (s, b)) * np.where(rng.random((s, b)) < 0.5,
                                                 1.0, -1.0)
    x[rng.random((s, b)) < 0.2] = np.nan
    # a group whose bucket 0 is missing in every series
    x[gids == gids.max(), 0] = np.nan
    return x, gids.astype(np.int64), g


CASES = ["skewed", "deep", "sparse", "one_group", "one_series"]


def _assert_close(got, want, rtol=1e-9):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               equal_nan=True)


@pytest.mark.parametrize("agg", LINEAR_AGGS)
@pytest.mark.parametrize("case", CASES)
def test_group_reduce_matches_reference(case, agg, monkeypatch):
    """The fixed-order reduction against the JAX package's, twice, with
    the atomic scatter paths made to fail."""
    x, gids, g = _case(case)
    want = jgb._group_reduce(jnp.asarray(x), jnp.asarray(gids), g, agg)

    def atomic(*a, **k):
        raise AssertionError("an order-free scatter ran")

    monkeypatch.setattr(torch.Tensor, "index_add_", atomic)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", atomic)
    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", atomic)
    xt, gt = torch.as_tensor(x), torch.as_tensor(gids)
    first = tgb._group_reduce(xt, gt, g, agg)
    again = tgb._group_reduce(xt, gt, g, agg)
    _assert_close(first.numpy(), np.asarray(want))
    assert first.shape == (g, x.shape[1])
    assert torch.equal(first.view(torch.int64), again.view(torch.int64))


@pytest.mark.parametrize("s,g,block,levels", [
    (1, 1, 2, 0), (32, 1, 32, 1), (33, 1, 32, 2), (1024, 1, 32, 2),
    (1025, 1, 32, 3), (40_000, 1, 32, 4),
    (1000, 1000, 2, 0),       # one series a group: no level
    (1000, 400, 2, 10)])      # small groups on average, one of 601
def test_plan_block_and_levels(s, g, block, levels):
    """The tree reads blocks of BLOCK rows, fewer when the groups are
    small on average, and its depth is ceil(log_block(largest group))."""
    gids = np.minimum(np.arange(s), g - 1)
    plan = tgb.GroupPlan(torch.as_tensor(gids), g)
    assert (plan.block, len(plan.levels)) == (block, levels)
    for _, valid, nb in plan.levels:
        assert nb * plan.block <= 2 * s + g * plan.block
    x = torch.as_tensor(np.random.default_rng(s).normal(size=(s, 3)))
    want = np.zeros((g, 3))
    np.add.at(want, gids, x.numpy())
    np.testing.assert_allclose(plan.sum(x).numpy(), want, rtol=1e-12,
                               atol=1e-12)


def test_float32_sums_round_once():
    """float32 inputs are added in float64 and rounded once, so they
    match the float64 sum of the same float32 values within one
    rounding."""
    rng = np.random.default_rng(5)
    s, g = 20_011, 13
    gids = rng.integers(0, g, s)
    x = rng.normal(100.0, 15.0, (s, 4)).astype(np.float32)
    got = tgb.GroupPlan(torch.as_tensor(gids), g).sum(torch.as_tensor(x))
    assert got.dtype == torch.float32
    want = np.zeros((g, 4))
    np.add.at(want, gids, x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23)


def test_non_finite_values_stay_in_their_group():
    """An infinity or NaN changes only its own group's sum, as an
    addition of the same values in any order would."""
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    x[1, 0], x[2, 0], x[4, 1] = np.inf, -np.inf, np.nan
    gids = np.array([0, 1, 1, 2, 3, 3])
    got = tgb.GroupPlan(torch.as_tensor(gids), 5).sum(torch.as_tensor(x))
    want = np.zeros((5, 2))
    with np.errstate(invalid="ignore"):
        np.add.at(want, gids, x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[1, 0]) and want[0, 0] == 0.0
