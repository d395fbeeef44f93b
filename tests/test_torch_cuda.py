"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips when no card is present and runs
on the card with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerance: per cell ``|kernel - plain| <= 1e-5 * sum|terms| + 1e-6``
(float32 sums in another order; the one-hot kernel's float atomics
change the order from run to run); emit masks and NaN positions equal.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
from opentsdb_tpu_torch.ops.rate import RateOptions

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(card, ds_fn, agg, rate, counter, allow_span, s=1500, b=7, k=3,
          g=9, misalign=False):
    """``misalign`` puts the value rows at a 4-byte offset from a 16-byte
    boundary (a contiguous view one float into its buffer)."""
    rng = np.random.default_rng(3)
    p = b * k
    vals = (np.cumsum(rng.uniform(1, 50, (s, p)), axis=1) if counter
            else rng.normal(100.0, 15.0, (s, p)))
    gids = rng.integers(0, g, s).astype(np.int32)
    if allow_span:
        gids.sort()
    ts = np.arange(b, dtype=np.int64) * 60_000
    spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                        ds_function=ds_fn, agg_name=agg, rate=rate,
                        rate_counter=counter)
    x = torch.as_tensor(vals, dtype=torch.float32, device=card)
    if misalign:
        buf = torch.empty(s * p + 1, dtype=torch.float32, device=card)
        x = buf[1:].view(s, p).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    cm, rv = (2.0**32, 5.0) if counter else (float(2**64 - 1), 0.0)
    batch = fused.prepare(x, ts, gids, spec, allow_span=allow_span)
    assert (batch.spans is not None) == allow_span
    before = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    ro = RateOptions(counter=counter, counter_max=cm, reset_value=rv)
    got_res, got_emit = fused.run(batch, spec, k, ro)
    after = (fused.span_reduce.launches, fused.onehot_reduce.launches)
    assert after[0 if allow_span else 1] == \
        before[0 if allow_span else 1] + 1
    t = fused._transform_plain(batch.values, batch.inv_dt, spec, k, cm, rv)
    acc = fused._group_stage_plain(t, batch.gids, g)
    terms = fused._group_stage_plain(t.abs(), batch.gids, g)
    want_res, want_emit = fused._finalize(acc, batch.sizes, spec)
    torch.cuda.synchronize()
    assert torch.equal(got_emit, want_emit)
    assert torch.equal(torch.isnan(got_res), torch.isnan(want_res))
    scale = terms / torch.where(batch.sizes[:, None] > 0,
                                batch.sizes[:, None], 1.0) \
        if agg == "avg" else terms
    err = (got_res - want_res).abs().nan_to_num(0.0)
    assert bool((err <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("allow_span", [True, False])
@pytest.mark.parametrize("ds_fn", sorted(fused._DS_FNS))
def test_kernel_matches_plain_over_ds_fns(card, ds_fn, allow_span):
    _case(card, ds_fn, "sum", True, False, allow_span)


@pytest.mark.parametrize("allow_span", [True, False])
@pytest.mark.parametrize("agg", sorted(fused._AGG_FNS))
def test_kernel_matches_plain_over_aggs(card, agg, allow_span):
    _case(card, "avg", agg, False, False, allow_span)


@pytest.mark.parametrize("allow_span", [True, False])
def test_kernel_counter_rate(card, allow_span):
    _case(card, "last", "sum", True, True, allow_span)


def test_onehot_group_chunks(card):
    """G * B * 4 above the one-hot kernel's shared accumulator budget:
    the block walks its rows once per group chunk."""
    _case(card, "sum", "sum", True, False, False, s=3000, b=13, k=2,
          g=4000)


def _onehot_tile() -> int:
    from opentsdb_tpu_torch.ops import _cuda_build
    return _cuda_build.library().fused_onehot_tile()


@pytest.mark.parametrize("d", [None, -1, 1])
def test_onehot_ragged_tiles(card, d):
    """S = 1 (below one tile) and a block tile of the kernel less or
    plus one row: rows past S add nothing."""
    s = 1 if d is None else _onehot_tile() + d
    _case(card, "avg", "sum", True, False, False, s=s, b=12, k=5, g=7)


@pytest.mark.parametrize("b,k,misalign", [(7, 3, False), (9, 7, False),
                                          (12, 5, True)])
def test_onehot_unaligned_rows(card, b, k, misalign):
    """P % 4 != 0, or a base that is not 16-byte aligned: the ring takes
    4-byte async copies instead of 16-byte ones."""
    _case(card, "sum", "sum", True, False, False, s=3001, b=b, k=k,
          g=1500, misalign=misalign)


def test_onehot_ring_wraps(card):
    """Each warp takes several 32-row tiles of four column chunks (P =
    64: 20, 20, 20 and a ragged 4), far more steps than its ring has
    stages: every warp's ring wraps several times."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    s = 4 * sms * _onehot_tile() + 77
    _case(card, "avg", "sum", True, False, False, s=s, b=16, k=4, g=2000)


@pytest.mark.parametrize("g", [1, fused._MAX_GROUPS])
def test_onehot_group_extremes(card, g):
    """One group, and the most groups the one-hot layout takes."""
    _case(card, "avg", "squareSum", True, False, False, s=5000, b=12, k=5,
          g=g)


@pytest.mark.parametrize("b,g", [(13_000, 3), (26_000, 2)])
def test_onehot_long_rows(card, b, g):
    """Rows whose buckets crowd the shared accumulator: past 12,928
    buckets 1/dt stays in global memory and the accumulator holds one
    group's row; past 25,856 it holds part of one, and the kernel walks
    the rows once per bucket chunk."""
    _case(card, "sum", "sum", True, True, False, s=100, b=b, k=1, g=g)
