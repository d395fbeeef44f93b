"""The query pipeline: downsample -> fill -> rate -> interpolate ->
aggregate -> group-by over a ``[series, bucket]`` grid, in PyTorch.

Port of ``opentsdb_tpu/ops/pipeline.py`` for the regular-cadence point
path. ``execute_auto`` takes a row-padded batch; when every row holds
the same k-per-bucket points it runs the fused CUDA kernels
(:mod:`opentsdb_tpu_torch.ops.fused`) for complete data and the dense
PyTorch path (:func:`run_pipeline_dense`) when the data has NaN holes,
an option the kernels decline, or float64 on CUDA. Irregular layouts
(the reference's padded-scatter and flat paths) arrive with a later
slice and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.ops import fused
from opentsdb_tpu_torch.ops import groupby as gb_mod
from opentsdb_tpu_torch.ops.rate import RateOptions, _rate_kernel

_SHARED_NAN = float("nan")


@dataclass(frozen=True)
class PipelineSpec:
    """Configuration of one sub-query's compute."""
    num_series: int
    num_buckets: int
    num_groups: int
    ds_function: str          # downsample function ('sum', 'avg', ...)
    agg_name: str             # group aggregator name ('sum', 'p99', ...)
    fill_policy: ds_mod.FillPolicy = ds_mod.FillPolicy.NONE
    fill_value: float = _SHARED_NAN
    rate: bool = False
    rate_counter: bool = False
    rate_drop_resets: bool = False
    emit_raw: bool = False    # agg 'none': emit per-series, skip group stage
    # True when the CALLER verified every (series, bucket) cell holds a
    # real value: cross-series interpolation and the per-group emission
    # reduction are provably no-ops and are skipped.
    complete: bool = False

    def __post_init__(self):
        # each float("nan") object hashes by identity: canonicalize so
        # specs built per query compare and hash equal
        if isinstance(self.fill_value, float) and \
                self.fill_value != self.fill_value:
            object.__setattr__(self, "fill_value", _SHARED_NAN)


def apply_fill_policy(grid, has_data, spec: PipelineSpec):
    """Downsample fill policy: ZERO/SCALAR substitute before rate,
    matching FillingDownsampler feeding RateSpan."""
    if spec.fill_policy == ds_mod.FillPolicy.ZERO:
        grid = torch.where(torch.isnan(grid), 0.0, grid)
        has_data = torch.ones_like(has_data)
    elif spec.fill_policy == ds_mod.FillPolicy.SCALAR:
        grid = torch.where(torch.isnan(grid), spec.fill_value, grid)
        has_data = torch.ones_like(has_data)
    return grid, has_data


def _finish_pipeline(grid, has_data, bucket_ts, group_ids,
                     ro: RateOptions, spec: PipelineSpec):
    g, b = spec.num_groups, spec.num_buckets
    grid, has_data = apply_fill_policy(grid, has_data, spec)

    # rate conversion per series (ref: Downsampler -> RateSpan order)
    if spec.rate:
        grid = _rate_kernel(grid, bucket_ts, spec.rate_counter,
                            float(ro.counter_max), float(ro.reset_value),
                            spec.rate_drop_resets)
        has_data = has_data & ~torch.isnan(grid)

    if spec.emit_raw:
        return grid, has_data

    # interpolate at merge + aggregate over series within groups. NAN/
    # NULL fill policies emit explicit NaN points, which the reference's
    # merge loop skips WITHOUT interpolating; only fill NONE leaves true
    # gaps that interpolate.
    agg = aggs_mod.get(spec.agg_name)
    interpolate = spec.fill_policy == ds_mod.FillPolicy.NONE \
        and not spec.complete
    result = gb_mod.group_aggregate(grid, bucket_ts, group_ids, g, agg,
                                    interpolate=interpolate)

    # emission: fill NONE emits the union of the group's series' buckets;
    # any other policy emits every bucket (FillingDownsampler)
    ones = torch.ones((g, b), dtype=torch.bool, device=grid.device)
    if spec.complete and not spec.rate:
        emit = ones
    elif spec.fill_policy == ds_mod.FillPolicy.NONE:
        emit = gb_mod._group_sum(has_data.to(grid.dtype), group_ids,
                                 g) > 0
    else:
        emit = ones
    return result, emit


_DENSE_FNS = frozenset(("sum", "zimsum", "pfsum", "avg", "min", "mimmin",
                        "max", "mimmax", "count", "first", "last"))


def run_pipeline_dense(values2d, bucket_ts, group_ids, ro: RateOptions,
                       spec: PipelineSpec, pts_per_bucket: int):
    """Regular-cadence path: every series has the same P timestamps and
    each bucket covers exactly ``pts_per_bucket`` consecutive points, so
    downsampling is a reshape reduction over ``[S, B, k]``.

    values2d: [S, P] tensor with NaN for missing points, P = B * k;
    bucket_ts: [B] int64 relative ms; group_ids: [S] int64."""
    s, b, k = spec.num_series, spec.num_buckets, pts_per_bucket
    x = values2d.reshape(s, b, k)
    valid = ~torch.isnan(x)
    cnt = valid.sum(dim=-1)
    fn = spec.ds_function
    pos = torch.arange(k, device=x.device)
    if fn in ("sum", "zimsum", "pfsum"):
        out = torch.nansum(x, dim=-1)
    elif fn == "avg":
        out = torch.nansum(x, dim=-1) / cnt.clamp(min=1)
    elif fn in ("min", "mimmin"):
        out = torch.where(valid, x, torch.inf).amin(dim=-1)
    elif fn in ("max", "mimmax"):
        out = torch.where(valid, x, -torch.inf).amax(dim=-1)
    elif fn == "count":
        out = cnt.to(values2d.dtype)
    elif fn in ("first", "last"):
        idx = (torch.where(valid, pos, -1).amax(dim=-1) if fn == "last"
               else torch.where(valid, pos, k).amin(dim=-1))
        out = torch.gather(x, -1, idx.clamp(0, k - 1)[..., None])[..., 0]
    else:
        raise ValueError(
            f"dense path does not support downsample fn {fn!r}")
    grid = torch.where(cnt > 0, out, float("nan"))
    return _finish_pipeline(grid, cnt > 0, bucket_ts, group_ids, ro,
                            spec)


def detect_regular_padded(counts: np.ndarray, bucket_idx2d: np.ndarray,
                          num_buckets: int) -> int | None:
    """Regular-cadence check on the padded layout: every row full to the
    same P with the identical k-contiguous bucket pattern. Returns k
    (points per bucket) or None."""
    if len(counts) == 0:
        return None
    p = int(counts[0])
    if p == 0 or not (counts == p).all() or \
            bucket_idx2d.shape[1] != p or p % num_buckets != 0:
        return None
    k = p // num_buckets
    expected = np.repeat(np.arange(num_buckets, dtype=bucket_idx2d.dtype),
                         k)
    if not (bucket_idx2d[0] == expected).all():
        return None
    if not (bucket_idx2d == bucket_idx2d[0]).all():
        return None
    return k


def device_bucket_ts(bucket_ts: np.ndarray) -> np.ndarray:
    """Bucket timestamps as int64 ms offsets from the first bucket: the
    kernels only use timestamp differences, which stay exact."""
    rel = np.asarray(bucket_ts, dtype=np.int64)
    return rel - rel[0] if len(rel) else rel


def upload(values2d: np.ndarray, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Host [S, P] values -> a contiguous tensor of ``dtype`` on
    ``device`` (converted on the host, so only ``dtype`` bytes cross)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    host = torch.from_numpy(np.ascontiguousarray(values2d,
                                                 dtype=np_dtype))
    return host.to(device)


def _run_dense_or_fused(values: torch.Tensor, bucket_ts: np.ndarray,
                        group_ids: np.ndarray, spec: PipelineSpec, k: int,
                        ro: RateOptions):
    """Regular-cadence execution: the fused kernels when the data and
    op combination allow it, the dense PyTorch path otherwise."""
    if not ro.drop_resets \
            and fused.supported(spec, values.dtype, values.device) \
            and not bool(torch.isnan(values).any()):
        return fused.fused_dense_pipeline(
            values, np.asarray(bucket_ts), np.asarray(group_ids), spec, k,
            rate_options=ro)
    dev = values.device
    return run_pipeline_dense(
        values, torch.as_tensor(device_bucket_ts(bucket_ts)).to(dev),
        torch.as_tensor(np.asarray(group_ids, dtype=np.int64)).to(dev),
        ro, spec, k)


def execute_auto(padded, bucket_idx2d: np.ndarray,
                 bucket_ts: np.ndarray, group_ids: np.ndarray,
                 spec: PipelineSpec, rate_options: RateOptions | None,
                 *, dtype: torch.dtype, device):
    """Host entry over a row-padded batch (``core.store.PaddedBatch``)
    -> (result [G, B], emit [G, B]) tensors on ``device``. Regular
    batches run the fused kernels or the dense path; irregular ones
    raise NotImplementedError (not ported yet)."""
    ro = rate_options or RateOptions()
    counts = np.asarray(padded.counts)
    k = detect_regular_padded(counts, np.asarray(bucket_idx2d),
                              spec.num_buckets)
    if k is None or spec.ds_function not in _DENSE_FNS:
        raise NotImplementedError(
            "only regular-cadence batches (every series with the same "
            "k points per bucket) and the dense downsample functions "
            "are ported yet")
    values = upload(padded.values2d, dtype, device)
    return _run_dense_or_fused(values, bucket_ts, group_ids, spec, k, ro)
