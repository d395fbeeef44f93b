"""The query pipeline: downsample -> fill -> rate -> interpolate ->
aggregate -> group-by over a ``[series, bucket]`` grid, in PyTorch.

Port of ``opentsdb_tpu/ops/pipeline.py`` for two paths:

- the point path: ``prepare_auto`` uploads a row-padded batch as a
  :class:`PreparedBatch` and ``run_prepared`` runs it, in one of three
  layouts, as the reference picks them:

  - ``dense``: every row holds the same k-per-bucket points. The fused
    CUDA kernels (:mod:`opentsdb_tpu_torch.ops.fused`) run complete
    data, and the dense PyTorch path (:func:`run_pipeline_dense`) data
    with NaN holes, an option the kernels decline, or float64 on CUDA;
  - ``padded``: irregular rows (jittered or dropped points) of a
    :data:`~.downsample.PADDED_FNS` function within the
    :data:`_PADDED_EINSUM_MAX_CELLS` budget, downsampled by
    :func:`.downsample.bucketize_padded` (:func:`run_pipeline_padded`);
  - ``flat``: anything else (the rank downsample functions, a union
    grid of many timestamps, a skewed batch the engine materialized
    flat), a point batch sorted by (series, time) downsampled by
    segmented reductions (:func:`run_pipeline`).

  ``execute_auto`` and ``execute`` are upload and run in one call.
- the grid path: the store has already downsampled the window to a
  ``[S, B]`` grid (``TimeSeriesStore.bucket_reduce``); ``put_grid``
  uploads it and ``execute_grid`` runs the pipeline's tail on it;
  ``execute_avg_divide`` runs the same tail on the quotient of a rollup
  sum tier's grid and its count tier's (an ``avg`` from the tiers).

The reference pads every shape up to a geometric bucket
(``ops/shapes.py``) to bound XLA's compile space. Eager PyTorch
compiles nothing per shape, so the port runs the true ``(S, B, G)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.core.store import pad_mask
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
    # True when the engine placed this tail on the host CPU (ref:
    # ``PipelineSpec.host``, the host-tail path): its tensors are CPU
    # tensors, so every kernel wrapper takes its plain version. The
    # reference switches its group stage to segment ops there (its
    # device one is a one-hot contraction); the port's group stage is
    # the fixed-order segment reduction of ``GroupPlan`` on every
    # device, so the flag selects no other code in the tail
    host: bool = False
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
    if spec.host and grid.device.type != "cpu":
        raise ValueError(f"a host-placed tail got a {grid.device} grid")
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
    plan = gb_mod.GroupPlan(group_ids, g)
    result = gb_mod.group_aggregate(grid, bucket_ts, group_ids, g, agg,
                                    interpolate=interpolate, plan=plan)

    # emission: fill NONE emits the union of the group's series' buckets;
    # any other policy emits every bucket (FillingDownsampler)
    ones = torch.ones((g, b), dtype=torch.bool, device=grid.device)
    if spec.complete and not spec.rate:
        emit = ones
    elif spec.fill_policy == ds_mod.FillPolicy.NONE:
        # any series present
        emit = plan.max(has_data.to(grid.dtype)) > 0
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
    bucket_ts: [B] int64 relative ms; group_ids: [S] integer."""
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


def run_pipeline(values, series_idx, bucket_idx, bucket_ts, group_ids,
                 ro: RateOptions, spec: PipelineSpec):
    """Flat path: values [N], series_idx [N], bucket_idx [N] (sorted
    by series, then time), bucket_ts [B] int64 relative ms, group_ids
    [S] -> (result [G, B] or [S, B], emit mask of the same shape)."""
    grid, cnt = ds_mod.bucketize(values, series_idx, bucket_idx,
                                 spec.num_series, spec.num_buckets,
                                 spec.ds_function)
    return _finish_pipeline(grid, cnt > 0, bucket_ts, group_ids, ro, spec)


def run_pipeline_padded(values2d, bucket_idx2d, bucket_ts, group_ids,
                        ro: RateOptions, spec: PipelineSpec):
    """Irregular data in the row-padded layout: values2d [S, Pmax]
    NaN-padded, bucket_idx2d [S, Pmax] with -1 for pads; downsampled
    without a scatter (:func:`.downsample.bucketize_padded`), then the
    shared fill/rate/interpolate/aggregate tail."""
    grid, cnt = ds_mod.bucketize_padded(values2d, bucket_idx2d,
                                        spec.num_buckets,
                                        spec.ds_function)
    return _finish_pipeline(grid, cnt > 0, bucket_ts, group_ids, ro, spec)


def detect_dense(num_series: int, num_buckets: int,
                 series_idx: np.ndarray, bucket_idx: np.ndarray,
                 ds_function: str) -> int | None:
    """Regular-cadence check on a flat batch: every series contributes
    the same P points in the same bucket pattern, each bucket exactly
    k = P / B consecutive points. Returns k, or None."""
    if ds_function not in _DENSE_FNS:
        return None
    n = len(series_idx)
    if num_series == 0 or n == 0 or n % num_series != 0:
        return None
    p = n // num_series
    if p % num_buckets != 0:
        return None
    k = p // num_buckets
    sgrid = series_idx.reshape(num_series, p)
    if not (sgrid == np.arange(num_series,
                               dtype=sgrid.dtype)[:, None]).all():
        return None
    bgrid = bucket_idx.reshape(num_series, p)
    expected = np.repeat(np.arange(num_buckets, dtype=bgrid.dtype), k)
    if not (bgrid == expected[None, :]).all():
        return None
    return k


# the reference's traffic budget for its padded [S, Pmax, B] compare;
# the port reduces each bucket's band of columns instead, but takes the
# same layout decisions
_PADDED_EINSUM_MAX_CELLS = 2 * 10**9


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


def flatten_padded(values2d: np.ndarray, bucket_idx2d: np.ndarray,
                   counts: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded -> flat (values, series_idx, bucket_idx), in (series,
    time) order."""
    mask = ~pad_mask(counts, values2d.shape[1])
    series_idx = np.repeat(np.arange(values2d.shape[0], dtype=np.int32),
                           counts.astype(np.int64))
    return (values2d[mask], series_idx,
            bucket_idx2d[mask].astype(np.int32))


def device_bucket_ts(bucket_ts: np.ndarray) -> np.ndarray:
    """Bucket timestamps as int64 ms offsets from the first bucket: the
    kernels only use timestamp differences, which stay exact."""
    rel = np.asarray(bucket_ts, dtype=np.int64)
    return rel - rel[0] if len(rel) else rel


def _query_operands(bucket_ts: np.ndarray, group_ids: np.ndarray,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-query operands on ``device``: relative bucket times and
    int32 group ids."""
    return (torch.as_tensor(device_bucket_ts(bucket_ts)).to(device),
            torch.as_tensor(np.asarray(group_ids, dtype=np.int32))
            .to(device))


def upload(values2d: np.ndarray, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Host [S, P] values -> a contiguous tensor of ``dtype`` on
    ``device`` (converted on the host, so only ``dtype`` bytes cross)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    host = torch.from_numpy(np.ascontiguousarray(values2d,
                                                 dtype=np_dtype))
    return host.to(device)


def run_pipeline_grid(grid, has_data, bucket_ts, group_ids,
                      ro: RateOptions, spec: PipelineSpec):
    """Tail entry for a storage-side ``[S, B]`` downsample grid (NaN
    holes, ``has_data`` marking the cells that held points): fill,
    rate, interpolate and aggregate, without a per-point upload."""
    return _finish_pipeline(grid, has_data, bucket_ts, group_ids, ro,
                            spec)


def grid_from_reduce(fn: str, sums: np.ndarray, cnts: np.ndarray,
                     mins: np.ndarray | None, maxs: np.ndarray | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The downsample grid of one function from ``bucket_reduce``'s
    statistics: (float64 ``[S, B]`` with NaN holes, presence mask)."""
    present = cnts > 0
    if fn in ("sum", "zimsum", "pfsum"):
        grid = sums
    elif fn == "count":
        grid = cnts
    elif fn == "avg":
        grid = sums / np.maximum(cnts, 1.0)
    elif fn in ("min", "mimmin"):
        grid = mins
    elif fn in ("max", "mimmax"):
        grid = maxs
    else:
        raise ValueError(f"no grid for downsample function {fn!r}")
    return np.where(present, grid, np.nan), present


def put_grid(grid: np.ndarray, has_data: np.ndarray, dtype: torch.dtype,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """Upload a ``[S, B]`` grid in the compute dtype and its presence
    mask, once: callers cache the device tensors so a repeat skips the
    host scan and the transfer."""
    return (upload(grid, dtype, device),
            torch.from_numpy(np.ascontiguousarray(has_data, dtype=bool))
            .to(device))


def execute_grid(grid, has_data, bucket_ts: np.ndarray,
                 group_ids: np.ndarray, spec: PipelineSpec,
                 rate_options: RateOptions | None = None):
    """Entry over an uploaded ``[S, B]`` grid (:func:`put_grid`) ->
    (result, emit) tensors on the grid's device, ``[G, B]`` or, for
    ``emit_raw``, ``[S, B]``."""
    return run_pipeline_grid(
        grid, has_data, *_query_operands(bucket_ts, group_ids, grid.device),
        rate_options or RateOptions(), spec)


def avg_divide_grid(grid_sum, grid_cnt):
    """The rollup average (ref: ``avg_divide_grid``): SUM-tier cells
    over COUNT-tier cells where both tiers hold a cell, NaN elsewhere
    (ref: RollupSpan's agg-prefixed sum and count qualifiers). Returns
    (grid, valid)."""
    valid = ~torch.isnan(grid_sum) & ~torch.isnan(grid_cnt) & (grid_cnt > 0)
    grid = torch.where(valid, grid_sum / torch.where(valid, grid_cnt, 1.0),
                       torch.nan)
    return grid, valid


def run_pipeline_avg_div(grid_sum, grid_cnt, bucket_ts, group_ids,
                         ro: RateOptions, spec: PipelineSpec):
    """Tail entry of the avg-rollup path (ref: ``run_pipeline_avg_div``):
    the divide, then the fill/rate/interpolate/aggregate chain, with
    both ``[S, B]`` grids on the device."""
    grid, valid = avg_divide_grid(grid_sum, grid_cnt)
    return _finish_pipeline(grid, valid, bucket_ts, group_ids, ro, spec)


def execute_avg_divide(grid_sum, grid_cnt, bucket_ts: np.ndarray,
                       group_ids: np.ndarray, spec: PipelineSpec,
                       rate_options: RateOptions | None = None):
    """Entry over the sum and count tiers' ``[S, B]`` grids, NaN where a
    tier holds no cell, both on one device (ref: ``execute_avg_divide``)
    -> (result, emit) tensors there, ``[G, B]`` or, for ``emit_raw``,
    ``[S, B]``."""
    return run_pipeline_avg_div(
        grid_sum, grid_cnt,
        *_query_operands(bucket_ts, group_ids, grid_sum.device),
        rate_options or RateOptions(), spec)


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
    return run_pipeline_dense(
        values, *_query_operands(bucket_ts, group_ids, values.device), ro,
        spec, k)


@dataclass(frozen=True)
class PreparedBatch:
    """Device-resident upload of one sub-query's point data, ready to
    run again: the engine caches these so a warm query pays neither the
    host materialize nor the transfer.

    kind ``dense``: ``arrays = (values2d,)``, ``k`` points per bucket;
    kind ``padded``: ``arrays = (values2d, bucket_idx2d)``;
    kind ``flat``: ``arrays = (values, series_idx, bucket_idx)``, the
    points in (series, time) order."""
    kind: str
    arrays: tuple
    k: int | None = None

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays)


def prepare_auto(padded, bucket_idx2d: np.ndarray, spec: PipelineSpec,
                 *, dtype: torch.dtype, device) -> PreparedBatch:
    """Layout-detect and upload a row-padded batch
    (``core.store.PaddedBatch``), with the reference's rules: regular
    batches of the dense downsample functions become ``dense``;
    irregular ones of a :data:`~.downsample.PADDED_FNS` function within
    :data:`_PADDED_EINSUM_MAX_CELLS` become ``padded``; anything else
    is flattened to ``flat``."""
    values2d = np.asarray(padded.values2d)
    counts = np.asarray(padded.counts)
    bucket_idx2d = np.asarray(bucket_idx2d)
    k = detect_regular_padded(counts, bucket_idx2d, spec.num_buckets)
    if k is not None and spec.ds_function in _DENSE_FNS:
        return PreparedBatch("dense", (upload(values2d, dtype, device),),
                             k)
    cells = values2d.shape[0] * values2d.shape[1] * spec.num_buckets
    if ds_mod.padded_supported(spec.ds_function, spec.num_buckets) \
            and cells <= _PADDED_EINSUM_MAX_CELLS:
        return PreparedBatch("padded", (
            upload(values2d, dtype, device),
            upload(bucket_idx2d, torch.int32, device)))
    return prepare_flat(*flatten_padded(values2d, bucket_idx2d, counts),
                        spec, dtype=dtype, device=device)


def prepare_flat(values: np.ndarray, series_idx: np.ndarray,
                 bucket_idx: np.ndarray, spec: PipelineSpec, *,
                 dtype: torch.dtype, device) -> PreparedBatch:
    """Layout-detect and upload a flat point batch: ``dense`` when it
    is regular (:func:`detect_dense`), else ``flat``. A batch that is
    not in (series, time) order is put in it first by a stable sort
    (the points of one bucket keep their order)."""
    values = np.asarray(values)
    series_idx = np.asarray(series_idx)
    bucket_idx = np.asarray(bucket_idx)
    k = detect_dense(spec.num_series, spec.num_buckets, series_idx,
                     bucket_idx, spec.ds_function)
    if k is not None:
        return PreparedBatch("dense", (upload(
            values.reshape(spec.num_series, -1), dtype, device),), k)
    seg = series_idx.astype(np.int64) * spec.num_buckets + bucket_idx
    if len(seg) > 1 and (seg[1:] < seg[:-1]).any():
        order = np.argsort(seg, kind="stable")
        values, series_idx, bucket_idx = (values[order], series_idx[order],
                                          bucket_idx[order])
    return PreparedBatch("flat", (upload(values, dtype, device),
                                  upload(series_idx, torch.int32, device),
                                  upload(bucket_idx, torch.int32, device)))


def run_prepared(prep: PreparedBatch, bucket_ts: np.ndarray,
                 group_ids: np.ndarray, spec: PipelineSpec,
                 rate_options: RateOptions | None = None):
    """Run a (possibly cached) PreparedBatch -> (result [G, B],
    emit [G, B]) tensors on its device.

    A ``dense`` batch runs :func:`_run_dense_or_fused`, as the cold
    point path does, so a warm hit on the card launches the same
    kernels. The reference's ``run_prepared`` runs its dense XLA path
    instead: the same function with the additions in another order."""
    ro = rate_options or RateOptions()
    if prep.kind == "dense":
        return _run_dense_or_fused(prep.arrays[0], bucket_ts, group_ids,
                                   spec, prep.k, ro)
    bts, gids = _query_operands(bucket_ts, group_ids,
                                prep.arrays[0].device)
    if prep.kind == "padded":
        return run_pipeline_padded(*prep.arrays, bts, gids, ro, spec)
    if prep.kind == "flat":
        return run_pipeline(*prep.arrays, bts, gids, ro, spec)
    raise ValueError(f"unknown prepared batch kind {prep.kind!r}")


def execute(batch_values: np.ndarray, series_idx: np.ndarray,
            bucket_idx: np.ndarray, bucket_ts: np.ndarray,
            group_ids: np.ndarray, spec: PipelineSpec,
            rate_options: RateOptions | None, *, dtype: torch.dtype,
            device):
    """Host entry over a flat point batch -> (result, emit) tensors on
    ``device``: upload and run, as :func:`prepare_flat` and
    :func:`run_prepared`."""
    return run_prepared(prepare_flat(batch_values, series_idx, bucket_idx,
                                     spec, dtype=dtype, device=device),
                        bucket_ts, group_ids, spec, rate_options)


def execute_auto(padded, bucket_idx2d: np.ndarray,
                 bucket_ts: np.ndarray, group_ids: np.ndarray,
                 spec: PipelineSpec, rate_options: RateOptions | None,
                 *, dtype: torch.dtype, device):
    """Host entry over a row-padded batch (``core.store.PaddedBatch``)
    -> (result [G, B], emit [G, B]) tensors on ``device``: upload and
    run, as :func:`prepare_auto` and :func:`run_prepared`."""
    return run_prepared(prepare_auto(padded, bucket_idx2d, spec,
                                     dtype=dtype, device=device),
                        bucket_ts, group_ids, spec, rate_options)
