"""The fused dense query pipeline: downsample -> rate -> group reduce
in one kernel launch per query, for complete regular-cadence data.

Port of ``opentsdb_tpu/ops/pallas_fused.py``. Its two Pallas kernel
bodies become two hand-written CUDA kernels for Hopper
(``csrc/fused_pipeline.cu``), each behind a wrapper here:

- :func:`span_reduce` replaces ``_kernel_span`` (pallas_fused.py:270).
  Rows are gathered into group order first (the port of
  ``_gather_transpose``, without the transpose, which exists only for
  the TPU's 128-lane tiling), so a tile of :data:`TILE_S` series covers
  at most :data:`SPAN_MAX` groups; the kernel reduces each group slot
  inside the block and a second small kernel sums the tile partials in
  tile order, so the result is deterministic.
- :func:`onehot_reduce` replaces ``_kernel`` (pallas_fused.py:241):
  unsorted group ids. A persistent block of 768 threads per SM; each
  warp streams its own 32-row tiles through a two-stage ring of async
  copies into shared memory, and every lane adds its row's buckets into
  the block's shared-memory ``[G, B]`` accumulator (or a chunk of it)
  with shared atomics. Each block writes its partial to one row slice
  of a ``[slices, G, B]`` scratch tensor, sized by the library's
  ``fused_onehot_slices``, and a second small kernel sums the slices in
  order. The shared float atomics make the order of the sums inside a
  block vary from run to run.

Both kernels run the same per-series transform as the reference's
``_tile_transform`` (pallas_fused.py:196): downsample P points to B
buckets of k (sum-like functions add, ``avg`` then multiplies by 1/k,
``min``/``max`` reduce, ``first``/``last`` pick, ``count`` is k), then
the optional rate ``(t - t_prev) * inv_dt`` with counter rollover and
``reset_value``, then the square for ``squareSum``. The reference's
bf16 split of the value operand is a TPU matrix-unit workaround and is
not carried over: the kernels add in float32.

Each wrapper takes its plain PyTorch version (:func:`_transform_plain`
plus :func:`_group_stage_plain`, the same op order) only when handed
CPU tensors; for CUDA tensors it launches the kernel or raises. Each
wrapper counts its launches in a ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import _cuda_build
from opentsdb_tpu_torch.ops import downsample as ds_mod

_SUM_FNS = frozenset(("sum", "zimsum", "pfsum", "avg"))
_DS_FNS = _SUM_FNS | {"first", "last", "min", "mimmin", "max", "mimmax",
                      "count"}
# group aggregators expressible as an accumulated sum
_AGG_FNS = frozenset(("sum", "zimsum", "pfsum", "avg", "count",
                      "squareSum"))
_MAX_GROUPS = 4096
# span layout: at most SPAN_MAX distinct groups per tile of TILE_S
# group-sorted series, and at most _SPAN_GROUP_MAX groups in all
SPAN_MAX = 8
_SPAN_GROUP_MAX = 1024
# series per CUDA block (one per thread); equals kTile in the source
TILE_S = 128

# csrc/fused_pipeline.cu enums
_DS_KIND = {"sum": 0, "zimsum": 0, "pfsum": 0, "avg": 1, "first": 2,
            "last": 3, "min": 4, "mimmin": 4, "max": 5, "mimmax": 5,
            "count": 6}


def supported(spec, dtype, device) -> bool:
    """Can the fused kernels run this (ds_function, agg, rate)
    combination? float64 is declined on CUDA: the kernels are
    float32-only, as the reference declines f64 on the TPU."""
    if spec.ds_function not in _DS_FNS or spec.agg_name not in _AGG_FNS:
        return False
    if spec.emit_raw or spec.num_groups > _MAX_GROUPS:
        return False
    if spec.rate and spec.rate_drop_resets:
        return False  # re-opens NaN holes mid-pipeline
    if dtype == torch.float64 and torch.device(device).type == "cuda":
        return False
    return True


# -- host prep ---------------------------------------------------------------

def _build_inv_dt(spec, bucket_ts: np.ndarray) -> np.ndarray:
    """1/dt seconds per bucket for the rate stage, entry 0 zeroed (the
    dropped first bucket; the finalizer masks it)."""
    b = spec.num_buckets
    ts = np.asarray(bucket_ts, dtype=np.float64)
    dt = np.ones(b, dtype=np.float64)
    if b > 1:
        d = (ts[1:] - ts[:-1]) / 1000.0  # ms -> s (RateSpan dv/dt)
        d[d <= 0] = 1.0  # the rate kernel clamps non-positive dt
        dt[1:] = d
    inv = 1.0 / dt
    inv[0] = 0.0
    return inv


def array_digest(arr) -> bytes:
    """Content fingerprint of an index array (group ids)."""
    return hashlib.blake2b(memoryview(arr), digest_size=16).digest()


# group-sort permutations keyed by group-id content: a repeated
# dashboard query re-sorting the same (often 1M-long) group vector
# would pay an O(S log S) host argsort each time. Byte-bounded and
# locked: queries may prepare concurrently.
_ORDER_CACHE: "dict[tuple, np.ndarray | None]" = {}
_ORDER_CACHE_MAX_BYTES = 32 * 1024 * 1024
_ORDER_CACHE_LOCK = threading.Lock()
_order_cache_bytes = 0


def _sort_order(gids: np.ndarray):
    """Stable group-sort permutation (None = already sorted), memoized
    on the group-id content digest."""
    global _order_cache_bytes
    key = (array_digest(np.ascontiguousarray(gids)), len(gids))
    with _ORDER_CACHE_LOCK:
        if key in _ORDER_CACHE:
            return _ORDER_CACHE[key]
    order = None if np.all(gids[1:] >= gids[:-1]) else \
        np.argsort(gids, kind="stable")
    nbytes = 0 if order is None else order.nbytes
    with _ORDER_CACHE_LOCK:
        while _ORDER_CACHE and \
                _order_cache_bytes + nbytes > _ORDER_CACHE_MAX_BYTES:
            _, old = _ORDER_CACHE.popitem()
            _order_cache_bytes -= 0 if old is None else old.nbytes
        if key not in _ORDER_CACHE:
            _ORDER_CACHE[key] = order
            _order_cache_bytes += nbytes
    return order


def _span_layout(group_ids: np.ndarray, g: int):
    """Try the group-sorted span layout at the CUDA tile size. Returns
    (order | None, spans [NT, SPAN_MAX] int32), or None when some tile
    would cover more than SPAN_MAX groups or there are more than
    _SPAN_GROUP_MAX groups. Empty slots hold the sentinel ``g``."""
    if g > _SPAN_GROUP_MAX:
        return None
    gids = np.asarray(group_ids, dtype=np.int32)
    s = len(gids)
    nt = -(-s // TILE_S)
    order = _sort_order(gids) if s else None
    gpad = np.full(nt * TILE_S, g, np.int32)
    gpad[:s] = gids if order is None else gids[order]
    gt = gpad.reshape(nt, TILE_S)
    # first row of each group run inside a tile; padded rows carry the
    # sentinel, which needs no slot
    starts = np.ones(gt.shape, dtype=bool)
    starts[:, 1:] = gt[:, 1:] != gt[:, :-1]
    starts &= gt != g
    slot = np.cumsum(starts, axis=1) - 1
    if nt and int(slot[:, -1].max()) + 1 > SPAN_MAX:
        return None
    spans = np.full((nt, SPAN_MAX), g, np.int32)
    r, c = np.nonzero(starts)
    spans[r, slot[r, c]] = gt[r, c]
    return order, spans


@dataclass
class FusedBatch:
    """Device arguments of one fused execution (see :func:`prepare`)."""
    values: torch.Tensor         # [S, P]; group-sorted rows with spans
    gids: torch.Tensor           # [S] int32 in the row order of values
    inv_dt: torch.Tensor         # [B]
    sizes: torch.Tensor          # [G] series per group
    spans: torch.Tensor | None   # [NT, SPAN_MAX] int32 -> span kernel
    group_start: torch.Tensor | None  # [G+1] int32 first sorted row


def prepare(values: torch.Tensor, bucket_ts: np.ndarray,
            group_ids: np.ndarray, spec,
            allow_span: bool = True) -> FusedBatch:
    """Host prep and the group-sort gather (the port of the reference's
    ``prepare``): picks the span layout when it fits, else the one-hot
    layout. ``values`` is the [S, P] batch, already on its device."""
    dev, dtype = values.device, values.dtype
    gids = np.asarray(group_ids, dtype=np.int32)
    sizes = np.bincount(gids, minlength=spec.num_groups)
    inv_dt = torch.as_tensor(_build_inv_dt(spec, bucket_ts),
                             dtype=dtype).to(dev)
    sizes_t = torch.as_tensor(sizes, dtype=dtype).to(dev)
    span = _span_layout(gids, spec.num_groups) if allow_span else None
    if span is None:
        return FusedBatch(values, torch.as_tensor(gids).to(dev), inv_dt,
                          sizes_t, None, None)
    order, spans = span
    if order is not None:
        values = values.index_select(0, torch.as_tensor(order).to(dev))
        gids = gids[order]
    group_start = np.zeros(spec.num_groups + 1, dtype=np.int32)
    np.cumsum(sizes, out=group_start[1:])
    return FusedBatch(values, torch.as_tensor(gids).to(dev), inv_dt,
                      sizes_t, torch.as_tensor(spans).to(dev),
                      torch.as_tensor(group_start).to(dev))


# -- the plain versions -------------------------------------------------------

def _transform_plain(values: torch.Tensor, inv_dt: torch.Tensor, spec,
                     k: int, counter_max: float,
                     reset_value: float) -> torch.Tensor:
    """Per-series transform [S, P] -> t [S, B], in the kernels' order:
    downsample, rate (with counter rollover and reset_value), square."""
    s = values.shape[0]
    b = spec.num_buckets
    fn = spec.ds_function
    x = values.reshape(s, b, k)
    if fn in _SUM_FNS:
        # left to right, as each kernel thread adds its bucket's points:
        # a rate over nearly equal bucket sums cancels most digits, so a
        # different addition order would show in t itself
        t = x[:, :, 0]
        for j in range(1, k):
            t = t + x[:, :, j]
        if fn == "avg":
            t = t * torch.tensor(1.0 / k, dtype=values.dtype)
    elif fn == "first":
        t = x[:, :, 0]
    elif fn == "last":
        t = x[:, :, k - 1]
    elif fn in ("min", "mimmin"):
        t = x.amin(dim=-1)
    elif fn in ("max", "mimmax"):
        t = x.amax(dim=-1)
    else:  # count
        t = torch.full((s, b), float(k), dtype=values.dtype,
                       device=values.device)
    if spec.rate:
        t_prev = torch.cat([t[:, :1], t[:, :-1]], dim=1)
        delta = t - t_prev
        if spec.rate_counter:
            delta = torch.where(delta < 0, counter_max - t_prev + t,
                                delta)
        t = delta * inv_dt[None, :]
        if spec.rate_counter and reset_value > 0:
            t = torch.where(t > reset_value, 0.0, t)
    if spec.agg_name == "squareSum":
        t = t * t
    return t


def _group_stage_plain(t: torch.Tensor, gids: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """acc[g, b] = sum of t[s, b] over the series s of group g."""
    acc = t.new_zeros((num_groups, t.shape[1]))
    return acc.index_add_(0, gids.long(), t)


# -- the kernel wrappers ------------------------------------------------------

def _kernel_flags(spec) -> tuple[int, int, int]:
    rate_mode = (2 if spec.rate_counter else 1) if spec.rate else 0
    return (_DS_KIND[spec.ds_function], rate_mode,
            int(spec.agg_name == "squareSum"))


def _check_cuda(values, gids, inv_dt, spec, k):
    if not values.is_cuda:
        raise ValueError(f"fused kernels take CPU or CUDA tensors, not "
                         f"{values.device}")
    s, p = values.shape
    if values.dtype != torch.float32 or inv_dt.dtype != torch.float32:
        raise TypeError("the CUDA fused kernels are float32-only")
    if p != spec.num_buckets * k or inv_dt.shape != (spec.num_buckets,):
        raise ValueError("values must be [S, B*k] with inv_dt [B]")
    if gids.dtype != torch.int32 or gids.shape != (s,):
        raise ValueError("group ids must be int32 [S]")
    for t in (values, gids, inv_dt):
        if not t.is_contiguous() or t.device != values.device:
            raise ValueError("kernel operands must be contiguous and on "
                             "one device")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = _cuda_build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.fused_error_string(err).decode()}")


def span_reduce(values: torch.Tensor, gids: torch.Tensor,
                spans: torch.Tensor, group_start: torch.Tensor,
                inv_dt: torch.Tensor, spec, k: int, counter_max: float,
                reset_value: float) -> torch.Tensor:
    """Group-sorted fused transform + group sum -> acc [G, B].

    ``values`` [S, P] rows in group order, ``gids`` [S] int32 in the
    same order, ``spans`` [ceil(S/TILE_S), SPAN_MAX] the groups of each
    tile, ``group_start`` [G+1] each group's first row."""
    g = spec.num_groups
    if values.device.type == "cpu":
        return _group_stage_plain(
            _transform_plain(values, inv_dt, spec, k, counter_max,
                             reset_value), gids, g)
    _check_cuda(values, gids, inv_dt, spec, k)
    s, p = values.shape
    nt = -(-s // TILE_S)
    if spans.shape != (nt, SPAN_MAX) or spans.dtype != torch.int32 \
            or group_start.shape != (g + 1,) \
            or group_start.dtype != torch.int32:
        raise ValueError("spans must be int32 [NT, SPAN_MAX] and "
                         "group_start int32 [G+1]")
    b = spec.num_buckets
    partials = torch.empty((nt, SPAN_MAX, b), dtype=torch.float32,
                           device=values.device)
    out = torch.empty((g, b), dtype=torch.float32, device=values.device)
    ds_kind, rate_mode, square = _kernel_flags(spec)
    _launch("fused_span_reduce", values.device,
            values.data_ptr(), s, p, k, b, gids.data_ptr(),
            spans.data_ptr(), nt, group_start.data_ptr(), g,
            inv_dt.data_ptr(), counter_max, reset_value, ds_kind,
            rate_mode, square, partials.data_ptr(), out.data_ptr())
    span_reduce.launches += 1
    return out


span_reduce.launches = 0


def onehot_reduce(values: torch.Tensor, gids: torch.Tensor,
                  inv_dt: torch.Tensor, spec, k: int, counter_max: float,
                  reset_value: float) -> torch.Tensor:
    """Fused transform + group sum over unsorted group ids -> acc
    [G, B]. ``values`` [S, P], ``gids`` [S] int32."""
    g = spec.num_groups
    if values.device.type == "cpu":
        return _group_stage_plain(
            _transform_plain(values, inv_dt, spec, k, counter_max,
                             reset_value), gids, g)
    _check_cuda(values, gids, inv_dt, spec, k)
    s, p = values.shape
    b = spec.num_buckets
    dev = values.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices = _cuda_build.library().fused_onehot_slices(s, b, g, sms)
    partials = torch.empty((slices, g, b), dtype=torch.float32, device=dev)
    out = torch.empty((g, b), dtype=torch.float32, device=dev)
    ds_kind, rate_mode, square = _kernel_flags(spec)
    _launch("fused_onehot_reduce", dev,
            values.data_ptr(), s, p, k, b, gids.data_ptr(), g,
            inv_dt.data_ptr(), counter_max, reset_value, ds_kind,
            rate_mode, square, sms, dev.index,
            partials.data_ptr(), out.data_ptr())
    onehot_reduce.launches += 1
    return out


onehot_reduce.launches = 0


# -- finalize and the host entry ---------------------------------------------

def _finalize(acc: torch.Tensor, group_sizes: torch.Tensor, spec):
    """Shared [G, B] finalizer: aggregator division / counts and the
    emission mask (fill policy NONE follows pre-fill presence)."""
    g, b = spec.num_groups, spec.num_buckets
    full_cnt = group_sizes[:, None].expand(g, b)
    cnt = full_cnt.clone()
    if spec.rate:
        cnt[:, 0] = 0.0
    agg = spec.agg_name
    # ZIM-interpolation aggregators (Aggregators.java:92-113) fill every
    # hole, the rate-dropped first bucket included, with a valid 0
    zim = agg in ("zimsum", "count", "squareSum")
    eff_cnt = full_cnt if zim else cnt
    if agg in ("sum", "zimsum", "pfsum", "squareSum"):
        out = acc
    elif agg == "avg":
        out = acc / eff_cnt.clamp(min=1.0)
    elif agg == "count":
        out = eff_cnt
    else:
        raise ValueError(f"fused pipeline has no aggregator {agg!r}")
    result = torch.where(eff_cnt > 0, out, float("nan"))
    if spec.fill_policy == ds_mod.FillPolicy.NONE:
        # the rate-dropped bucket never emits, even for ZIM aggregators
        emit = cnt > 0
    else:
        emit = torch.ones((g, b), dtype=torch.bool, device=acc.device)
    return result, emit


def run(batch: FusedBatch, spec, k: int, rate_options=None):
    """Execute a prepared batch -> (result [G, B], emit [G, B]) on the
    batch's device."""
    cm = float(rate_options.counter_max) if rate_options else \
        float(2**64 - 1)
    rv = float(rate_options.reset_value) if rate_options else 0.0
    if batch.spans is not None:
        acc = span_reduce(batch.values, batch.gids, batch.spans,
                          batch.group_start, batch.inv_dt, spec, k, cm, rv)
    else:
        acc = onehot_reduce(batch.values, batch.gids, batch.inv_dt, spec,
                            k, cm, rv)
    return _finalize(acc, batch.sizes, spec)


def fused_dense_pipeline(values: torch.Tensor, bucket_ts: np.ndarray,
                         group_ids: np.ndarray, spec, k: int,
                         rate_options=None, allow_span: bool = True):
    """Host entry for complete data: values [S, P] (no NaN, on its
    device), bucket_ts [B] ms, group_ids [S] -> (result [G, B],
    emit [G, B]) tensors on the same device."""
    batch = prepare(values, bucket_ts, group_ids, spec,
                    allow_span=allow_span)
    return run(batch, spec, k, rate_options)
