"""The fused dense query pipeline: downsample -> rate -> group reduce
in one kernel launch per query, for complete regular-cadence data.

Port of ``opentsdb_tpu/ops/pallas_fused.py``. Its two Pallas kernel
bodies become two hand-written CUDA kernels for Hopper
(``csrc/fused_pipeline.cu``), each behind a wrapper here:

- :func:`span_reduce` replaces ``_kernel_span`` (pallas_fused.py:270).
  The layout is the reference's stable group sort (its
  ``_gather_transpose``), but the rows are never gathered: the kernel
  walks 32-row warp tiles of the sorted order and reads each row
  through the permutation (``FusedBatch.order``), so a tile of
  :data:`TILE_S` sorted series covers at most :data:`SPAN_MAX` groups.
  It streams rows through the same per-warp async-copy rings as the
  one-hot kernel; each warp reduces a finished bucket per group slot
  with warp shuffles into per-warp-tile partials, and a second small
  kernel sums each group's partials with a fixed tree, so the result
  is bitwise the same from launch to launch.
- :func:`onehot_reduce` replaces ``_kernel`` (pallas_fused.py:241):
  more than :data:`_SPAN_GROUP_MAX` groups, or groups too spread for
  the span layout. It is the span kernel's scheme without the cap of
  :data:`SPAN_MAX` groups per tile: the rows are read through the same
  stable group-sort permutation, so a group's rows sit in adjacent
  lanes of a 32-row warp tile; each finished bucket is reduced per run
  of equal ids by a segmented scan of warp shuffles in a fixed order,
  the run's first lane writes it to a ``[ceil(S/32), 32, B]`` scratch
  tensor, and a second small kernel sums each group's warp tiles with a
  fixed tree. No float atomic: the result is bitwise the same from
  launch to launch.

Both kernels run the same per-series transform as the reference's
``_tile_transform`` (pallas_fused.py:196): downsample P points to B
buckets of k (sum-like functions add, ``avg`` then multiplies by 1/k,
``min``/``max`` reduce, ``first``/``last`` pick, ``count`` is k), then
the optional rate ``(t - t_prev) * inv_dt`` with counter rollover and
``reset_value``, then the square for ``squareSum``. The reference's
bf16 split of the value operand is a TPU matrix-unit workaround and is
not carried over: the kernels add in float32.

Each wrapper takes its plain PyTorch version (:func:`_plain`:
:func:`_transform_plain` plus :func:`_group_stage_plain`, the same op
order) only when handed CPU tensors; for CUDA tensors it launches the
kernel or raises. Each wrapper counts its launches in a ``launches``
attribute, under a lock: sub-queries launch from several threads.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import _cuda_build
from opentsdb_tpu_torch.ops import downsample as ds_mod
from opentsdb_tpu_torch.query.device_cache import array_digest

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
# sorted series per row of spans; equals kSpanTile in the source
TILE_S = 128
# rows per warp tile, a one-hot partial's slots; kWarpTile in the source
WARP_TILE = 32

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


# group-sort permutations keyed by group-id content: a repeated
# dashboard query re-sorting the same (often 1M-long) group vector
# would pay an O(S log S) host argsort each time. Byte-bounded and
# locked: queries may prepare concurrently.
_ORDER_CACHE: "dict[tuple, np.ndarray | None]" = {}
_ORDER_CACHE_MAX_BYTES = 32 * 1024 * 1024
_ORDER_CACHE_LOCK = threading.Lock()
_order_cache_bytes = 0


def _sort_order(gids: np.ndarray):
    """Stable group-sort permutation as int32 (None = already sorted),
    memoized on the group-id content digest."""
    global _order_cache_bytes
    key = (array_digest(np.ascontiguousarray(gids)), len(gids))
    with _ORDER_CACHE_LOCK:
        if key in _ORDER_CACHE:
            return _ORDER_CACHE[key]
    order = None if np.all(gids[1:] >= gids[:-1]) else \
        np.argsort(gids, kind="stable").astype(np.int32)
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
    (order | None, spans [NT, SPAN_MAX] int32, the group ids in sorted
    order), or None when some tile would cover more than SPAN_MAX
    groups or there are more than _SPAN_GROUP_MAX groups. Empty slots
    hold the sentinel ``g``."""
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
    return order, spans, gpad[:s]


@dataclass
class FusedBatch:
    """Device arguments of one fused execution (see :func:`prepare`)."""
    values: torch.Tensor         # [S, P] in the caller's row order
    gids: torch.Tensor           # [S] int32, in group order
    inv_dt: torch.Tensor         # [B]
    sizes: torch.Tensor          # [G] series per group
    spans: torch.Tensor | None   # [NT, SPAN_MAX] int32 -> span kernel;
    #                              None -> one-hot kernel
    group_start: torch.Tensor    # [G+1] int32 first sorted row
    # [S] int32 stable group-sort permutation (row i of the sorted
    # order is values row order[i]); None when the ids are sorted
    order: torch.Tensor | None = None


def prepare(values: torch.Tensor, bucket_ts: np.ndarray,
            group_ids: np.ndarray, spec,
            allow_span: bool = True) -> FusedBatch:
    """Host prep (the port of the reference's ``prepare``): picks the
    span layout when it fits, else the one-hot layout. Both read the
    rows in the stable group order. ``values`` is the [S, P] batch,
    already on its device; it is never reordered (the kernels read its
    rows through ``order``)."""
    dev, dtype = values.device, values.dtype
    gids = np.asarray(group_ids, dtype=np.int32)
    sizes = np.bincount(gids, minlength=spec.num_groups)
    inv_dt = torch.as_tensor(_build_inv_dt(spec, bucket_ts),
                             dtype=dtype).to(dev)
    sizes_t = torch.as_tensor(sizes, dtype=dtype).to(dev)
    group_start = np.zeros(spec.num_groups + 1, dtype=np.int32)
    np.cumsum(sizes, out=group_start[1:])
    span = _span_layout(gids, spec.num_groups) if allow_span else None
    if span is None:
        order = _sort_order(gids) if len(gids) else None
        sorted_gids, spans = gids if order is None else gids[order], None
    else:
        order, spans, sorted_gids = span
        spans = torch.as_tensor(spans).to(dev)
    return FusedBatch(values, torch.as_tensor(sorted_gids).to(dev),
                      inv_dt, sizes_t, spans,
                      torch.as_tensor(group_start).to(dev),
                      None if order is None
                      else torch.as_tensor(order).to(dev))


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


def _in_group_order(t: torch.Tensor, order) -> torch.Tensor:
    """Rows of ``t`` in the group order (row i is ``t[order[i]]``), to
    pair them with the sorted group ids of a span batch."""
    return t if order is None else t.index_select(0, order.long())


def _plain(values, order, gids, inv_dt, spec, k: int, counter_max: float,
           reset_value: float, exact: bool = False,
           magnitude: bool = False) -> torch.Tensor:
    """The plain version of both kernels -> acc [G, B]: the transform,
    its rows paired with ``gids`` through ``order``, the group sums of t
    (of |t| with ``magnitude``). The wrappers run it as it is for CPU
    tensors, in the dtype of ``values``. With ``exact``, the group sums
    of the same terms are added in float64 and rounded once: the
    reference the kernels are held to on the card, whose own rounding
    then does not count against them (a float32 running sum over a
    group of 28,000 series drifts past the tolerance)."""
    t = _in_group_order(_transform_plain(values, inv_dt, spec, k,
                                         counter_max, reset_value), order)
    if magnitude:
        t = t.abs()
    if not exact:
        return _group_stage_plain(t, gids, spec.num_groups)
    return _group_stage_plain(t.double(), gids,
                              spec.num_groups).to(t.dtype)


def plain_reduce(batch: FusedBatch, spec, k: int, counter_max: float,
                 reset_value: float, exact: bool = False,
                 magnitude: bool = False) -> torch.Tensor:
    """:func:`_plain` of ``batch`` on its own device: what its kernel's
    wrapper runs for CPU tensors (``exact`` adds the group sums in
    float64, the reference on the card)."""
    return _plain(batch.values, batch.order, batch.gids, batch.inv_dt,
                  spec, k, counter_max, reset_value, exact, magnitude)


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


def _check_order(order, group_start, s: int, g: int, dev) -> None:
    if order is not None and (
            order.dtype != torch.int32 or order.shape != (s,)
            or not order.is_contiguous() or order.device != dev):
        raise ValueError("order must be a contiguous int32 [S] tensor on "
                         "the device of values")
    if group_start.shape != (g + 1,) or group_start.dtype != torch.int32 \
            or not group_start.is_contiguous() \
            or group_start.device != dev:
        raise ValueError("group_start must be a contiguous int32 [G+1] "
                         "tensor on the device of values")


_LAUNCHES_LOCK = threading.Lock()


def _launch(fn_name: str, device: torch.device, wrapper, *args) -> None:
    """Launch one library entry on the calling thread's current stream
    (PyTorch keeps one per thread) and count it on ``wrapper``."""
    lib = _cuda_build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.fused_error_string(err).decode()}")
    with _LAUNCHES_LOCK:
        wrapper.launches += 1


def span_reduce(values: torch.Tensor, order: torch.Tensor | None,
                gids: torch.Tensor, spans: torch.Tensor,
                group_start: torch.Tensor, inv_dt: torch.Tensor, spec,
                k: int, counter_max: float,
                reset_value: float) -> torch.Tensor:
    """Group-sorted fused transform + group sum -> acc [G, B].

    ``values`` [S, P] rows in any order, ``order`` [S] int32 the stable
    group-sort permutation (None: the rows are in group order),
    ``gids`` [S] int32 in group order, ``spans`` [ceil(S/TILE_S),
    SPAN_MAX] the groups of each tile of the sorted order,
    ``group_start`` [G+1] each group's first sorted row."""
    g = spec.num_groups
    if values.device.type == "cpu":
        return _plain(values, order, gids, inv_dt, spec, k, counter_max,
                      reset_value)
    _check_cuda(values, gids, inv_dt, spec, k)
    s, p = values.shape
    dev = values.device
    _check_order(order, group_start, s, g, dev)
    if spans.shape != (-(-s // TILE_S), SPAN_MAX) \
            or spans.dtype != torch.int32 or not spans.is_contiguous() \
            or spans.device != dev:
        raise ValueError("spans must be a contiguous int32 [NT, SPAN_MAX] "
                         "tensor on the device of values")
    b = spec.num_buckets
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = _cuda_build.library().fused_warp_tiles(s)
    partials = torch.empty((tiles, SPAN_MAX, b), dtype=torch.float32,
                           device=dev)
    out = torch.empty((g, b), dtype=torch.float32, device=dev)
    ds_kind, rate_mode, square = _kernel_flags(spec)
    _launch("fused_span_reduce", dev, span_reduce,
            values.data_ptr(), 0 if order is None else order.data_ptr(),
            s, p, k, b, gids.data_ptr(), spans.data_ptr(),
            group_start.data_ptr(), g, inv_dt.data_ptr(), counter_max,
            reset_value, ds_kind, rate_mode, square, sms, dev.index,
            partials.data_ptr(), out.data_ptr())
    return out


span_reduce.launches = 0


def onehot_reduce(values: torch.Tensor, order: torch.Tensor | None,
                  gids: torch.Tensor, group_start: torch.Tensor,
                  inv_dt: torch.Tensor, spec, k: int, counter_max: float,
                  reset_value: float) -> torch.Tensor:
    """Fused transform + group sum over any number of groups per tile
    -> acc [G, B]. ``values`` [S, P] rows in any order, ``order`` [S]
    int32 the stable group-sort permutation (None: the rows are in
    group order), ``gids`` [S] int32 in group order, ``group_start``
    [G+1] each group's first sorted row."""
    g = spec.num_groups
    if values.device.type == "cpu":
        return _plain(values, order, gids, inv_dt, spec, k, counter_max,
                      reset_value)
    _check_cuda(values, gids, inv_dt, spec, k)
    s, p = values.shape
    dev = values.device
    _check_order(order, group_start, s, g, dev)
    b = spec.num_buckets
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = _cuda_build.library().fused_warp_tiles(s)
    partials = torch.empty((tiles, WARP_TILE, b), dtype=torch.float32,
                           device=dev)
    out = torch.empty((g, b), dtype=torch.float32, device=dev)
    ds_kind, rate_mode, square = _kernel_flags(spec)
    _launch("fused_onehot_reduce", dev, onehot_reduce,
            values.data_ptr(), 0 if order is None else order.data_ptr(),
            s, p, k, b, gids.data_ptr(), group_start.data_ptr(), g,
            inv_dt.data_ptr(), counter_max, reset_value, ds_kind,
            rate_mode, square, sms, dev.index, partials.data_ptr(),
            out.data_ptr())
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
        acc = span_reduce(batch.values, batch.order, batch.gids,
                          batch.spans, batch.group_start, batch.inv_dt,
                          spec, k, cm, rv)
    else:
        acc = onehot_reduce(batch.values, batch.order, batch.gids,
                            batch.group_start, batch.inv_dt, spec, k, cm,
                            rv)
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
