// Fused dense query pipeline for Hopper (sm_90a): downsample -> rate ->
// group reduce over complete regular-cadence series, in float32.
//
// Replaces the two Pallas TPU kernels of opentsdb_tpu/ops/pallas_fused.py:
//   span_reduce_kernel (+ span_combine_kernel)     <- _kernel_span (:270)
//   onehot_reduce_kernel (+ onehot_combine_kernel) <- _kernel      (:241)
// Both run the per-series transform of _tile_transform (:196) in the same
// op order as the plain PyTorch version in ops/fused.py.
//
// What bounds them: bytes. Each query reads the [S, P] value matrix once
// (S*P*4 bytes) plus S group ids (S*4), and does a handful of flops per
// value, far below the card's flop/byte balance. Both kernels read each
// value once and keep every intermediate (the open bucket, the previous
// bucket's value for the rate) in registers; one thread owns one series
// and walks its row left to right, so any P and k work with a fixed
// shared footprint. Neither uses an atomic: both are bitwise the same from
// launch to launch.
//
// Both kernels stream rows the same way (the ring machinery below): one
// persistent block of kBlock = 768 threads (24 warps) per SM. Each warp
// walks its own 32-row warp tiles (b*kBlockWarps + w, then every
// gridDim.x*kBlockWarps-th) through its own ring of kStages = 2 shared
// stages of [32, kChunk = 20] points, filled with cp.async (16-byte .cg
// copies when P % 4 == 0 and the base is 16-byte aligned, else 4-byte .ca
// copies; a warp tile's group ids ride along at its first chunk). Step
// n+1 is in flight while step n is computed; the warp syncs with
// __syncwarp only, so no warp waits on another between steps. Each
// thread reads its row as float4s; rows are kPitch floats apart, an odd
// number of float4s (20 = 5 x 4), so the 8 rows of a quarter warp (a
// 128-bit shared load is served a quarter warp at a time) start in 8
// different float4 bank groups: no conflicts, and every row start stays
// 16-byte aligned for the copies. The downsample step is a template on
// the kind, chosen once per step. Both read the rows through the stable
// group-sort order (below); what they differ in is what happens when a
// bucket finishes.
//
// span (G <= 1024, at most kSpanMax groups per kSpanTile = 128 rows of
// the stable group-sorted order): the rows are read through the group
// order, so the value matrix is never gathered. Warp tiles run over
// sorted positions; row r of a warp tile is values row order[row0 + r]
// (or row0 + r when the ids are already sorted). Lane r loads that index
// once per warp tile, one warp tile ahead, and each copy takes its row's
// base with a shuffle. Bytes: S*P*4 values + S*4 permutation + S*4
// sorted ids, each read once (248 MB at config 3: S = 1M, P = 60, B = 12,
// G = 100). The reads through the order stay coalesced enough: a row is
// 240 contiguous bytes, each copy instruction moves 16 bytes a lane with
// consecutive lanes on consecutive float4s of a row (about 6 rows of 80
// bytes per instruction), and the three column steps of one warp tile
// touch each row's 32-byte sectors once; a sector shared by two steps
// stays in L2 (50 MB) between them, microseconds apart. A warp tile
// (32 sorted rows, aligned inside a 128-row span tile) covers at most
// kSpanMax groups; each row's slot is its group's index in the tile's
// spans row (which rides in the ring beside the group ids). When a
// bucket finishes, the warp does one masked shuffle reduction per slot
// that the warp tile covers (1-2 at config 3) and lane 0 writes it to
// partials[warp tile, slot, b]: no block barrier, no atomics, so the
// result is bitwise the same from launch to launch. The partials keep
// the per-warp-tile shape [ceil(S/32), kSpanMax, B] (only the covered
// slots are written) rather than shrinking the span tile to 32 rows:
// the host layout, its eligibility (<= 8 groups per 128 sorted rows)
// and its spans stay as they are. span_combine then reduces each group
// over its warp tiles with a block per group and a fixed tree (threads
// over buckets x a power of two of tile lanes), in parallel and in a
// fixed order. Resources at config 3: value rings 2 x 768 x 20 x 4 =
// 122,880 B, id rings (32 group ids + 8 span ids per stage and warp) 2 x
// 24 x 40 x 4 = 7,680 B, 1/dt 48 B: 130,608 B, one block (24 warps) per
// SM. In flight per SM: one 32 x 80 B stage per warp, 61,440 B (3.35 TB/s
// x ~1 us / 132 SMs is about 25 KB). Partials: 31,250 x 8 x 12 x 4 B =
// 12 MB allocated, about 1.6 MB written and read back from L2.
//
// one-hot (G <= 4096, any spread of ids over the rows): the span
// kernel's scheme without its cap of kSpanMax groups per span tile. The
// rows are read through the same stable group order, so the rows of one
// group sit in adjacent lanes of a warp tile, which may cover up to 32
// groups. Each lane's run of equal group ids is found once per warp tile
// (__match_any_sync: a sorted tile's runs are contiguous lanes). When a
// bucket finishes, a segmented suffix scan by shuffles (5 steps, each
// lane adding the lane `off` above it while that lane is in its run)
// leaves each run's sum in its first lane, which writes it to
// partials[warp tile, lane, b]. onehot_combine then sums each group over
// its warp tiles (its first warp tile at the lane of its first row, every
// later one at lane 0) with a block per group and a fixed tree, as
// span_combine does. No float atomic anywhere: the order of every
// addition is fixed by the group ids alone, so the result is bitwise the
// same from launch to launch. Bytes as the span kernel's (S*P*4 values +
// S*4 permutation + S*4 sorted ids; 248 MB at config 3, G = 2000).
// Resources: value rings 122,880 B, id rings (32 group ids a stage and
// warp) 2 x 24 x 32 x 4 = 6,144 B, 1/dt 48 B: 129,072 B, one block (24
// warps) per SM. Partials: [ceil(S/32), 32, B] floats allocated (48 MB
// at config 3), of which only the runs' first lanes are written (about
// (S/32 + G) x B floats, 1.6 MB) and read back from L2.
//
// Plain C interface (loaded with ctypes); every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError().
// Host-side state: whether each kernel's shared-memory attribute is set,
// per device, set at its first launch there.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kSpanTile = 128;  // sorted rows per row of spans
constexpr int kSpanMax = 8;     // group slots per span tile
constexpr int kWarpTile = 32;   // rows per warp tile, one per lane
// series per block, columns per ring step, ring depth, row pitch
constexpr int kBlock = 768;
constexpr int kChunk = 20;
constexpr int kStages = 2;
// float4 row reads are conflict-free when the pitch is an odd number of
// float4s: pad an even chunk by one float4
constexpr int kPitch = kChunk / 4 % 2 ? kChunk : kChunk + 4;
constexpr int kBlockWarps = kBlock / 32;
// shared floats of the value rings
constexpr int kRingFloats = kStages * kBlock * kPitch;
// ints per ring stage of the ids: one-hot, a warp tile's (sorted) group
// ids; span, those and its span tile's kSpanMax slot ids
constexpr int kOhIds = kWarpTile;
constexpr int kSpanIds = kWarpTile + kSpanMax;
// shared bytes of the one-hot value and group-id rings; 1/dt follows
constexpr int kOhRingBytes =
    (kRingFloats + kStages * kBlockWarps * kOhIds) * (int)sizeof(float);
// shared bytes of the span value and id rings; 1/dt follows
constexpr int kSpanRingBytes =
    (kRingFloats + kStages * kBlockWarps * kSpanIds) * (int)sizeof(float);
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take
constexpr int kCombine = 1024;    // threads per span_combine block
constexpr int kOhCombine = 256;   // threads per onehot_combine block
constexpr int kMaxDevices = 64;
std::atomic<bool> g_onehot_smem_set[kMaxDevices];
std::atomic<bool> g_span_smem_set[kMaxDevices];

enum DsKind {
  kDsSum = 0, kDsAvg = 1, kDsFirst = 2, kDsLast = 3, kDsMin = 4,
  kDsMax = 5, kDsCount = 6
};
enum RateMode { kRateNone = 0, kRatePlain = 1, kRateCounter = 2 };

struct Transform {
  int P, k, B;
  int ds_kind, rate_mode, square;
  float inv_k, counter_max, reset_value;
  const float* inv_dt;
};

// One step of the downsample accumulator over the bucket's points;
// pos is the point's index inside its bucket.
__device__ __forceinline__ float ds_step(int kind, float acc, float x,
                                         int pos) {
  switch (kind) {
    case kDsSum:
    case kDsAvg: return pos == 0 ? x : acc + x;
    case kDsFirst: return pos == 0 ? x : acc;
    case kDsLast: return x;
    case kDsMin: return pos == 0 ? x : fminf(acc, x);
    case kDsMax: return pos == 0 ? x : fmaxf(acc, x);
    default: return acc;  // count: a constant, set when the bucket ends
  }
}

// The finished bucket b of one series: downsample value, then rate,
// then square. t_prev carries the previous bucket's downsample value.
__device__ __forceinline__ float bucket_value(const Transform& tf,
                                              float acc, float* t_prev,
                                              int b) {
  float t = acc;
  if (tf.ds_kind == kDsAvg) t = acc * tf.inv_k;
  else if (tf.ds_kind == kDsCount) t = (float)tf.k;
  if (tf.rate_mode != kRateNone) {
    const float prev = b == 0 ? t : *t_prev;
    float delta = t - prev;
    if (tf.rate_mode == kRateCounter && delta < 0.f)
      delta = tf.counter_max - prev + t;
    float r = delta * tf.inv_dt[b];
    if (tf.rate_mode == kRateCounter && tf.reset_value > 0.f &&
        r > tf.reset_value)
      r = 0.f;
    *t_prev = t;
    t = r;
  }
  if (tf.square) t = t * t;
  return t;
}

// cp.async helpers (sm_80+): 16-byte copies bypass L1 (.cg), 4-byte
// copies go through it (.ca, the only cache mode for sizes below 16).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- the ring machinery shared by both kernels ----------------------------

// One step of a warp's ring: columns [ci*kChunk, +kChunk) of the warp's
// jn-th warp tile (32 rows). A warp takes warp tiles first, first +
// stride, ...; its steps run through the chunks of one warp tile, then
// the next.
struct RingStep {
  int64_t row0;  // first row (sorted position, for span) of the warp tile
  int rows;      // rows of the warp tile inside S
  int ci, c0, cw;
};

__device__ __forceinline__ RingStep ring_step(int jn, int ci, int P,
                                              int64_t S, int64_t first,
                                              int64_t stride) {
  RingStep st;
  st.ci = ci;
  st.row0 = (first + jn * stride) * kWarpTile;
  st.rows = S - st.row0 < kWarpTile ? (int)(S - st.row0) : kWarpTile;
  st.c0 = ci * kChunk;
  st.cw = min(kChunk, P - st.c0);
  return st;
}

// The next step after (jn, ci) for nc chunks per row.
__device__ __forceinline__ void ring_next(int& jn, int& ci, int nc) {
  if (++ci == nc) {
    ci = 0;
    ++jn;
  }
}

// Where a warp tile's rows lie in values: row r of the warp tile at
// sorted position row0 starts at base(values, row0, P) + row(r) * P, and
// is values row
// order[row0 + r] (row0 + r when order is null). Lane r holds its row's
// index, loaded one warp tile ahead (prime loads the first, begin moves
// to the next and loads the one after), and row() fetches it with a
// shuffle, so all 32 lanes call it together.
struct RowsThroughOrder {
  const int* __restrict__ order;
  int idx, next;

  __device__ __forceinline__ int load(int64_t row0, int64_t S,
                                      int lane) const {
    if (row0 >= S) return 0;
    const int64_t p = row0 + lane < S ? row0 + lane : S - 1;
    return order != nullptr ? __ldg(order + p) : (int)p;
  }
  __device__ __forceinline__ void prime(int64_t row0, int64_t S,
                                        int lane) {
    next = load(row0, S, lane);
  }
  __device__ __forceinline__ void begin(int64_t row0, int64_t S,
                                        int64_t stride_rows, int lane) {
    idx = next;
    next = load(row0 + stride_rows, S, lane);
  }
  __device__ __forceinline__ const float* base(const float* values,
                                               int64_t, int) const {
    return values;
  }
  __device__ __forceinline__ int row(int r) const {
    return __shfl_sync(0xffffffffu, idx, r);
  }
};

// One lane's copies of a [rows, q] slab of W-byte items (W = 16: float4,
// W = 4: float) from src0 (the warp tile's rows at the step's first
// column), consecutive lanes on consecutive items of a row. row()
// shuffles, so every lane runs every pass. Called with the constant q of
// a whole chunk, the divisions become shifts.
template <int W, class Rows>
__device__ __forceinline__ void ring_copy(float* dst, const float* src0,
                                          const Rows& rows_of, int rows,
                                          int P, int q, int lane) {
  constexpr int kF = W / 4;  // floats per item
  const int n = rows * q;
  const int end = (n + 31) & ~31;
  for (int i = lane; i < end; i += 32) {
    const int r = i / q;
    const int c = (i - r * q) * kF;
    const float* src = src0 + (int64_t)rows_of.row(r) * P + c;
    if (i < n) {
      if (W == 16) cp_async16(dst + r * kPitch + c, src);
      else cp_async4(dst + r * kPitch + c, src);
    }
  }
}

// Issue one lane's share of the async copies of a warp step into the
// warp's ring stage `slot`: the [rows, cw] slab of values (row pitch
// kPitch) and, at a warp tile's first chunk, its group ids (n_ids ints a
// stage) and, for span, its span tile's slot ids after them. Rows past S
// are not copied (their lanes add nothing).
template <class Rows>
__device__ __forceinline__ void ring_issue(
    float* __restrict__ ring, int* __restrict__ gring, int n_ids,
    const float* __restrict__ values, const int* __restrict__ gids,
    const int* __restrict__ spans, int64_t S, int64_t stride_rows, int P,
    bool vec16, const RingStep& st, int slot, int lane, Rows& rows_of) {
  if (st.ci == 0) rows_of.begin(st.row0, S, stride_rows, lane);
  float* dst = ring + slot * (kWarpTile * kPitch);
  const float* src = rows_of.base(values, st.row0, P) + st.c0;
  const bool full = st.cw == kChunk;
  if (vec16) {  // P % 4 == 0 and a 16-byte aligned base: whole float4s
    if (full) ring_copy<16>(dst, src, rows_of, st.rows, P, kChunk / 4, lane);
    else ring_copy<16>(dst, src, rows_of, st.rows, P, st.cw / 4, lane);
  } else {
    if (full) ring_copy<4>(dst, src, rows_of, st.rows, P, kChunk, lane);
    else ring_copy<4>(dst, src, rows_of, st.rows, P, st.cw, lane);
  }
  if (st.ci == 0) {
    int* ids = gring + slot * n_ids;
    if (lane < st.rows) cp_async4(ids + lane, gids + st.row0 + lane);
    if (spans != nullptr && lane < kSpanMax)
      cp_async4(ids + kWarpTile + lane,
                spans + st.row0 / kSpanTile * kSpanMax + lane);
  }
}

// The per-row work of one step for the downsample kind KIND: walk the
// row's cw staged points left to right, finish each bucket (rate,
// square) and hand it to sink(t, b). Every lane of a warp takes the
// same path (all rows have P points and k per bucket).
template <int KIND, class Sink>
__device__ __forceinline__ void ring_walk(const float* row, int cw,
                                          const Transform& tf,
                                          const Sink& sink, float& acc,
                                          float& t_prev, int& pos, int& b) {
  for (int c = 0; c < cw; c += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(row + c);
    const float xs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j >= cw) break;
      acc = ds_step(KIND, acc, xs[j], pos);
      if (++pos < tf.k) continue;
      sink(bucket_value(tf, acc, &t_prev, b), b);
      pos = 0;
      ++b;
    }
  }
}

// Stream one warp's warp tiles (first, first + stride, ... below
// ceil(S/32)) through its ring: keep the next step's copies in flight
// while this step is walked. At each warp tile's first chunk the warp
// calls tile.begin(step, the tile's ids in the ring, lane), then hands
// every finished bucket to tile(t, b).
template <class Rows, class Tile>
__device__ __forceinline__ void ring_stream(
    float* __restrict__ ring, int* __restrict__ gring, int n_ids,
    const float* __restrict__ values, const int* __restrict__ gids,
    const int* __restrict__ spans, int64_t S, const Transform& tf,
    bool vec16, int64_t first, int64_t stride, int lane, Rows& rows_of,
    Tile& tile) {
  const int nc = (tf.P + kChunk - 1) / kChunk;
  const int64_t n_wt = (S + kWarpTile - 1) / kWarpTile;
  const int64_t my_wt = first < n_wt ? (n_wt - 1 - first) / stride + 1 : 0;
  const int steps = (int)(my_wt * nc);  // <= S * P / (32 * kChunk)
  const int64_t stride_rows = stride * kWarpTile;
  rows_of.prime(first * kWarpTile, S, lane);
  // prologue: steps 0 .. kStages-2 in flight; one commit group per step,
  // empty past the end, so wait_group counts stay uniform
  int ijn = 0, ici = 0;  // the next step to issue
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < steps) {
      ring_issue(ring, gring, n_ids, values, gids, spans, S, stride_rows,
                 tf.P, vec16, ring_step(ijn, ici, tf.P, S, first, stride),
                 n, lane, rows_of);
      ring_next(ijn, ici, nc);
    }
    cp_async_commit();
  }
  float acc = 0.f, t_prev = 0.f;
  int pos = 0, b = 0;
  int cjn = 0, cci = 0;  // the step to compute
  for (int n = 0; n < steps; ++n) {
    // this lane's copies of step n have landed; __syncwarp makes the
    // other lanes' visible and frees the stage step n-1 used
    cp_async_wait<kStages - 2>();
    __syncwarp();
    const int nn = n + kStages - 1;
    if (nn < steps) {
      ring_issue(ring, gring, n_ids, values, gids, spans, S, stride_rows,
                 tf.P, vec16, ring_step(ijn, ici, tf.P, S, first, stride),
                 nn % kStages, lane, rows_of);
      ring_next(ijn, ici, nc);
    }
    cp_async_commit();
    const RingStep st = ring_step(cjn, cci, tf.P, S, first, stride);
    ring_next(cjn, cci, nc);
    const int slot = n % kStages;
    if (st.ci == 0) {
      tile.begin(st, gring + slot * n_ids, lane);
      acc = 0.f;
      t_prev = 0.f;
      pos = 0;
      b = 0;
    }
    const float* row = ring + (slot * kWarpTile + lane) * kPitch;
    switch (tf.ds_kind) {  // uniform: one instance of the walk per kind
      case kDsFirst:
        ring_walk<kDsFirst>(row, st.cw, tf, tile, acc, t_prev, pos, b);
        break;
      case kDsLast:
        ring_walk<kDsLast>(row, st.cw, tf, tile, acc, t_prev, pos, b);
        break;
      case kDsMin:
        ring_walk<kDsMin>(row, st.cw, tf, tile, acc, t_prev, pos, b);
        break;
      case kDsMax:
        ring_walk<kDsMax>(row, st.cw, tf, tile, acc, t_prev, pos, b);
        break;
      case kDsCount:
        ring_walk<kDsCount>(row, st.cw, tf, tile, acc, t_prev, pos, b);
        break;
      default:  // sum and avg add the same way
        ring_walk<kDsSum>(row, st.cw, tf, tile, acc, t_prev, pos, b);
    }
  }
  cp_async_wait<0>();
}

// -- span: group-sorted rows read through the order -----------------------

// A span warp tile: each lane's slot (its group's index in the span
// tile's spans row; -1 for rows past S), the slots the warp tile covers
// ([s_lo, s_hi]: its rows are sorted, so they cover a run of slots) and
// its row of partials. A finished bucket is reduced per covered slot
// with a fixed shuffle tree; lane 0 writes the sum.
struct SpanTile {
  float* __restrict__ partials;
  int B;
  float* part;
  int my_slot, s_lo, s_hi, lane;

  __device__ __forceinline__ void begin(const RingStep& st, const int* ids,
                                        int ln) {
    lane = ln;
    const int gid = lane < st.rows ? ids[lane] : -1;
    my_slot = -1;
#pragma unroll
    for (int j = 0; j < kSpanMax; ++j)
      if (ids[kWarpTile + j] == gid) my_slot = j;  // sentinel G: no row
    s_lo = __shfl_sync(0xffffffffu, my_slot, 0);
    s_hi = __shfl_sync(0xffffffffu, my_slot, st.rows - 1);
    part = partials + st.row0 / kWarpTile * kSpanMax * B;
  }
  __device__ __forceinline__ void operator()(float t, int b) const {
    for (int j = s_lo; j <= s_hi; ++j) {
      float x = my_slot == j ? t : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) part[j * B + b] = x;
    }
  }
};

// Persistent span reduce (see the note at the top): each warp streams
// its warp tiles of the sorted order through its ring, reading each row
// through order, and writes per-slot bucket sums to
// partials[ceil(S/32), kSpanMax, B].
__global__ void __launch_bounds__(kBlock, 1) span_reduce_kernel(
    const float* __restrict__ values, const int* __restrict__ order,
    int64_t S, Transform tf, const int* __restrict__ gids,
    const int* __restrict__ spans, int inv_shared, int vec16,
    float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ring = smem + warp * (kStages * kWarpTile * kPitch);
  int* gring = (int*)(smem + kRingFloats) + warp * (kStages * kSpanIds);
  Transform tfs = tf;
  if (inv_shared) {  // 1/dt, read once per bucket by every row
    float* sinv = smem + kSpanRingBytes / (int)sizeof(float);
    for (int i = tid; i < tf.B; i += kBlock) sinv[i] = tf.inv_dt[i];
    tfs.inv_dt = sinv;
  }
  __syncthreads();
  RowsThroughOrder rows_of{order, 0, 0};
  SpanTile tile{partials, tf.B, nullptr, -1, 0, -1, lane};
  ring_stream(ring, gring, kSpanIds, values, gids, spans, S, tfs,
              vec16 != 0, (int64_t)blockIdx.x * kBlockWarps + warp,
              (int64_t)gridDim.x * kBlockWarps, lane, rows_of, tile);
}

// out[g, b] = the sum over the warp tiles covering group g (its sorted
// rows group_start[g] .. group_start[g+1]) of the tile's partial in g's
// slot. One block per group; threads are (tile lane, bucket) pairs, each
// summing every lanes-th tile of one bucket, then a fixed tree over the
// tile lanes: the same order in every launch.
__global__ void __launch_bounds__(kCombine, 1) span_combine_kernel(
    const float* __restrict__ partials, const int* __restrict__ spans,
    const int* __restrict__ group_start, int B, float* __restrict__ out) {
  __shared__ float red[kCombine];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = group_start[g];
  const int hi = group_start[g + 1];
  const int t0 = lo / kWarpTile;  // S < 2^31: warp tiles fit an int
  const int t1 = hi > lo ? (hi - 1) / kWarpTile : t0 - 1;
  const int nb = B < kCombine ? B : kCombine;  // buckets per pass
  int lanes = 1;                               // a power of two
  while (lanes * 2 * nb <= kCombine) lanes *= 2;
  const int bi = tid % nb;
  const int tl = tid / nb;
  for (int b0 = 0; b0 < B; b0 += nb) {
    const int b = b0 + bi;
    if (tl < lanes) {
      float s = 0.f;
      if (b < B) {
        for (int t = t0 + tl; t <= t1; t += lanes) {
          const int* sp = spans + t / (kSpanTile / kWarpTile) * kSpanMax;
          int j = 0;
          while (j < kSpanMax - 1 && sp[j] != g) ++j;
          s += partials[((int64_t)t * kSpanMax + j) * B + b];
        }
      }
      red[tl * nb + bi] = s;
    }
    __syncthreads();
    for (int h = lanes / 2; h > 0; h >>= 1) {
      if (tl < h) red[tl * nb + bi] += red[(tl + h) * nb + bi];
      __syncthreads();
    }
    if (tl == 0 && b < B) out[(int64_t)g * B + b] = red[bi];
    __syncthreads();  // red is reused by the next pass
  }
}

// -- one-hot: any groups per warp tile, reduced by runs --------------------

// A one-hot warp tile: the lanes of one group form a run (the tile's rows
// are group-sorted). A finished bucket is reduced per run with a
// segmented suffix scan in a fixed order of shuffles; the run's first
// lane holds the run's sum and writes it to its own slot of the tile's
// partials. Lanes past S carry the id -1 and write nothing.
struct RunTile {
  float* __restrict__ partials;
  int B;
  float* part;
  int run_end, lane;
  bool head;

  __device__ __forceinline__ void begin(const RingStep& st, const int* ids,
                                        int ln) {
    lane = ln;
    const int gid = lane < st.rows ? ids[lane] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, gid);
    run_end = 31 - __clz(peers);
    head = gid >= 0 && __ffs(peers) - 1 == lane;
    part = partials + st.row0 * B;  // row0 / kWarpTile tiles of 32 x B
  }
  __device__ __forceinline__ void operator()(float t, int b) const {
    float x = t;
#pragma unroll
    for (int off = 1; off < kWarpTile; off <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, x, off);
      if (lane + off <= run_end) x += y;
    }
    if (head) part[lane * B + b] = x;
  }
};

// Persistent one-hot reduce (see the note at the top): each warp streams
// its warp tiles of the group-sorted order through its ring, reading each
// row through order, and writes each run's bucket sums to
// partials[ceil(S/32), 32, B] at the run's first lane.
__global__ void __launch_bounds__(kBlock, 1) onehot_reduce_kernel(
    const float* __restrict__ values, const int* __restrict__ order,
    int64_t S, Transform tf, const int* __restrict__ gids, int inv_shared,
    int vec16, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ring = smem + warp * (kStages * kWarpTile * kPitch);
  int* gring = (int*)(smem + kRingFloats) + warp * (kStages * kOhIds);
  Transform tfs = tf;
  if (inv_shared) {  // 1/dt, read once per bucket by every row
    float* sinv = smem + kOhRingBytes / (int)sizeof(float);
    for (int i = tid; i < tf.B; i += kBlock) sinv[i] = tf.inv_dt[i];
    tfs.inv_dt = sinv;
  }
  __syncthreads();
  RowsThroughOrder rows_of{order, 0, 0};
  RunTile tile{partials, tf.B, nullptr, -1, lane, false};
  ring_stream(ring, gring, kOhIds, values, gids, nullptr, S, tfs,
              vec16 != 0, (int64_t)blockIdx.x * kBlockWarps + warp,
              (int64_t)gridDim.x * kBlockWarps, lane, rows_of, tile);
}

// out[g, b] = the sum over the warp tiles covering group g (its sorted
// rows group_start[g] .. group_start[g+1]) of the tile's partial at the
// lane of g's first row there: lo % 32 in its first tile, 0 in every
// later one. One block per group; threads are (tile lane, bucket) pairs,
// each summing every lanes-th tile of one bucket, then a fixed tree over
// the tile lanes: the same order in every launch.
__global__ void __launch_bounds__(kOhCombine) onehot_combine_kernel(
    const float* __restrict__ partials, const int* __restrict__ group_start,
    int B, float* __restrict__ out) {
  __shared__ float red[kOhCombine];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = group_start[g];
  const int hi = group_start[g + 1];
  const int t0 = lo / kWarpTile;  // S < 2^31: warp tiles fit an int
  const int t1 = hi > lo ? (hi - 1) / kWarpTile : t0 - 1;
  const int nb = B < kOhCombine ? B : kOhCombine;  // buckets per pass
  int lanes = 1;                                   // a power of two
  while (lanes * 2 * nb <= kOhCombine) lanes *= 2;
  const int bi = tid % nb;
  const int tl = tid / nb;
  for (int b0 = 0; b0 < B; b0 += nb) {
    const int b = b0 + bi;
    if (tl < lanes) {
      float s = 0.f;
      if (b < B) {
        for (int t = t0 + tl; t <= t1; t += lanes) {
          const int slot = t == t0 ? lo - t0 * kWarpTile : 0;
          s += partials[((int64_t)t * kWarpTile + slot) * B + b];
        }
      }
      red[tl * nb + bi] = s;
    }
    __syncthreads();
    for (int h = lanes / 2; h > 0; h >>= 1) {
      if (tl < h) red[tl * nb + bi] += red[(tl + h) * nb + bi];
      __syncthreads();
    }
    if (tl == 0 && b < B) out[(int64_t)g * B + b] = red[bi];
    __syncthreads();  // red is reused by the next pass
  }
}

Transform make_transform(int P, int k, int B, const float* inv_dt,
                         float counter_max, float reset_value, int ds_kind,
                         int rate_mode, int square) {
  Transform tf;
  tf.P = P;
  tf.k = k;
  tf.B = B;
  tf.ds_kind = ds_kind;
  tf.rate_mode = rate_mode;
  tf.square = square;
  tf.inv_k = (float)(1.0 / (double)k);
  tf.counter_max = counter_max;
  tf.reset_value = reset_value;
  tf.inv_dt = inv_dt;
  return tf;
}

// Let `kernel` take up to kMaxSmem of dynamic shared memory on `device`,
// once per device.
template <class K>
cudaError_t allow_smem(K kernel, std::atomic<bool>* set, int device) {
  if (set[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) set[device].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

const char* fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_span_reduce(const float* values, const int* order, long long S,
                      int P, int k, int B, const int* gids,
                      const int* spans, const int* group_start, int G,
                      const float* inv_dt, float counter_max,
                      float reset_value, int ds_kind, int rate_mode,
                      int square, int sms, int device, float* partials,
                      float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || B < 1) return (int)cudaGetLastError();
  if (S > 0) {
    if (sms < 1 || device < 0 || device >= kMaxDevices)
      return (int)cudaErrorInvalidValue;
    // enough blocks for every warp to hold a warp tile, at most one per
    // SM; 1/dt in shared memory when it fits beside the rings
    const long long per_block = (long long)kBlockWarps * kWarpTile;
    const long long need = (S + per_block - 1) / per_block;
    const int blocks = (int)(need < sms ? need : sms);
    const int inv_shared = 4LL * B <= kMaxSmem - kSpanRingBytes;
    const int smem = kSpanRingBytes + (inv_shared ? 4 * B : 0);
    const cudaError_t err =
        allow_smem(span_reduce_kernel, g_span_smem_set, device);
    if (err != cudaSuccess) return (int)err;
    const Transform tf = make_transform(P, k, B, inv_dt, counter_max,
                                        reset_value, ds_kind, rate_mode,
                                        square);
    const int vec16 = P % 4 == 0 && (uintptr_t)values % 16 == 0;
    span_reduce_kernel<<<blocks, kBlock, smem, st>>>(
        values, order, S, tf, gids, spans, inv_shared, vec16, partials);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return (int)launch;
  }
  // with no rows every group is empty: out is all zeros
  span_combine_kernel<<<G, kCombine, 0, st>>>(partials, spans, group_start,
                                              B, out);
  return (int)cudaGetLastError();
}

// Warp tiles of the partials of either kernel: the wrapper allocates
// partials[tiles, kSpanMax, B] for fused_span_reduce, or
// partials[tiles, 32, B] for fused_onehot_reduce, with the same S.
int fused_warp_tiles(long long S) {
  return (int)((S + kWarpTile - 1) / kWarpTile);
}

// Series per block (one per thread).
int fused_onehot_tile() { return kBlock; }

int fused_onehot_reduce(const float* values, const int* order, long long S,
                        int P, int k, int B, const int* gids,
                        const int* group_start, int G, const float* inv_dt,
                        float counter_max, float reset_value, int ds_kind,
                        int rate_mode, int square, int sms, int device,
                        float* partials, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || B < 1) return (int)cudaGetLastError();
  if (S > 0) {
    if (sms < 1 || device < 0 || device >= kMaxDevices)
      return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)kBlockWarps * kWarpTile;
    const long long need = (S + per_block - 1) / per_block;
    const int blocks = (int)(need < sms ? need : sms);
    const int inv_shared = 4LL * B <= kMaxSmem - kOhRingBytes;
    const int smem = kOhRingBytes + (inv_shared ? 4 * B : 0);
    const cudaError_t err =
        allow_smem(onehot_reduce_kernel, g_onehot_smem_set, device);
    if (err != cudaSuccess) return (int)err;
    const Transform tf = make_transform(P, k, B, inv_dt, counter_max,
                                        reset_value, ds_kind, rate_mode,
                                        square);
    const int vec16 = P % 4 == 0 && (uintptr_t)values % 16 == 0;
    onehot_reduce_kernel<<<blocks, kBlock, smem, st>>>(
        values, order, S, tf, gids, inv_shared, vec16, partials);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return (int)launch;
  }
  // with no rows every group is empty: out is all zeros
  onehot_combine_kernel<<<G, kOhCombine, 0, st>>>(partials, group_start, B,
                                                  out);
  return (int)cudaGetLastError();
}

}  // extern "C"
