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
// bucket's value for the rate, the group sums) in registers and shared
// memory; one thread owns one series and walks its row left to right, so
// any P and k work with a fixed shared footprint.
//
// span (group-sorted rows, at most kSpanMax groups per tile): a block
// per tile of kTile series stages [kTile, kChunk] slabs with coalesced
// loads; each finished bucket is reduced per group slot with warp
// shuffles, the tile partials go to global memory, and span_combine sums
// them in tile order (deterministic).
//
// one-hot (unsorted group ids, G <= 4096): the accumulator, [G, B] or a
// chunk of it, lives in shared memory (96,000 B at config 3), so only one
// block fits an SM, and the loads must be kept in flight by that block
// itself. What then limits it is the latency of each thread's serial
// walk of its row (shared read, downsample step, a bucket every k points
// ending in a shared-atomic loop): on an H100 SXM its time fell with the
// number of warps per SM, not with the bytes in flight. So the design
// buys warps and takes block barriers out of the loop:
//   - one persistent block of kOhTile = 768 threads (24 warps) per SM.
//     Each warp walks its own 32-row warp tiles (b*kOhWarps + w, then
//     every gridDim.x*kOhWarps-th) through its own ring of kOhStages = 2
//     shared stages of [32, kOhChunk = 20] points, filled with cp.async
//     (16-byte .cg copies when P % 4 == 0 and the base is 16-byte
//     aligned, else 4-byte .ca copies; a warp tile's group ids ride along
//     at its first chunk). Step n+1 is in flight while step n is
//     computed; the warp syncs with __syncwarp only, so no warp waits on
//     another between steps;
//   - each thread reads its row as float4s; rows are kOhPitch floats
//     apart, an odd number of float4s (20 = 5 x 4), so the 8 rows of a
//     quarter warp (a 128-bit shared load is served a quarter warp at a
//     time) start in 8 different float4 bank groups: no conflicts, and
//     every row start stays 16-byte aligned for the copies;
//   - the downsample step is a template on the kind, chosen once per
//     step, and 1/dt is read from a shared copy;
//   - shared float atomics into a [g_chunk, b_chunk] chunk of [G, B]
//     (onehot_plan): as many whole groups as fit beside the rings, or,
//     when one group's B buckets do not fit, one group and as many
//     buckets as fit (1/dt then stays in global memory). Each chunk's
//     rows are cut into `slices` row slices, one block each; a block's
//     partial of a chunk goes to partials[slice, chunk cells] (no global
//     atomics, no memset) and onehot_combine sums the slices in order
//     into out. The partials hold `slices` copies of [G, B], and slices
//     shrink as chunks grow, so they stay near SMs x the accumulator.
// Resources at config 3 (S = 1M, P = 60, B = 12, G = 2000): value rings
// 2 x 768 x 20 x 4 = 122,880 B, group-id rings 2 x 768 x 4 = 6,144 B,
// 1/dt 48 B, accumulator 2000 x 12 x 4 = 96,000 B: 225,072 B of the
// 232,448 B a block may take; one chunk, one block (24 warps) per SM,
// 132 slices. In flight per SM: one 32 x 80 B stage per warp, 61,440 B
// (3.35 TB/s x ~1 us / 132 SMs is about 25 KB). Partials: 132 x 24,000
// x 4 B = 12.7 MB, read once from L2.
//
// Plain C interface (loaded with ctypes); every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError().
// Host-side state: whether the one-hot kernel's shared-memory attribute
// is set, per device, set at its first launch there.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 128;   // series per block, one per thread
constexpr int kChunk = 32;   // points per row staged per step
constexpr int kSpanMax = 8;  // group slots per span tile
constexpr int kWarps = kTile / 32;
// one-hot: series per block, columns per ring step, ring depth, row pitch
constexpr int kOhTile = 768;
constexpr int kOhChunk = 20;
constexpr int kOhStages = 2;
// float4 row reads are conflict-free when the pitch is an odd number of
// float4s: pad an even chunk by one float4
constexpr int kOhPitch = kOhChunk / 4 % 2 ? kOhChunk : kOhChunk + 4;
constexpr int kOhWarps = kOhTile / 32;
// shared bytes of the value and group-id rings; the accumulator follows
constexpr int kOhRingBytes =
    kOhStages * kOhTile * (kOhPitch + 1) * (int)sizeof(float);
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take
constexpr int kMaxDevices = 64;
std::atomic<bool> g_onehot_smem_set[kMaxDevices];

// The one-hot launch plan (see the note at the top): the accumulator's
// chunk of [G, B], whether 1/dt is in shared memory, the row slices per
// chunk, the blocks and their dynamic shared bytes.
struct OhPlan {
  int g_chunk, b_chunk, inv_shared, slices, blocks;
  long long n_chunks, smem;
};

OhPlan onehot_plan(long long S, int B, int G, int sms) {
  OhPlan p{1, 1, 0, 1, 0, 0, kOhRingBytes};
  if (B < 1 || G < 1) return p;
  const long long avail = (kMaxSmem - kOhRingBytes) / 4;  // floats
  p.inv_shared = 2LL * B <= avail;
  const long long acc = avail - (p.inv_shared ? B : 0);
  p.b_chunk = acc >= B ? B : (int)acc;
  p.g_chunk = acc >= B ? (int)(acc / B < G ? acc / B : G) : 1;
  p.n_chunks = (long long)((G + p.g_chunk - 1) / p.g_chunk) *
               ((B + p.b_chunk - 1) / p.b_chunk);
  const long long tiles = (S + kOhTile - 1) / kOhTile;
  const long long per_chunk = sms / p.n_chunks;
  p.slices = (int)(per_chunk < tiles ? per_chunk : tiles);
  if (p.slices < 1) p.slices = 1;
  const long long work = p.slices * p.n_chunks;
  p.blocks = (int)(work < sms ? work : sms);
  p.smem = kOhRingBytes +
           4LL * ((p.inv_shared ? B : 0) + (long long)p.g_chunk * p.b_chunk);
  return p;
}

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

// Stage columns [c0, c0 + cw) of rows [row0, row0 + kTile) into shared
// memory; rows past S read as 0.
__device__ __forceinline__ void stage_chunk(
    float (*stage)[kChunk + 1], const float* __restrict__ values,
    int64_t S, int P, int64_t row0, int c0, int cw) {
  for (int i = threadIdx.x; i < kTile * cw; i += kTile) {
    const int r = i / cw;
    const int c = i - r * cw;
    const int64_t row = row0 + r;
    stage[r][c] = row < S ? values[row * P + c0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kTile) span_reduce_kernel(
    const float* __restrict__ values, int64_t S, Transform tf,
    const int* __restrict__ gids, const int* __restrict__ spans, int G,
    float* __restrict__ partials) {
  __shared__ float stage[kTile][kChunk + 1];
  __shared__ float warp_part[kWarps][kSpanMax];
  __shared__ int slot_gid[kSpanMax];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t row0 = tile * kTile;
  const int64_t row = row0 + tid;
  if (tid < kSpanMax) slot_gid[tid] = spans[tile * kSpanMax + tid];
  __syncthreads();
  // slots are filled in order; the sentinel G marks the unused tail
  int n_slots = 0;
  int my_slot = -1;
  const int my_gid = row < S ? gids[row] : -1;
  for (int j = 0; j < kSpanMax; ++j) {
    if (slot_gid[j] < G) n_slots = j + 1;
    if (slot_gid[j] == my_gid) my_slot = j;
  }
  float* tile_part = partials + tile * kSpanMax * tf.B;
  float acc = 0.f, t_prev = 0.f;
  int pos = 0, b = 0;
  for (int c0 = 0; c0 < tf.P; c0 += kChunk) {
    const int cw = min(kChunk, tf.P - c0);
    __syncthreads();  // the previous slab is fully consumed
    stage_chunk(stage, values, S, tf.P, row0, c0, cw);
    __syncthreads();
    for (int c = 0; c < cw; ++c) {
      acc = ds_step(tf.ds_kind, acc, stage[tid][c], pos);
      if (++pos < tf.k) continue;
      // bucket b is complete in every row at once (uniform branch)
      const float t = bucket_value(tf, acc, &t_prev, b);
      for (int j = 0; j < n_slots; ++j) {
        float x = my_slot == j ? t : 0.f;
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) warp_part[warp][j] = x;
      }
      __syncthreads();
      if (tid < n_slots) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += warp_part[w][tid];
        tile_part[tid * tf.B + b] = s;
      }
      __syncthreads();  // warp_part is reused by the next bucket
      pos = 0;
      ++b;
    }
  }
}

// out[g, b] = sum over the tiles covering group g, in tile order, of the
// slot partial whose span id is g.
__global__ void span_combine_kernel(const float* __restrict__ partials,
                                    const int* __restrict__ spans,
                                    const int* __restrict__ group_start,
                                    int G, int B, float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)G * B) return;
  const int g = (int)(idx / B);
  const int b = (int)(idx - (int64_t)g * B);
  const int lo = group_start[g];
  const int hi = group_start[g + 1];
  float s = 0.f;
  if (hi > lo) {
    for (int64_t t = lo / kTile; t <= (hi - 1) / kTile; ++t)
      for (int j = 0; j < kSpanMax; ++j)
        if (spans[t * kSpanMax + j] == g)
          s += partials[(t * kSpanMax + j) * B + b];
  }
  out[idx] = s;
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

// One step of a warp's ring: columns [ci*kOhChunk, +kOhChunk) of the
// warp's jn-th warp tile (32 rows). Warp w of block b takes warp tiles
// b*kOhWarps + w, then every gridDim.x*kOhWarps-th after it; a warp's
// steps run through the chunks of one warp tile, then the next.
struct OhStep {
  int64_t row0;  // first row of the warp tile
  int rows;      // rows of the warp tile inside S
  int ci, c0, cw;
};

__device__ __forceinline__ OhStep oh_step(int jn, int ci, int P, int64_t S,
                                          int64_t first, int64_t stride) {
  OhStep st;
  st.ci = ci;
  st.row0 = (first + jn * stride) * 32;
  st.rows = S - st.row0 < 32 ? (int)(S - st.row0) : 32;
  st.c0 = ci * kOhChunk;
  st.cw = min(kOhChunk, P - st.c0);
  return st;
}

// The next step after (jn, ci) for nc chunks per row.
__device__ __forceinline__ void oh_next(int& jn, int& ci, int nc) {
  if (++ci == nc) {
    ci = 0;
    ++jn;
  }
}

// One lane's copies of a [rows, q] slab of W-byte items (W = 16: float4,
// W = 4: float), consecutive lanes on consecutive items of a row. Called
// with the constant q of a whole chunk, the divisions become shifts.
template <int W>
__device__ __forceinline__ void oh_copy(float* dst, const float* src,
                                        int rows, int P, int q, int lane) {
  constexpr int kF = W / 4;  // floats per item
  for (int i = lane; i < rows * q; i += 32) {
    const int r = i / q;
    const int c = (i - r * q) * kF;
    if (W == 16)
      cp_async16(dst + r * kOhPitch + c, src + (int64_t)r * P + c);
    else
      cp_async4(dst + r * kOhPitch + c, src + (int64_t)r * P + c);
  }
}

// Issue one lane's share of the async copies of a warp step into the
// warp's ring stage `slot`: the [rows, cw] slab of values (row pitch
// kOhPitch) and, at a warp tile's first chunk, its group ids. Rows past
// S are not copied (their lanes add nothing).
__device__ __forceinline__ void oh_issue(
    float* __restrict__ ring, int* __restrict__ gring,
    const float* __restrict__ values, const int* __restrict__ gids,
    int P, bool vec16, const OhStep& st, int slot, int lane) {
  float* dst = ring + slot * (32 * kOhPitch);
  const float* src = values + st.row0 * P + st.c0;
  const bool full = st.cw == kOhChunk;
  if (vec16) {  // P % 4 == 0 and a 16-byte aligned base: whole float4s
    if (full) oh_copy<16>(dst, src, st.rows, P, kOhChunk / 4, lane);
    else oh_copy<16>(dst, src, st.rows, P, st.cw / 4, lane);
  } else {
    if (full) oh_copy<4>(dst, src, st.rows, P, kOhChunk, lane);
    else oh_copy<4>(dst, src, st.rows, P, st.cw, lane);
  }
  if (st.ci == 0 && lane < st.rows)
    cp_async4(gring + slot * 32 + lane, gids + st.row0 + lane);
}

// The per-row work of one step for the downsample kind KIND: walk the
// row's cw staged points left to right, finish each bucket (rate,
// square) and add buckets [b0, b0 + bw) to the row's group cell (cell:
// the group's row of the accumulator, or null for a row outside this
// chunk's groups).
template <int KIND>
__device__ __forceinline__ void oh_walk(const float* row, int cw,
                                        const Transform& tf, float* cell,
                                        int b0, int bw, float& acc,
                                        float& t_prev, int& pos, int& b) {
  for (int c = 0; c < cw; c += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(row + c);
    const float xs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j >= cw) break;
      acc = ds_step(KIND, acc, xs[j], pos);
      if (++pos < tf.k) continue;
      const float t = bucket_value(tf, acc, &t_prev, b);
      if (cell != nullptr && (unsigned)(b - b0) < (unsigned)bw)
        atomicAdd(cell + (b - b0), t);
      pos = 0;
      ++b;
    }
  }
}

// Persistent one-hot group reduce (see the note at the top). Each block
// takes work items (chunk, slice) in grid stride; for one item, each
// warp walks its own warp tiles of the slice through its own cp.async
// ring, lanes add their rows' buckets into the block's shared
// [g_chunk, b_chunk] accumulator, and the block writes it to the
// chunk's cells of partials[slice].
__global__ void __launch_bounds__(kOhTile, 1) onehot_reduce_kernel(
    const float* __restrict__ values, int64_t S, Transform tf,
    const int* __restrict__ gids, int G, OhPlan plan, int vec16,
    float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ring = smem + warp * (kOhStages * 32 * kOhPitch);  // this warp's
  int* gring = (int*)(smem + kOhStages * kOhTile * kOhPitch) +
               warp * (kOhStages * 32);
  // then, if it fits, 1/dt per bucket (read once per bucket by every
  // row), and the [g_chunk][b_chunk] accumulator
  float* sinv = smem + kOhStages * kOhTile * (kOhPitch + 1);
  float* sacc = sinv + (plan.inv_shared ? tf.B : 0);
  Transform tfs = tf;
  if (plan.inv_shared) {
    tfs.inv_dt = sinv;
    for (int i = tid; i < tf.B; i += kOhTile) sinv[i] = tf.inv_dt[i];
  }
  const int nc = (tf.P + kOhChunk - 1) / kOhChunk;
  const int64_t n_wt = (S + 31) / 32;
  const int n_bc = (tf.B + plan.b_chunk - 1) / plan.b_chunk;
  const int64_t n_work = plan.n_chunks * plan.slices;
  for (int64_t w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int slice = (int)(w % plan.slices);
    const int chunk = (int)(w / plan.slices);
    const int g0 = chunk / n_bc * plan.g_chunk;
    const int b0 = chunk % n_bc * plan.b_chunk;
    const int gw = min(plan.g_chunk, G - g0);
    const int bw = min(plan.b_chunk, tf.B - b0);
    const int64_t first = (int64_t)slice * kOhWarps + warp;
    const int64_t stride = (int64_t)plan.slices * kOhWarps;
    const int64_t my_wt =
        first < n_wt ? (n_wt - 1 - first) / stride + 1 : 0;
    const int steps = (int)(my_wt * nc);  // <= S * P / (32 * kOhChunk)
    for (int i = tid; i < gw * bw; i += kOhTile) sacc[i] = 0.f;
    __syncthreads();
    // prologue: steps 0 .. kOhStages-2 in flight; one commit group per
    // step, empty past the end, so wait_group counts stay uniform
    int ijn = 0, ici = 0;  // the next step to issue
    for (int n = 0; n < kOhStages - 1; ++n) {
      if (n < steps) {
        oh_issue(ring, gring, values, gids, tf.P, vec16,
                 oh_step(ijn, ici, tf.P, S, first, stride), n, lane);
        oh_next(ijn, ici, nc);
      }
      cp_async_commit();
    }
    float acc = 0.f, t_prev = 0.f;
    int pos = 0, b = 0, g = -1;
    int cjn = 0, cci = 0;  // the step to compute
    for (int n = 0; n < steps; ++n) {
      // this lane's copies of step n have landed; __syncwarp makes the
      // other lanes' visible and frees the stage step n-1 used
      cp_async_wait<kOhStages - 2>();
      __syncwarp();
      const int nn = n + kOhStages - 1;
      if (nn < steps) {
        oh_issue(ring, gring, values, gids, tf.P, vec16,
                 oh_step(ijn, ici, tf.P, S, first, stride), nn % kOhStages,
                 lane);
        oh_next(ijn, ici, nc);
      }
      cp_async_commit();
      const OhStep st = oh_step(cjn, cci, tf.P, S, first, stride);
      oh_next(cjn, cci, nc);
      const int slot = n % kOhStages;
      if (st.ci == 0) {
        g = lane < st.rows ? gring[slot * 32 + lane] - g0 : -1;
        acc = 0.f;
        t_prev = 0.f;
        pos = 0;
        b = 0;
      }
      float* cell = g >= 0 && g < gw ? sacc + g * bw : nullptr;
      const float* row = ring + (slot * 32 + lane) * kOhPitch;
      switch (tf.ds_kind) {  // uniform: one instance of the walk per kind
        case kDsFirst:
          oh_walk<kDsFirst>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                            pos, b);
          break;
        case kDsLast:
          oh_walk<kDsLast>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                           pos, b);
          break;
        case kDsMin:
          oh_walk<kDsMin>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                          pos, b);
          break;
        case kDsMax:
          oh_walk<kDsMax>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                          pos, b);
          break;
        case kDsCount:
          oh_walk<kDsCount>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                            pos, b);
          break;
        default:  // sum and avg add the same way
          oh_walk<kDsSum>(row, st.cw, tfs, cell, b0, bw, acc, t_prev,
                          pos, b);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* part = partials + ((int64_t)slice * G + g0) * tf.B + b0;
    for (int i = tid; i < gw * bw; i += kOhTile) {
      const int gi = i / bw;
      part[(int64_t)gi * tf.B + (i - gi * bw)] = sacc[i];
    }
    __syncthreads();  // the rings and sacc are reused by the next item
  }
}

// out[i] = sum over slices, in slice order, of partials[slice, i].
__global__ void onehot_combine_kernel(const float* __restrict__ partials,
                                      int n_slices, int64_t cells,
                                      float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells) return;
  float s = 0.f;
#pragma unroll 8
  for (int sl = 0; sl < n_slices; ++sl) s += partials[sl * cells + idx];
  out[idx] = s;
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

}  // namespace

extern "C" {

const char* fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_span_reduce(const float* values, long long S, int P, int k,
                      int B, const int* gids, const int* spans,
                      int n_tiles, const int* group_start, int G,
                      const float* inv_dt, float counter_max,
                      float reset_value, int ds_kind, int rate_mode,
                      int square, float* partials, float* out,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Transform tf = make_transform(P, k, B, inv_dt, counter_max,
                                      reset_value, ds_kind, rate_mode,
                                      square);
  if (n_tiles > 0) {
    span_reduce_kernel<<<n_tiles, kTile, 0, st>>>(values, S, tf, gids,
                                                   spans, G, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long cells = (long long)G * B;
  if (cells > 0) {
    const int threads = 256;
    const int blocks = (int)((cells + threads - 1) / threads);
    span_combine_kernel<<<blocks, threads, 0, st>>>(partials, spans,
                                                    group_start, G, B, out);
  }
  return (int)cudaGetLastError();
}

// Row slices of the one-hot partials: the wrapper allocates
// partials[slices, G, B] for fused_onehot_reduce with the same S, B, G
// and SM count.
int fused_onehot_slices(long long S, int B, int G, int sms) {
  return onehot_plan(S, B, G, sms).slices;
}

// Series per one-hot block (one per thread).
int fused_onehot_tile() { return kOhTile; }

int fused_onehot_reduce(const float* values, long long S, int P, int k,
                        int B, const int* gids, int G,
                        const float* inv_dt, float counter_max,
                        float reset_value, int ds_kind, int rate_mode,
                        int square, int sms, int device, float* partials,
                        float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long cells = (long long)G * B;
  if (cells == 0) return (int)cudaGetLastError();
  int n_slices = 0;  // no rows: out is all zeros
  if (S > 0) {
    if (sms < 1 || device < 0 || device >= kMaxDevices)
      return (int)cudaErrorInvalidValue;
    const OhPlan plan = onehot_plan(S, B, G, sms);
    if (!g_onehot_smem_set[device].load(std::memory_order_acquire)) {
      const cudaError_t err = cudaFuncSetAttribute(
          onehot_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      g_onehot_smem_set[device].store(true, std::memory_order_release);
    }
    const Transform tf = make_transform(P, k, B, inv_dt, counter_max,
                                        reset_value, ds_kind, rate_mode,
                                        square);
    const int vec16 = P % 4 == 0 && (uintptr_t)values % 16 == 0;
    onehot_reduce_kernel<<<plan.blocks, kOhTile, (int)plan.smem, st>>>(
        values, S, tf, gids, G, plan, vec16, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n_slices = plan.slices;
  }
  const int threads = 256;
  onehot_combine_kernel<<<(int)((cells + threads - 1) / threads), threads,
                          0, st>>>(partials, n_slices, cells, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
