// Fused dense query pipeline for Hopper (sm_90a): downsample -> rate ->
// group reduce over complete regular-cadence series, in float32.
//
// Replaces the two Pallas TPU kernels of opentsdb_tpu/ops/pallas_fused.py:
//   span_reduce_kernel (+ span_combine_kernel)  <- _kernel_span (:270)
//   onehot_reduce_kernel                        <- _kernel      (:241)
// Both run the per-series transform of _tile_transform (:196) in the same
// op order as the plain PyTorch version in ops/fused.py.
//
// What bounds them: bytes. Each query reads the [S, P] value matrix once
// (S*P*4 bytes) plus S group ids, and does a handful of flops per value,
// far below the card's flop/byte balance. The design therefore reads each
// value exactly once with coalesced loads and keeps every intermediate
// (the downsampled [B] row, its rate, the group partials) in registers and
// shared memory:
//   - one thread per series, a block per tile of kTile consecutive series;
//   - the block stages a [kTile, kChunk] slab of the row-major matrix in
//     shared memory with consecutive threads on consecutive addresses,
//     then each thread walks its own row from shared memory, carrying the
//     open bucket's accumulator and the previous bucket's value (rate) in
//     registers, so any P and k work with a fixed shared footprint;
//   - span: rows are group-sorted on the host side, so a tile holds at
//     most kSpanMax groups; each finished bucket is reduced per group slot
//     with warp shuffles, the tile's partials go to global memory, and a
//     second kernel sums them in tile order (deterministic);
//   - one-hot: unsorted group ids; shared float atomics into a per-block
//     [G_chunk, B] accumulator, then one global atomic per touched cell.
//
// Plain C interface (loaded with ctypes); every function launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // series per block, one per thread
constexpr int kChunk = 32;   // points per row staged per step
constexpr int kSpanMax = 8;  // group slots per span tile
constexpr int kWarps = kTile / 32;
// shared-memory budget of the one-hot accumulator per block
constexpr int kOnehotAccBytes = 96 * 1024;
constexpr int kOnehotAccMaxBytes = 200 * 1024;

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

__global__ void __launch_bounds__(kTile) onehot_reduce_kernel(
    const float* __restrict__ values, int64_t S, Transform tf,
    const int* __restrict__ gids, int G, int g_chunk, int64_t n_tiles,
    float* __restrict__ out) {
  extern __shared__ float sacc[];  // [g_chunk][B]
  __shared__ float stage[kTile][kChunk + 1];
  const int tid = threadIdx.x;
  const int cells = g_chunk * tf.B;
  for (int g0 = 0; g0 < G; g0 += g_chunk) {
    for (int i = tid; i < cells; i += kTile) sacc[i] = 0.f;
    __syncthreads();
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int64_t row0 = tile * kTile;
      const int64_t row = row0 + tid;
      const int g = row < S ? gids[row] - g0 : -1;
      const bool mine = g >= 0 && g < g_chunk;
      float acc = 0.f, t_prev = 0.f;
      int pos = 0, b = 0;
      for (int c0 = 0; c0 < tf.P; c0 += kChunk) {
        const int cw = min(kChunk, tf.P - c0);
        __syncthreads();
        stage_chunk(stage, values, S, tf.P, row0, c0, cw);
        __syncthreads();
        for (int c = 0; c < cw; ++c) {
          acc = ds_step(tf.ds_kind, acc, stage[tid][c], pos);
          if (++pos < tf.k) continue;
          const float t = bucket_value(tf, acc, &t_prev, b);
          if (mine) atomicAdd(&sacc[g * tf.B + b], t);
          pos = 0;
          ++b;
        }
      }
    }
    __syncthreads();
    const int live = min(g_chunk, G - g0) * tf.B;
    for (int i = tid; i < live; i += kTile) {
      const float v = sacc[i];
      if (v != 0.f) atomicAdd(&out[(int64_t)g0 * tf.B + i], v);
    }
    __syncthreads();
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

int fused_onehot_reduce(const float* values, long long S, int P, int k,
                        int B, const int* gids, int G,
                        const float* inv_dt, float counter_max,
                        float reset_value, int ds_kind, int rate_mode,
                        int square, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)G * B,
                                    st);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || G == 0 || B == 0) return (int)cudaGetLastError();
  // the accumulator holds as many whole groups as the budget allows,
  // at least one; the block walks its rows once per group chunk
  const long long row_bytes = (long long)B * sizeof(float);
  if (row_bytes > kOnehotAccMaxBytes) return (int)cudaErrorInvalidValue;
  long long g_chunk = kOnehotAccBytes / row_bytes;
  if (g_chunk < 1) g_chunk = 1;
  if (g_chunk > G) g_chunk = G;
  const int smem = (int)(g_chunk * row_bytes);
  err = cudaFuncSetAttribute(onehot_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, onehot_reduce_kernel, kTile, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (S + kTile - 1) / kTile;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  const Transform tf = make_transform(P, k, B, inv_dt, counter_max,
                                      reset_value, ds_kind, rate_mode,
                                      square);
  onehot_reduce_kernel<<<(int)blocks, kTile, smem, st>>>(
      values, S, tf, gids, G, (int)g_chunk, n_tiles, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
