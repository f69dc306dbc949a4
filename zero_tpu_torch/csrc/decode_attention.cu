// Single-query decode attention for Hopper (sm_90a): the CUDA counterparts
// of the Pallas TPU kernels in zero_tpu/ops/kernels/decode_attention.py.
//
//   decode_attention       replaces decode_attention (_kernel), one query
//                          per row over a static [B, T, hidden] cache.
//   decode_pool_attention  replaces decode_pool_attention (_pool_kernel),
//                          one query per beam over UNPERMUTED beam pools
//                          [B, K, T, hidden]; position t of beam i reads
//                          pool row ancestry[b, i, t].
//
// Both are one kernel here: the plain cache is a pool with one beam whose
// ancestry is the identity (ancestry == nullptr).
//
// Bound. Per (row, head) the kernel must read the query, the K and V
// slices of positions 0..time and write the output: ~4 * hidden * (time+1)
// flops against 2 * hidden * (time+1) elements read, far below the card's
// ~295 flops/byte ridge, so it is bound by device-memory bytes. The design
// reads every selected K/V element exactly once from device memory:
//   * one block per (row, head); its 4 warps take positions round-robin,
//     a warp reads one position's head slice with neighbouring lanes on
//     neighbouring elements (coalesced) and reduces the dot by shuffles;
//   * the ancestry gather costs one int read per position: the TPU kernel
//     instead made K masked passes over every pool row, because VMEM
//     blocks cannot gather rows cheaply;
//   * scores stay in shared memory (time+1 floats), the softmax is two
//     block reductions, and the weighted value sum is accumulated in fp32
//     registers, reduced across warps in shared memory.
// Not yet done (later work): vectorised 16-byte loads, cp.async/TMA
// prefetch of the next positions, and split-T for long caches.
//
// Interface: a plain C function, loaded with ctypes; it returns
// cudaGetLastError() after the launch.

#include "zt_common.cuh"

namespace {

using zt::from_float;
using zt::to_float;
using zt::warp_max;
using zt::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// head depth is at most 32 * kMaxPerLane = 256 (checked by the wrapper)
constexpr int kMaxPerLane = 8;

// Block-wide max or sum; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// grid = (rows = B * beams, heads); block = kThreads.
// q, out: [rows, hidden]; k, v: [B, beams, t_max, hidden];
// ancestry: [rows, t_max] int32 pool-row index of each position, or null
// (each beam reads its own row).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
single_query_attention(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ ancestry, T* __restrict__ out,
                       int beams, int t_max, int hidden, int dh, int time,
                       float scale) {
  extern __shared__ float weights[];  // [time + 1]
  __shared__ float partial[kWarps][kMaxPerLane * 32];
  __shared__ float scratch[kWarps];

  const int row = blockIdx.x;
  const int head = blockIdx.y;
  const int b = row / beams;
  const int beam = row - b * beams;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = time + 1;

  const T* q_row = q + (size_t)row * hidden + (size_t)head * dh;
  float qr[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < dh ? to_float(q_row[d]) * scale : 0.f;
  }

  const int* anc = ancestry ? ancestry + (size_t)row * t_max : nullptr;
  const size_t pool0 = (size_t)b * beams;  // first pool row of sentence b
  const size_t head_off = (size_t)head * dh;

  // 1. scaled logits of positions 0..time
  for (int t = warp; t < n; t += kWarps) {
    const int j = anc ? anc[t] : beam;
    const T* k_row = k + ((pool0 + j) * t_max + t) * (size_t)hidden + head_off;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc += qr[i] * to_float(k_row[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) weights[t] = acc;
  }
  __syncthreads();

  // 2. weights: relu (unnormalised, ReLA) or max-subtracted softmax
  float norm = 1.f;
  if (kRelu) {
    for (int t = threadIdx.x; t < n; t += kThreads)
      weights[t] = fmaxf(weights[t], 0.f);
  } else {
    float m = -3.402823466e38f;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, weights[t]);
    m = block_reduce<true>(m, scratch);
    float s = 0.f;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float p = expf(weights[t] - m);
      weights[t] = p;
      s += p;
    }
    s = block_reduce<false>(s, scratch);
    norm = 1.f / s;
  }
  __syncthreads();

  // 3. weighted sum of the selected value rows, fp32
  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.f;
  for (int t = warp; t < n; t += kWarps) {
    const int j = anc ? anc[t] : beam;
    const T* v_row = v + ((pool0 + j) * t_max + t) * (size_t)hidden + head_off;
    const float w = weights[t];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc[i] += w * to_float(v_row[d]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) partial[warp][d] = acc[i];
  }
  __syncthreads();
  T* o_row = out + (size_t)row * hidden + head_off;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += partial[w][d];
    o_row[d] = from_float<T>(o * norm);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* ancestry,
            void* out, int rows, int beams, int t_max, int hidden,
            int num_heads, int time, int relu, float scale,
            cudaStream_t stream) {
  const dim3 grid(rows, num_heads);
  const size_t smem = (size_t)(time + 1) * sizeof(float);
  const int dh = hidden / num_heads;
  if (relu) {
    single_query_attention<T, true><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, ancestry, (T*)out, beams,
        t_max, hidden, dh, time, scale);
  } else {
    single_query_attention<T, false><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, ancestry, (T*)out, beams,
        t_max, hidden, dh, time, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int zt_single_query_attention(
    const void* q, const void* k, const void* v, const void* ancestry,
    void* out, int dtype, int rows, int beams, int t_max, int hidden,
    int num_heads, int time, int relu, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* anc = (const int*)ancestry;
  if (dtype == 0) {
    launch<float>(q, k, v, anc, out, rows, beams, t_max, hidden, num_heads,
                  time, relu, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, anc, out, rows, beams, t_max, hidden,
                          num_heads, time, relu, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
