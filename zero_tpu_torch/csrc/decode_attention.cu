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
//   decode_cross_attention replaces decode_cross_attention (_cross_kernel),
//                          the beam-folded one-step cross attention of
//                          [B, beams, hidden] queries over precomputed
//                          memory projections [B, S, hidden] under a [B, S]
//                          pad mask (unwired in the JAX package and here).
//
// The first two are one kernel here: the plain cache is a pool with one
// beam whose ancestry is the identity (ancestry == nullptr).
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
// Cross attention (#9) is bound by the same bytes: each memory element
// once per batch row, whatever the beam count. A block owns one (batch row,
// head) and up to 16 beams (4 per warp); it walks S in tiles of 32
// positions staged in shared memory as fp32, and every staged K/V element
// serves all its beams (the beam fold). An fp32 online softmax (running
// max and sum per beam, as csrc/fused_attention.cu) lets S grow without a
// VMEM-style limit: shared memory does not depend on S. The weights stay
// fp32 where the TPU kernel rounds them to the value dtype. At small batch
// and long memory B * heads blocks would leave most SMs idle, so the
// wrapper splits S into chunks (at least 256 positions each) until about
// two blocks per SM are in flight; a second kernel folds the chunks'
// partial sums by their running maxima (flash-decoding).
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launch.

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

constexpr int kCrossTile = 32;                 // memory positions per tile
constexpr int kBeamsPerWarp = 4;
constexpr int kBeamsPerBlock = kWarps * kBeamsPerWarp;   // 16
constexpr float kCrossMasked = -1e30f;          // NEG_INF of _cross_kernel

// grid = (B, heads, splits * groups), groups = ceil(beams / 16); block =
// kThreads. Block (b, head, split * groups + group) attends beams
// [16 group, 16 group + 16) over memory positions [chunk split,
// chunk (split + 1)). q, out: [B, beams, hidden]; mk, mv: [B, S, hidden];
// mask: [B, S] fp32. With one split (part_o null) it writes the output;
// otherwise its unnormalised fp32 sums part_o [B, heads, splits, beams, dh]
// and the running max and sum part_ml [B, heads, splits, beams, 2], which
// cross_attention_combine folds.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
cross_attention(const T* __restrict__ q, const T* __restrict__ mk,
                const T* __restrict__ mv, const float* __restrict__ mask,
                T* __restrict__ out, float* __restrict__ part_o,
                float* __restrict__ part_ml, int beams, int s_len,
                int hidden, int dh, float scale, int chunk, int groups) {
  extern __shared__ float smem[];
  float* qs = smem;                                // [16][dh], scaled
  float* ks = qs + kBeamsPerBlock * dh;            // [32][dh + 1]
  float* vs = ks + kCrossTile * (dh + 1);          // [32][dh]
  float* ps = vs + kCrossTile * dh;                // [16][32]
  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int group = blockIdx.z % groups;
  const int split = blockIdx.z / groups;
  const int splits = gridDim.z / groups;
  const int beam0 = group * kBeamsPerBlock;
  const int nb = min(kBeamsPerBlock, beams - beam0);
  const int s_begin = split * chunk;
  const int s_end = min(s_len, s_begin + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head_off = (size_t)head * dh;
  const T* k_b = mk + (size_t)b * s_len * hidden + head_off;
  const T* v_b = mv + (size_t)b * s_len * hidden + head_off;
  const float* mask_b = mask + (size_t)b * s_len;

  for (int e = threadIdx.x; e < kBeamsPerBlock * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    qs[e] = r < nb ? to_float(q[((size_t)b * beams + beam0 + r) * hidden +
                                head_off + d]) * scale
                   : 0.f;
  }
  float m[kBeamsPerWarp], l[kBeamsPerWarp], acc[kBeamsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kBeamsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int s0 = s_begin; s0 < s_end; s0 += kCrossTile) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int e = threadIdx.x; e < kCrossTile * dh; e += kThreads) {
      const int r = e / dh;
      const int d = e - r * dh;
      const bool in = s0 + r < s_end;
      const size_t off = (size_t)(s0 + r) * hidden + d;
      ks[r * (dh + 1) + d] = in ? to_float(k_b[off]) : 0.f;
      vs[r * dh + d] = in ? to_float(v_b[off]) : 0.f;
    }
    __syncthreads();
    const int pos = s0 + lane;
    const bool exists = pos < s_end;
    const bool valid = exists && mask_b[exists ? pos : 0] > 0.f;
    float s[kBeamsPerWarp];
#pragma unroll
    for (int r = 0; r < kBeamsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (dh + 1);
    const float* qr = qs + warp * kBeamsPerWarp * dh;
    for (int d = 0; d < dh; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kBeamsPerWarp; ++r) s[r] += qr[r * dh + d] * kd;
    }
#pragma unroll
    for (int r = 0; r < kBeamsPerWarp; ++r) {
      // position s0 exists in every tile, so m_new is finite
      const float x = exists ? (valid ? s[r] : kCrossMasked) : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float e = exists ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      ps[(warp * kBeamsPerWarp + r) * kCrossTile + lane] = e;
    }
    __syncwarp();
    for (int jj = 0; jj < kCrossTile; ++jj) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < dh ? vs[jj * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBeamsPerWarp; ++r) {
        const float e = ps[(warp * kBeamsPerWarp + r) * kCrossTile + jj];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += e * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBeamsPerWarp; ++r) {
    const int local = warp * kBeamsPerWarp + r;
    if (local >= nb) continue;
    const int beam = beam0 + local;
    if (part_o == nullptr) {
      T* o_row = out + ((size_t)b * beams + beam) * hidden + head_off;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o_row[d] = from_float<T>(acc[r][c] * inv);
      }
    } else {
      const size_t row =
          (((size_t)b * heads + head) * splits + split) * beams + beam;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) part_o[row * dh + d] = acc[r][c];
      }
      if (lane == 0) {
        part_ml[2 * row] = m[r];
        part_ml[2 * row + 1] = l[r];
      }
    }
  }
}

// grid = (B, heads); block = kThreads. Folds the splits' partial sums of
// cross_attention: o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cross_attention_combine(const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, int beams, int hidden, int dh,
                        int splits) {
  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const size_t first = ((size_t)b * gridDim.y + head) * splits * beams;
  for (int e = threadIdx.x; e < beams * dh; e += kThreads) {
    const int beam = e / dh;
    const int d = e - beam * dh;
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      big = fmaxf(big, part_ml[2 * (first + (size_t)sp * beams + beam)]);
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const size_t row = first + (size_t)sp * beams + beam;
      const float w = expf(part_ml[2 * row] - big);
      num += w * part_o[row * dh + d];
      den += w * part_ml[2 * row + 1];
    }
    out[((size_t)b * beams + beam) * hidden + (size_t)head * dh + d] =
        from_float<T>(num / den);
  }
}

template <typename T, int NC>
cudaError_t launch_cross_nc(const void* q, const void* mk, const void* mv,
                            const float* mask, void* out, float* part_o,
                            float* part_ml, int batch, int beams, int s_len,
                            int hidden, int num_heads, float scale,
                            int splits, int chunk, cudaStream_t stream) {
  const int dh = hidden / num_heads;
  const int groups = (beams + kBeamsPerBlock - 1) / kBeamsPerBlock;
  const size_t bytes = sizeof(float) *
      (size_t)(kBeamsPerBlock * dh + kCrossTile * (dh + 1) +
               kCrossTile * dh + kBeamsPerBlock * kCrossTile);
  cudaError_t err = zt::allow_smem(cross_attention<T, NC>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, num_heads, splits * groups);
  cross_attention<T, NC><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)mk, (const T*)mv, mask, (T*)out,
      splits > 1 ? part_o : nullptr, part_ml, beams, s_len, hidden, dh,
      scale, chunk, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  cross_attention_combine<T><<<dim3(batch, num_heads), kThreads, 0,
                               stream>>>(part_o, part_ml, (T*)out, beams,
                                         hidden, dh, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const void* q, const void* mk, const void* mv,
                         const float* mask, void* out, float* part_o,
                         float* part_ml, int batch, int beams, int s_len,
                         int hidden, int num_heads, float scale, int splits,
                         int chunk, cudaStream_t s) {
  const int dh = hidden / num_heads;
#define ZT_CROSS(NC)                                                       \
  launch_cross_nc<T, NC>(q, mk, mv, mask, out, part_o, part_ml, batch,     \
                         beams, s_len, hidden, num_heads, scale, splits,   \
                         chunk, s)
  if (dh <= 32) return ZT_CROSS(1);
  if (dh <= 64) return ZT_CROSS(2);
  if (dh <= 128) return ZT_CROSS(4);
  if (dh <= 256) return ZT_CROSS(8);
#undef ZT_CROSS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. splits > 1 needs part_o
// [B, heads, splits, beams, dh] and part_ml [B, heads, splits, beams, 2]
// fp32 scratch; chunk (a multiple of 32) positions per split.
extern "C" int zt_cross_attention(const void* q, const void* mk,
                                  const void* mv, const void* mask, void* out,
                                  void* part_o, void* part_ml, int dtype,
                                  int batch, int beams, int s_len, int hidden,
                                  int num_heads, float scale, int splits,
                                  int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  float* po = (float*)part_o;
  float* pml = (float*)part_ml;
  if (splits < 1 || (splits > 1 && (po == nullptr || pml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_cross<float>(q, mk, mv, m, out, po, pml, batch, beams,
                                    s_len, hidden, num_heads, scale, splits,
                                    chunk, s);
  if (dtype == 1)
    return (int)launch_cross<__nv_bfloat16>(q, mk, mv, m, out, po, pml,
                                            batch, beams, s_len, hidden,
                                            num_heads, scale, splits, chunk,
                                            s);
  return (int)cudaErrorInvalidValue;
}

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
