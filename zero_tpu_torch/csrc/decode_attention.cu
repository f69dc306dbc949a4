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
// ~295 flops/byte ridge, so it is bound by device-memory bytes, and what
// counts is how many of them are in flight. The design reads every
// selected K/V element exactly once, in one pass:
//   * a block (128 threads) owns one (row, head) and a range of positions;
//     it splits into groups of G lanes, G the 16-byte loads of a head
//     slice (Dh * sizeof(T) / 16, rounded up to a power of two, at most 32:
//     8 lanes at Dh 64 in bf16, 16 in fp32; a lane makes two loads at Dh
//     256 in fp32). A group takes one position at a time, kUnroll of them
//     with their K and V loads issued before the first dot needs them, and
//     reduces each dot by a shuffle tree inside the group (3 steps at 8
//     lanes). Head slices that are not 16-byte aligned take one element a
//     load, the same way;
//   * an online softmax per group (running max, sum and an fp32 O slice in
//     registers; V read in the same sweep as K); the groups fold by their
//     maxima in shared memory at the end. ReLA (relu) sums relu(s) * V with
//     no max and no normaliser, and folds by a plain sum;
//   * the ancestry gather costs one int read per position: the TPU kernel
//     instead made K masked passes over every pool row, because VMEM
//     blocks cannot gather rows cheaply;
//   * where rows * heads blocks would leave SMs idle (long caches at small
//     batch), the wrapper splits the positions into chunks
//     (decode_splits): each chunk's block writes its fp32 partial O and (m,
//     l), and combine_splits folds them by their maxima (flash-decoding, as
//     #9 below). At transformer-base decode shapes it is one launch.
// Every sum is fp32, in a fixed order: the fp32 reference models decode the
// same beams as the CPU.
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
// two blocks per SM are in flight; combine_splits folds the chunks' partial
// sums by their running maxima (flash-decoding).
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include <cfloat>

#include "zt_common.cuh"

namespace {

using zt::from_float;
using zt::to_float;
using zt::warp_max;
using zt::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// positions whose K and V loads a lane group has in flight at once
constexpr int kUnroll = 4;
// the groups' O slices at the fold: (kThreads / G) x Dh floats, at most
// kThreads * 8 (G covers a head slice in 16-byte loads, or Dh <= 256 at
// G = 32)
constexpr int kFoldFloats = kThreads * 8;

// VEC elements of T read by one load: 16 bytes (VEC = 16 / sizeof(T)), or
// one element where the head slices are not 16-byte aligned
template <typename T, int VEC>
struct Chunk;

template <typename T>
struct Chunk<T, 1> {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = *p; }
  __device__ __forceinline__ void zero() { x = from_float<T>(0.f); }
  __device__ __forceinline__ float at(int) const { return to_float(x); }
};

template <>
struct Chunk<float, 4> {
  float4 x;
  __device__ __forceinline__ void load(const float* p) {
    x = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() {
    x = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 x;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { x = make_uint4(0u, 0u, 0u, 0u); }
  // a bf16 is the upper half of the fp32 of the same value
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = e < 2 ? x.x : e < 4 ? x.y : e < 6 ? x.z : x.w;
    return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
};

// grid = (rows = B * beams, heads, splits); block = kThreads in groups of
// `group` lanes (a power of two up to 32). Block (row, head, split) attends
// positions [split * chunk, min(time + 1, (split + 1) * chunk)).
// q, out: [rows, hidden]; k, v: [B, beams, t_max, hidden]; ancestry:
// [rows, t_max] int32 pool-row index of each position, or null (each beam
// reads its own row). With one split (part_o null) it writes the output;
// otherwise its unnormalised fp32 sums part_o [B, heads, splits, beams, dh]
// and the max and sum part_ml [B, heads, splits, beams, 2], which
// combine_splits folds.
template <typename T, int VEC, int NL, bool kRelu>
__global__ void __launch_bounds__(kThreads)
single_query_attention(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ ancestry, T* __restrict__ out,
                       float* __restrict__ part_o,
                       float* __restrict__ part_ml, int beams, int t_max,
                       int hidden, int dh, int time, float scale, int group,
                       int chunk) {
  __shared__ float fold[kFoldFloats];
  __shared__ float group_m[kThreads], group_l[kThreads];

  const int row = blockIdx.x, head = blockIdx.y, heads = gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int b = row / beams;
  const int beam = row - b * beams;
  const int tid = threadIdx.x;
  const int gi = tid / group, gl = tid - gi * group;   // group, its lane
  const int groups = kThreads / group;
  const int vecs = dh / VEC;                // loads of one head slice
  const int t_begin = split * chunk;
  const int t_end = min(time + 1, t_begin + chunk);

  // this lane's loads of a head slice: vecs gl + group * i, i < NL
  const size_t head_off = (size_t)head * dh;
  const T* q_row = q + (size_t)row * hidden + head_off;
  float qf[NL][VEC], o[NL][VEC];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c = gl + group * i;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[i][e] = c < vecs ? to_float(q_row[c * VEC + e]) * scale : 0.f;
      o[i][e] = 0.f;
    }
  }
  const int* anc = ancestry ? ancestry + (size_t)row * t_max : nullptr;
  const size_t pool0 = (size_t)b * beams;   // first pool row of sentence b
  float m = -FLT_MAX, l = 0.f;

  // an iteration covers groups * kUnroll positions: group gi takes base +
  // gi + groups * u (the bounds are the block's, so every lane of a warp
  // takes the same iterations and the shuffles stay converged)
  for (int base = t_begin; base < t_end; base += groups * kUnroll) {
    Chunk<T, VEC> kc[kUnroll][NL], vc[kUnroll][NL];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + gi + groups * u;
      in[u] = t < t_end;
      const int j = (in[u] && anc) ? anc[t] : beam;
      const size_t off =
          ((pool0 + j) * t_max + (in[u] ? t : 0)) * (size_t)hidden +
          head_off;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c = gl + group * i;
        if (in[u] && c < vecs) {
          kc[u][i].load(k + off + c * VEC);
          vc[u][i].load(v + off + c * VEC);
        } else {
          kc[u][i].zero();
          vc[u][i].zero();
        }
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc = fmaf(qf[i][e], kc[u][i].at(e), acc);
      s[u] = acc;
    }
    // each dot over its group's lanes: xor partners stay inside the group
    for (int w = group >> 1; w > 0; w >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], w);

    float p[kUnroll];
    if (kRelu) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) p[u] = in[u] ? fmaxf(s[u], 0.f) : 0.f;
    } else {
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (in[u]) m_new = fmaxf(m_new, s[u]);
      const float alpha = expf(m - m_new);   // 1 while m_new = m
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = in[u] ? expf(s[u] - m_new) : 0.f;
        l += p[u];
      }
      m = m_new;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[i][e] = fmaf(p[u], vc[u][i].at(e), o[i][e]);
  }

  // fold the groups: softmax rescales each by e^(m_group - max), relu adds
  if (!kRelu) {
    if (gl == 0) group_m[gi] = m;
    __syncthreads();
    float big = -FLT_MAX;
    for (int g = 0; g < groups; ++g) big = fmaxf(big, group_m[g]);
    const float f = expf(m - big);
    l *= f;
#pragma unroll
    for (int i = 0; i < NL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[i][e] *= f;
    m = big;
    if (gl == 0) group_l[gi] = l;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c = gl + group * i;
    if (c < vecs)
#pragma unroll
      for (int e = 0; e < VEC; ++e) fold[gi * dh + c * VEC + e] = o[i][e];
  }
  __syncthreads();
  float total = 0.f;
  if (!kRelu)
    for (int g = 0; g < groups; ++g) total += group_l[g];
  const size_t part =
      (((size_t)b * heads + head) * splits + split) * beams + beam;
  for (int d = tid; d < dh; d += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += fold[g * dh + d];
    if (part_o == nullptr)
      out[(size_t)row * hidden + head_off + d] =
          from_float<T>(kRelu ? acc : acc / total);
    else
      part_o[part * dh + d] = acc;
  }
  if (part_o != nullptr && tid == 0) {
    part_ml[2 * part] = kRelu ? 0.f : m;
    part_ml[2 * part + 1] = total;
  }
}

// grid = (B, heads); block = kThreads. Folds the splits' partial sums
// part_o [B, heads, splits, beams, dh] and (m, l) part_ml [B, heads,
// splits, beams, 2] of single_query_attention or cross_attention: o =
// sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s; relu: o = sum_s acc_s.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
combine_splits(const float* __restrict__ part_o,
               const float* __restrict__ part_ml, T* __restrict__ out,
               int beams, int hidden, int dh, int splits) {
  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const size_t first = ((size_t)b * gridDim.y + head) * splits * beams;
  for (int e = threadIdx.x; e < beams * dh; e += kThreads) {
    const int beam = e / dh;
    const int d = e - beam * dh;
    float o;
    if (kRelu) {
      o = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        o += part_o[(first + (size_t)sp * beams + beam) * dh + d];
    } else {
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
      o = num / den;
    }
    out[((size_t)b * beams + beam) * hidden + (size_t)head * dh + d] =
        from_float<T>(o);
  }
}

template <typename T, int VEC, int NL>
cudaError_t launch_single_nl(const void* q, const void* k, const void* v,
                             const int* ancestry, void* out, float* part_o,
                             float* part_ml, int rows, int beams, int t_max,
                             int hidden, int num_heads, int time, int relu,
                             float scale, int group, int splits, int chunk,
                             cudaStream_t stream) {
  const dim3 grid(rows, num_heads, splits);
  const int dh = hidden / num_heads;
  float* po = splits > 1 ? part_o : nullptr;
  if (relu)
    single_query_attention<T, VEC, NL, true><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, ancestry, (T*)out, po,
        part_ml, beams, t_max, hidden, dh, time, scale, group, chunk);
  else
    single_query_attention<T, VEC, NL, false><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, ancestry, (T*)out, po,
        part_ml, beams, t_max, hidden, dh, time, scale, group, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const dim3 fold(rows / beams, num_heads);
  if (relu)
    combine_splits<T, true><<<fold, kThreads, 0, stream>>>(
        part_o, part_ml, (T*)out, beams, hidden, dh, splits);
  else
    combine_splits<T, false><<<fold, kThreads, 0, stream>>>(
        part_o, part_ml, (T*)out, beams, hidden, dh, splits);
  return cudaGetLastError();
}

// The lane group and loads per lane of a head slice: 16-byte loads where
// the slices are 16-byte aligned, else one element a load.
template <typename T>
cudaError_t launch_single(const void* q, const void* k, const void* v,
                          const int* ancestry, void* out, float* part_o,
                          float* part_ml, int rows, int beams, int t_max,
                          int hidden, int num_heads, int time, int relu,
                          float scale, int splits, int chunk,
                          cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int dh = hidden / num_heads;
  const bool wide = dh * sizeof(T) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                    (uintptr_t)v % 16 == 0;
  const int vecs = wide ? dh / kVec : dh;
  int group = 1;
  while (group < vecs && group < 32) group *= 2;
  const int nl = (vecs + group - 1) / group;
#define ZT_SINGLE(VEC, NL)                                                  \
  launch_single_nl<T, VEC, NL>(q, k, v, ancestry, out, part_o, part_ml,    \
                               rows, beams, t_max, hidden, num_heads, time, \
                               relu, scale, group, splits, chunk, s)
  if (wide) {
    if (nl == 1) return ZT_SINGLE(kVec, 1);
    // two 16-byte loads a lane: fp32 past Dh 128 (a bf16 slice of Dh <= 256
    // is at most 32 loads)
    if constexpr (sizeof(T) == 4)
      if (nl == 2) return ZT_SINGLE(kVec, 2);
  } else {
    if (nl == 1) return ZT_SINGLE(1, 1);
    if (nl == 2) return ZT_SINGLE(1, 2);
    if (nl <= 4) return ZT_SINGLE(1, 4);
    if (nl <= 8) return ZT_SINGLE(1, 8);
  }
#undef ZT_SINGLE
  return cudaErrorInvalidValue;
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
// combine_splits folds.
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
  combine_splits<T, false><<<dim3(batch, num_heads), kThreads, 0,
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

// dtype: 0 = float32, 1 = bfloat16. splits > 1 needs part_o
// [B, heads, splits, beams, dh] and part_ml [B, heads, splits, beams, 2]
// fp32 scratch (B = rows / beams); chunk positions per split.
extern "C" int zt_single_query_attention(
    const void* q, const void* k, const void* v, const void* ancestry,
    void* out, void* part_o, void* part_ml, int dtype, int rows, int beams,
    int t_max, int hidden, int num_heads, int time, int relu, float scale,
    int splits, int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* anc = (const int*)ancestry;
  float* po = (float*)part_o;
  float* pml = (float*)part_ml;
  if (splits < 1 || chunk < 1 ||
      (splits > 1 && (po == nullptr || pml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_single<float>(q, k, v, anc, out, po, pml, rows, beams,
                                     t_max, hidden, num_heads, time, relu,
                                     scale, splits, chunk, s);
  if (dtype == 1)
    return (int)launch_single<__nv_bfloat16>(q, k, v, anc, out, po, pml,
                                             rows, beams, t_max, hidden,
                                             num_heads, time, relu, scale,
                                             splits, chunk, s);
  return (int)cudaErrorInvalidValue;
}
