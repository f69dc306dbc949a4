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
// All three are one kernel here (decode_attention_kernel): the plain cache
// is a pool with one beam whose ancestry is the identity (ancestry ==
// nullptr), and the cross attention reads one memory row per position for
// up to kCrossBeams beam queries at once, under a pad mask.
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
// once per batch row, whatever the beam count. It is the same design over
// the memory positions: a block owns one (batch row, head) and up to
// kCrossBeams beams; each lane group reads a position's K and V head slices
// in 16-byte loads (kUnroll positions in flight) and takes the dots of all
// the block's beams from the one K load, the scaled beam queries in
// registers (the beam fold); an online softmax per beam and group, the
// groups folded by their maxima in shared memory. Masked positions take the
// logit -1e30 of _cross_kernel, so a batch row whose positions are all
// masked averages all S of them. Shared memory does not depend on S. At
// small batch and long memory the wrapper splits S into chunks
// (cross_splits) and combine_splits folds them (flash-decoding). The
// weights stay fp32 where the TPU kernel rounds them to the value dtype.
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include <cfloat>

#include "zt_common.cuh"

namespace {

using zt::from_float;
using zt::to_float;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// positions whose K and V loads a lane group has in flight at once
constexpr int kUnroll = 4;
// the groups' O slices at the fold: (kThreads / G) x Dh floats, at most
// kThreads * 8 (G covers a head slice in 16-byte loads, or Dh <= 256 at
// G = 32)
constexpr int kFoldFloats = kThreads * 8;
// beam queries of a cross-attention block (#9): each memory position's K
// load serves all of them; more beams take more blocks
constexpr int kCrossBeams = 4;
constexpr float kCrossMasked = -1e30f;   // NEG_INF of _cross_kernel

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

// The arguments of a launch. q, out: [B, beams, hidden] (rows = B * beams);
// CROSS false (#10/#8): k, v [B, beams, t_max, hidden] pools, ancestry
// [rows, t_max] int32 pool-row index of each position or null (each beam
// reads its own row); CROSS true (#9): k, v [B, t_max = S, hidden] memory,
// mask [B, S] fp32. n positions are attended (time + 1, or S). part_o [B,
// heads, splits, beams, dh] and part_ml [B, heads, splits, beams, 2]: the
// splits' unnormalised fp32 sums and their (max, sum), or part_o null with
// one split.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* ancestry;
  const float* mask;
  void* out;
  float* part_o;
  float* part_ml;
  int beams, t_max, hidden, dh, n;
  float scale;
  int group, chunk, bgroups;
};

// grid = (B * bgroups, heads, splits), bgroups = ceil(beams / NB); block =
// kThreads in groups of a.group lanes (a power of two up to 32). Block (b *
// bgroups + g, head, split) attends beams [NB g, NB g + NB) of batch row b
// over positions [split * chunk, min(n, (split + 1) * chunk)); every group
// takes the dots of all NB beams from one K load. With one split it writes
// the output; otherwise part_o/part_ml, which combine_splits folds.
template <typename T, int VEC, int NL, int NB, bool kRelu, bool CROSS>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(DecodeArgs a) {
  __shared__ float fold[NB * kFoldFloats];
  __shared__ float group_m[NB * kThreads], group_l[NB * kThreads];

  const int b = blockIdx.x / a.bgroups;
  const int beam0 = (blockIdx.x - b * a.bgroups) * NB;
  const int nb = min(NB, a.beams - beam0);
  const int head = blockIdx.y, heads = gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, group = a.group, dh = a.dh;
  const int gi = tid / group, gl = tid - gi * group;   // group, its lane
  const int groups = kThreads / group;
  const int vecs = dh / VEC;                // loads of one head slice
  const int t_begin = split * a.chunk;
  const int t_end = min(a.n, t_begin + a.chunk);
  const size_t head_off = (size_t)head * dh;
  const T* __restrict__ k = (const T*)a.k + head_off;
  const T* __restrict__ v = (const T*)a.v + head_off;
  // position t reads K/V row kv0 + j * t_max + t: j = 0 (CROSS), the pool
  // row ancestry[row, t], or the beam's own
  const size_t kv0 = (size_t)b * (CROSS ? 1 : a.beams) * a.t_max;
  const int* __restrict__ anc =
      (!CROSS && a.ancestry)
          ? a.ancestry + ((size_t)b * a.beams + beam0) * a.t_max
          : nullptr;
  const float* __restrict__ mask =
      CROSS ? a.mask + (size_t)b * a.t_max : nullptr;

  // the scaled queries (0 past nb) and this lane's share of each beam's O
  // slice: loads gl + group * i, i < NL
  float qf[NB][NL][VEC], o[NB][NL][VEC], m[NB], l[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const T* q_row = (const T*)a.q +
        ((size_t)b * a.beams + beam0 + min(r, nb - 1)) * a.hidden + head_off;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c = gl + group * i;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[r][i][e] = r < nb && c < vecs
                          ? to_float(q_row[c * VEC + e]) * a.scale : 0.f;
        o[r][i][e] = 0.f;
      }
    }
    m[r] = -FLT_MAX;
    l[r] = 0.f;
  }

  // an iteration covers groups * kUnroll positions: group gi takes base +
  // gi + groups * u (the bounds are the block's, so every lane of a warp
  // takes the same iterations and the shuffles stay converged)
  for (int base = t_begin; base < t_end; base += groups * kUnroll) {
    Chunk<T, VEC> kc[kUnroll][NL], vc[kUnroll][NL];
    bool in[kUnroll], valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + gi + groups * u;
      in[u] = t < t_end;
      const int tt = in[u] ? t : 0;
      valid[u] = in[u] && (!CROSS || __ldg(mask + tt) > 0.f);
      const int j = CROSS ? 0 : (anc && in[u]) ? __ldg(anc + t) : beam0;
      const size_t off = (kv0 + (size_t)j * a.t_max + tt) * a.hidden;
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
    float s[kUnroll][NB];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc = fmaf(qf[r][i][e], kc[u][i].at(e), acc);
        s[u][r] = acc;
      }
    // each dot over its group's lanes: xor partners stay inside the group
    for (int w = group >> 1; w > 0; w >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < NB; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], w);

#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float p[kUnroll];
      if (kRelu) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          p[u] = in[u] ? fmaxf(s[u][r], 0.f) : 0.f;
      } else {
        // a masked position's logit: -1e30 (_cross_kernel)
        float m_new = m[r];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (CROSS && !valid[u]) s[u][r] = kCrossMasked;
          if (in[u]) m_new = fmaxf(m_new, s[u][r]);
        }
        const float alpha = expf(m[r] - m_new);   // 1 while m_new = m
        l[r] *= alpha;
#pragma unroll
        for (int i = 0; i < NL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[r][i][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = in[u] ? expf(s[u][r] - m_new) : 0.f;
          l[r] += p[u];
        }
        m[r] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < NL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o[r][i][e] = fmaf(p[u], vc[u][i].at(e), o[r][i][e]);
    }
  }

  // fold the groups: softmax rescales each by e^(m_group - max), relu adds
  if (!kRelu) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (gl == 0) group_m[gi * NB + r] = m[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float big = -FLT_MAX;
      for (int g = 0; g < groups; ++g) big = fmaxf(big, group_m[g * NB + r]);
      const float f = expf(m[r] - big);
      m[r] = big;
      l[r] *= f;
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[r][i][e] *= f;
      if (gl == 0) group_l[gi * NB + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c = gl + group * i;
      if (c < vecs)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          fold[(gi * NB + r) * dh + c * VEC + e] = o[r][i][e];
    }
  __syncthreads();
  for (int x = tid; x < nb * dh; x += kThreads) {
    const int r = NB == 1 ? 0 : x / dh, d = x - r * dh;
    float acc = 0.f, total = 0.f;
    for (int g = 0; g < groups; ++g) {
      acc += fold[(g * NB + r) * dh + d];
      if (!kRelu) total += group_l[g * NB + r];
    }
    const int beam = beam0 + r;
    if (a.part_o == nullptr) {
      ((T*)a.out)[((size_t)b * a.beams + beam) * a.hidden + head_off + d] =
          from_float<T>(kRelu ? acc : acc / total);
    } else {
      const size_t part =
          (((size_t)b * heads + head) * splits + split) * a.beams + beam;
      a.part_o[part * dh + d] = acc;
      if (d == 0) {
        // every thread's m[r] is the block's max after the fold
        a.part_ml[2 * part] = kRelu ? 0.f : m[r];
        a.part_ml[2 * part + 1] = total;
      }
    }
  }
}

// grid = (B, heads); block = kThreads. Folds the splits' partial sums
// part_o [B, heads, splits, beams, dh] and (m, l) part_ml [B, heads,
// splits, beams, 2] of decode_attention_kernel: o = sum_s e^(m_s - M)
// acc_s / sum_s e^(m_s - M) l_s; relu: o = sum_s acc_s.
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

template <typename T, int VEC, int NL, int NB, bool kRelu, bool CROSS>
cudaError_t launch_nl(DecodeArgs a, int batch, int heads, int splits,
                      cudaStream_t stream) {
  float* part_o = a.part_o;
  if (splits == 1) a.part_o = nullptr;
  decode_attention_kernel<T, VEC, NL, NB, kRelu, CROSS>
      <<<dim3(batch * a.bgroups, heads, splits), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  combine_splits<T, kRelu><<<dim3(batch, heads), kThreads, 0, stream>>>(
      part_o, a.part_ml, (T*)a.out, a.beams, a.hidden, a.dh, splits);
  return cudaGetLastError();
}

// The lane group and loads per lane of a head slice (16-byte loads where
// the slices and the K and V bases are 16-byte aligned, else one element a
// load; the group the loads' count rounded up to a power of two, at most 32
// lanes), then the launch: two 16-byte loads a lane only in fp32 past Dh
// 128 (a bf16 slice of Dh <= 256 is at most 32 loads), up to 8
// one-element loads a lane.
template <typename T, int NB, bool kRelu, bool CROSS>
cudaError_t launch(DecodeArgs a, int batch, int heads, int splits,
                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = a.dh * sizeof(T) % 16 == 0 && (uintptr_t)a.k % 16 == 0 &&
                    (uintptr_t)a.v % 16 == 0;
  const int vecs = wide ? a.dh / kVec : a.dh;
  a.group = 1;
  while (a.group < vecs && a.group < 32) a.group *= 2;
  const int nl = (vecs + a.group - 1) / a.group;
  a.bgroups = (a.beams + NB - 1) / NB;
#define ZT_LAUNCH(VEC, NL) \
  launch_nl<T, VEC, NL, NB, kRelu, CROSS>(a, batch, heads, splits, s)
  if (wide) {
    if (nl == 1) return ZT_LAUNCH(kVec, 1);
    if constexpr (sizeof(T) == 4)
      if (nl == 2) return ZT_LAUNCH(kVec, 2);
  } else {
    if (nl == 1) return ZT_LAUNCH(1, 1);
    if (nl == 2) return ZT_LAUNCH(1, 2);
    if (nl <= 4) return ZT_LAUNCH(1, 4);
    if (nl <= 8) return ZT_LAUNCH(1, 8);
  }
#undef ZT_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool kRelu, bool CROSS>
int run(int dtype, const DecodeArgs& a, int batch, int heads, int splits,
        void* stream) {
  constexpr int NB = CROSS ? kCrossBeams : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float, NB, kRelu, CROSS>(a, batch, heads, splits, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, NB, kRelu, CROSS>(a, batch, heads,
                                                        splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// #9. dtype: 0 = float32, 1 = bfloat16. splits > 1 needs part_o [B, heads,
// splits, beams, dh] and part_ml [B, heads, splits, beams, 2] fp32 scratch;
// chunk positions per split.
extern "C" int zt_cross_attention(const void* q, const void* mk,
                                  const void* mv, const void* mask, void* out,
                                  void* part_o, void* part_ml, int dtype,
                                  int batch, int beams, int s_len, int hidden,
                                  int num_heads, float scale, int splits,
                                  int chunk, void* stream) {
  if (splits < 1 || chunk < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a = {q, mk, mv, nullptr, (const float*)mask, out,
                        (float*)part_o, (float*)part_ml, beams, s_len,
                        hidden, hidden / num_heads, s_len, scale, 0, chunk,
                        0};
  return run<false, true>(dtype, a, batch, num_heads, splits, stream);
}

// #10/#8. dtype: 0 = float32, 1 = bfloat16. splits > 1 needs part_o [B,
// heads, splits, beams, dh] and part_ml [B, heads, splits, beams, 2] fp32
// scratch (B = rows / beams); chunk positions per split.
extern "C" int zt_single_query_attention(
    const void* q, const void* k, const void* v, const void* ancestry,
    void* out, void* part_o, void* part_ml, int dtype, int rows, int beams,
    int t_max, int hidden, int num_heads, int time, int relu, float scale,
    int splits, int chunk, void* stream) {
  if (splits < 1 || chunk < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a = {q, k, v, (const int*)ancestry, nullptr, out,
                        (float*)part_o, (float*)part_ml, beams, t_max,
                        hidden, hidden / num_heads, time + 1, scale, 0, chunk,
                        0};
  return relu ? run<true, false>(dtype, a, rows / beams, num_heads, splits,
                                 stream)
              : run<false, false>(dtype, a, rows / beams, num_heads, splits,
                                  stream);
}
