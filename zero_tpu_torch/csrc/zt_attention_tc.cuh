// Attention code shared by the port's attention libraries
// (streaming_attention.cu, fused_attention.cu): the launch parameters, the
// row seed of the dropout mask, and in namespace tc the bf16 tensor-core
// forward and backward, FlashAttention-2 style, that both run:
//
//   forward_tc  #5, and #1: the online softmax over 64-key tiles; writes o
//               and the row statistics m and l apart.
//   dq_tc       #6, and #2's first half: delta = rowsum(dO * O), then dq
//               over the key tiles.
//   dkdv_tc     #7, and #2's second half: a block owns 64 keys and walks
//               the query tiles for dk and dv.
//
// m is the max of s * Dh^-0.5 over a row's valid keys, or -1e30 on a row
// with none; l is the undropped sum of exp(s * Dh^-0.5 - m). The backward
// recomputes the weights from them; no [Lq, Lk] tensor leaves the SM.
//   * A block is one warpgroup (128 threads) owning 64 query rows (forward,
//     dq) or 64 keys (dk/dv), three blocks to an SM. Q, K, V and dO tiles
//     are staged as stored (row-major [rows, Dh], zero past Lq, Lk and Dh)
//     into 128-byte-swizzled shared memory (zt_wgmma.cuh) through a
//     cp.async ring; the head depth is padded to DP = 64 or 128 columns.
//     The key pad values come with each key tile, m, l and delta (fp32)
//     with each query tile, as 4-byte copies, and each query row's seed
//     word is hashed once per tile beside them.
//   * forward (grid: 64-row query tiles x B*H): Q staged once; per 64-key
//     tile S = Q.K^T by wgmma m64n64k16 (both k-major), the online softmax
//     on the accumulator fragment (a row's max by shuffles within the quad;
//     m, l and the DP/2-register O accumulator in fp32, O rescaled by
//     alpha), P dropped by the keep bit, scaled by 1/(1 - p) and rounded to
//     bf16 straight into the A fragment, O += P.V with the staged V tile
//     read m/n-major; o = O / l in bf16.
//   * dq (grid: 64-row query tiles x B*H): delta = rowsum(dO * O) in fp32
//     first, written for dk/dv. Over the 64-key tiles (stopping at the
//     diagonal under the causal flag): S = Q.K^T and dP = dO.V^T by wgmma
//     m64n64k16 (both operands k-major), then, in registers at each
//     fragment's (row, key), the CUDA-core kernels' rule: w = exp(s*scale -
//     m) / l, dP dropped by the keep bit and scaled, dS = valid ? w * (dP -
//     delta) : 0; then dQ += dS.K by wgmma with dS as the A operand from
//     registers (bf16; the accumulator fragment is the A fragment) and the
//     same K tile read m/n-major. dq = dQ * scale in bf16.
//   * dk/dv (grid: 64-key tiles x B*H): K and V resident in shared memory,
//     dK and dV in fp32 registers. Over the query tiles (64 rows; 32 at DP
//     = 128, to keep the accumulators in registers): S^T = K.Q^T and dP^T =
//     V.dO^T by wgmma, P^T (its dropped copy) and dS^T by the same rule,
//     then dV += P_drop^T.dO and dK += dS^T.Q with A from registers and the
//     staged Q and dO tiles read m/n-major. dk = dK * scale, dv = dV in
//     bf16.
//   P and dS are rounded to bf16 as the products' A operands, as in every
//   FlashAttention kernel (the JAX kernels multiply the weights in fp32);
//   everything else stays fp32.
//
// The mask rule (template argument FUSED of forward_tc and dkdv_tc). Under
// the causal flag the streaming kernels (#5-#7) treat keys past a row as
// absent: a row normalises over the keys up to it. The fused kernels
// (#1/#2, and the JAX kernel's _scores) keep them, masked at -1e30: a row
// whose visible keys are all padded (an all-pad batch row of decoder
// self-attention) gets uniform weights over all Lk keys. Such rows come
// first (row i sees every key that row i - 1 sees), so a tile holds one iff
// its first row is one.
//   * forward: a block may stop at the diagonal only if its first row q0
//     has a valid key, i.e. some key j <= q0 is not padded; one warpgroup
//     vote over the pad mask before the walk decides it, and a block that
//     fails it walks all ceil(Lk / 64) key tiles, where keys past a row
//     enter at the masked exponent. A row with a valid key gets exactly 0
//     from every masked key; a row without one gets exactly 1 from each key
//     (below), so it averages all Lk keys.
//   * dq and dk agree under both rules (dS is 0 at every masked entry), so
//     dq_tc takes no rule.
//   * dv differs, since such a row gives a 1/l share of its dropped dO to
//     every key, the keys above the diagonal too. So under the fused rule
//     dk/dv also walks the query tiles above the diagonal that hold a row
//     at m = -1e30: a warpgroup vote over m at the first row of each tile
//     above the diagonal, once before the walk, counts them, and the walk
//     takes those tiles and then the tiles from the diagonal on. Every
//     batch row with a valid key keeps the causal skip, and the walk itself
//     has no per-tile branch (a per-tile vote inside the loop made ptxas
//     spill).
// The masked exponent -1e30 * log2(e) - m * log2(e) is subtracted plainly
// (no fused multiply-add), so that on a row with m = -1e30 it is exactly 0.

#pragma once

#include "zt_common.cuh"
#include "zt_wgmma.cuh"

namespace zt {

constexpr float kMasked = -1e30f;   // NEG_INF of the JAX kernels

// The arguments of an attention launch. Layout: q [B*H, Lq, Dh], k/v
// [B*H, Lk, Dh] contiguous, fp32 or bf16; pad [B, Lk] fp32 (1 = attend);
// m, l, delta [B*H, Lq] fp32.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  const float* pad;
  const void* o;
  const void* dout;
  void* out;        // forward: o; dq kernel: dq
  void* dk;
  void* dv;
  float* m;
  float* l;
  float* delta;
  int heads, lq, lk, dh, causal, dropout;
  float scale, drop_scale;
  uint32_t threshold, s0, s1;
};

// The seed word of query row i of head bh (0 when dropout is off).
__device__ __forceinline__ uint32_t row_seed(const AttnParams& p, int bh,
                                             int i) {
  if (!p.dropout) return 0u;
  return row_seed((uint32_t)bh * (uint32_t)p.lq + (uint32_t)i, p.s0, p.s1);
}

namespace tc {

using namespace zt::wg;   // cp.async ring, swizzle, descriptors, wgmma
using bf16 = __nv_bfloat16;
using Params = AttnParams;

constexpr int kThreadsTC = 128;   // one warpgroup
constexpr int kBlockRows = 64;    // query rows (forward, dq) or keys (dk/dv)
constexpr int kKeys = 64;         // keys of a tile that forward and dq walk
// cp.async ring slots and resident blocks per SM of forward, dq and dk/dv
// (at DP = 64; one at DP = 128), chosen on the card at B=2, H=4, L=8320
// (PERF.md, Findings): one warpgroup a block with three blocks to an SM ran
// faster than two warpgroups sharing their tiles with one block to an SM,
// because blocks that are not in step overlap one's products with
// another's softmax.
constexpr int kFwdStages = 3, kFwdMinBlocks = 3;
constexpr int kDqStages = 3, kDqMinBlocks = 3;
constexpr int kKvStages = 3, kKvMinBlocks = 3;
constexpr float kLog2e = 1.4426950408889634f;

// queries of a tile that dk/dv walks: 64, or 32 at DP = 128 so that dK, dV,
// S and dP (160 fp32 a thread) stay in registers
template <int DP>
__host__ __device__ constexpr int query_tile() {
  return DP == 64 ? 64 : 32;
}

// 2^x and 1/x by the special-function unit (one instruction each; P and
// dS are rounded to bf16 after them)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bf16* align1024(unsigned char* raw) {
  return reinterpret_cast<bf16*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
}

// k-major descriptor of depth kk.. (a multiple of 16) of a swizzled
// [rows][DP] tile
__device__ __forceinline__ uint64_t k_desc(const bf16* tile, int rows,
                                           int kk) {
  return descriptor(tile + (kk >> 6) * rows * 64 + (kk & 63), 16);
}

// m/n-major descriptor of rows (the k of the product) k0.. of a swizzled
// [rows][DP] tile, its columns the product's n
__device__ __forceinline__ uint64_t mn_desc(const bf16* tile, int rows,
                                            int k0) {
  return descriptor(tile + k0 * 64, rows * 64 * sizeof(bf16));
}

// Quad reductions: the four threads of a quad (lane & 3) hold one
// fragment row between them.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * kBlockRows * DP + kDqStages * 2 * kKeys * DP) +
         sizeof(float) * (kDqStages * kKeys + kBlockRows) + 1024;
}

template <int DP>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (2 * kBlockRows * DP +
                         kKvStages * 2 * query_tile<DP>() * DP) +
         sizeof(float4) * kKvStages * query_tile<DP>() + 1024;
}

// Write a thread's share of a warpgroup's m64 x DP accumulator, times
// `scale`, as bf16 to rows r0 + frag_row(h) (below `rows`) of a row-major
// [rows][dh] array.
template <int DP>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[DP / 2],
                                          int r0, int rows, int dh,
                                          float scale) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + frag_row(h), c = frag_col(j);
      if (r < rows && c < dh)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * dh + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                  acc[4 * j + 2 * h + 1] * scale);
    }
}

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (kBlockRows * DP + kFwdStages * 2 * kKeys * DP) +
         sizeof(float) * kFwdStages * kKeys + 1024;
}

// The rows of a forward thread (fragment rows h = 0, 1): the running max m
// of s * scale over the valid keys (from -1e30), m * log2(e) rounded apart,
// this thread's share of the undropped sum l, the row's seed word.
struct FwdRows {
  int row[2];
  float m[2], ml[2], l[2];
  uint32_t seed[2];
};

// The online softmax over the key tile at k0, from S (s): the row max
// (quad shuffles), the rescale of l and of the O accumulator o by alpha,
// then the dropped weights P into s. EDGE: the tile may hold keys past Lk
// (absent) or, under the causal flag, keys past a row: absent under the
// streaming rule, masked under the fused rule (FUSED). A masked key enters
// at -1e30: exp(-1e30 - m) is 0 beside a valid key, and exactly 1 on a row
// with none (m = -1e30), whose weights are then uniform.
template <int DP, bool EDGE, bool FUSED>
__device__ __forceinline__ void fwd_scores(const Params& p, float (&s)[32],
                                           float (&o)[DP / 2], FwdRows& r,
                                           const float* pd, int k0,
                                           float scale_log2) {
  const float masked_log2 = kMasked * kLog2e;
  float smax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;   // 0 past Lk
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (pad_ok && (!EDGE || !p.causal || key <= r.row[h]))
          smax[h] = fmaxf(smax[h], s[4 * j + 2 * h + e]);
    }
  float alpha[2], masked[2], lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // max(s) * scale is the max of s * scale (rounding is monotone)
    const float m_new = fmaxf(r.m[h], quad_max(smax[h]) * p.scale);
    const float ml_new = __fmul_rn(m_new, kLog2e);
    alpha[h] = fast_exp2(__fsub_rn(r.ml[h], ml_new));
    r.m[h] = m_new;
    r.ml[h] = ml_new;
    // a masked key's exponent, subtracted plainly (no fused multiply-add)
    // so that it is exactly 0 where m = -1e30
    masked[h] = __fsub_rn(masked_log2, ml_new);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        const bool seen = !EDGE || !p.causal || key <= r.row[h];
        const bool exists = !EDGE || (key < p.lk && (FUSED || seen));
        // under the streaming rule a key that exists is seen
        const bool valid = FUSED ? pad_ok && seen : pad_ok;
        float w = 0.f;
        if (exists) {
          // one exponential a pair, of the valid or the masked exponent
          w = fast_exp2(valid ? fmaf(s[x], scale_log2, -r.ml[h])
                              : masked[h]);
          lsum[h] += w;
          if (p.dropout)
            w = zt::keep_key(r.seed[h], key, p.s1, p.threshold)
                    ? w * p.drop_scale : 0.f;
        }
        s[x] = w;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) r.l[h] = r.l[h] * alpha[h] + lsum[h];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= alpha[h];
      o[4 * j + 2 * h + 1] *= alpha[h];
    }
}

// o, m, l of 64 query rows; grid (ceil(Lq / kBlockRows), B*H)
template <int DP, bool FUSED>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kFwdMinBlocks : 1)
    forward_tc(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* ring = qs + kBlockRows * DP;              // slots of K, V [64][DP]
  float* pads = reinterpret_cast<float*>(ring + kFwdStages * 2 * kKeys * DP);
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int q0 = blockIdx.x * kBlockRows, dh = p.dh;
  const size_t qoff = (size_t)bh * p.lq * dh;
  const bf16* k = (const bf16*)p.k + (size_t)bh * p.lk * dh;
  const bf16* v = (const bf16*)p.v + (size_t)bh * p.lk * dh;
  const float* pad = p.pad + (size_t)b * p.lk;

  auto load = [&](int slot, int t) {
    const int k0 = t * kKeys;
    bf16* ks = ring + slot * 2 * kKeys * DP;
    load_tile<kKeys, DP, kThreadsTC>(ks, k, dh, k0, 0, p.lk, dh);
    load_tile<kKeys, DP, kThreadsTC>(ks + kKeys * DP, v, dh, k0, 0, p.lk, dh);
    if (tid < kKeys) {
      const bool ok = k0 + tid < p.lk;
      cp_async4(pads + slot * kKeys + tid, ok ? pad + k0 + tid : pad, ok);
    }
  };
  load_tile<kBlockRows, DP, kThreadsTC>(qs, (const bf16*)p.q + qoff, dh, q0,
                                        0, p.lq, dh);

  // causal: the walk stops at the diagonal tile; under the fused rule only
  // if row q0 (and with it every row of the block) has a valid key
  int k_end = p.causal ? min(p.lk, q0 + kBlockRows) : p.lk;
  if (FUSED && p.causal) {
    const int last = min(q0, p.lk - 1);
    int seen = 0;
    for (int j0 = 0; j0 <= last && !seen; j0 += kThreadsTC)
      seen = __syncthreads_or(j0 + tid <= last && pad[j0 + tid] > 0.f);
    if (!seen) k_end = p.lk;
  }
  const int tiles = (k_end + kKeys - 1) / kKeys;
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }

  const float scale_log2 = p.scale * kLog2e;
  FwdRows rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows.row[h] = q0 + frag_row(h);
    rows.m[h] = kMasked;
    rows.ml[h] = __fmul_rn(kMasked, kLog2e);
    rows.l[h] = 0.f;
    rows.seed[h] = row_seed(p, bh, rows.row[h]);
  }

  float s[32], o[DP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();
    fence_proxy_async();   // the copies, visible to the tensor cores
    __syncthreads();       // and the slot to refill has retired everywhere
    if (t + kFwdStages - 1 < tiles)
      load((t + kFwdStages - 1) % kFwdStages, t + kFwdStages - 1);
    cp_async_commit();
    const int slot = t % kFwdStages, k0 = t * kKeys;
    const bf16* ks = ring + slot * 2 * kKeys * DP;
    const bf16* vs = ks + kKeys * DP;

    // S = Q.K^T over this warpgroup's 64 rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss<64>(s, k_desc(qs, kBlockRows, kk), k_desc(ks, kKeys, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    // the tiles from the diagonal on under the causal flag and the tile
    // that straddles Lk take the edge rules; every other tile only the pad
    // mask
    if (k0 + kKeys > p.lk || (p.causal && k0 + kKeys - 1 > q0))
      fwd_scores<DP, true, FUSED>(p, s, o, rows, pads + slot * kKeys, k0,
                                  scale_log2);
    else
      fwd_scores<DP, false, FUSED>(p, s, o, rows, pads + slot * kKeys, k0,
                                   scale_log2);

    // O += P.V: P (bf16) from registers, V m/n-major (keys are the k)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(o, a[kk], mn_desc(vs, kKeys, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  // o = O / l; m and l apart, in the units the backward reads
  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(rows.l[h]);
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 2 * h] *= inv;
      o[4 * j + 2 * h + 1] *= inv;
    }
  }
  store_acc<DP>((bf16*)p.out + qoff, o, q0, p.lq, dh, 1.f);
  if ((tid & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows.row[h] < p.lq) {
        p.m[(size_t)bh * p.lq + rows.row[h]] = rows.m[h];
        p.l[(size_t)bh * p.lq + rows.row[h]] = l[h];
      }
  }
}

template <int DP, bool FUSED>
cudaError_t launch_forward_dp(const Params& p, int bh, cudaStream_t s) {
  cudaError_t err = allow_smem(forward_tc<DP, FUSED>, fwd_smem<DP>());
  if (err != cudaSuccess) return err;
  dim3 grid((p.lq + kBlockRows - 1) / kBlockRows, bh);
  forward_tc<DP, FUSED><<<grid, kThreadsTC, fwd_smem<DP>(), s>>>(p);
  return cudaGetLastError();
}

// The rows of a dq thread (fragment rows h = 0, 1).
struct DqRows {
  int row[2];
  bool row_in[2];
  float ml[2], inv_l[2], delta[2];
  uint32_t seed[2];
};

// dS (into s) at each fragment's (row, key) of the key tile at k0, from S
// (s) and dP (dp). EDGE: the tile may hold rows past Lq or, under the
// causal flag, keys past a row; else only the pad mask decides.
template <bool EDGE>
__device__ __forceinline__ void dq_scores(const Params& p, float (&s)[32],
                                          const float (&dp)[32],
                                          const float* pd, int k0,
                                          const DqRows& r, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;   // 0 past Lk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        const bool valid =
            pad_ok && (!EDGE || (r.row_in[h] &&
                                 (!p.causal || key <= r.row[h])));
        float ds = 0.f;
        if (valid) {
          const float w =
              fast_exp2(fmaf(s[x], scale_log2, -r.ml[h])) * r.inv_l[h];
          float dw = dp[x];
          if (p.dropout)
            dw = zt::keep_key(r.seed[h], key, p.s1, p.threshold)
                     ? dw * p.drop_scale : 0.f;
          ds = w * (dw - r.delta[h]);
        }
        s[x] = ds;
      }
    }
}

// delta = rowsum(dO * O) and dq; grid (ceil(Lq / kBlockRows), B*H). Both
// mask rules: dS is 0 at every masked entry, so the key tiles past the
// diagonal are skipped under the causal flag either way.
template <int DP>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kDqMinBlocks : 1)
    dq_tc(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* dos = qs + kBlockRows * DP;               // [kBlockRows][DP]
  bf16* ring = dos + kBlockRows * DP;             // slots of K, V [64][DP]
  float* pads = reinterpret_cast<float*>(ring + kDqStages * 2 * kKeys * DP);
  float* delta_s = pads + kDqStages * kKeys;      // [kBlockRows]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int q0 = blockIdx.x * kBlockRows, dh = p.dh;
  const size_t qoff = (size_t)bh * p.lq * dh;
  const bf16* q = (const bf16*)p.q + qoff;
  const bf16* o = (const bf16*)p.o + qoff;
  const bf16* dout = (const bf16*)p.dout + qoff;
  const bf16* k = (const bf16*)p.k + (size_t)bh * p.lk * dh;
  const bf16* v = (const bf16*)p.v + (size_t)bh * p.lk * dh;
  const float* pad = p.pad + (size_t)b * p.lk;
  const int k_end = p.causal ? min(p.lk, q0 + kBlockRows) : p.lk;
  const int tiles = (k_end + kKeys - 1) / kKeys;

  auto load = [&](int slot, int t) {
    const int k0 = t * kKeys;
    bf16* ks = ring + slot * 2 * kKeys * DP;
    load_tile<kKeys, DP, kThreadsTC>(ks, k, dh, k0, 0, p.lk, dh);
    load_tile<kKeys, DP, kThreadsTC>(ks + kKeys * DP, v, dh, k0, 0, p.lk, dh);
    if (tid < kKeys) {
      const bool ok = k0 + tid < p.lk;
      cp_async4(pads + slot * kKeys + tid, ok ? pad + k0 + tid : pad, ok);
    }
  };
  load_tile<kBlockRows, DP, kThreadsTC>(qs, q, dh, q0, 0, p.lq, dh);
  load_tile<kBlockRows, DP, kThreadsTC>(dos, dout, dh, q0, 0, p.lq, dh);
#pragma unroll
  for (int s = 0; s < kDqStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }

  // delta: each warp sums its share of the block's rows in fp32
  constexpr int kRowsPerWarp = kBlockRows / (kThreadsTC / 32);
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    const int i = q0 + r;
    float part = 0.f;
    if (i < p.lq) {
      for (int d = 2 * lane; d < dh; d += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + (size_t)i * dh + d));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)i * dh +
                                                      d));
        part += a.x * c.x + a.y * c.y;
      }
    }
    part = zt::warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      if (i < p.lq) p.delta[(size_t)bh * p.lq + i] = part;
    }
  }
  __syncthreads();

  const float scale_log2 = p.scale * kLog2e;
  DqRows rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = frag_row(h), i = q0 + r;
    const bool in = i < p.lq;
    const size_t gi = (size_t)bh * p.lq + (in ? i : 0);
    rows.row[h] = i;
    rows.row_in[h] = in;
    rows.ml[h] = in ? __fmul_rn(p.m[gi], kLog2e) : 0.f;
    rows.inv_l[h] = in ? 1.f / p.l[gi] : 0.f;
    rows.delta[h] = delta_s[r];
    rows.seed[h] = row_seed(p, bh, i);
  }
  const bool rows_edge = q0 + kBlockRows > p.lq;

  float s[32], dp[32], dq[DP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kDqStages - 2>();
    fence_proxy_async();   // the copies, visible to the tensor cores
    __syncthreads();       // and the slot to refill has retired everywhere
    if (t + kDqStages - 1 < tiles)
      load((t + kDqStages - 1) % kDqStages, t + kDqStages - 1);
    cp_async_commit();
    const int slot = t % kDqStages, k0 = t * kKeys;
    const bf16* ks = ring + slot * 2 * kKeys * DP;
    const bf16* vs = ks + kKeys * DP;

    // S = Q.K^T, dP = dO.V^T over this warpgroup's 64 rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wgmma_ss<64>(s, k_desc(qs, kBlockRows, kk),
                   k_desc(ks, kKeys, kk), kk > 0);
      wgmma_ss<64>(dp, k_desc(dos, kBlockRows, kk),
                   k_desc(vs, kKeys, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (rows_edge || (p.causal && k0 + kKeys - 1 > q0))
      dq_scores<true>(p, s, dp, pads + slot * kKeys, k0, rows, scale_log2);
    else
      dq_scores<false>(p, s, dp, pads + slot * kKeys, k0, rows, scale_log2);

    // dQ += dS.K: dS from registers, K m/n-major (keys are the k)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dq, a[kk], mn_desc(ks, kKeys, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  store_acc<DP>((bf16*)p.out + qoff, dq, q0, p.lq, dh, p.scale);
}

// The keys of a dk/dv thread (fragment rows h = 0, 1).
struct DkvKeys {
  int key[2];
  bool key_in[2], pad_ok[2];
};

// P_drop^T (into dp) and dS^T (into s) at each fragment's (key, query row)
// of the query tile at qt0, whose rows' m, l, delta and seed are st[]. EDGE:
// the tile may hold rows past Lq or, under the causal flag, rows before a
// key; else each key exists for every row. FUSED: such a key exists,
// masked (the fused rule); else it is absent (the streaming rule).
template <int BQ, bool EDGE, bool FUSED>
__device__ __forceinline__ void dkdv_scores(const Params& p,
                                            float (&s)[BQ / 2],
                                            float (&dp)[BQ / 2],
                                            const float4* st, int qt0,
                                            const DkvKeys& kv,
                                            float scale_log2) {
  const float masked_log2 = kMasked * kLog2e;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, i = qt0 + c;
      const float4 r = st[c];
      // rounded apart (no fused multiply-add), so that on a row whose keys
      // are all padded (m = -1e30) the masked exponent is exactly 0
      const float ml = __fmul_rn(r.x, kLog2e), inv_l = fast_rcp(r.y);
      const uint32_t seed = __float_as_uint(r.w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        const bool seen = !EDGE || !p.causal || kv.key[h] <= i;
        const bool exists =
            kv.key_in[h] && (!EDGE || i < p.lq) && (FUSED || seen);
        const bool valid = exists && seen && kv.pad_ok[h];
        float wd = 0.f, ds = 0.f;
        if (exists) {
          const float w =
              fast_exp2((valid ? s[x] * scale_log2 : masked_log2) - ml) *
              inv_l;
          const bool keep =
              !p.dropout || zt::keep_key(seed, kv.key[h], p.s1, p.threshold);
          wd = keep ? w * p.drop_scale : 0.f;
          if (valid) ds = w * ((keep ? dp[x] * p.drop_scale : 0.f) - r.z);
        }
        s[x] = ds;
        dp[x] = wd;
      }
    }
}

// dk, dv; grid (ceil(Lk / kBlockRows), B*H); reads delta from dq_tc
template <int DP, bool FUSED>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kKvMinBlocks : 1)
    dkdv_tc(Params p) {
  constexpr int BQ = query_tile<DP>();
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* vs = ks + kBlockRows * DP;                // [kBlockRows][DP]
  bf16* ring = vs + kBlockRows * DP;              // slots of Q, dO [BQ][DP]
  // per query row of a slot: m, l, delta and the row's seed word
  float4* stats =
      reinterpret_cast<float4*>(ring + kKvStages * 2 * BQ * DP);
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int k0 = blockIdx.x * kBlockRows, dh = p.dh;
  const size_t qoff = (size_t)bh * p.lq * dh;
  const size_t koff = (size_t)bh * p.lk * dh;
  const bf16* q = (const bf16*)p.q + qoff;
  const bf16* dout = (const bf16*)p.dout + qoff;
  const float* pad = p.pad + (size_t)b * p.lk;
  // causal: the first query tile holding a row that sees key k0
  const int t_diag = p.causal ? k0 / BQ : 0;
  const int tiles = (p.lq + BQ - 1) / BQ;
  // the fused rule: first the n_pre tiles above the diagonal that hold a
  // row with no valid key (the first rows; one vote for each tile's first
  // row), then the tiles from the diagonal on
  int n_pre = 0;
  if (FUSED) {
    for (int t = 0; t < t_diag; t += kThreadsTC) {
      const int i = (t + tid) * BQ;
      n_pre += __syncthreads_count(
          t + tid < t_diag && i < p.lq &&
          p.m[(size_t)bh * p.lq + i] == kMasked);
    }
  }
  const int walk = n_pre + tiles - t_diag;
  auto tile_of = [&](int u) { return u < n_pre ? u : t_diag + u - n_pre; };

  auto load = [&](int slot, int u) {
    const int qt0 = tile_of(u) * BQ;
    bf16* qsl = ring + slot * 2 * BQ * DP;
    load_tile<BQ, DP, kThreadsTC>(qsl, q, dh, qt0, 0, p.lq, dh);
    load_tile<BQ, DP, kThreadsTC>(qsl + BQ * DP, dout, dh, qt0, 0, p.lq, dh);
    if (tid < BQ) {
      const int i = qt0 + tid;
      const bool in = i < p.lq;
      const size_t gi = (size_t)bh * p.lq + (in ? i : 0);
      float4* st = stats + slot * BQ + tid;
      cp_async4(&st->x, p.m + gi, in);
      cp_async4(&st->y, p.l + gi, in);
      cp_async4(&st->z, p.delta + gi, in);
      st->w = __uint_as_float(row_seed(p, bh, i));
    }
  };
  load_tile<kBlockRows, DP, kThreadsTC>(ks, (const bf16*)p.k + koff, dh, k0,
                                        0, p.lk, dh);
  load_tile<kBlockRows, DP, kThreadsTC>(vs, (const bf16*)p.v + koff, dh, k0,
                                        0, p.lk, dh);
#pragma unroll
  for (int s = 0; s < kKvStages - 1; ++s) {
    if (s < walk) load(s, s);
    cp_async_commit();
  }

  const float scale_log2 = p.scale * kLog2e;
  DkvKeys kv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kv.key[h] = k0 + frag_row(h);
    kv.key_in[h] = kv.key[h] < p.lk;
    kv.pad_ok[h] = kv.key_in[h] && pad[kv.key_in[h] ? kv.key[h] : 0] > 0.f;
  }

  float s[BQ / 2], dp[BQ / 2], dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int u = 0; u < walk; ++u) {
    const int qt0 = tile_of(u) * BQ;
    cp_async_wait<kKvStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (u + kKvStages - 1 < walk)
      load((u + kKvStages - 1) % kKvStages, u + kKvStages - 1);
    cp_async_commit();
    const int slot = u % kKvStages;
    const bf16* qsl = ring + slot * 2 * BQ * DP;
    const bf16* dosl = qsl + BQ * DP;

    // S^T = K.Q^T, dP^T = V.dO^T over this warpgroup's 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wgmma_ss<BQ>(s, k_desc(ks, kBlockRows, kk),
                   k_desc(qsl, BQ, kk), kk > 0);
      wgmma_ss<BQ>(dp, k_desc(vs, kBlockRows, kk),
                   k_desc(dosl, BQ, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (qt0 + BQ > p.lq || (p.causal && qt0 < k0 + kBlockRows - 1))
      dkdv_scores<BQ, true, FUSED>(p, s, dp, stats + slot * BQ, qt0, kv,
                                   scale_log2);
    else
      dkdv_scores<BQ, false, FUSED>(p, s, dp, stats + slot * BQ, qt0, kv,
                                    scale_log2);

    // dV += P_drop^T.dO, dK += dS^T.Q: A from registers, B m/n-major
    uint32_t ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(dp, kk, ap[kk]);
      acc_to_a(s, kk, as[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<DP>(dv, ap[kk], mn_desc(dosl, BQ, 16 * kk), 1);
      wgmma_rs<DP>(dk, as[kk], mn_desc(qsl, BQ, 16 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  store_acc<DP>((bf16*)p.dk + koff, dk, k0, p.lk, dh, p.scale);
  store_acc<DP>((bf16*)p.dv + koff, dv, k0, p.lk, dh, 1.f);
}

template <int DP, bool FUSED>
cudaError_t launch_backward_dp(const Params& p, int bh, bool dkdv,
                               cudaStream_t s) {
  cudaError_t err;
  if (!dkdv) {
    err = allow_smem(dq_tc<DP>, dq_smem<DP>());
    if (err != cudaSuccess) return err;
    dim3 grid((p.lq + kBlockRows - 1) / kBlockRows, bh);
    dq_tc<DP><<<grid, kThreadsTC, dq_smem<DP>(), s>>>(p);
  } else {
    err = allow_smem(dkdv_tc<DP, FUSED>, dkdv_smem<DP>());
    if (err != cudaSuccess) return err;
    dim3 grid((p.lk + kBlockRows - 1) / kBlockRows, bh);
    dkdv_tc<DP, FUSED><<<grid, kThreadsTC, dkdv_smem<DP>(), s>>>(p);
  }
  return cudaGetLastError();
}

// Whether the tensor-core kernels take a launch: bf16 (dtype 1), head
// depth a multiple of 16 up to 128.
inline bool takes(int dtype, int dh) {
  return dtype == 1 && dh % 16 == 0 && dh <= 128;
}

// o, m, l (p.out, p.m, p.l) under the mask rule FUSED; a launch the
// kernels do not take returns cudaErrorInvalidValue
template <bool FUSED>
int run_forward(const Params& p, int dtype, int bh, void* stream) {
  if (!takes(dtype, p.dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.dh <= 64 ? launch_forward_dp<64, FUSED>(p, bh, s)
                          : launch_forward_dp<128, FUSED>(p, bh, s));
}

// dq (dkdv false) or dk/dv (dkdv true) under the mask rule FUSED; a launch
// the kernels do not take returns cudaErrorInvalidValue
template <bool FUSED>
int run_backward(const Params& p, int dtype, int bh, bool dkdv,
                 void* stream) {
  if (!takes(dtype, p.dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.dh <= 64 ? launch_backward_dp<64, FUSED>(p, bh, dkdv, s)
                          : launch_backward_dp<128, FUSED>(p, bh, dkdv, s));
}

}  // namespace tc
}  // namespace zt
