// Attention code shared by the port's attention libraries
// (streaming_attention.cu, fused_attention.cu, fused_attention_rpr.cu): the
// launch parameters, the row seed of the dropout mask, and in namespace tc
// the bf16 tensor-core forward and backward, FlashAttention-2 style, that
// they run:
//
//   forward_tc  #5, and #1: the online softmax over 64-key tiles; writes o
//               and the row statistics m and l apart.
//   dq_tc       #6, and #2's first half: delta = rowsum(dO * O), then dq
//               over the key tiles.
//   dkdv_tc     #7, and #2's second half: a block owns 64 keys and walks
//               the query tiles for dk and dv.
//   All three take a policy: NoRpr (the default) or Rpr, which adds Shaw's
//   relative-position terms: in forward_tc #3 (q.Tk before the walk, the
//   bucket sums of P_drop in it, wb.Tv after it), in dq_tc and dkdv_tc #4
//   (the same terms, the bucket sums of dS and the table gradients; see Rpr
//   below).
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
//   P and dS (and under Rpr the bucket sums wb and ds_b) are rounded to
//   bf16 as the products' A operands, as in every FlashAttention kernel
//   (the JAX kernels multiply the weights in fp32); everything else stays
//   fp32.
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
  // Shaw RPR (the Rpr policy; fused_attention_rpr.cu): tables tk, tv [R,
  // Dh] bf16, R = 2 rel + 1; for dq_tc and dkdv_tc, fp32 scratch qd [B*H,
  // Lq, R] of pairs (q.Tk^T, do.Tv^T) and fp32 table-gradient partials
  // part_tk, part_tv [dq blocks, R, Dh]
  const void* tk;
  const void* tv;
  float2* qd;
  float* part_tk;
  float* part_tv;
  int rel;
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
// S and dP (160 fp32 a thread) stay in registers, and under the Rpr policy
// (POL::kOn), whose terms need registers beside them (at 64 rows ptxas
// spilled 528 bytes)
template <int DP, class POL>
__host__ __device__ constexpr int query_tile() {
  return DP == 64 && !POL::kOn ? 64 : 32;
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

// The policy of forward_tc, dq_tc and dkdv_tc. NoRpr: plain attention (#1,
// #2, #5, #6, #7); its code paths are those of the kernels without a
// policy. Rpr: Shaw's relative positions (#3, #4), the terms below.
struct NoRpr {
  static constexpr bool kOn = false;
  __host__ __device__ static constexpr size_t fwd_smem(int) { return 0; }
  __host__ __device__ static constexpr size_t dq_smem(int) { return 0; }
  template <int DP>
  __host__ __device__ static constexpr size_t kv_smem() { return 0; }
};

struct Rpr {
  static constexpr bool kOn = true;
  // forward: qr of the block's 64 rows, fp32 [64][R], which the walk's
  // interior buckets reuse as their scratch (rpr_fwd_scores)
  __host__ __device__ static constexpr size_t fwd_smem(int rel) {
    return sizeof(float) * kBlockRows * (2 * rel + 1);
  }
  // dq: the bucket sums (wb, ds_b) of the block's 64 rows as bf16 pairs
  // [64][R]
  __host__ __device__ static constexpr size_t dq_smem(int rel) {
    return sizeof(__nv_bfloat162) * kBlockRows * (2 * rel + 1);
  }
  // dk/dv: each ring slot's per-query-row terms (qr, dwb) at the edge
  // buckets 0 and 2 rel
  template <int DP>
  __host__ __device__ static constexpr size_t kv_smem() {
    return sizeof(float4) * kKvStages * query_tile<DP, Rpr>();
  }
};

// ---------------------------------------------------------------------------
// The Rpr policy (#3, #4). With c(i, j) = clip(i - j, -rel, rel) + rel,
// R = 2 rel + 1 buckets and the tables Tk, Tv [R, Dh]:
//   S += qr[i, c(i, j)] (qr = Q.Tk^T),  dP += dwb[i, c(i, j)] (dwb = dO.Tv^T),
//   wb[i, c] = sum_{j: c(i,j) = c} P_drop,  ds_b[i, c] = the same sum of dS,
//   o += wb.Tv,  dq += ds_b.Tk,  dTk = scale * sum_i ds_b^T q,
//   dTv = sum_i wb^T dO.
// A 64 x 64 tile that lies wholly outside the band |i - j| <= rel has one
// bucket everywhere (2 rel left of the band, 0 right of it): there the
// terms are per-row constants and the bucket sums row sums. Only the tiles
// that meet the band index buckets per element, and only their interior
// buckets (0 < c < 2 rel) read the scratch per element; the edge buckets'
// terms come once per tile. An interior bucket of a row gets exactly one
// key (j = i - c + rel), so its bucket sum is that key's value, a plain
// store. The small products (qr before the forward walk and wb.Tv after
// it; qr, dwb before the dq walk, ds_b.Tk, ds_b^T.Q, wb^T.dO after it) are
// wgmma tiles of 64 buckets, the tables staged in a ring slot as a K or a
// V tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int rpr_bucket(int i, int j, int rel) {
  return min(max(i - j, -rel), rel) + rel;
}

// The one bucket of a tile of query rows r0 .. r0 + rows - 1 and keys c0 ..
// c0 + keys - 1 that lies outside the band (2 rel or 0), or -1 where it
// meets the band.
__device__ __forceinline__ int rpr_tile_bucket(int r0, int rows, int c0,
                                               int keys, int rel) {
  if (r0 - (c0 + keys - 1) > rel) return 2 * rel;
  if (c0 - (r0 + rows - 1) > rel) return 0;
  return -1;
}

// A valid score under the Rpr policy, S + qr[i, c(i, j)], and its exponent
// in log2 units against the row max (ml = m * log2(e)). forward_tc and
// dq_tc form both through these two functions from the same fp32 S and qr
// of the same wgmma instructions, so #4 rebuilds as exp(s - m) / l exactly
// the weights #3 normalised.
__device__ __forceinline__ float rpr_score(float s, float qr) {
  return s + qr;
}

__device__ __forceinline__ float rpr_exponent(float score, float scale_log2,
                                              float ml) {
  return fmaf(score, scale_log2, -ml);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * kBlockRows * DP + kDqStages * 2 * kKeys * DP) +
         sizeof(float) * (kDqStages * kKeys + kBlockRows) + 1024;
}

template <int DP, class POL>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (2 * kBlockRows * DP +
                         kKvStages * 2 * query_tile<DP, POL>() * DP) +
         sizeof(float4) * kKvStages * query_tile<DP, POL>() + 1024;
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

// The forward under the Rpr policy (#3). Each block keeps qr = Q.Tk^T of
// its 64 rows in shared memory (fp32 [64][R]); each tile reads its rows' qr
// at the edge buckets into registers once (held through the walk they made
// ptxas spill at the 168 registers of three blocks an SM). The bucket sums
// of P_drop: the edge
// buckets' are row sums in registers, rescaled by alpha with l; an interior
// bucket's one key leaves its score in the qr scratch, over the qr it was
// formed from (read there first, in the same statement, and never again),
// and after the walk becomes exp2 of its exponent against the row's final
// max, dropped by the key's keep bit. So no [64][R] array is rescaled, and
// no element pays a reduction.

// forward_tc's Rpr state of a thread's rows (fragment rows h = 0, 1): its
// share of the rows' bucket sums of P_drop at the edge buckets 0 (wlo) and
// 2 rel (whi).
struct RprFwdRows {
  float wlo[2], whi[2];
};

// What an interior bucket's scratch entry holds for a masked key (its
// weight is then the masked exponent's); a valid key leaves its score.
constexpr float kRprMaskedKey = INFINITY;

// Before the forward walk: qr = Q.Tk^T of the block's rows into the scratch
// qr (S serves as the accumulator), Tk staged 64 buckets at a time in
// `slot` as a K tile. Its first 64 buckets came with Q, in the commit group
// ahead of the walk's first key tiles, which stay in flight behind this.
// Then the edge buckets' sums zeroed.
template <int DP>
__device__ __forceinline__ void rpr_fwd_prologue(const Params& p,
                                                 const bf16* qs, bf16* slot,
                                                 float* qr, float (&s)[32],
                                                 RprFwdRows& x) {
  const int nb = 2 * p.rel + 1;
  for (int c0 = 0; c0 < nb; c0 += kKeys) {
    if (c0 == 0) {
      cp_async_wait<kFwdStages - 1>();   // Q and the first 64 buckets
    } else {
      __syncthreads();   // the last chunk's products are done
      load_tile<kKeys, DP, kThreadsTC>(slot, (const bf16*)p.tk, p.dh, c0, 0,
                                       nb, p.dh);
      cp_async_commit();
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss<64>(s, k_desc(qs, kBlockRows, kk), k_desc(slot, kKeys, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + frag_col(j) + e;
          if (c < nb) qr[frag_row(h) * nb + c] = s[4 * j + 2 * h + e];
        }
  }
  __syncthreads();   // the scratch complete; the slot free for the walk
#pragma unroll
  for (int h = 0; h < 2; ++h) x.wlo[h] = x.whi[h] = 0.f;
}

// fwd_scores under the Rpr policy and the fused mask rule: the scores S +
// qr (BAND: the tile meets the band, and an interior bucket's qr is read
// from the scratch per element and replaced by the key's score; else the
// tile's one bucket is ce), the online softmax over them, the dropped
// weights P into s, and the edge buckets' sums of P_drop. (The interior
// store sits in the first pass, so that no scratch address lives into the
// second: beside S and O they made ptxas spill.)
template <int DP, bool EDGE, bool BAND>
__device__ __forceinline__ void rpr_fwd_scores(const Params& p,
                                               float (&s)[32],
                                               float (&o)[DP / 2],
                                               FwdRows& r, RprFwdRows& x,
                                               float* qr, const float* pd,
                                               int k0, int ce,
                                               float scale_log2) {
  const float masked_log2 = kMasked * kLog2e;
  const int nb = 2 * p.rel + 1, top = 2 * p.rel;
  float* const row_qr[2] = {qr + frag_row(0) * nb, qr + frag_row(1) * nb};
  float lo[2], hi[2];   // qr at the edge buckets
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = row_qr[h][0];
    hi[h] = row_qr[h][top];
  }
  float smax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;   // 0 past Lk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        const bool valid = pad_ok && (!EDGE || !p.causal || key <= r.row[h]);
        if (BAND) {
          const int b = rpr_bucket(r.row[h], key, p.rel);
          if (b == 0 || b == top) {
            s[i] = rpr_score(s[i], b == 0 ? lo[h] : hi[h]);
          } else {
            s[i] = rpr_score(s[i], row_qr[h][b]);
            if (!EDGE || key < p.lk)
              row_qr[h][b] = valid ? s[i] : kRprMaskedKey;
          }
        } else {
          s[i] = rpr_score(s[i], ce == 0 ? lo[h] : hi[h]);
        }
        if (valid) smax[h] = fmaxf(smax[h], s[i]);
      }
    }
  float alpha[2], masked[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(r.m[h], quad_max(smax[h]) * p.scale);
    const float ml_new = __fmul_rn(m_new, kLog2e);
    alpha[h] = fast_exp2(__fsub_rn(r.ml[h], ml_new));
    r.m[h] = m_new;
    r.ml[h] = ml_new;
    masked[h] = __fsub_rn(masked_log2, ml_new);
  }
  float lsum[2] = {0.f, 0.f}, wlo[2] = {0.f, 0.f}, whi[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        const bool seen = !EDGE || !p.causal || key <= r.row[h];
        const bool exists = !EDGE || key < p.lk;
        const bool valid = pad_ok && seen;
        float w = 0.f;
        if (exists) {
          w = fast_exp2(valid ? rpr_exponent(s[i], scale_log2, r.ml[h])
                              : masked[h]);
          lsum[h] += w;
          if (p.dropout)
            w = zt::keep_key(r.seed[h], key, p.s1, p.threshold)
                    ? w * p.drop_scale : 0.f;
        }
        if (!BAND) {
          wlo[h] += w;   // the tile's one bucket, ce: moved below
        } else {
          const int b = rpr_bucket(r.row[h], key, p.rel);
          if (b == 0)
            wlo[h] += w;
          else if (b == top)
            whi[h] += w;
        }
        s[i] = w;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!BAND && ce != 0) {
      whi[h] = wlo[h];
      wlo[h] = 0.f;
    }
    r.l[h] = r.l[h] * alpha[h] + lsum[h];
    x.wlo[h] = x.wlo[h] * alpha[h] + wlo[h];
    x.whi[h] = x.whi[h] * alpha[h] + whi[h];
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= alpha[h];
      o[4 * j + 2 * h + 1] *= alpha[h];
    }
}

// After the forward walk: O += wb.Tv by wgmma, 64 buckets a step, wb the
// register A operand (rounded to bf16, as #4 rounds wb) and Tv staged in
// `slot` as a V tile read m/n-major; its first 64 buckets were issued there
// during the last key tile. wb is in the units of the rows' final
// max, as O is: the edge buckets' sums from x (quad sums); an interior
// bucket c of row i from the scratch, exp2 of its one key's exponent against
// the final max, times 1/(1 - p) or 0 by the key's keep bit. That key, j =
// i - c + rel, weighs 0 where it does not exist or the walk did not reach it
// (j < 0, j >= key_end: past Lk, or past the causal stop, where it is masked
// for a row with a valid key).
template <int DP>
__device__ __forceinline__ void rpr_fwd_finish(const Params& p,
                                               const FwdRows& r,
                                               const RprFwdRows& x,
                                               const float* qr, int key_end,
                                               float scale_log2, bf16* slot,
                                               float (&o)[DP / 2]) {
  const float masked_log2 = kMasked * kLog2e;
  const int nb = 2 * p.rel + 1, top = 2 * p.rel;
  float wl[2], wh[2], masked[2];
  const float* row_qr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wl[h] = quad_sum(x.wlo[h]);
    wh[h] = quad_sum(x.whi[h]);
    masked[h] = __fsub_rn(masked_log2, r.ml[h]);
    row_qr[h] = qr + frag_row(h) * nb;
  }
  // bucket c of fragment row h, without branches but on the dropout flag:
  // an interior bucket's weight is formed at every column and kept where
  // its key was reached and kept (an early-return form ran slower on the
  // card: PERF.md, Findings)
  auto weight = [&](int h, int c) {
    const int j = r.row[h] + p.rel - c;
    const float u = row_qr[h][min(c, nb - 1)];
    const bool in = c > 0 && c < top && (unsigned)j < (unsigned)key_end &&
                    (!p.dropout ||
                     zt::keep_key(r.seed[h], j, p.s1, p.threshold));
    const float w = fast_exp2(u == kRprMaskedKey
                                  ? masked[h]
                                  : rpr_exponent(u, scale_log2, r.ml[h])) *
                    p.drop_scale;
    return c == 0 ? wl[h] : c == top ? wh[h] : in ? w : 0.f;
  };
  for (int c0 = 0; c0 < nb; c0 += kKeys) {
    // the scratch complete, and the walk's (or the last chunk's) products
    // done with the slot
    __syncthreads();
    if (c0 > 0) {
      load_tile<kKeys, DP, kThreadsTC>(slot, (const bf16*)p.tv, p.dh, c0, 0,
                                       nb, p.dh);
      cp_async_commit();
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    // the weights of the k16 steps that hold a bucket below R; a step past
    // R is zero (and still issued: a wgmma under a branch serialises them)
    const int steps = (nb - c0 + 15) / 16;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + frag_col(2 * kk + (q >> 1)), h = q & 1;
        a[kk][q] = kk < steps ? pack_bf16(weight(h, c), weight(h, c + 1))
                              : 0u;
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(o, a[kk], mn_desc(slot, kKeys, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait_all();
  }
}

// o, m, l of 64 query rows; grid (ceil(Lq / kBlockRows), B*H). POL = Rpr
// (the fused rule only) adds the RPR terms.
template <int DP, bool FUSED, class POL = NoRpr>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kFwdMinBlocks : 1)
    forward_tc(Params p) {
  static_assert(FUSED || !POL::kOn, "Rpr takes the fused mask rule");
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* ring = qs + kBlockRows * DP;              // slots of K, V [64][DP]
  float* pads = reinterpret_cast<float*>(ring + kFwdStages * 2 * kKeys * DP);
  // Rpr: qr of the block's rows, fp32 [kBlockRows][R]
  float* qr = pads + kFwdStages * kKeys;
  // Rpr: Tk's 64-bucket tiles, in the ring's last slot, which the walk
  // first loads after the prologue
  bf16* table_slot = ring + (kFwdStages - 1) * 2 * kKeys * DP;
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
  if constexpr (POL::kOn) {
    // Tk's first 64 buckets, in one commit group with Q
    load_tile<kKeys, DP, kThreadsTC>(table_slot, (const bf16*)p.tk, dh, 0, 0,
                                     2 * p.rel + 1, dh);
    cp_async_commit();
  }

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
  RprFwdRows rpr;
  if constexpr (POL::kOn)
    rpr_fwd_prologue<DP>(p, qs, table_slot, qr, s, rpr);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();
    fence_proxy_async();   // the copies, visible to the tensor cores
    __syncthreads();       // and the slot to refill has retired everywhere
    if (t + kFwdStages - 1 < tiles)
      load((t + kFwdStages - 1) % kFwdStages, t + kFwdStages - 1);
    else if (POL::kOn && t == tiles - 1)   // Tv's first 64 buckets
      load_tile<kKeys, DP, kThreadsTC>(
          ring + (t + kFwdStages - 1) % kFwdStages * 2 * kKeys * DP,
          (const bf16*)p.tv, dh, 0, 0, 2 * p.rel + 1, dh);
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
    const bool edge = k0 + kKeys > p.lk || (p.causal && k0 + kKeys - 1 > q0);
    if constexpr (POL::kOn) {
      const int ce = rpr_tile_bucket(q0, kBlockRows, k0, kKeys, p.rel);
      const float* pd = pads + slot * kKeys;
      if (ce < 0) {
        if (edge)
          rpr_fwd_scores<DP, true, true>(p, s, o, rows, rpr, qr, pd, k0, ce,
                                         scale_log2);
        else
          rpr_fwd_scores<DP, false, true>(p, s, o, rows, rpr, qr, pd, k0, ce,
                                          scale_log2);
      } else {
        if (edge)
          rpr_fwd_scores<DP, true, false>(p, s, o, rows, rpr, qr, pd, k0, ce,
                                          scale_log2);
        else
          rpr_fwd_scores<DP, false, false>(p, s, o, rows, rpr, qr, pd, k0,
                                           ce, scale_log2);
      }
    } else {
      if (edge)
        fwd_scores<DP, true, FUSED>(p, s, o, rows, pads + slot * kKeys, k0,
                                    scale_log2);
      else
        fwd_scores<DP, false, FUSED>(p, s, o, rows, pads + slot * kKeys, k0,
                                     scale_log2);
    }

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
  if constexpr (POL::kOn)   // Tv where the last tile put it
    rpr_fwd_finish<DP>(
        p, rows, rpr, qr, min(p.lk, tiles * kKeys), scale_log2,
        ring + (tiles + kFwdStages - 2) % kFwdStages * 2 * kKeys * DP, o);

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

template <int DP, bool FUSED, class POL>
cudaError_t launch_forward_dp(const Params& p, int bh, cudaStream_t s) {
  const size_t bytes = fwd_smem<DP>() + POL::fwd_smem(p.rel);
  cudaError_t err = allow_smem(forward_tc<DP, FUSED, POL>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.lq + kBlockRows - 1) / kBlockRows, bh);
  forward_tc<DP, FUSED, POL><<<grid, kThreadsTC, bytes, s>>>(p);
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

// The Rpr policy's backward (#4): dq_tc reads qr and dwb from its own
// prologue, dk/dv from the fp32 scratch of pairs that dq writes.

// The (qr, dwb) pair of bucket b of a row: the edge buckets' pairs lo (b =
// 0) and hi (b = 2 rel) are given, an interior one is read from the row's
// scratch qd.
__device__ __forceinline__ float2 rpr_terms(const float2* qd, int b,
                                            int rel, float2 lo, float2 hi) {
  return b == 0 ? lo : b == 2 * rel ? hi : qd[b];
}

// A dq thread's sums over its rows' edge buckets, 0 (lo) and 2 rel (hi),
// kept in registers through the walk: of P_drop (w) and of dS (d). In the
// band an interior bucket of a row gets exactly one key, so its value is a
// plain shared-memory store.
struct RprSums {
  float wlo[2], whi[2], dlo[2], dhi[2];
};

// Two bf16 as one wgmma A-operand word, the first low.
__device__ __forceinline__ uint32_t bf16_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Before the dq walk: qr and dwb of the block's rows into the scratch (S
// and dP serve as the accumulators), the tables staged 64 buckets at a time
// in the ring's last slot, whose first tile the walk loads only after this;
// then the bucket sums zeroed.
template <int DP>
__device__ __forceinline__ void rpr_dq_prologue(const Params& p, int bh,
                                                int q0, const bf16* qs,
                                                const bf16* dos, bf16* slot,
                                                __nv_bfloat162* sums,
                                                float (&s)[32],
                                                float (&dp)[32]) {
  const int nb = 2 * p.rel + 1, dh = p.dh;
  bf16* tks = slot;
  bf16* tvs = slot + kKeys * DP;
  for (int c0 = 0; c0 < nb; c0 += kKeys) {
    if (c0 > 0) __syncthreads();   // the last chunk's products are done
    load_tile<kKeys, DP, kThreadsTC>(tks, (const bf16*)p.tk, dh, c0, 0, nb,
                                     dh);
    load_tile<kKeys, DP, kThreadsTC>(tvs, (const bf16*)p.tv, dh, c0, 0, nb,
                                     dh);
    cp_async_commit();
    cp_async_wait<0>();   // with Q, dO and the first key tiles
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wgmma_ss<64>(s, k_desc(qs, kBlockRows, kk), k_desc(tks, kKeys, kk),
                   kk > 0);
      wgmma_ss<64>(dp, k_desc(dos, kBlockRows, kk), k_desc(tvs, kKeys, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = q0 + frag_row(h), c = c0 + frag_col(j) + e;
          if (i < p.lq && c < nb)
            p.qd[((size_t)bh * p.lq + i) * nb + c] = make_float2(
                s[4 * j + 2 * h + e], dp[4 * j + 2 * h + e]);
        }
  }
  uint32_t* z = reinterpret_cast<uint32_t*>(sums);
  for (int e = threadIdx.x; e < kBlockRows * nb; e += kThreadsTC) z[e] = 0u;
  __syncthreads();   // the scratch and the zeros, visible; the slot free
}

// dq_scores with the RPR terms, and the bucket sums of the tile at k0. BAND:
// the tile meets the band (buckets per element); else its one bucket is ce.
template <bool EDGE, bool BAND>
__device__ __forceinline__ void rpr_dq_scores(
    const Params& p, float (&s)[32], const float (&dp)[32], const float* pd,
    int k0, const DqRows& r, float scale_log2, int bh, int q0, int ce,
    RprSums& sum, __nv_bfloat162* sums) {
  const float masked_log2 = kMasked * kLog2e;
  const int nb = 2 * p.rel + 1;
  const float2* qd[2];
  float2 lo[2], hi[2];
  float wsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qd[h] = p.qd + ((size_t)bh * p.lq + (r.row_in[h] ? r.row[h] : 0)) * nb;
    if (BAND) {
      lo[h] = qd[h][0];
      hi[h] = qd[h][2 * p.rel];
    } else {
      lo[h] = hi[h] = qd[h][ce];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, key = k0 + c;
      const bool pad_ok = pd[c] > 0.f;   // 0 past Lk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        // a key that exists enters wb, valid or masked: an all-pad row
        // (m = -1e30) gets 1/l from every key
        const bool exists = !EDGE || (r.row_in[h] && key < p.lk);
        const bool valid =
            pad_ok && (!EDGE || (r.row_in[h] &&
                                 (!p.causal || key <= r.row[h])));
        const int b = BAND ? rpr_bucket(r.row[h], key, p.rel) : ce;
        float wd = 0.f, ds = 0.f;
        if (exists) {
          const float2 t =
              BAND ? rpr_terms(qd[h], b, p.rel, lo[h], hi[h]) : lo[h];
          const float w =
              fast_exp2(valid ? rpr_exponent(rpr_score(s[x], t.x),
                                             scale_log2, r.ml[h])
                              : __fsub_rn(masked_log2, r.ml[h])) *
              r.inv_l[h];
          float dw = dp[x] + t.y;
          wd = w;
          if (p.dropout) {
            const bool keep =
                zt::keep_key(r.seed[h], key, p.s1, p.threshold);
            wd = keep ? w * p.drop_scale : 0.f;
            dw = keep ? dw * p.drop_scale : 0.f;
          }
          if (valid) ds = w * (dw - r.delta[h]);
        }
        s[x] = ds;
        if (!BAND) {
          wsum[h] += wd;
          dsum[h] += ds;
        } else if (b == 0) {
          sum.wlo[h] += wd;
          sum.dlo[h] += ds;
        } else if (b == 2 * p.rel) {
          sum.whi[h] += wd;
          sum.dhi[h] += ds;
        } else if (exists) {
          sums[(r.row[h] - q0) * nb + b] = __floats2bfloat162_rn(wd, ds);
        }
      }
    }
  if (!BAND) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ce == 0) {
        sum.wlo[h] += wsum[h];
        sum.dlo[h] += dsum[h];
      } else {
        sum.whi[h] += wsum[h];
        sum.dhi[h] += dsum[h];
      }
    }
  }
}

// After the dq walk: the edge buckets' quad sums into the bucket sums, then
// dQ += ds_b.Tk by wgmma (ds_b the register A operand, rounded to bf16 as
// dS is; Tk staged in ring slot 0 and read m/n-major), 64 buckets a step.
template <int DP>
__device__ __forceinline__ void rpr_dq_finish(const Params& p,
                                              const RprSums& sum,
                                              __nv_bfloat162* sums,
                                              bf16* slot,
                                              float (&dq)[DP / 2]) {
  const int nb = 2 * p.rel + 1, dh = p.dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float wl = quad_sum(sum.wlo[h]), wh = quad_sum(sum.whi[h]);
    const float dl = quad_sum(sum.dlo[h]), dhi = quad_sum(sum.dhi[h]);
    if ((threadIdx.x & 3) == 0) {
      __nv_bfloat162* row = sums + frag_row(h) * nb;
      row[0] = __floats2bfloat162_rn(wl, dl);
      if (p.rel > 0) row[2 * p.rel] = __floats2bfloat162_rn(wh, dhi);
    }
  }
  __syncthreads();   // the sums complete, the ring no longer read
  for (int c0 = 0; c0 < nb; c0 += kKeys) {
    if (c0 > 0) __syncthreads();   // the last chunk's products are done
    load_tile<kKeys, DP, kThreadsTC>(slot, (const bf16*)p.tk, dh, c0, 0, nb,
                                     dh);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + frag_col(2 * kk + (q >> 1));
        const __nv_bfloat162* row = sums + frag_row(q & 1) * nb;
        const bf16 zero = __float2bfloat16_rn(0.f);
        a[kk][q] = bf16_pair(c < nb ? row[c].y : zero,
                             c + 1 < nb ? row[c + 1].y : zero);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dq, a[kk], mn_desc(slot, kKeys, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait_all();
  }
}

// After dq: the block's table-gradient partials dTk = scale * ds_b^T.Q and
// dTv = wb^T.dO (fp32 [R, Dh] at part_tk/part_tv[block]) by wgmma, 64
// buckets a step: the A fragment (bucket rows, query-row columns) read from
// the bucket sums, Q and dO read m/n-major.
template <int DP>
__device__ __forceinline__ void rpr_dq_tables(const Params& p,
                                              const bf16* qs, const bf16* dos,
                                              const __nv_bfloat162* sums) {
  const int nb = 2 * p.rel + 1, dh = p.dh;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float acc[DP / 2];
  for (int c0 = 0; c0 < nb; c0 += kKeys)
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + frag_row(q & 1);
          const int i = frag_col(2 * kk + (q >> 1));
          if (c < nb) {
            const __nv_bfloat162 u = sums[i * nb + c];
            const __nv_bfloat162 v = sums[(i + 1) * nb + c];
            a[kk][q] = t ? bf16_pair(u.x, v.x) : bf16_pair(u.y, v.y);
          } else {
            a[kk][q] = 0u;
          }
        }
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(acc, a[kk], mn_desc(t ? dos : qs, kBlockRows, 16 * kk),
                     1);
      wgmma_commit();
      wgmma_wait_all();
      float* part = (t ? p.part_tv : p.part_tk) + blk * nb * dh;
      const float sc = t ? 1.f : p.scale;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + frag_row(h), d = frag_col(j);
          if (c < nb && d < dh)   // dh is a multiple of 16: so is d + 1
            *reinterpret_cast<float2*>(part + (size_t)c * dh + d) =
                make_float2(acc[4 * j + 2 * h] * sc,
                            acc[4 * j + 2 * h + 1] * sc);
        }
    }
}

// delta = rowsum(dO * O) and dq; grid (ceil(Lq / kBlockRows), B*H). Both
// mask rules: dS is 0 at every masked entry, so the key tiles past the
// diagonal are skipped under the causal flag either way (but see Rpr).
// POL = Rpr adds the RPR terms, the bucket sums and the table partials.
template <int DP, class POL = NoRpr>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kDqMinBlocks : 1)
    dq_tc(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* dos = qs + kBlockRows * DP;               // [kBlockRows][DP]
  bf16* ring = dos + kBlockRows * DP;             // slots of K, V [64][DP]
  float* pads = reinterpret_cast<float*>(ring + kDqStages * 2 * kKeys * DP);
  float* delta_s = pads + kDqStages * kKeys;      // [kBlockRows]
  // Rpr: the bucket sums (wb, ds_b), bf16 pairs [kBlockRows][R]
  __nv_bfloat162* sums =
      reinterpret_cast<__nv_bfloat162*>(delta_s + kBlockRows);
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
  int k_end = p.causal ? min(p.lk, q0 + kBlockRows) : p.lk;
  if constexpr (POL::kOn) {
    // an all-pad row (the fused rule) feeds wb, and so dTv, from every
    // key, the keys past the diagonal too: a block whose first row has no
    // valid key (m = -1e30, one load for the whole block) walks them all
    if (p.causal && q0 < p.lq && p.m[(size_t)bh * p.lq + q0] == kMasked)
      k_end = p.lk;
  }
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
  float s[32], dp[32], dq[DP / 2];
  if constexpr (POL::kOn)
    rpr_dq_prologue<DP>(p, bh, q0, qs, dos,
                        ring + (kDqStages - 1) * 2 * kKeys * DP, sums, s,
                        dp);

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

#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  RprSums edge_sums = {};

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

    if constexpr (POL::kOn) {
      // the edge rules also where the tile holds keys past Lk, which must
      // not enter wb
      const bool edge = rows_edge || k0 + kKeys > p.lk ||
                        (p.causal && k0 + kKeys - 1 > q0);
      const int ce = rpr_tile_bucket(q0, kBlockRows, k0, kKeys, p.rel);
      const float* pd = pads + slot * kKeys;
      if (ce < 0) {
        if (edge)
          rpr_dq_scores<true, true>(p, s, dp, pd, k0, rows, scale_log2, bh,
                                    q0, ce, edge_sums, sums);
        else
          rpr_dq_scores<false, true>(p, s, dp, pd, k0, rows, scale_log2, bh,
                                     q0, ce, edge_sums, sums);
      } else {
        if (edge)
          rpr_dq_scores<true, false>(p, s, dp, pd, k0, rows, scale_log2, bh,
                                     q0, ce, edge_sums, sums);
        else
          rpr_dq_scores<false, false>(p, s, dp, pd, k0, rows, scale_log2,
                                      bh, q0, ce, edge_sums, sums);
      }
    } else {
      if (rows_edge || (p.causal && k0 + kKeys - 1 > q0))
        dq_scores<true>(p, s, dp, pads + slot * kKeys, k0, rows, scale_log2);
      else
        dq_scores<false>(p, s, dp, pads + slot * kKeys, k0, rows,
                         scale_log2);
    }

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

  if constexpr (POL::kOn) rpr_dq_finish<DP>(p, edge_sums, sums, ring, dq);
  store_acc<DP>((bf16*)p.out + qoff, dq, q0, p.lq, dh, p.scale);
  if constexpr (POL::kOn) rpr_dq_tables<DP>(p, qs, dos, sums);
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

// Rpr: dkdv_scores with the RPR terms. Each query row's terms at the edge
// buckets come staged with the slot (eg: qr, dwb at 0, then at 2 rel).
// BAND: the tile meets the band, and an interior bucket's terms are read
// from the scratch per element; else the tile's one bucket is ce.
template <int BQ, bool EDGE, bool FUSED, bool BAND>
__device__ __forceinline__ void rpr_dkdv_scores(
    const Params& p, float (&s)[BQ / 2], float (&dp)[BQ / 2],
    const float4* st, const float4* eg, int qt0, const DkvKeys& kv,
    float scale_log2, int bh, int ce) {
  const float masked_log2 = kMasked * kLog2e;
  const int nb = 2 * p.rel + 1;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e, i = qt0 + c;
      const float4 r = st[c];
      const float ml = __fmul_rn(r.x, kLog2e), inv_l = fast_rcp(r.y);
      const uint32_t seed = __float_as_uint(r.w);
      const float4 edge = eg[c];
      const float2 lo = make_float2(edge.x, edge.y);
      const float2 hi = make_float2(edge.z, edge.w);
      const float2* qd =
          p.qd + ((size_t)bh * p.lq + (i < p.lq ? i : 0)) * nb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        const bool seen = !EDGE || !p.causal || kv.key[h] <= i;
        const bool exists =
            kv.key_in[h] && (!EDGE || i < p.lq) && (FUSED || seen);
        const bool valid = exists && seen && kv.pad_ok[h];
        float wd = 0.f, ds = 0.f;
        if (exists) {
          const float2 t =
              BAND ? rpr_terms(qd, rpr_bucket(i, kv.key[h], p.rel), p.rel,
                               lo, hi)
                   : (ce == 0 ? lo : hi);
          const float w =
              fast_exp2((valid ? (s[x] + t.x) * scale_log2 : masked_log2) -
                        ml) * inv_l;
          const bool keep =
              !p.dropout || zt::keep_key(seed, kv.key[h], p.s1, p.threshold);
          wd = keep ? w * p.drop_scale : 0.f;
          if (valid)
            ds = w * ((keep ? (dp[x] + t.y) * p.drop_scale : 0.f) - r.z);
        }
        s[x] = ds;
        dp[x] = wd;
      }
    }
}

// dk, dv; grid (ceil(Lk / kBlockRows), B*H); reads delta (and, under Rpr,
// the scratch of qr and dwb) from dq_tc
template <int DP, bool FUSED, class POL = NoRpr>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? kKvMinBlocks : 1)
    dkdv_tc(Params p) {
  constexpr int BQ = query_tile<DP, POL>();
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = align1024(smem_raw);                 // [kBlockRows][DP]
  bf16* vs = ks + kBlockRows * DP;                // [kBlockRows][DP]
  bf16* ring = vs + kBlockRows * DP;              // slots of Q, dO [BQ][DP]
  // per query row of a slot: m, l, delta and the row's seed word
  float4* stats =
      reinterpret_cast<float4*>(ring + kKvStages * 2 * BQ * DP);
  // Rpr: per query row of a slot, (qr, dwb) at buckets 0 and 2 rel
  float4* edges = stats + kKvStages * BQ;
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
      if constexpr (POL::kOn) {
        const float2* qd = p.qd + gi * (2 * p.rel + 1);
        float4* eg = edges + slot * BQ + tid;
        cp_async8(&eg->x, qd, in);
        cp_async8(&eg->z, qd + 2 * p.rel, in);
      }
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

    const bool edge =
        qt0 + BQ > p.lq || (p.causal && qt0 < k0 + kBlockRows - 1);
    if constexpr (POL::kOn) {
      const float4* st = stats + slot * BQ;
      const float4* eg = edges + slot * BQ;
      const int ce = rpr_tile_bucket(qt0, BQ, k0, kBlockRows, p.rel);
      if (ce < 0) {
        if (edge)
          rpr_dkdv_scores<BQ, true, FUSED, true>(p, s, dp, st, eg, qt0, kv,
                                                 scale_log2, bh, ce);
        else
          rpr_dkdv_scores<BQ, false, FUSED, true>(p, s, dp, st, eg, qt0, kv,
                                                  scale_log2, bh, ce);
      } else {
        if (edge)
          rpr_dkdv_scores<BQ, true, FUSED, false>(p, s, dp, st, eg, qt0, kv,
                                                  scale_log2, bh, ce);
        else
          rpr_dkdv_scores<BQ, false, FUSED, false>(p, s, dp, st, eg, qt0,
                                                   kv, scale_log2, bh, ce);
      }
    } else {
      if (edge)
        dkdv_scores<BQ, true, FUSED>(p, s, dp, stats + slot * BQ, qt0, kv,
                                     scale_log2);
      else
        dkdv_scores<BQ, false, FUSED>(p, s, dp, stats + slot * BQ, qt0, kv,
                                      scale_log2);
    }

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

template <int DP, bool FUSED, class POL>
cudaError_t launch_backward_dp(const Params& p, int bh, bool dkdv,
                               cudaStream_t s) {
  cudaError_t err;
  if (!dkdv) {
    const size_t bytes = dq_smem<DP>() + POL::dq_smem(p.rel);
    err = allow_smem(dq_tc<DP, POL>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.lq + kBlockRows - 1) / kBlockRows, bh);
    dq_tc<DP, POL><<<grid, kThreadsTC, bytes, s>>>(p);
  } else {
    const size_t bytes =
        dkdv_smem<DP, POL>() + POL::template kv_smem<DP>();
    err = allow_smem(dkdv_tc<DP, FUSED, POL>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.lk + kBlockRows - 1) / kBlockRows, bh);
    dkdv_tc<DP, FUSED, POL><<<grid, kThreadsTC, bytes, s>>>(p);
  }
  return cudaGetLastError();
}

// Whether the tensor-core kernels take a launch: bf16 (dtype 1), head
// depth a multiple of 16 up to 128.
inline bool takes(int dtype, int dh) {
  return dtype == 1 && dh % 16 == 0 && dh <= 128;
}

// o, m, l (p.out, p.m, p.l) under the mask rule FUSED and the policy POL;
// a launch the kernels do not take returns cudaErrorInvalidValue
template <bool FUSED, class POL = NoRpr>
int run_forward(const Params& p, int dtype, int bh, void* stream) {
  if (!takes(dtype, p.dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.dh <= 64 ? launch_forward_dp<64, FUSED, POL>(p, bh, s)
                          : launch_forward_dp<128, FUSED, POL>(p, bh, s));
}

// dq (dkdv false) or dk/dv (dkdv true) under the mask rule FUSED and the
// policy POL; a launch the kernels do not take returns
// cudaErrorInvalidValue
template <bool FUSED, class POL = NoRpr>
int run_backward(const Params& p, int dtype, int bh, bool dkdv,
                 void* stream) {
  if (!takes(dtype, p.dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.dh <= 64
                   ? launch_backward_dp<64, FUSED, POL>(p, bh, dkdv, s)
                   : launch_backward_dp<128, FUSED, POL>(p, bh, dkdv, s));
}

}  // namespace tc
}  // namespace zt
