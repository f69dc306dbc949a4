// Fused multi-head attention with Shaw relative positions (RPR) for training
// on Hopper (sm_90a): the CUDA counterparts of the Pallas TPU kernels of the
// RPR variant in zero_tpu/ops/kernels/fused_attention.py.
//
//   zt_attention_rpr_forward   replaces _fused_forward_rpr (_fwd_kernel_rpr).
//   zt_attention_rpr_backward  replaces _fused_bwd_rule_rpr (_bwd_kernel_rpr).
//
// Math. With c(i, j) = clip(i - j, -m, m) + m, R = 2m + 1 buckets and the
// tables Tk, Tv [R, Dh] in the order given (bucket c is row c):
//   s_ij = (q_i . k_j + q_i . Tk[c(i,j)]) * Dh^-0.5   under the key pad mask
//          and the causal flag (masked entries -1e30)
//   w    = fp32 softmax of s, w_d = w after dropout
//   o_i  = sum_j w_d,ij (v_j + Tv[c(i,j)])
// The TPU kernel works in flipped bucket space (c' = 2m - c) and its wrapper
// reverses the tables; these kernels index c itself and return the table
// gradients in the same order.
//
// Layout: q [B*H, Lq, Dh], k/v [B*H, Lk, Dh] contiguous, fp32 or bf16; pad
// [B, Lk] fp32 (1 = attend); Tk/Tv [R, Dh] in the q dtype. Any Lq, Lk;
// Dh <= 256; R <= 129 (m <= 64).
//
// Design. The tiling is that of fused_attention.cu (kernels #1/#2): a block
// owns 32 query rows (forward, dq) or 32 keys (dk/dv) of one (batch, head)
// and walks the other axis in tiles of 32 staged in shared memory as fp32;
// a warp owns 8 query rows and lane j owns key j of a tile.
//   * Bias. Per query tile, qr[i, c] = q_i . Tk[c] is computed once into
//     shared memory ([32, R] fp32, Tk staged 32 buckets at a time), and each
//     score adds qr[i, c(i,j)]. The [Lq, Lk] bias never exists.
//   * Value side under the online softmax. Each row keeps a bucket
//     accumulator wb[i, c] = sum_{j: c(i,j) = c} w_d,ij in shared memory,
//     rescaled by exp(m_old - m_new) with the output accumulator. The
//     interior buckets 1..2m-1 get one key each (a lane writes its own);
//     the edge buckets 0 and 2m collect every key beyond the clip distance
//     (warp sums). At the end o_i += wb_i . Tv, and o_i /= l_i.
//   * Backward. The weights are rebuilt as exp(s - m) / l from the stored
//     fp32 m and l (an all-pad row gets 1/Lk, never the 1.0 that lse = m +
//     log l would round to). With
//       dwb = do . Tv^T [Lq, R],  dw_d,ij = do_i . v_j + dwb[i, c(i,j)],
//       ds = w o (dw - delta), zero at masked entries, ds_b = bucket sums,
//     the gradients are dq = (ds k + ds_b Tk) * scale, dk = ds^T q * scale,
//     dv = w_d^T do, dTk = sum_rows ds_b^T q * scale, dTv = sum_rows wb^T do.
//     Since o already holds the Tv term, delta = rowsum(dO o O) still equals
//     rowsum(dW o W) = sum_j w_d,ij dw_d,ij, with dropout on too: that is
//     what lets the dq/dk/dv split of #2 carry over. Kernel 1 (per query
//     tile) writes delta, dq, the rows' qr and dwb (fp32 scratch for kernel
//     2) and its block's table-gradient partials [R, Dh]; kernel 2 (per key
//     tile) gives dk/dv; kernel 3 sums the partials over all blocks in a
//     fixed order and writes dTk/dTv in the table dtype. No atomics:
//     deterministic.
//   * An all-pad row has uniform weights, so its bucket sums and Tv term are
//     not zero and dTv gets its share; ds is zero there, so dq, dk and dTk
//     get nothing from it.
//   * Dropout: the keep bit of element (row i, key j) of head bh is
//     hash_bits(((bh * Lq + i) * Lk + j), s0, s1) < threshold, scale
//     1/(1 - rate), as in kernels #1/#2; bucket sums are taken over the
//     dropped weights.
//
// Bound. At transformer-base shapes (L <= 256, Dh = 64, m = 16) the RPR
// terms add ~4*R*Dh flops per query row (q . Tk, wb . Tv) to the ~4*Lk*Dh
// of attention, and the tables are a few KB. In bf16 the least time is set
// by reading q/k/v and writing o (~5 us at B=16, H=8, L=256 on an H100),
// with the tensor-core products close behind; in fp32 on the CUDA cores by
// operations. This first kernel multiplies on the CUDA cores in fp32, one
// multiply-add per shared-memory read; tensor cores are later work.
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include "zt_common.cuh"

namespace {

constexpr int kTile = 32;              // query rows, keys or buckets per tile
constexpr int kRows = 8;               // rows per warp (4 warps)
constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;      // NEG_INF of the JAX kernel
constexpr int kMaxBuckets = 129;       // R = 2m + 1, m <= 64
constexpr int kReduceWarps = 8;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* pad;
  const void* tk;
  const void* tv;
  const void* o;
  const void* dout;
  void* out;        // forward: o; backward: dq
  void* dk;
  void* dv;
  float* m;
  float* l;
  float* delta;
  float* qr;        // backward scratch [B*H, Lq, R]: q . Tk
  float* dwb;       // backward scratch [B*H, Lq, R]: do . Tv
  float* part_tk;   // [blocks, R, Dh] per-block partials of dTk, dTv
  float* part_tv;
  int heads, lq, lk, dh, rel, buckets, causal, dropout;
  float scale, drop_scale;
  uint32_t threshold, s0, s1;
};

__device__ __forceinline__ bool keep_bit(const Params& p, int bh, int i,
                                         int j) {
  const uint32_t index =
      ((uint32_t)bh * (uint32_t)p.lq + (uint32_t)i) * (uint32_t)p.lk +
      (uint32_t)j;
  return zt::hash_bits(index, p.s0, p.s1) < p.threshold;
}

__device__ __forceinline__ int bucket(int i, int j, int rel) {
  const int d = i - j;
  return (d < -rel ? -rel : (d > rel ? rel : d)) + rel;
}

// Stage rows [r0, r0 + kTile) of a [rows, dh] matrix as fp32 in shared
// memory with row stride `stride`; rows past `rows` become zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int dh, int stride) {
  for (int e = threadIdx.x; e < kTile * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    dst[r * stride + d] =
        (r0 + r < rows) ? zt::to_float(src[(size_t)(r0 + r) * dh + d]) : 0.f;
  }
}

// out[r] = a[warp*8 + r] . b[lane] for the warp's 8 rows of a ([32][dh])
// and row `lane` of b ([32][dh + 1]). Every kernel computes scores and qr
// through this one function, so the backward rebuilds the forward's exact
// scores.
__device__ __forceinline__ void row_dots(float (&out)[kRows], const float* a,
                                         const float* b, int dh, int warp,
                                         int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
  const float* br = b + lane * (dh + 1);
  const float* ar = a + warp * kRows * dh;
  for (int d = 0; d < dh; ++d) {
    const float bd = br[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r] += ar[r * dh + d] * bd;
  }
}

// acc[r][c] += sum_{jj < count} p[(warp*8 + r) * pstride + jj] *
// vals[jj * vstride + lane + 32c]
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][NC],
                                           const float* p, int pstride,
                                           const float* vals, int vstride,
                                           int dh, int warp, int lane,
                                           int count) {
  for (int jj = 0; jj < count; ++jj) {
    float vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      vv[c] = d < dh ? vals[jj * vstride + d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float e = p[(warp * kRows + r) * pstride + jj];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] += e * vv[c];
    }
  }
}

// Add each lane's value x to bucket c of a warp's row `row` ([R] floats):
// interior buckets hold one key of the row each, so a lane writes its own;
// the edge buckets 0 and 2m are warp sums added by lane 0. Every lane of
// the warp must call it.
__device__ __forceinline__ void add_to_buckets(float* row, int c, float x,
                                               int rel, int lane) {
  const float lo = zt::warp_sum(c == 0 ? x : 0.f);
  const float hi = zt::warp_sum(c != 0 && c == 2 * rel ? x : 0.f);
  if (c > 0 && c < 2 * rel) row[c] += x;
  if (lane == 0) {
    row[0] += lo;
    if (rel > 0) row[2 * rel] += hi;
  }
}

__device__ __forceinline__ void zero(float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rpr_forward(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh, nb = p.buckets;
  float* qs = smem;                        // [32][dh]
  float* ks = qs + kTile * dh;             // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh]
  float* ps = vs + kTile * dh;             // [32][32]
  float* qr = ps + kTile * kTile;          // [32][R] q . Tk
  float* wb = qr + kTile * nb;             // [32][R] bucket sums of w_d
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = (const T*)p.q + (size_t)bh * p.lq * dh;
  const T* k = (const T*)p.k + (size_t)bh * p.lk * dh;
  const T* v = (const T*)p.v + (size_t)bh * p.lk * dh;
  const float* pad = p.pad + (size_t)b * p.lk;

  stage(qs, q, q0, p.lq, dh, dh);
  zero(wb, kTile * nb);
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    __syncthreads();
    stage(ks, (const T*)p.tk, c0, nb, dh, dh + 1);
    __syncthreads();
    float d[kRows];
    row_dots(d, qs, ks, dh, warp, lane);
    if (c0 + lane < nb) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) qr[(warp * kRows + r) * nb + c0 + lane] = d[r];
    }
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(ks, k, k0, p.lk, dh, dh + 1);
    stage(vs, v, k0, p.lk, dh, dh);
    __syncthreads();
    const int j = k0 + lane;
    const bool exists = j < p.lk;
    const bool pad_ok = exists && pad[exists ? j : 0] > 0.f;
    float s[kRows];
    row_dots(s, qs, ks, dh, warp, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      const int i = q0 + rr;
      const int c = bucket(i, j, p.rel);
      const bool valid = pad_ok && (!p.causal || j <= i);
      float x = valid ? (s[r] + qr[rr * nb + c]) * p.scale : kMasked;
      if (!exists) x = -INFINITY;
      const float m_new = fmaxf(m[r], zt::warp_max(x));
      const float alpha = expf(m[r] - m_new);
      float e = exists ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + zt::warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) acc[r][c2] *= alpha;
      if (p.dropout) e = (exists && keep_bit(p, bh, i, j)) ? e * p.drop_scale
                                                          : 0.f;
      ps[rr * kTile + lane] = e;
      float* wr = wb + rr * nb;
      if (alpha != 1.f) {   // warp-uniform
        for (int cc = lane; cc < nb; cc += 32) wr[cc] *= alpha;
      }
      __syncwarp();
      add_to_buckets(wr, c, e, p.rel, lane);
    }
    __syncwarp();
    accumulate(acc, ps, kTile, vs, dh, dh, warp, lane, kTile);
  }

  // o += wb . Tv, 32 buckets at a time
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    __syncthreads();
    stage(vs, (const T*)p.tv, c0, nb, dh, dh);
    __syncthreads();
    accumulate(acc, wb + c0, nb, vs, dh, dh, warp, lane,
               min(kTile, nb - c0));
  }

  T* o = (T*)p.out + (size_t)bh * p.lq * dh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= p.lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) o[(size_t)i * dh + d] = zt::from_float<T>(acc[r][c] * inv);
    }
    if (lane == 0) {
      p.m[(size_t)bh * p.lq + i] = m[r];
      p.l[(size_t)bh * p.lq + i] = l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta, qr, dwb, dq and the block's table-gradient partials;
// grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rpr_backward_dq(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh, nb = p.buckets;
  float* qs = smem;                        // [32][dh]
  float* dos = qs + kTile * dh;            // [32][dh]
  float* ks = dos + kTile * dh;            // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh + 1]
  float* ps = vs + kTile * (dh + 1);       // [32][32] ds
  float* qr = ps + kTile * kTile;          // [32][R] q . Tk
  float* dwb = qr + kTile * nb;            // [32][R] do . Tv
  float* dsb = dwb + kTile * nb;           // [32][R] bucket sums of ds
  float* wbs = dsb + kTile * nb;           // [32][R] bucket sums of w_d
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * p.lq * dh;
  const T* q = (const T*)p.q + qoff;
  const T* o = (const T*)p.o + qoff;
  const T* dout = (const T*)p.dout + qoff;
  const T* k = (const T*)p.k + (size_t)bh * p.lk * dh;
  const T* v = (const T*)p.v + (size_t)bh * p.lk * dh;
  const float* pad = p.pad + (size_t)b * p.lk;

  stage(qs, q, q0, p.lq, dh, dh);
  stage(dos, dout, q0, p.lq, dh, dh);
  zero(dsb, 2 * kTile * nb);               // dsb and wbs
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    __syncthreads();
    stage(ks, (const T*)p.tk, c0, nb, dh, dh + 1);
    stage(vs, (const T*)p.tv, c0, nb, dh, dh + 1);
    __syncthreads();
    float a[kRows], d[kRows];
    row_dots(a, qs, ks, dh, warp, lane);
    row_dots(d, dos, vs, dh, warp, lane);
    const int c = c0 + lane;
    if (c < nb) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int rr = warp * kRows + r;
        const int i = q0 + rr;
        qr[rr * nb + c] = a[r];
        dwb[rr * nb + c] = d[r];
        if (i < p.lq) {
          const size_t g = ((size_t)bh * p.lq + i) * nb + c;
          p.qr[g] = a[r];
          p.dwb[g] = d[r];
        }
      }
    }
  }

  float m[kRows], l[kRows], delta[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    float part = 0.f;
    if (i < p.lq) {
      for (int d = lane; d < dh; d += 32)
        part += dos[(warp * kRows + r) * dh + d] *
                zt::to_float(o[(size_t)i * dh + d]);
    }
    delta[r] = zt::warp_sum(part);
    const bool in = i < p.lq;
    m[r] = in ? p.m[(size_t)bh * p.lq + i] : 0.f;
    l[r] = in ? p.l[(size_t)bh * p.lq + i] : 1.f;
    if (in && lane == 0) p.delta[(size_t)bh * p.lq + i] = delta[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();
    stage(ks, k, k0, p.lk, dh, dh + 1);
    stage(vs, v, k0, p.lk, dh, dh + 1);
    __syncthreads();
    const int j = k0 + lane;
    const bool exists = j < p.lk;
    const bool pad_ok = exists && pad[exists ? j : 0] > 0.f;
    float s[kRows], dp[kRows];
    row_dots(s, qs, ks, dh, warp, lane);
    row_dots(dp, dos, vs, dh, warp, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      const int i = q0 + rr;
      const bool row_in = i < p.lq;
      const int c = bucket(i, j, p.rel);
      const bool valid = row_in && pad_ok && (!p.causal || j <= i);
      const float x = valid ? (s[r] + qr[rr * nb + c]) * p.scale : kMasked;
      const float w = (exists && row_in) ? expf(x - m[r]) / l[r] : 0.f;
      float wd = w, dw = dp[r] + dwb[rr * nb + c];
      if (p.dropout) {
        const bool keep = exists && row_in && keep_bit(p, bh, i, j);
        wd = keep ? w * p.drop_scale : 0.f;
        dw = keep ? dw * p.drop_scale : 0.f;
      }
      const float ds = valid ? w * (dw - delta[r]) : 0.f;
      ps[rr * kTile + lane] = ds;
      add_to_buckets(dsb + rr * nb, c, ds, p.rel, lane);
      add_to_buckets(wbs + rr * nb, c, wd, p.rel, lane);
    }
    __syncwarp();
    accumulate(acc, ps, kTile, ks, dh + 1, dh, warp, lane, kTile);
  }

  // dq += ds_b . Tk, 32 buckets at a time
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    __syncthreads();
    stage(ks, (const T*)p.tk, c0, nb, dh, dh + 1);
    __syncthreads();
    accumulate(acc, dsb + c0, nb, ks, dh + 1, dh, warp, lane,
               min(kTile, nb - c0));
  }

  T* dq = (T*)p.out + qoff;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= p.lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) dq[(size_t)i * dh + d] =
          zt::from_float<T>(acc[r][c] * p.scale);
    }
  }

  // this block's table-gradient partials: dTk[c] = scale * sum_i ds_b[i,c]
  // q_i, dTv[c] = sum_i wb[i,c] do_i over its 32 rows (rows past Lq hold
  // zeros)
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* ptk = p.part_tk + blk * nb * dh;
  float* ptv = p.part_tv + blk * nb * dh;
  for (int e = threadIdx.x; e < nb * dh; e += kThreads) {
    const int c = e / dh;
    const int d = e - c * dh;
    float gk = 0.f, gv = 0.f;
    for (int rr = 0; rr < kTile; ++rr) {
      gk += dsb[rr * nb + c] * qs[rr * dh + d];
      gv += wbs[rr * nb + c] * dos[rr * dh + d];
    }
    ptk[e] = gk * p.scale;
    ptv[e] = gv;
  }
}

// ---------------------------------------------------------------------------
// backward 2: dk, dv; grid (ceil(Lk / 32), B*H). Needs delta, qr and dwb
// from kernel 1.
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rpr_backward_dkdv(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh, nb = p.buckets;
  float* ks = smem;                        // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh + 1]
  float* qs = vs + kTile * (dh + 1);       // [32][dh]
  float* dos = qs + kTile * dh;            // [32][dh]
  float* ps = dos + kTile * dh;            // [32][32] dropped weights
  float* dss = ps + kTile * kTile;         // [32][32] ds
  float* stats = dss + kTile * kTile;      // [3][32] m, l, delta
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)bh * p.lq * dh;
  const size_t koff = (size_t)bh * p.lk * dh;
  const T* q = (const T*)p.q + qoff;
  const T* dout = (const T*)p.dout + qoff;
  const T* k = (const T*)p.k + koff;
  const T* v = (const T*)p.v + koff;
  const float* pad = p.pad + (size_t)b * p.lk;

  stage(ks, k, k0, p.lk, dh, dh + 1);
  stage(vs, v, k0, p.lk, dh, dh + 1);
  // score phase: lane = key k0 + lane; accumulate phase: this thread owns
  // keys k0 + warp*8 .. +8 and depths lane + 32c
  const int j = k0 + lane;
  const bool exists = j < p.lk;
  const bool pad_ok = exists && pad[exists ? j : 0] > 0.f;
  float dk[kRows][NC], dv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int q0 = 0; q0 < p.lq; q0 += kTile) {
    __syncthreads();
    stage(qs, q, q0, p.lq, dh, dh);
    stage(dos, dout, q0, p.lq, dh, dh);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      const bool in = i < p.lq;
      stats[threadIdx.x] = in ? p.m[(size_t)bh * p.lq + i] : 0.f;
      stats[kTile + threadIdx.x] = in ? p.l[(size_t)bh * p.lq + i] : 1.f;
      stats[2 * kTile + threadIdx.x] =
          in ? p.delta[(size_t)bh * p.lq + i] : 0.f;
    }
    __syncthreads();
    float s[kRows], dp[kRows];
    row_dots(s, qs, ks, dh, warp, lane);
    row_dots(dp, dos, vs, dh, warp, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      const int i = q0 + rr;
      const bool row_in = i < p.lq;
      const int c = bucket(i, j, p.rel);
      const size_t g = ((size_t)bh * p.lq + (row_in ? i : 0)) * nb + c;
      const bool valid = row_in && pad_ok && (!p.causal || j <= i);
      const float x = valid ? (s[r] + p.qr[g]) * p.scale : kMasked;
      const float w = (exists && row_in)
                          ? expf(x - stats[rr]) / stats[kTile + rr] : 0.f;
      float wd = w, dw = dp[r] + (row_in ? p.dwb[g] : 0.f);
      if (p.dropout) {
        const bool keep = exists && row_in && keep_bit(p, bh, i, j);
        wd = keep ? w * p.drop_scale : 0.f;
        dw = keep ? dw * p.drop_scale : 0.f;
      }
      ps[rr * kTile + lane] = wd;
      dss[rr * kTile + lane] = valid ? w * (dw - stats[2 * kTile + rr]) : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < kTile; ++rr) {
      float dov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        dov[c] = d < dh ? dos[rr * dh + d] : 0.f;
        qv[c] = d < dh ? qs[rr * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float wd = ps[rr * kTile + warp * kRows + r];
        const float ds = dss[rr * kTile + warp * kRows + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] += wd * dov[c];
          dk[r][c] += ds * qv[c];
        }
      }
    }
  }

  T* dk_out = (T*)p.dk + koff;
  T* dv_out = (T*)p.dv + koff;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int jj = k0 + warp * kRows + r;
    if (jj >= p.lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        dk_out[(size_t)jj * dh + d] = zt::from_float<T>(dk[r][c] * p.scale);
        dv_out[(size_t)jj * dh + d] = zt::from_float<T>(dv[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dTk, dTv = the sums of the per-block partials, in a fixed
// order; grid (ceil(R*Dh / 32), 2), 8 warps: warp w sums blocks w, w+8, ...
// of 32 neighbouring outputs (one a lane), then warp 0 adds the 8 sums.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kReduceWarps * 32) rpr_reduce_tables(
    const float* part_tk, const float* part_tv, T* dtk, T* dtv, int blocks,
    int n) {
  __shared__ float red[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* part = blockIdx.y ? part_tv : part_tk;
  T* out = blockIdx.y ? dtv : dtk;
  const int e = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (e < n) {
    for (int blk = warp; blk < blocks; blk += kReduceWarps)
      acc += part[(size_t)blk * n + e];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < n) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) sum += red[w][lane];
    out[e] = zt::from_float<T>(sum);
  }
}

size_t forward_bytes(const Params& p) {
  return sizeof(float) * (size_t)(kTile * p.dh * 2 + kTile * (p.dh + 1) +
                                  kTile * kTile + 2 * kTile * p.buckets);
}

size_t dq_bytes(const Params& p) {
  return sizeof(float) * (size_t)(kTile * p.dh * 2 + kTile * (p.dh + 1) * 2 +
                                  kTile * kTile + 4 * kTile * p.buckets);
}

size_t dkdv_bytes(const Params& p) {
  return sizeof(float) * (size_t)(kTile * (p.dh + 1) * 2 + kTile * p.dh * 2 +
                                  2 * kTile * kTile + 3 * kTile);
}

template <typename T, int NC>
cudaError_t forward_nc(const Params& p, int bh, cudaStream_t stream) {
  const size_t bytes = forward_bytes(p);
  cudaError_t err = zt::allow_smem(rpr_forward<T, NC>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.lq + kTile - 1) / kTile, bh);
  rpr_forward<T, NC><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t backward_nc(const Params& p, int bh, T* dtk, T* dtv,
                        cudaStream_t stream) {
  const size_t qb = dq_bytes(p), kb = dkdv_bytes(p);
  cudaError_t err = zt::allow_smem(rpr_backward_dq<T, NC>, qb);
  if (err != cudaSuccess) return err;
  err = zt::allow_smem(rpr_backward_dkdv<T, NC>, kb);
  if (err != cudaSuccess) return err;
  dim3 grid_q((p.lq + kTile - 1) / kTile, bh);
  rpr_backward_dq<T, NC><<<grid_q, kThreads, qb, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((p.lk + kTile - 1) / kTile, bh);
  rpr_backward_dkdv<T, NC><<<grid_k, kThreads, kb, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.buckets * p.dh;
  dim3 grid_r((n + 31) / 32, 2);
  rpr_reduce_tables<T><<<grid_r, kReduceWarps * 32, 0, stream>>>(
      p.part_tk, p.part_tv, dtk, dtv, (int)(grid_q.x * grid_q.y), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, bool backward, void* dtk,
                     void* dtv, cudaStream_t s) {
  T* gk = (T*)dtk;
  T* gv = (T*)dtv;
  if (p.dh <= 32)
    return backward ? backward_nc<T, 1>(p, bh, gk, gv, s)
                    : forward_nc<T, 1>(p, bh, s);
  if (p.dh <= 64)
    return backward ? backward_nc<T, 2>(p, bh, gk, gv, s)
                    : forward_nc<T, 2>(p, bh, s);
  if (p.dh <= 128)
    return backward ? backward_nc<T, 4>(p, bh, gk, gv, s)
                    : forward_nc<T, 4>(p, bh, s);
  if (p.dh <= 256)
    return backward ? backward_nc<T, 8>(p, bh, gk, gv, s)
                    : forward_nc<T, 8>(p, bh, s);
  return cudaErrorInvalidValue;
}

cudaError_t run(const Params& p, int dtype, int bh, bool backward, void* dtk,
                void* dtv, void* stream) {
  if (p.buckets > kMaxBuckets || p.buckets < 1 || bh > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, bh, backward, dtk, dtv, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, bh, backward, dtk, dtv, s);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* pad, const void* tk, const void* tv, int heads,
                   int lq, int lk, int dh, int rel, int causal, float scale,
                   int dropout, unsigned int threshold, float drop_scale,
                   unsigned int s0, unsigned int s1) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.pad = (const float*)pad;
  p.tk = tk;
  p.tv = tv;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.dh = dh;
  p.rel = rel;
  p.buckets = 2 * rel + 1;
  p.causal = causal;
  p.scale = scale;
  p.dropout = dropout;
  p.threshold = threshold;
  p.drop_scale = drop_scale;
  p.s0 = s0;
  p.s1 = s1;
  return p;
}

}  // namespace

extern "C" int zt_attention_rpr_forward(
    const void* q, const void* k, const void* v, const void* pad,
    const void* tk, const void* tv, void* o, void* m, void* l, int dtype,
    int batch, int heads, int lq, int lk, int dh, int rel, int causal,
    float scale, int dropout, unsigned int threshold, float drop_scale,
    unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, tk, tv, heads, lq, lk, dh, rel, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.out = o;
  p.m = (float*)m;
  p.l = (float*)l;
  return (int)run(p, dtype, batch * heads, false, nullptr, nullptr, stream);
}

extern "C" int zt_attention_rpr_backward(
    const void* q, const void* k, const void* v, const void* pad,
    const void* tk, const void* tv, const void* o, const void* dout,
    const void* m, const void* l, void* delta, void* qr, void* dwb,
    void* part_tk, void* part_tv, void* dq, void* dk, void* dv, void* dtk,
    void* dtv, int dtype, int batch, int heads, int lq, int lk, int dh,
    int rel, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, tk, tv, heads, lq, lk, dh, rel, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.o = o;
  p.dout = dout;
  p.m = (float*)m;
  p.l = (float*)l;
  p.delta = (float*)delta;
  p.qr = (float*)qr;
  p.dwb = (float*)dwb;
  p.part_tk = (float*)part_tk;
  p.part_tv = (float*)part_tv;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  return (int)run(p, dtype, batch * heads, true, dtk, dtv, stream);
}
