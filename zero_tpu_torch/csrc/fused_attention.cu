// Fused multi-head attention for training on Hopper (sm_90a): the CUDA
// counterparts of the Pallas TPU kernels in
// zero_tpu/ops/kernels/fused_attention.py.
//
//   zt_attention_forward   replaces _fused_forward (_fwd_kernel): masked
//                          scores q.k^T * Dh^-0.5 under a key pad mask and
//                          a causal flag, fp32 softmax, attention dropout,
//                          product with V. Also writes the per-row softmax
//                          max m and sum l (fp32) for the backward.
//   zt_attention_backward  replaces _fused_bwd_rule (_bwd_kernel): rebuilds
//                          the weights from (m, l), gives dq per q-tile and
//                          dk/dv per k-tile; ds is zero at masked entries.
//   zt_attention_forward_tc, zt_attention_backward_tc  the same on the
//                          tensor cores (bf16, head depth a multiple of 16
//                          up to 128): zt::tc::forward_tc, then
//                          zt::tc::dq_tc and zt::tc::dkdv_tc, all under the
//                          fused rule (zt_attention_tc.cuh). The wrapper
//                          picks one route for both directions
//                          (ops/kernels/fused_attention.py:forward_route).
//
// Layout: q [B*H, Lq, Dh], k/v [B*H, Lk, Dh] contiguous, fp32 or bf16; pad
// [B, Lk] fp32 (1 = attend). Any Lq, Lk; Dh <= 256.
//
// Design of the CUDA-core kernels (the tensor-core ones:
// zt_attention_tc.cuh).
//   * A block owns 32 query rows (forward, dq) or 32 keys (dk/dv) of one
//     (batch, head) and walks the other axis in tiles of 32, staged in
//     shared memory as fp32. In a score tile a warp owns 8 query rows and
//     lane j owns key j, so a row's max and sum are warp shuffles and the
//     [Lq, Lk] matrix never leaves the SM.
//   * Forward: online softmax in fp32 registers (running m, l, rescaled
//     accumulator), as the TPU kernel's whole-row softmax would give.
//     Masked scores are -1e30, not -inf: a row with no valid key then gets
//     uniform weights 1/Lk, as in JAX, and stays finite.
//   * Backward (FlashAttention-2 algebra): the weights are rebuilt as
//     exp(s - m) / l from the stored m and l, NOT from lse = m + log l,
//     which rounds to -1e30 on a fully-masked row and would give weight 1
//     instead of 1/Lk. delta = rowsum(dO * O) equals rowsum(W * dW) with
//     dropout on too. Kernel 1 writes delta and dq; kernel 2 gives each
//     block its own keys' dk/dv, reducing over every query row inside the
//     block: no atomics, no split partial sums, deterministic.
//   * Dropout: element (row r = bh * Lq + i, key j) keeps iff
//     hash_bits(j, hash_bits(r, s0, s1), s1) < threshold (zt::row_seed,
//     zt::keep_key), the 32-bit test of _dropout_keep, with scale
//     1/(1 - rate): the streaming kernels' rule, a per-row seed word hashed
//     once per row, so no B*H*Lq*Lk index wraps at 2^32. The bit depends on
//     the element only, so the forward and backward tile differently and
//     still agree, and the plain PyTorch version reproduces the mask.
//
// Bound. At transformer-base training shapes (L <= 256, Dh = 64) a head's
// q/k/v are a few tens of KB and the products are ~4*Lq*Lk*Dh flops against
// ~4*L*Dh elements: ~L/2 flops per byte, so the kernels are bound by
// operations. The CUDA-core kernels (fp32, and bf16 at depths the tensor
// cores do not take) multiply in fp32 (the fp32 inputs need it for exact
// agreement), one fused multiply-add per shared-memory read. The
// tensor-core kernels multiply bf16 tiles by wgmma with fp32 accumulation;
// at these lengths a block walks at most four 64-wide tiles, so their time
// goes to staging, the per-pair softmax and keep bit between the products,
// and a grid of B*H*ceil(L/64) blocks (512 at B=16, H=8, L=256, about four
// to an SM).
//
// The fused rule. Under the causal flag keys past a row exist, masked at
// -1e30, as in the JAX kernel's _scores: a row whose visible keys are all
// padded (an all-pad batch row of decoder self-attention) gets uniform
// weights over all Lk keys, where the streaming kernels give them over the
// keys up to the row. The tensor-core forward then walks every key tile
// for a block whose first row has no valid key; dq and dk agree under both
// rules; dv does not, so dkdv_tc takes the rule as a template argument.
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include "zt_attention_tc.cuh"

namespace {

constexpr int kTile = 32;              // query rows or keys per block
constexpr int kRows = 8;               // rows per warp (4 warps)
constexpr int kThreads = 128;
using Params = zt::AttnParams;
using zt::kMasked;
using zt::row_seed;

__device__ __forceinline__ bool keep_bit(const Params& p, uint32_t seed,
                                         int j) {
  return zt::keep_key(seed, j, p.s1, p.threshold);
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

// ---------------------------------------------------------------------------
// forward: grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) attn_forward(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* qs = smem;                        // [32][dh]
  float* ks = qs + kTile * dh;             // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh]
  float* ps = vs + kTile * dh;             // [32][32]
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = (const T*)p.q + (size_t)bh * p.lq * dh;
  const T* k = (const T*)p.k + (size_t)bh * p.lk * dh;
  const T* v = (const T*)p.v + (size_t)bh * p.lk * dh;
  const float* pad = p.pad + (size_t)b * p.lk;

  stage(qs, q, q0, p.lq, dh, dh);
  float m[kRows], l[kRows], acc[kRows][NC];
  uint32_t seed[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    seed[r] = row_seed(p, bh, q0 + warp * kRows + r);
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
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (dh + 1);
    const float* qr = qs + warp * kRows * dh;
    for (int d = 0; d < dh; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qr[r * dh + d] * kd;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + warp * kRows + r;
      const bool valid = pad_ok && (!p.causal || j <= i);
      float x = valid ? s[r] * p.scale : kMasked;
      if (!exists) x = -INFINITY;
      const float m_new = fmaxf(m[r], zt::warp_max(x));
      const float alpha = expf(m[r] - m_new);
      float e = exists ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + zt::warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      if (p.dropout) e = (exists && keep_bit(p, seed[r], j)) ? e * p.drop_scale
                                                            : 0.f;
      ps[(warp * kRows + r) * kTile + lane] = e;
    }
    __syncwarp();
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < dh ? vs[jj * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = ps[(warp * kRows + r) * kTile + jj];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += e * vv[c];
      }
    }
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
// backward 1: delta = rowsum(dO * O) and dq; grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) attn_backward_dq(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* qs = smem;                        // [32][dh]
  float* dos = qs + kTile * dh;            // [32][dh]
  float* ks = dos + kTile * dh;            // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh + 1]
  float* ps = vs + kTile * (dh + 1);       // [32][32]
  uint32_t* seeds = (uint32_t*)(ps + kTile * kTile);   // [32]
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
  if (threadIdx.x < kTile)
    seeds[threadIdx.x] = row_seed(p, bh, q0 + threadIdx.x);
  __syncthreads();
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
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* kr = ks + lane * (dh + 1);
    const float* vr = vs + lane * (dh + 1);
    const float* qr = qs + warp * kRows * dh;
    const float* dor = dos + warp * kRows * dh;
    for (int d = 0; d < dh; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] += qr[r * dh + d] * kd;
        dp[r] += dor[r * dh + d] * vd;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + warp * kRows + r;
      const bool valid = pad_ok && (!p.causal || j <= i);
      const float x = valid ? s[r] * p.scale : kMasked;
      const float w = exists ? expf(x - m[r]) / l[r] : 0.f;
      float dw = dp[r];
      if (p.dropout)
        dw = (exists && keep_bit(p, seeds[warp * kRows + r], j))
                 ? dw * p.drop_scale : 0.f;
      ps[(warp * kRows + r) * kTile + lane] =
          valid ? w * (dw - delta[r]) : 0.f;
    }
    __syncwarp();
    for (int jj = 0; jj < kTile; ++jj) {
      float kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        kk[c] = d < dh ? ks[jj * (dh + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ds = ps[(warp * kRows + r) * kTile + jj];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += ds * kk[c];
      }
    }
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
}

// ---------------------------------------------------------------------------
// backward 2: dk, dv; grid (ceil(Lk / 32), B*H). Needs delta from kernel 1.
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) attn_backward_dkdv(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* ks = smem;                        // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh + 1]
  float* qs = vs + kTile * (dh + 1);       // [32][dh]
  float* dos = qs + kTile * dh;            // [32][dh]
  float* ps = dos + kTile * dh;            // [32][32] dropped weights
  float* dss = ps + kTile * kTile;         // [32][32] ds
  float* stats = dss + kTile * kTile;      // [3][32] m, l, delta
  uint32_t* seeds = (uint32_t*)(stats + 3 * kTile);   // [32]
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
      seeds[threadIdx.x] = row_seed(p, bh, i);
    }
    __syncthreads();
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* kr = ks + lane * (dh + 1);
    const float* vr = vs + lane * (dh + 1);
    const float* qr = qs + warp * kRows * dh;
    const float* dor = dos + warp * kRows * dh;
    for (int d = 0; d < dh; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] += qr[r * dh + d] * kd;
        dp[r] += dor[r * dh + d] * vd;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      const int i = q0 + rr;
      const bool row_in = i < p.lq;
      const bool valid = row_in && pad_ok && (!p.causal || j <= i);
      const float x = valid ? s[r] * p.scale : kMasked;
      const float w = (exists && row_in)
                          ? expf(x - stats[rr]) / stats[kTile + rr] : 0.f;
      float wd = w, dw = dp[r];
      if (p.dropout) {
        const bool keep = exists && row_in && keep_bit(p, seeds[rr], j);
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

template <typename T, int NC>
cudaError_t forward_nc(const Params& p, int bh, cudaStream_t stream) {
  const size_t bytes = sizeof(float) *
      (size_t)(kTile * p.dh * 2 + kTile * (p.dh + 1) + kTile * kTile);
  cudaError_t err = zt::allow_smem(attn_forward<T, NC>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.lq + kTile - 1) / kTile, bh);
  attn_forward<T, NC><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t backward_nc(const Params& p, int bh, cudaStream_t stream) {
  const size_t dq_bytes = sizeof(float) *
      (size_t)(kTile * p.dh * 2 + kTile * (p.dh + 1) * 2 + kTile * kTile +
               kTile);
  const size_t kv_bytes = dq_bytes + sizeof(float) *
      (size_t)(kTile * kTile + 3 * kTile);
  cudaError_t err = zt::allow_smem(attn_backward_dq<T, NC>, dq_bytes);
  if (err != cudaSuccess) return err;
  err = zt::allow_smem(attn_backward_dkdv<T, NC>, kv_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_q((p.lq + kTile - 1) / kTile, bh);
  attn_backward_dq<T, NC><<<grid_q, kThreads, dq_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((p.lk + kTile - 1) / kTile, bh);
  attn_backward_dkdv<T, NC><<<grid_k, kThreads, kv_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, bool backward,
                     cudaStream_t s) {
  if (p.dh <= 32)
    return backward ? backward_nc<T, 1>(p, bh, s) : forward_nc<T, 1>(p, bh, s);
  if (p.dh <= 64)
    return backward ? backward_nc<T, 2>(p, bh, s) : forward_nc<T, 2>(p, bh, s);
  if (p.dh <= 128)
    return backward ? backward_nc<T, 4>(p, bh, s) : forward_nc<T, 4>(p, bh, s);
  if (p.dh <= 256)
    return backward ? backward_nc<T, 8>(p, bh, s) : forward_nc<T, 8>(p, bh, s);
  return cudaErrorInvalidValue;
}

cudaError_t run(const Params& p, int dtype, int bh, bool backward,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, bh, backward, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, bh, backward, s);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* pad, int heads, int lq, int lk, int dh,
                   int causal, float scale, int dropout,
                   unsigned int threshold, float drop_scale,
                   unsigned int s0, unsigned int s1) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.pad = (const float*)pad;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.dh = dh;
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

extern "C" int zt_attention_forward(
    const void* q, const void* k, const void* v, const void* pad, void* o,
    void* m, void* l, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, heads, lq, lk, dh, causal, scale,
                         dropout, threshold, drop_scale, s0, s1);
  p.out = o;
  p.m = (float*)m;
  p.l = (float*)l;
  return (int)run(p, dtype, batch * heads, false, stream);
}

extern "C" int zt_attention_backward(
    const void* q, const void* k, const void* v, const void* pad,
    const void* o, const void* dout, const void* m, const void* l,
    void* delta, void* dq, void* dk, void* dv, int dtype, int batch,
    int heads, int lq, int lk, int dh, int causal, float scale, int dropout,
    unsigned int threshold, float drop_scale, unsigned int s0,
    unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, heads, lq, lk, dh, causal, scale,
                         dropout, threshold, drop_scale, s0, s1);
  p.o = o;
  p.dout = dout;
  p.m = (float*)m;
  p.l = (float*)l;
  p.delta = (float*)delta;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  return (int)run(p, dtype, batch * heads, true, stream);
}

// The bf16 tensor-core forward: zt_attention_forward's arguments; dtype
// must be 1 and dh a multiple of 16 up to 128 (else cudaErrorInvalidValue).
extern "C" int zt_attention_forward_tc(
    const void* q, const void* k, const void* v, const void* pad, void* o,
    void* m, void* l, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, heads, lq, lk, dh, causal, scale,
                         dropout, threshold, drop_scale, s0, s1);
  p.out = o;
  p.m = (float*)m;
  p.l = (float*)l;
  return zt::tc::run_forward<true>(p, dtype, batch * heads, stream);
}

// The bf16 tensor-core backward: the same arguments; dtype must be 1 and dh
// a multiple of 16 up to 128 (else cudaErrorInvalidValue). Two launches:
// delta and dq, then dk and dv.
extern "C" int zt_attention_backward_tc(
    const void* q, const void* k, const void* v, const void* pad,
    const void* o, const void* dout, const void* m, const void* l,
    void* delta, void* dq, void* dk, void* dv, int dtype, int batch,
    int heads, int lq, int lk, int dh, int causal, float scale, int dropout,
    unsigned int threshold, float drop_scale, unsigned int s0,
    unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, heads, lq, lk, dh, causal, scale,
                         dropout, threshold, drop_scale, s0, s1);
  p.o = o;
  p.dout = dout;
  p.m = (float*)m;
  p.l = (float*)l;
  p.delta = (float*)delta;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  const int err = zt::tc::run_backward<true>(p, dtype, batch * heads, false,
                                             stream);
  if (err != 0) return err;
  return zt::tc::run_backward<true>(p, dtype, batch * heads, true, stream);
}
