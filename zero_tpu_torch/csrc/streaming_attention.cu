// Streaming (key-blocked) attention for training on Hopper (sm_90a): the
// CUDA counterparts of the Pallas TPU kernels in
// zero_tpu/ops/kernels/streaming_attention.py, which the JAX package runs
// for keys past the fused kernel's 8192.
//
//   zt_streaming_forward(_tc)       replace _streaming_forward (_fwd_kernel):
//                                 masked scores q.k^T * Dh^-0.5 under a key
//                                 pad mask and a causal flag, an fp32 online
//                                 softmax over key tiles, dropout on the
//                                 accumulated p only (l undropped), o = acc
//                                 / l. Writes the per-row max m and sum l
//                                 (fp32) apart.
//   zt_streaming_backward_dq(_tc)   replace the dq pallas_call of _bwd_rule
//                                 (_dq_kernel): delta = rowsum(dO * O), then
//                                 dq over the key tiles.
//   zt_streaming_backward_dkdv(_tc) replace the dk/dv pallas_call of
//                                 _bwd_rule (_dkv_kernel): a block owns a key
//                                 tile and walks the query tiles.
// The _tc kernels (bf16, head depth a multiple of 16 up to 128) multiply on
// the tensor cores; the others (fp32 and bf16 at any depth up to 256) on the
// CUDA cores. The wrapper picks (ops/kernels/streaming_attention.py:route).
//
// Layout: q [B*H, Lq, Dh], k/v [B*H, Lk, Dh] contiguous, fp32 or bf16; pad
// [B, Lk] fp32 (1 = attend); m, l, delta [B*H, Lq] fp32. Any Lq, Lk (no
// tiling gate); B*H*Lq < 2^32 (the wrapper checks).
//
// Semantics shared by every kernel here.
//   * Causal: keys past a row are absent, not masked (the streaming rule of
//     zt_attention_tc.cuh). A tile whose first key lies past the block's
//     last row is skipped (forward and dq stop early, dk/dv start at the
//     first query tile that reaches the block's keys), as the TPU kernel
//     skips above-diagonal blocks; a row then normalises over the keys it
//     can see, so skipping changes no number.
//   * Fully-masked rows (every visible key padded): scores are -1e30, so the
//     forward gives uniform weights over the visible keys. The backward
//     rebuilds the weights as exp(s - m) / l from m and l stored apart. The
//     TPU kernel stores lse = m + log l, which rounds to -1e30 on such a row
//     and gives weight 1 instead of 1/Lk; here such a row gets zero dq and
//     dk and a 1/Lk share of dO in dv, as softmax does.
//   * Dropout bits are 64-bit safe: element (row r = bh*Lq + i, key j) keeps
//     iff hash_bits(j, hash_bits(r, s0, s1), s1) < threshold (zt::row_seed,
//     zt::keep_key; kernels #1-#4 draw the same). A per-row seed word, hashed
//     once per row, then the key index: no B*H*Lq*Lk linear index that wraps
//     at 2^32 (it does at B=2, H=8, L=16384). The bit depends on the element
//     only, so forward and backward agree, and the plain PyTorch version
//     (streaming_attention_ref) reproduces it.
//   * No atomics and no split over keys or queries: every sum runs in a
//     fixed order, so dq, dk and dv are the same from run to run.
//
// Tensor-core kernels (bf16, zt_attention_tc.cuh under the streaming
// rule): #5 is zt::tc::forward_tc<DP, false>, FlashAttention-2's forward on
// wgmma, #6 zt::tc::dq_tc and #7 zt::tc::dkdv_tc<DP, false>. The fused
// kernels #1/#2 run the same kernels under the fused rule. Under the causal
// flag the forward walk stops at the diagonal tile; only that tile and the
// one straddling Lk take the edge rules. m and l are written in the units
// the backward reads (m the max of s * Dh^-0.5 or -1e30, l the undropped
// sum); the JAX kernel multiplies P by V in fp32, these round P to bf16
// first, as FlashAttention does.
//
// Bound. #5 does 4 flops per (row, key) pair and depth (S, P.V), #6 6 (S,
// dP, dQ), #7 8 (S, dP, dV, dK), and each reads its inputs and writes its
// outputs once: at B=2, H=4, L=8320, Dh=64 under a pad mask (5.0e8 visible
// pairs) the operation bounds at the 989 TFLOP/s dense bf16 peak are
// 0.127 ms (#5), 0.190 ms (#6) and 0.253 ms (#7), over ten times the byte
// bounds. What the tensor-core kernels meet instead: per (row, key) pair,
// an exponential, ~10 integer operations of the keep bit when dropout is
// on, and the masks' selects, all on the CUDA cores between the products
// (the forward also walks the padded keys, which exist at -1e30); and each
// warpgroup waits for its own products (no producer warp, no overlap of one
// tile's products with the next tile's softmax inside a warpgroup; three
// blocks to an SM overlap one block's products with another's softmax).
//
// CUDA-core kernels (fp32 and bf16 where the tensor-core ones do not
// apply). A block owns 32 query rows (forward, dq) or 32 keys (dk/dv) of
// one (batch, head) and walks the other axis in tiles of 32 staged in
// shared memory as fp32, one fused multiply-add per shared-memory read
// (~10 TFLOP/s). fp32 stays here because the small fp32 reference models
// need exact products (TF32 would give ~1e-3 against their 1e-4
// tolerance).
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launch.

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

// Keys a block of query rows [q0, q0 + kTile) walks: all, or under the
// causal flag those up to its last row.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  return p.causal ? min(p.lk, q0 + kTile) : p.lk;
}

// ---------------------------------------------------------------------------
// #5 forward: grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) stream_forward(Params p) {
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

  const int k_end = key_end(p, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(ks, k, k0, p.lk, dh, dh + 1);
    stage(vs, v, k0, p.lk, dh, dh);
    __syncthreads();
    const int j = k0 + lane;
    const bool in_keys = j < p.lk;
    const bool pad_ok = in_keys && pad[in_keys ? j : 0] > 0.f;
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
      const bool exists = in_keys && (!p.causal || j <= i);
      const float x =
          exists ? (pad_ok ? s[r] * p.scale : kMasked) : -INFINITY;
      // key 0 exists for every row, so m_new is finite from the first tile
      const float m_new = fmaxf(m[r], zt::warp_max(x));
      const float alpha = expf(m[r] - m_new);
      float e = exists ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + zt::warp_sum(e);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      if (p.dropout)
        e = (exists && keep_bit(p, seed[r], j)) ? e * p.drop_scale : 0.f;
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
// #6 backward dq: delta = rowsum(dO * O) and dq; grid (ceil(Lq / 32), B*H)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) stream_backward_dq(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* qs = smem;                        // [32][dh]
  float* dos = qs + kTile * dh;            // [32][dh]
  float* ks = dos + kTile * dh;            // [32][dh + 1]
  float* vs = ks + kTile * (dh + 1);       // [32][dh + 1]
  float* ps = vs + kTile * (dh + 1);       // [32][32]
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
  __syncthreads();
  float m[kRows], l[kRows], delta[kRows], acc[kRows][NC];
  uint32_t seed[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    const bool in = i < p.lq;
    float part = 0.f;
    if (in) {
      for (int d = lane; d < dh; d += 32)
        part += dos[(warp * kRows + r) * dh + d] *
                zt::to_float(o[(size_t)i * dh + d]);
    }
    delta[r] = zt::warp_sum(part);
    m[r] = in ? p.m[(size_t)bh * p.lq + i] : 0.f;
    l[r] = in ? p.l[(size_t)bh * p.lq + i] : 1.f;
    seed[r] = row_seed(p, bh, i);
    if (in && lane == 0) p.delta[(size_t)bh * p.lq + i] = delta[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int k_end = key_end(p, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage(ks, k, k0, p.lk, dh, dh + 1);
    stage(vs, v, k0, p.lk, dh, dh + 1);
    __syncthreads();
    const int j = k0 + lane;
    const bool in_keys = j < p.lk;
    const bool pad_ok = in_keys && pad[in_keys ? j : 0] > 0.f;
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
      const bool exists = in_keys && (!p.causal || j <= i);
      const bool valid = exists && pad_ok;
      const float x = valid ? s[r] * p.scale : kMasked;
      const float w = exists ? expf(x - m[r]) / l[r] : 0.f;
      float dw = dp[r];
      if (p.dropout)
        dw = (exists && keep_bit(p, seed[r], j)) ? dw * p.drop_scale : 0.f;
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
      if (d < dh)
        dq[(size_t)i * dh + d] = zt::from_float<T>(acc[r][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// #7 backward dk, dv: grid (ceil(Lk / 32), B*H); reads delta from #6
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) stream_backward_dkdv(Params p) {
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
  const bool in_keys = j < p.lk;
  const bool pad_ok = in_keys && pad[in_keys ? j : 0] > 0.f;
  float dk[kRows][NC], dv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  // causal: the first query tile holding a row that sees key k0
  const int q_begin = p.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < p.lq; q0 += kTile) {
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
      const bool exists = in_keys && i < p.lq && (!p.causal || j <= i);
      const bool valid = exists && pad_ok;
      const float x = valid ? s[r] * p.scale : kMasked;
      const float w =
          exists ? expf(x - stats[rr]) / stats[kTile + rr] : 0.f;
      float wd = w, dw = dp[r];
      if (p.dropout) {
        const bool keep = exists && keep_bit(p, seeds[rr], j);
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

enum Which { kForward = 0, kDq = 1, kDkdv = 2 };

template <typename T, int NC>
cudaError_t launch_nc(const Params& p, int bh, Which which,
                      cudaStream_t stream) {
  const int dh = p.dh;
  cudaError_t err;
  if (which == kForward) {
    const size_t bytes = sizeof(float) *
        (size_t)(kTile * dh * 2 + kTile * (dh + 1) + kTile * kTile);
    err = zt::allow_smem(stream_forward<T, NC>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.lq + kTile - 1) / kTile, bh);
    stream_forward<T, NC><<<grid, kThreads, bytes, stream>>>(p);
  } else if (which == kDq) {
    const size_t bytes = sizeof(float) *
        (size_t)(kTile * dh * 2 + kTile * (dh + 1) * 2 + kTile * kTile);
    err = zt::allow_smem(stream_backward_dq<T, NC>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.lq + kTile - 1) / kTile, bh);
    stream_backward_dq<T, NC><<<grid, kThreads, bytes, stream>>>(p);
  } else {
    const size_t bytes = sizeof(float) *
        (size_t)(kTile * dh * 2 + kTile * (dh + 1) * 2 + 2 * kTile * kTile +
                 4 * kTile);
    err = zt::allow_smem(stream_backward_dkdv<T, NC>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.lk + kTile - 1) / kTile, bh);
    stream_backward_dkdv<T, NC><<<grid, kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, Which which, cudaStream_t s) {
  if (p.dh <= 32) return launch_nc<T, 1>(p, bh, which, s);
  if (p.dh <= 64) return launch_nc<T, 2>(p, bh, which, s);
  if (p.dh <= 128) return launch_nc<T, 4>(p, bh, which, s);
  if (p.dh <= 256) return launch_nc<T, 8>(p, bh, which, s);
  return cudaErrorInvalidValue;
}

int run(const Params& p, int dtype, int bh, Which which, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(p, bh, which, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, bh, which, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* pad, const void* m, const void* l, int heads,
                   int lq, int lk, int dh, int causal, float scale,
                   int dropout, unsigned int threshold, float drop_scale,
                   unsigned int s0, unsigned int s1) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.pad = (const float*)pad;
  p.m = (float*)m;
  p.l = (float*)l;
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

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int zt_streaming_forward(
    const void* q, const void* k, const void* v, const void* pad, void* o,
    void* m, void* l, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.out = o;
  return run(p, dtype, batch * heads, kForward, stream);
}

extern "C" int zt_streaming_backward_dq(
    const void* q, const void* k, const void* v, const void* pad,
    const void* o, const void* dout, const void* m, const void* l,
    void* delta, void* dq, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.o = o;
  p.dout = dout;
  p.delta = (float*)delta;
  p.out = dq;
  return run(p, dtype, batch * heads, kDq, stream);
}

extern "C" int zt_streaming_backward_dkdv(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, const void* m, const void* l, const void* delta,
    void* dk, void* dv, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.dout = dout;
  p.delta = (float*)delta;
  p.dk = dk;
  p.dv = dv;
  return run(p, dtype, batch * heads, kDkdv, stream);
}

// The bf16 tensor-core kernels (#5, #6, #7): the same arguments; dtype
// must be 1 and dh a multiple of 16 up to 128 (else cudaErrorInvalidValue).
extern "C" int zt_streaming_forward_tc(
    const void* q, const void* k, const void* v, const void* pad, void* o,
    void* m, void* l, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.out = o;
  return zt::tc::run_forward<false>(p, dtype, batch * heads, stream);
}

extern "C" int zt_streaming_backward_dq_tc(
    const void* q, const void* k, const void* v, const void* pad,
    const void* o, const void* dout, const void* m, const void* l,
    void* delta, void* dq, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.o = o;
  p.dout = dout;
  p.delta = (float*)delta;
  p.out = dq;
  return zt::tc::run_backward<false>(p, dtype, batch * heads, false,
                                     stream);
}

extern "C" int zt_streaming_backward_dkdv_tc(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, const void* m, const void* l, const void* delta,
    void* dk, void* dv, int dtype, int batch, int heads, int lq, int lk,
    int dh, int causal, float scale, int dropout, unsigned int threshold,
    float drop_scale, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(q, k, v, pad, m, l, heads, lq, lk, dh, causal,
                         scale, dropout, threshold, drop_scale, s0, s1);
  p.dout = dout;
  p.delta = (float*)delta;
  p.dk = dk;
  p.dv = dv;
  return zt::tc::run_backward<false>(p, dtype, batch * heads, true,
                                     stream);
}
