// Streaming (key-blocked) attention for training on Hopper (sm_90a): the
// CUDA counterparts of the Pallas TPU kernels in
// zero_tpu/ops/kernels/streaming_attention.py, which the JAX package runs
// for keys past the fused kernel's 8192.
//
//   zt_streaming_forward          replaces _streaming_forward (_fwd_kernel):
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
// The _tc backward kernels (bf16, head depth a multiple of 16 up to 128)
// multiply on the tensor cores; the others (fp32 and bf16 at any depth up to
// 256, and the forward) on the CUDA cores. The wrapper picks
// (ops/kernels/streaming_attention.py:backward_route).
//
// Layout: q [B*H, Lq, Dh], k/v [B*H, Lk, Dh] contiguous, fp32 or bf16; pad
// [B, Lk] fp32 (1 = attend); m, l, delta [B*H, Lq] fp32. Any Lq, Lk (no
// tiling gate); B*H*Lq < 2^32 (the wrapper checks).
//
// Semantics shared by every kernel here.
//   * Causal: keys past a row are absent, not masked. A tile whose first key
//     lies past the block's last row is skipped (forward and dq stop early,
//     dk/dv start at the first query tile that reaches the block's keys), as
//     the TPU kernel skips above-diagonal blocks; a row then normalises over
//     the keys it can see, so skipping changes no number.
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
// Tensor-core backward (bf16; namespace tc), FlashAttention-2 style: the
// weights are recomputed from m and l, and no [Lq, Lk] tensor leaves the SM.
//   * A block is one warpgroup (128 threads) owning 64 query rows (#6) or
//     64 keys (#7), three blocks to an SM. Q, K, V and dO tiles are staged
//     as stored (row-major [rows, Dh], zero past Lq, Lk and Dh) into
//     128-byte-swizzled shared memory (zt_wgmma.cuh) through a cp.async
//     ring; the head depth is padded to DP = 64 or 128 columns. m, l, delta
//     (fp32) come with each query tile, as 4-byte copies, and each query
//     row's seed word is hashed once per tile beside them.
//   * #6 (grid: 64-row query tiles x B*H): delta = rowsum(dO * O) in fp32
//     first, written for #7. Over the 64-key tiles (stopping at the
//     diagonal under the causal flag): S = Q.K^T and dP = dO.V^T by wgmma
//     m64n64k16 (both operands k-major), then, in registers at each
//     fragment's (row, key), the CUDA-core kernels' rule: w = exp(s*scale -
//     m) / l, dP dropped by the keep bit and scaled, dS = valid ? w * (dP -
//     delta) : 0; then dQ += dS.K by wgmma with dS as the A operand from
//     registers (bf16; the accumulator fragment is the A fragment) and the
//     same K tile read m/n-major. dq = dQ * scale in bf16.
//   * #7 (grid: 64-key tiles x B*H): K and V resident in shared memory, dK
//     and dV in fp32 registers. Over the query tiles (64 rows; 32 at DP =
//     128, to keep the accumulators in registers), from the first that
//     reaches the keys under the causal flag: S^T = K.Q^T and dP^T = V.dO^T
//     by wgmma, P^T (its dropped copy) and dS^T by the same rule, then dV +=
//     P_drop^T.dO and dK += dS^T.Q with A from registers and the staged Q
//     and dO tiles read m/n-major. dk = dK * scale, dv = dV in bf16.
//   P and dS are rounded to bf16 as the products' A operands, as in every
//   FlashAttention backward; everything else stays fp32.
//
// Bound. #6 does 6 flops per (row, key) pair and depth (S, dP, dQ), #7 8
// (S, dP, dV, dK), and each reads its inputs and writes its outputs once:
// at B=2, H=4, L=8320, Dh=64 under a pad mask (5.0e8 visible pairs) the
// operation bounds at the 989 TFLOP/s dense bf16 peak are 0.190 ms (#6)
// and 0.253 ms (#7), over ten times the byte bounds. What the kernels meet
// instead (~22% of that peak): per (row, key) pair, an exponential, ~10
// integer operations of the keep bit when dropout is on, and the masks'
// selects, all on the CUDA cores between the products; and each warpgroup
// waits for its own products (no producer warp, no overlap of one tile's
// products with the next tile's softmax inside a warpgroup; three blocks
// to an SM overlap one block's products with another's softmax).
//
// CUDA-core kernels (fp32 and bf16; the forward, and the backward where the
// tensor-core one does not apply). A block owns 32 query rows (forward, dq)
// or 32 keys (dk/dv) of one (batch, head) and walks the other axis in tiles
// of 32 staged in shared memory as fp32, one fused multiply-add per
// shared-memory read (~10 TFLOP/s). fp32 stays here because the small fp32
// reference models need exact products (TF32 would give ~1e-3 against their
// 1e-4 tolerance).
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launch.

#include "zt_common.cuh"
#include "zt_wgmma.cuh"

namespace {

constexpr int kTile = 32;              // query rows or keys per block
constexpr int kRows = 8;               // rows per warp (4 warps)
constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;      // NEG_INF of the JAX kernel

struct Params {
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
__device__ __forceinline__ uint32_t row_seed(const Params& p, int bh, int i) {
  if (!p.dropout) return 0u;
  return zt::row_seed((uint32_t)bh * (uint32_t)p.lq + (uint32_t)i, p.s0,
                      p.s1);
}

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

// ---------------------------------------------------------------------------
// bf16 tensor-core backward: #6 dq_tc, #7 dkdv_tc
// ---------------------------------------------------------------------------
namespace tc {

using namespace zt::wg;   // cp.async ring, swizzle, descriptors, wgmma
using bf16 = __nv_bfloat16;

constexpr int kThreadsTC = 128;   // one warpgroup
constexpr int kBlockRows = 64;    // query rows (#6) or keys (#7) of a block
constexpr int kKeys = 64;         // keys of a tile that #6 walks
// cp.async ring slots and resident blocks per SM of #6 and #7 (at DP = 64;
// one at DP = 128), chosen on the card at B=2, H=4, L=8320 (PERF.md,
// Findings): one warpgroup a block with three blocks to an SM ran faster
// than two warpgroups sharing their tiles with one block to an SM, because
// blocks that are not in step overlap one's products with another's
// softmax.
constexpr int kDqStages = 3, kDqMinBlocks = 3;
constexpr int kKvStages = 3, kKvMinBlocks = 3;
constexpr float kLog2e = 1.4426950408889634f;

// queries of a tile that #7 walks: 64, or 32 at DP = 128 so that dK, dV, S
// and dP (160 fp32 a thread) stay in registers
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

// The rows of a #6 thread (fragment rows h = 0, 1).
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

// #6: delta = rowsum(dO * O) and dq; grid (ceil(Lq / kBlockRows), B*H)
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

// The keys of a #7 thread (fragment rows h = 0, 1).
struct DkvKeys {
  int key[2];
  bool key_in[2], pad_ok[2];
};

// P_drop^T (into dp) and dS^T (into s) at each fragment's (key, query row)
// of the query tile at qt0, whose rows' m, l, delta and seed are st[]. EDGE:
// the tile may hold rows past Lq or, under the causal flag, rows before a
// key; else each key exists for every row.
template <int BQ, bool EDGE>
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
        const bool exists =
            kv.key_in[h] &&
            (!EDGE || (i < p.lq && (!p.causal || kv.key[h] <= i)));
        const bool valid = exists && kv.pad_ok[h];
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

// #7: dk, dv; grid (ceil(Lk / kBlockRows), B*H); reads delta from #6
template <int DP>
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
  const int t0 = p.causal ? k0 / BQ : 0;
  const int tiles = (p.lq + BQ - 1) / BQ;

  auto load = [&](int slot, int t) {
    const int qt0 = t * BQ;
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
    if (t0 + s < tiles) load(s, t0 + s);
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

  for (int t = t0; t < tiles; ++t) {
    const int u = t - t0, qt0 = t * BQ;
    cp_async_wait<kKvStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (t + kKvStages - 1 < tiles)
      load((u + kKvStages - 1) % kKvStages, t + kKvStages - 1);
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
      dkdv_scores<BQ, true>(p, s, dp, stats + slot * BQ, qt0, kv,
                            scale_log2);
    else
      dkdv_scores<BQ, false>(p, s, dp, stats + slot * BQ, qt0, kv,
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

template <int DP>
cudaError_t launch_dp(const Params& p, int bh, bool dkdv, cudaStream_t s) {
  cudaError_t err;
  if (!dkdv) {
    err = zt::allow_smem(dq_tc<DP>, dq_smem<DP>());
    if (err != cudaSuccess) return err;
    dim3 grid((p.lq + kBlockRows - 1) / kBlockRows, bh);
    dq_tc<DP><<<grid, kThreadsTC, dq_smem<DP>(), s>>>(p);
  } else {
    err = zt::allow_smem(dkdv_tc<DP>, dkdv_smem<DP>());
    if (err != cudaSuccess) return err;
    dim3 grid((p.lk + kBlockRows - 1) / kBlockRows, bh);
    dkdv_tc<DP><<<grid, kThreadsTC, dkdv_smem<DP>(), s>>>(p);
  }
  return cudaGetLastError();
}

// bf16 only; head depth a multiple of 16 up to 128
int run(const Params& p, int dtype, int bh, bool dkdv, void* stream) {
  if (dtype != 1 || p.dh % 16 != 0 || p.dh > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.dh <= 64 ? launch_dp<64>(p, bh, dkdv, s)
                          : launch_dp<128>(p, bh, dkdv, s));
}

}  // namespace tc

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

// The bf16 tensor-core backward (#6, #7): the same arguments; dtype must be
// 1 and dh a multiple of 16 up to 128 (else cudaErrorInvalidValue).
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
  return tc::run(p, dtype, batch * heads, false, stream);
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
  return tc::run(p, dtype, batch * heads, true, stream);
}
