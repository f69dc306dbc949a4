// Fused FFN (linear -> ReLU -> dropout -> linear) for training on Hopper
// (sm_90a): the CUDA counterparts of the Pallas TPU kernels in
// zero_tpu/ops/kernels/fused_ffn.py.
//
//   zt_ffn_forward   replaces _fused_forward (_fwd_kernel):
//                    y = drop(relu(x @ W1 + b1)) @ W2 + b2. A block owns 16
//                    rows and walks the filter axis in chunks of 64: the
//                    [16, 64] hidden chunk lives in shared memory and is
//                    multiplied into the block's [16, d_out] fp32
//                    accumulator at once, so the [N, filter] hidden tensor
//                    is never stored.
//   zt_ffn_backward  replaces _bwd_rule (_bwd_kernel). Kernel 1 (rows, like
//                    the forward) regenerates the hidden chunk and its
//                    mask, forms dh = relu'(h) * mask * scale * (dy @ W2^T),
//                    accumulates dx = dh @ W1^T, and writes the dropped
//                    hidden h_d and dh in the compute dtype plus per-block
//                    partial column sums of dh (for db1). Kernel 2 gives
//                    dW1 = x^T @ dh and dW2 = h_d^T @ dy: each block owns
//                    one 64x64 tile of the weight gradient and reduces over
//                    all N rows itself. Kernel 3 sums columns (db2 from dy,
//                    db1 from the partials). No atomics, no split-K: the
//                    sums are deterministic. This is the "second reduction
//                    kernel" way across the grid; the TPU kernel instead
//                    carried dW in an output block revisited by its
//                    sequential grid, which Hopper's parallel blocks cannot
//                    do.
//
// Rounding follows the JAX kernel and the plain PyTorch version: the
// products accumulate in fp32, x @ W1 is rounded to the compute dtype, then
// + b1 is rounded, relu, the dropout scale multiplies in the compute dtype,
// h_d @ W2 is rounded and + b2 rounded. dx is rounded once at the end; dW
// and db stay fp32 (the wrapper casts to the parameter dtype).
//
// Dropout: keep bit of hidden element (row, col) is
// (hash_bits(row * filter + col, s0, s1) & 255) < t, scale 256/t: the same
// mask as zero_tpu/ops/common.py:dropout draws over the [N, filter] hidden
// tensor from the same two key words. It depends on the element only, so
// forward and backward need no shared tiling.
//
// Bound. At transformer-base (N = 4096 tokens, 512 -> 2048 -> 512) the
// forward is 17 GFLOP against ~6 MB of inputs and outputs, so a tensor-core
// kernel is bound by operations. This first kernel multiplies on the CUDA
// cores in fp32 (exact for the fp32 path), reading weights through L1/L2
// with coalesced loads; tensor cores are later work.
//
// Layout: row-major x [N, d_in], W1 [d_in, f], W2 [f, d_out], and for the
// backward the transposes W1^T [f, d_in], W2^T [d_out, f] (made by the
// wrapper). d_in, d_out <= 1024; any N and f.
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include "zt_common.cuh"

namespace {

constexpr int kRowsPerBlock = 16;   // token rows per block
constexpr int kChunk = 64;          // filter columns per chunk
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kRowsPerBlock * kChunk / kThreads;  // 4

struct Params {
  const void* x;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const void* w1t;
  const void* w2t;
  const void* dy;
  void* y;       // forward: y; backward: dx
  void* hd;      // backward: dropped hidden [N, f]
  void* dh;      // backward: dh in the compute dtype [N, f]
  float* db1_part;  // backward: [blocks, f]
  int n, din, f, dout, dropout, t;
  float inv;
  uint32_t s0, s1;
};

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int width) {
  for (int e = threadIdx.x; e < kRowsPerBlock * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    dst[e] = (r0 + r < rows) ? zt::to_float(src[(size_t)(r0 + r) * width + c])
                             : 0.f;
  }
}

__device__ __forceinline__ bool ffn_keep(const Params& p, int row, int col) {
  const uint32_t index = (uint32_t)row * (uint32_t)p.f + (uint32_t)col;
  return (zt::hash_bits(index, p.s0, p.s1) & 255u) < (uint32_t)p.t;
}

// ---------------------------------------------------------------------------
// forward: grid ceil(N / 16); OC = ceil(d_out / 256)
// ---------------------------------------------------------------------------
template <typename T, int OC>
__global__ void __launch_bounds__(kThreads) ffn_forward(Params p) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [16][d_in]
  float* hs = xs + kRowsPerBlock * p.din;        // [16][64]
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int hcol = tid % kChunk;
  const int hrow = (tid / kChunk) * kRowsPerThread;
  const T* w1 = (const T*)p.w1;
  const T* b1 = (const T*)p.b1;
  const T* w2 = (const T*)p.w2;
  const T* b2 = (const T*)p.b2;
  stage_rows(xs, (const T*)p.x, r0, p.n, p.din);
  float acc[kRowsPerBlock][OC];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < p.f; f0 += kChunk) {
    const int col = f0 + hcol;
    float h[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) h[r] = 0.f;
    if (col < p.f) {
      for (int kk = 0; kk < p.din; ++kk) {
        const float w = zt::to_float(w1[(size_t)kk * p.f + col]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          h[r] += xs[(hrow + r) * p.din + kk] * w;
      }
      const float bias = zt::to_float(b1[col]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        float v = zt::round_to<T>(zt::round_to<T>(h[r]) + bias);
        v = fmaxf(v, 0.f);
        if (p.dropout)
          v = ffn_keep(p, r0 + hrow + r, col) ? zt::round_to<T>(v * p.inv)
                                              : 0.f;
        h[r] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      hs[(hrow + r) * kChunk + hcol] = h[r];
    __syncthreads();
    const int width = min(kChunk, p.f - f0);
    for (int jj = 0; jj < width; ++jj) {
      float w[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int oc = tid + kThreads * c;
        w[c] = oc < p.dout ? zt::to_float(w2[(size_t)(f0 + jj) * p.dout + oc])
                           : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        const float hv = hs[r * kChunk + jj];
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[r][c] += hv * w[c];
      }
    }
    __syncthreads();
  }

  T* y = (T*)p.y;
#pragma unroll
  for (int c = 0; c < OC; ++c) {
    const int oc = tid + kThreads * c;
    if (oc >= p.dout) continue;
    const float bias = zt::to_float(b2[oc]);
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      if (r0 + r < p.n)
        y[(size_t)(r0 + r) * p.dout + oc] =
            zt::from_float<T>(zt::round_to<T>(acc[r][c]) + bias);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1 (rows): grid ceil(N / 16); IC = ceil(d_in / 256)
// ---------------------------------------------------------------------------
template <typename T, int IC>
__global__ void __launch_bounds__(kThreads) ffn_backward_rows(Params p) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [16][d_in]
  float* dys = xs + kRowsPerBlock * p.din;       // [16][d_out]
  float* hs = dys + kRowsPerBlock * p.dout;      // [16][64] dh (rounded)
  float* sums = hs + kRowsPerBlock * kChunk;     // [4][64] dh column sums
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int hcol = tid % kChunk;
  const int group = tid / kChunk;
  const int hrow = group * kRowsPerThread;
  const T* w1 = (const T*)p.w1;
  const T* b1 = (const T*)p.b1;
  const T* w1t = (const T*)p.w1t;
  const T* w2t = (const T*)p.w2t;
  T* hd_out = (T*)p.hd;
  T* dh_out = (T*)p.dh;
  stage_rows(xs, (const T*)p.x, r0, p.n, p.din);
  stage_rows(dys, (const T*)p.dy, r0, p.n, p.dout);
  float acc[kRowsPerBlock][IC];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < IC; ++c) acc[r][c] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < p.f; f0 += kChunk) {
    const int col = f0 + hcol;
    float dh[kRowsPerThread];
    float colsum = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dh[r] = 0.f;
    if (col < p.f) {
      float h[kRowsPerThread], g[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) h[r] = g[r] = 0.f;
      for (int kk = 0; kk < p.din; ++kk) {
        const float w = zt::to_float(w1[(size_t)kk * p.f + col]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          h[r] += xs[(hrow + r) * p.din + kk] * w;
      }
      for (int cc = 0; cc < p.dout; ++cc) {
        const float w = zt::to_float(w2t[(size_t)cc * p.f + col]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          g[r] += dys[(hrow + r) * p.dout + cc] * w;
      }
      const float bias = zt::to_float(b1[col]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = r0 + hrow + r;
        const float pre = zt::round_to<T>(zt::round_to<T>(h[r]) + bias);
        float hv = fmaxf(pre, 0.f);
        float gd = g[r];
        if (p.dropout) {
          const bool keep = ffn_keep(p, row, col);
          hv = keep ? zt::round_to<T>(hv * p.inv) : 0.f;
          gd = keep ? gd * p.inv : 0.f;
        }
        const float d = pre > 0.f ? gd : 0.f;
        if (row < p.n) {
          hd_out[(size_t)row * p.f + col] = zt::from_float<T>(hv);
          dh_out[(size_t)row * p.f + col] = zt::from_float<T>(d);
          colsum += d;
        }
        dh[r] = zt::round_to<T>(d);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      hs[(hrow + r) * kChunk + hcol] = dh[r];
    sums[group * kChunk + hcol] = colsum;
    __syncthreads();
    if (tid < kChunk && f0 + tid < p.f) {
      float s = 0.f;
#pragma unroll
      for (int gi = 0; gi < kThreads / kChunk; ++gi) s += sums[gi * kChunk + tid];
      p.db1_part[(size_t)blockIdx.x * p.f + f0 + tid] = s;
    }
    const int width = min(kChunk, p.f - f0);
    for (int jj = 0; jj < width; ++jj) {
      float w[IC];
#pragma unroll
      for (int c = 0; c < IC; ++c) {
        const int ic = tid + kThreads * c;
        w[c] = ic < p.din ? zt::to_float(w1t[(size_t)(f0 + jj) * p.din + ic])
                          : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        const float dv = hs[r * kChunk + jj];
#pragma unroll
        for (int c = 0; c < IC; ++c) acc[r][c] += dv * w[c];
      }
    }
    __syncthreads();
  }

  T* dx = (T*)p.y;
#pragma unroll
  for (int c = 0; c < IC; ++c) {
    const int ic = tid + kThreads * c;
    if (ic >= p.din) continue;
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      if (r0 + r < p.n)
        dx[(size_t)(r0 + r) * p.din + ic] = zt::from_float<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: C[P, Q] = sum_n A[n, p] * B[n, q] (fp32 out); 64x64 tiles,
// each thread a 4x4 block, n in chunks of 16. grid (ceil(Q/64), ceil(P/64))
// ---------------------------------------------------------------------------
constexpr int kGT = 64;
constexpr int kGN = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_tn(const T* a, const T* b,
                                                    float* c, int n, int P,
                                                    int Q) {
  __shared__ float as[kGN][kGT];
  __shared__ float bs[kGN][kGT];
  const int p0 = blockIdx.y * kGT, q0 = blockIdx.x * kGT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < n; n0 += kGN) {
    for (int e = tid; e < kGN * kGT; e += kThreads) {
      const int nn = e / kGT, cc = e - nn * kGT;
      const int row = n0 + nn;
      as[nn][cc] = (row < n && p0 + cc < P)
                       ? zt::to_float(a[(size_t)row * P + p0 + cc]) : 0.f;
      bs[nn][cc] = (row < n && q0 + cc < Q)
                       ? zt::to_float(b[(size_t)row * Q + q0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kGN; ++nn) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[nn][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[nn][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = p0 + ty * 4 + i;
    if (pp >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = q0 + tx * 4 + j;
      if (qq < Q) c[(size_t)pp * Q + qq] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: out[c] = sum_r A[r, c]; blocks of 32 columns x 8 row slices
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) column_sums(const T* a, float* out,
                                                        int rows, int cols) {
  __shared__ float part[8][32];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int slice = threadIdx.x >> 5;
  float s = 0.f;
  if (c < cols)
    for (int r = slice; r < rows; r += 8) s += zt::to_float(a[(size_t)r * cols + c]);
  part[slice][threadIdx.x & 31] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x];
    out[c] = t;
  }
}

template <typename T, int OC>
cudaError_t forward_oc(const Params& p, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (size_t)(kRowsPerBlock * (p.din + kChunk));
  cudaError_t err = zt::allow_smem(ffn_forward<T, OC>, bytes);
  if (err != cudaSuccess) return err;
  ffn_forward<T, OC><<<(p.n + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                       bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const Params& p, cudaStream_t s) {
  if (p.dout <= 256) return forward_oc<T, 1>(p, s);
  if (p.dout <= 512) return forward_oc<T, 2>(p, s);
  if (p.dout <= 1024) return forward_oc<T, 4>(p, s);
  return cudaErrorInvalidValue;
}

template <typename T, int IC>
cudaError_t backward_rows_ic(const Params& p, cudaStream_t s) {
  const size_t bytes = sizeof(float) *
      (size_t)(kRowsPerBlock * (p.din + p.dout + kChunk) +
               (kThreads / kChunk) * kChunk);
  cudaError_t err = zt::allow_smem(ffn_backward_rows<T, IC>, bytes);
  if (err != cudaSuccess) return err;
  ffn_backward_rows<T, IC><<<(p.n + kRowsPerBlock - 1) / kRowsPerBlock,
                             kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const Params& p, float* dw1, float* dw2, float* db1,
                     float* db2, cudaStream_t s) {
  cudaError_t err;
  if (p.din <= 256) err = backward_rows_ic<T, 1>(p, s);
  else if (p.din <= 512) err = backward_rows_ic<T, 2>(p, s);
  else if (p.din <= 1024) err = backward_rows_ic<T, 4>(p, s);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  // dW1 [d_in, f] = x^T @ dh ; dW2 [f, d_out] = h_d^T @ dy
  dim3 g1((p.f + kGT - 1) / kGT, (p.din + kGT - 1) / kGT);
  gemm_tn<T><<<g1, kThreads, 0, s>>>((const T*)p.x, (const T*)p.dh, dw1, p.n,
                                     p.din, p.f);
  dim3 g2((p.dout + kGT - 1) / kGT, (p.f + kGT - 1) / kGT);
  gemm_tn<T><<<g2, kThreads, 0, s>>>((const T*)p.hd, (const T*)p.dy, dw2,
                                     p.n, p.f, p.dout);
  const int blocks = (p.n + kRowsPerBlock - 1) / kRowsPerBlock;
  column_sums<float><<<(p.f + 31) / 32, kThreads, 0, s>>>(p.db1_part, db1,
                                                          blocks, p.f);
  column_sums<T><<<(p.dout + 31) / 32, kThreads, 0, s>>>((const T*)p.dy, db2,
                                                         p.n, p.dout);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* w1, const void* b1,
                   const void* w2, int n, int din, int f, int dout,
                   int dropout, int t, float inv, unsigned int s0,
                   unsigned int s1) {
  Params p = {};
  p.x = x;
  p.w1 = w1;
  p.b1 = b1;
  p.w2 = w2;
  p.n = n;
  p.din = din;
  p.f = f;
  p.dout = dout;
  p.dropout = dropout;
  p.t = t;
  p.inv = inv;
  p.s0 = s0;
  p.s1 = s1;
  return p;
}

}  // namespace

extern "C" int zt_ffn_forward(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y,
                              int dtype, int n, int din, int f, int dout,
                              int dropout, int t, float inv, unsigned int s0,
                              unsigned int s1, void* stream) {
  Params p = make_params(x, w1, b1, w2, n, din, f, dout, dropout, t, inv, s0,
                         s1);
  p.b2 = b2;
  p.y = y;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)forward<float>(p, s);
  if (dtype == 1) return (int)forward<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zt_ffn_backward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* w1t, const void* w2t, const void* dy, void* dx, void* hd,
    void* dh, void* db1_part, void* dw1, void* db1, void* dw2, void* db2,
    int dtype, int n, int din, int f, int dout, int dropout, int t,
    float inv, unsigned int s0, unsigned int s1, void* stream) {
  Params p = make_params(x, w1, b1, w2, n, din, f, dout, dropout, t, inv, s0,
                         s1);
  p.w1t = w1t;
  p.w2t = w2t;
  p.dy = dy;
  p.y = dx;
  p.hd = hd;
  p.dh = dh;
  p.db1_part = (float*)db1_part;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)backward<float>(p, (float*)dw1, (float*)dw2, (float*)db1,
                                (float*)db2, s);
  if (dtype == 1)
    return (int)backward<__nv_bfloat16>(p, (float*)dw1, (float*)dw2,
                                        (float*)db1, (float*)db2, s);
  return (int)cudaErrorInvalidValue;
}
