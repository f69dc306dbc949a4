// Fused FFN (linear -> ReLU -> dropout -> linear) for training on Hopper
// (sm_90a): the CUDA counterparts of the Pallas TPU kernels in
// zero_tpu/ops/kernels/fused_ffn.py. Two families, chosen by dtype:
//
// bf16: tensor-core kernels. Each block computes a 128 x 128 output tile
// with two warpgroups, each issuing wgmma.mma_async m64n128k16 (bf16 in,
// fp32 accumulators in registers) on operands in 128-byte-swizzled shared
// memory; the operands stream through a ring of 2-4 slots of 64-deep K
// filled by cp.async (16-byte copies, zero past the edges). k-major and
// m/n-major operands are both read as stored, the latter by wgmma's
// transpose bit, so no transposed copy of a weight or activation is made.
// Epilogues run on the accumulator registers, where each fragment's (row,
// col) is known, and write through a staged tile in shared memory with
// 16-byte stores.
//   zt_ffn_forward   replaces _fused_forward (_fwd_kernel) with two
//                    products and fused epilogues:
//                    (a) tc::ffn_hidden  H_d = drop(relu(round(round(X @ W1)
//                        + b1))) written once in bf16, [N, f];
//                    (b) tc::ffn_out     Y = round(round(H_d @ W2) + b2).
//   zt_ffn_backward  replaces _bwd_rule (_bwd_kernel):
//                    (c) tc::ffn_bwd_hidden, over [N, f] tiles, recomputes
//                        pre = round(round(X @ W1) + b1) (held in shared
//                        memory), then dY @ W2^T (W2 read k-major as
//                        stored), and writes h_d and dh = relu'(pre) *
//                        keep * scale * (dY @ W2^T) in bf16, plus per-tile
//                        fp32 column partials of dh (for db1) and of dY
//                        (for db2);
//                    (d) tc::ffn_bwd_weights, one launch over a combined
//                        tile list: dW1 = X^T @ dh and dW2 = H_d^T @ dY
//                        (K = N, A m-major) first, then dx = dh @ W1^T
//                        (W1 read k-major as stored);
//                    then column_sums folds the partials into db1, db2.
//
// Why H_d is stored (the TPU kernel kept the [rows, filter] hidden tile in
// VMEM, which holds many MB). On Hopper a block that owns whole rows must
// also hold their [rows, d_out] fp32 accumulator: 64 rows x 512 is half an
// SM's register file, and at N = 4096 that leaves 64 blocks for 132 SMs,
// each re-reading the 4 MB of weights. Storing H_d instead costs 16.8 MB
// written and read at N = 4096, 512 -> 2048 -> 512, mostly inside the 50 MB
// L2 and at most ~10 us at 3.35 TB/s, against the 17 GFLOP / 989 TFLOP/s =
// 17.4 us operation bound; in exchange (a) has 512 tiles and (b) 128 tiles
// that fill the card. The backward stores h_d and dh as before.
//
// What bounds them. 128 x 128 tiles read 32 KB from L2 for every 64-deep
// step of 2 MFLOP, so the 132 SMs would need ~15 TB/s from L2 to run the
// tensor cores at their peak. At N = 4096, (c) reads 256 MB and (d) 384 MB
// through L2, which sets their times more than the operation bound does.
// Sharing operand tiles between the SMs of a cluster (TMA multicast) is
// the next step.
//
// fp32: the CUDA-core kernels (fp32 FMAs, exact for the fp32 path that the
// small reference models run; tensor cores would be TF32 there).
//   ffn_forward       a block owns 16 rows and walks the filter axis in
//                     chunks of 64: the [16, 64] hidden chunk lives in
//                     shared memory and is multiplied into the block's
//                     [16, d_out] fp32 accumulator at once.
//   ffn_backward_rows regenerates the hidden chunk and its mask, forms dh,
//                     accumulates dx = dh @ W1^T (sub-tiles of W2 and W1
//                     staged transposed in shared memory), and writes
//                     h_d, dh and per-block column partials of dh; gemm_tn
//                     gives dW1 and dW2 as 64x64 tiles, each reducing over
//                     all N rows itself.
// Neither family uses atomics or split-K: every sum runs in a fixed order,
// so dW and db are the same from run to run. The TPU kernel carried dW in
// an output block revisited by its sequential grid, which Hopper's
// parallel blocks cannot do.
//
// Rounding follows the JAX kernel and the plain PyTorch version: the
// products accumulate in fp32, x @ W1 is rounded to the compute dtype, then
// + b1 is rounded, relu, the dropout scale multiplies in the compute dtype,
// h_d @ W2 is rounded and + b2 rounded. dx is rounded once at the end; dW
// and db stay fp32 (the wrapper casts to the parameter dtype); db1 sums the
// unrounded dh, dx and dW1 take dh rounded.
//
// Dropout: keep bit of hidden element (row, col) is
// (hash_bits(index_base + row * F + offset + col, s0, s1) & 255) < t, scale
// 256/t: the same mask as zero_tpu/ops/common.py:dropout draws over the
// [N, filter] hidden tensor from the same two key words (index_base: the
// elements of the global batch before this launch's under data
// parallelism, 0 in one process; F the whole width and offset the first
// column of this launch's slice under tensor parallelism, filter and 0
// otherwise; row the global token row, ffn_row's map of a sequence block's
// rows under sequence parallelism). It depends on the element only, so
// forward and backward need no shared tiling; the tensor-core epilogues
// compute it where each accumulator fragment's (row, col) is known.
//
// Layout: row-major x [N, d_in], W1 [d_in, f], W2 [f, d_out], dy [N, d_out].
// fp32: d_in, d_out <= 1024, any N and f. bf16: widths multiples of 16 (the
// ring copies 16-byte chunks), pointers 16-byte aligned, any N.
// Neither family makes a transposed copy of a weight.
//
// Interface: plain C functions, loaded with ctypes; each returns
// cudaGetLastError() after its launches.

#include "zt_common.cuh"
#include "zt_wgmma.cuh"

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
  const void* dy;
  void* y;       // forward: y; backward: dx
  void* hd;      // dropped hidden [N, f] (bf16 forward scratch; backward)
  void* dh;      // backward: dh in the compute dtype [N, f]
  float* db1_part;  // backward: column partials [row tiles, f + d_out]
  float* dw1;
  float* dw2;
  int n, din, f, dout, dropout, t;
  float inv;
  uint32_t s0, s1;
  uint32_t index_base;  // the global index of hidden element 0
  // the whole hidden width and this launch's first column (tensor
  // parallelism: a process's slice; f and 0 otherwise)
  uint32_t f_total, f_offset;
  // the row map of a sequence block (sequence parallelism): the launch's
  // rows are B blocks of l_local tokens, each at l_offset in a sequence of
  // l_whole; l_local == l_whole otherwise
  uint32_t l_local, l_whole, l_offset;
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

// keep bit of hidden element `index` = row * f_total + f_offset + col
// (dropout on)
__device__ __forceinline__ bool keep_index(const Params& p, uint32_t index) {
  return (zt::hash_bits(p.index_base + index, p.s0, p.s1) & 255u) <
         (uint32_t)p.t;
}

// the global token row of launch row `row` (the row map)
__device__ __forceinline__ uint32_t ffn_row(const Params& p, uint32_t row) {
  if (p.l_local == p.l_whole) return row;
  const uint32_t b = row / p.l_local;
  return b * p.l_whole + p.l_offset + (row - b * p.l_local);
}

__device__ __forceinline__ bool ffn_keep(const Params& p, int row, int col) {
  return keep_index(p, ffn_row(p, (uint32_t)row) * p.f_total + p.f_offset +
                           (uint32_t)col);
}

// ---------------------------------------------------------------------------
// fp32 forward: grid ceil(N / 16); OC = ceil(d_out / 256)
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
// fp32 backward 1 (rows): grid ceil(N / 16); IC = ceil(d_in / 256). W2
// and W1 are read across their rows here (W2^T, W1^T); sub-tiles of them
// are staged transposed in shared memory (wt, rows padded by one so the
// transposing stores spread over the banks), so the global reads stay
// along rows and no transposed copy of a weight is made.
// ---------------------------------------------------------------------------
constexpr int kSubK = 16;   // W1 columns staged at a time for dx

__host__ __device__ inline int staged_weights(int din) {
  return max(kChunk * (kChunk + 1), kSubK * (din + 1));
}

template <typename T, int IC>
__global__ void __launch_bounds__(kThreads) ffn_backward_rows(Params p) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [16][d_in]
  float* dys = xs + kRowsPerBlock * p.din;       // [16][d_out]
  float* hs = dys + kRowsPerBlock * p.dout;      // [16][64] dh (rounded)
  float* sums = hs + kRowsPerBlock * kChunk;     // [4][64] dh column sums
  float* wt = sums + (kThreads / kChunk) * kChunk;   // staged_weights()
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int hcol = tid % kChunk;
  const int group = tid / kChunk;
  const int hrow = group * kRowsPerThread;
  const T* w1 = (const T*)p.w1;
  const T* b1 = (const T*)p.b1;
  const T* w2 = (const T*)p.w2;
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
    float h[kRowsPerThread], g[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) h[r] = g[r] = 0.f;
    if (col < p.f) {
      for (int kk = 0; kk < p.din; ++kk) {
        const float w = zt::to_float(w1[(size_t)kk * p.f + col]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          h[r] += xs[(hrow + r) * p.din + kk] * w;
      }
    }
    // g = dy @ W2^T over d_out in steps of 64: wt[c][j] = W2[f0 + j][c0 + c]
    for (int c0 = 0; c0 < p.dout; c0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kChunk * kChunk; e += kThreads) {
        const int j = e / kChunk, c = e % kChunk;
        wt[c * (kChunk + 1) + j] =
            (f0 + j < p.f && c0 + c < p.dout)
                ? zt::to_float(w2[(size_t)(f0 + j) * p.dout + c0 + c])
                : 0.f;
      }
      __syncthreads();
      const int width = min(kChunk, p.dout - c0);
      for (int c = 0; c < width; ++c) {
        const float w = wt[c * (kChunk + 1) + hcol];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          g[r] += dys[(hrow + r) * p.dout + c0 + c] * w;
      }
    }
    float dh[kRowsPerThread];
    float colsum = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dh[r] = 0.f;
    if (col < p.f) {
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
      for (int gi = 0; gi < kThreads / kChunk; ++gi)
        s += sums[gi * kChunk + tid];
      p.db1_part[(size_t)blockIdx.x * (p.f + p.dout) + f0 + tid] = s;
    }
    // dx += dh @ W1^T over the chunk in steps of 16 columns:
    // wt[jj][ic] = W1[ic][f0 + j0 + jj]
    const int width = min(kChunk, p.f - f0);
    for (int j0 = 0; j0 < width; j0 += kSubK) {
      __syncthreads();
      for (int e = tid; e < kSubK * p.din; e += kThreads) {
        const int ic = e / kSubK, jj = e % kSubK;
        wt[jj * (p.din + 1) + ic] =
            j0 + jj < width
                ? zt::to_float(w1[(size_t)ic * p.f + f0 + j0 + jj])
                : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < min(kSubK, width - j0); ++jj) {
        float w[IC];
#pragma unroll
        for (int c = 0; c < IC; ++c) {
          const int ic = tid + kThreads * c;
          w[c] = ic < p.din ? wt[jj * (p.din + 1) + ic] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) {
          const float dv = hs[r * kChunk + j0 + jj];
#pragma unroll
          for (int c = 0; c < IC; ++c) acc[r][c] += dv * w[c];
        }
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
// fp32 backward 2: C[P, Q] = sum_n A[n, p] * B[n, q] (fp32 out); 64x64
// tiles, each thread a 4x4 block, n in chunks of 16. grid (ceil(Q/64),
// ceil(P/64))
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
// out[c] = sum_r A[r, c] over rows of stride ld (both families); blocks of
// 32 columns x 8 row slices
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) column_sums(const T* a, float* out,
                                                        int rows, int cols,
                                                        int ld) {
  __shared__ float part[8][32];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int slice = threadIdx.x >> 5;
  float s = 0.f;
  if (c < cols)
    for (int r = slice; r < rows; r += 8)
      s += zt::to_float(a[(size_t)r * ld + c]);
  part[slice][threadIdx.x & 31] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x];
    out[c] = t;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

using namespace zt::wg;   // cp.async ring, swizzle, descriptors, wgmma
using bf16 = __nv_bfloat16;
constexpr int kBM = 128, kBN = 128;   // output tile: two warpgroups of 64 rows
constexpr int kBK = 64;               // K per stage: 128-byte swizzle rows
constexpr int kTile = kBM * kBK;      // elements of one operand tile (16 KB)
constexpr int kLdS = kBN + 8;         // staged output row: 272 bytes, so the
                                      // fragment writes hit 32 banks
constexpr int kStaged = kBM * kLdS;   // elements of one staged output tile
// an m/n-major operand's column block: 64 k rows of 64 m/n
constexpr uint32_t kMnLbo = kBK * 64 * sizeof(__nv_bfloat16);

// Ring depths, chosen on the card at N = 4096, 512 -> 2048 -> 512: (a) and
// (d) run two blocks to an SM in 3 x 32 KB; (b), one block to an SM (128
// tiles), takes 4; (c) holds the 32 KB of staged pre-activations besides
// its ring, so 2 slots keep two blocks to an SM (3 slots and one block ran
// slower).
constexpr int kStages = 3;        // (a), (d)
constexpr int kOutStages = 4;     // (b)
constexpr int kBwdStages = 2;     // (c)

// the ring of `stages` slots, each an A and a B tile, plus the slack that
// aligns it to the 1024-byte swizzle pattern
constexpr size_t ring_bytes(int stages) {
  return sizeof(bf16) * 2 * kTile * stages + 1024;
}

__device__ __forceinline__ bf16* ring_base(unsigned char* raw) {
  return reinterpret_cast<bf16*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
}

typedef float Acc[64];   // a thread's share of its warpgroup's 64 x 128

struct bool2 {
  bool x, y;
};

// acc = A[m0:+128, :K] @ B[:K, n0:+128] for C [M, N], through a ring of
// STAGES slots at smem (1024-byte aligned). A_K: A is stored [M][K] (k
// contiguous), else [K][M]; B_K: B is stored [N][K], else [K][N]. lda/ldb
// are the stored row strides. Warpgroup g computes rows g * 64.. of the
// tile: a thread's acc[4 j + 2 h + e] is row frag_row(h), column
// frag_col(j) + e.
template <bool A_K, bool B_K, int STAGES>
__device__ __forceinline__ void mma_tile(const bf16* a, int lda, const bf16* b,
                                         int ldb, int M, int N, int K, int m0,
                                         int n0, bf16* smem, Acc& acc) {
  const int group = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int steps = (K + kBK - 1) / kBK;
  auto load = [&](int slot, int step) {
    bf16* sa = smem + slot * 2 * kTile;
    const int k0 = step * kBK;
    // k-major operands as [128][64 k], m/n-major as [64 k][128]
    if (A_K) load_tile<kBM, kBK, kThreads>(sa, a, lda, m0, k0, M, K);
    else load_tile<kBK, kBM, kThreads>(sa, a, lda, k0, m0, K, M);
    if (B_K) load_tile<kBN, kBK, kThreads>(sa + kTile, b, ldb, n0, k0, N, K);
    else load_tile<kBK, kBN, kThreads>(sa + kTile, b, ldb, k0, n0, K, N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();   // the copies, visible to the tensor cores
    __syncthreads();       // and the slot to refill has retired everywhere
    if (step + STAGES - 1 < steps)
      load((step + STAGES - 1) % STAGES, step + STAGES - 1);
    cp_async_commit();
    const bf16* sa = smem + (step % STAGES) * 2 * kTile;
    const bf16* sb = sa + kTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // warpgroup g's 64 rows (k-major) or m block (m-major) start at
      // g * 4096; 16 k are 32 bytes along a k-major row, 16 m/n-major rows
      const uint64_t da = descriptor(
          sa + group * 64 * kBK + (A_K ? ks : ks * 64), A_K ? 16 : kMnLbo);
      const uint64_t db =
          descriptor(B_K ? sb + ks : sb + ks * 64, B_K ? 16 : kMnLbo);
      wgmma_m64n128k16<A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();   // the batch retires before its slot is refilled
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the next product
}

__device__ __forceinline__ void put2(bf16* st, int r, int c,
                                     __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(st + r * kLdS + c) = v;
}

__device__ __forceinline__ __nv_bfloat162 get2(const bf16* st, int r, int c) {
  return *reinterpret_cast<const __nv_bfloat162*>(st + r * kLdS + c);
}

// a column pair of a bf16 vector, as floats
__device__ __forceinline__ float2 pair_at(const void* v, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>((const bf16*)v + col));
}

// round(a + b) of a pair, each sum rounded to bf16 once
__device__ __forceinline__ __nv_bfloat162 round2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// Write a staged [128][128] bf16 tile to rows m0.., columns n0.. of a
// row-major [rows][cols] array, 16 bytes a thread, rows whole.
__device__ __forceinline__ void store_tile(bf16* dst, int ld, int rows,
                                           int cols, int m0, int n0,
                                           const bf16* st) {
#pragma unroll
  for (int i = 0; i < kBM * (kBN / 8) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
    if (m0 + r < rows && n0 + c < cols)
      *reinterpret_cast<uint4*>(dst + (size_t)(m0 + r) * ld + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * kLdS + c);
  }
}

// pre-activations of hidden elements (row, col), (row, col + 1):
// round(round(acc) + b1)
__device__ __forceinline__ float2 pre_pair(const Params& p, float a0,
                                           float a1, int col) {
  const float2 s = __bfloat1622float2(round2(a0, a1));
  const float2 b = pair_at(p.b1, col);
  return __bfloat1622float2(round2(s.x + b.x, s.y + b.y));
}

// the hidden index of launch row `row`'s first column: the row map's
// global row times the whole width, plus this launch's first column
__device__ __forceinline__ uint32_t row_first(const Params& p, int row) {
  return ffn_row(p, (uint32_t)row) * p.f_total + p.f_offset;
}

// keep bits of hidden elements index, index + 1 (all kept, dropout off)
__device__ __forceinline__ bool2 keep_pair(const Params& p, uint32_t index) {
  if (!p.dropout) return {true, true};
  return {keep_index(p, index), keep_index(p, index + 1)};
}

// the dropped hidden pair from its pre-activations and keep bits
__device__ __forceinline__ __nv_bfloat162 dropped_pair(const Params& p,
                                                       float2 pre,
                                                       bool2 keep) {
  const float h0 = fmaxf(pre.x, 0.f), h1 = fmaxf(pre.y, 0.f);
  if (!p.dropout) return round2(h0, h1);   // exact
  __nv_bfloat162 v = round2(h0 * p.inv, h1 * p.inv);
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  if (!keep.x) v.x = zero;
  if (!keep.y) v.y = zero;
  return v;
}

// (a) H_d = drop(relu(pre)), grid (ceil(f / 128), ceil(N / 128))
__global__ void __launch_bounds__(kThreads, 2) ffn_hidden(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* smem = ring_base(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  Acc acc;
  mma_tile<true, false, kStages>((const bf16*)p.x, p.din, (const bf16*)p.w1,
                                 p.f, p.n, p.f, p.din, m0, n0, smem, acc);
  const uint32_t first[2] = {row_first(p, m0 + frag_row(0)),
                             row_first(p, m0 + frag_row(1))};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(h), c = frag_col(j);
      const int col = min(n0 + c, p.f - 2);   // past f: never stored
      put2(smem, r, c,
           dropped_pair(p, pre_pair(p, acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1], col),
                        keep_pair(p, first[h] + col)));
    }
  __syncthreads();
  store_tile((bf16*)p.hd, p.f, p.n, p.f, m0, n0, smem);
}

// (b) Y = round(round(H_d @ W2) + b2), grid (ceil(d_out / 128), ceil(N / 128))
__global__ void __launch_bounds__(kThreads) ffn_out(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* smem = ring_base(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  Acc acc;
  mma_tile<true, false, kOutStages>((const bf16*)p.hd, p.f, (const bf16*)p.w2,
                                    p.dout, p.n, p.dout, p.f, m0, n0, smem,
                                    acc);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(h), c = frag_col(j);
      const float2 s = __bfloat1622float2(
          round2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      const float2 b = pair_at(p.b2, min(n0 + c, p.dout - 2));
      put2(smem, r, c, round2(s.x + b.x, s.y + b.y));
    }
  __syncthreads();
  store_tile((bf16*)p.y, p.dout, p.n, p.dout, m0, n0, smem);
}

// (c) h_d, dh and the column partials over [N, f] tiles, grid
// (ceil(f / 128), ceil(N / 128)). Row blockIdx.y of db1_part [row tiles,
// f + d_out] gets the tile's column sums of dh (columns n0..) and, from the
// blocks whose blockIdx.x steps over d_out in 128s, those of dY's rows
// (columns f + ..). The pre-activations wait in shared memory while
// dY @ W2^T runs.
__global__ void __launch_bounds__(kThreads, 2) ffn_bwd_hidden(Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float colpart[kThreads / 32][kBN];
  bf16* ring = ring_base(smem_raw);
  bf16* pre = ring + 2 * kTile * kBwdStages;   // [128][kLdS], then h_d
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ld_part = p.f + p.dout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Acc acc;
  mma_tile<true, false, kBwdStages>((const bf16*)p.x, p.din,
                                    (const bf16*)p.w1, p.f, p.n, p.f, p.din,
                                    m0, n0, ring, acc);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(h), c = frag_col(j);
      const float2 v = pre_pair(p, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                min(n0 + c, p.f - 2));
      put2(pre, r, c, round2(v.x, v.y));   // exact
    }
  // dY @ W2^T: W2 [f, d_out] is B stored [N = f][K = d_out]
  mma_tile<true, true, kBwdStages>((const bf16*)p.dy, p.dout,
                                   (const bf16*)p.w2, p.dout, p.n, p.f,
                                   p.dout, m0, n0, ring, acc);
  bf16* dh = ring;   // staged dh; h_d overwrites pre in place
  const uint32_t first[2] = {row_first(p, m0 + frag_row(0)),
                             row_first(p, m0 + frag_row(1))};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(h), c = frag_col(j);
      const float2 pv = __bfloat1622float2(get2(pre, r, c));
      const bool2 keep = keep_pair(p, first[h] + n0 + c);
      const bool valid = m0 + r < p.n;
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float g = p.dropout ? acc[4 * j + 2 * h + e] * p.inv
                                  : acc[4 * j + 2 * h + e];
        d[e] = ((e ? pv.y : pv.x) > 0.f && (e ? keep.y : keep.x) && valid)
                   ? g : 0.f;
        cs[e] += d[e];
      }
      put2(pre, r, c, dropped_pair(p, pv, keep));
      put2(dh, r, c, round2(d[0], d[1]));
    }
    // this warp's 16 rows of the two columns, in a fixed order
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = cs[e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) colpart[warp][frag_col(j) + e] = s;
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < p.f) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += colpart[w][tid];
    p.db1_part[(size_t)blockIdx.y * ld_part + n0 + tid] = s;
  }
  store_tile((bf16*)p.hd, p.f, p.n, p.f, m0, n0, pre);
  store_tile((bf16*)p.dh, p.f, p.n, p.f, m0, n0, dh);
  // dY's column partials over this tile's rows: 64 column pairs x 4 row
  // groups of 32 rows, summed in a fixed order
  const bf16* dy = (const bf16*)p.dy;
  const int pair = tid & 63, rows = tid >> 6;
  for (int c0 = blockIdx.x * kBN; c0 < p.dout; c0 += gridDim.x * kBN) {
    const int col = c0 + pair * 2;
    float s0 = 0.f, s1 = 0.f;
    if (col < p.dout) {
      const int r_end = min(m0 + (rows + 1) * 32, p.n);
#pragma unroll 8
      for (int row = m0 + rows * 32; row < r_end; ++row) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            dy + (size_t)row * p.dout + col);
        s0 += __low2float(v);
        s1 += __high2float(v);
      }
    }
    __syncthreads();
    colpart[rows][pair * 2] = s0;
    colpart[rows][pair * 2 + 1] = s1;
    __syncthreads();
    if (tid < kBN && c0 + tid < p.dout)
      p.db1_part[(size_t)blockIdx.y * ld_part + p.f + c0 + tid] =
          colpart[0][tid] + colpart[1][tid] + colpart[2][tid] +
          colpart[3][tid];
  }
}

__host__ __device__ __forceinline__ int tiles(int rows, int cols) {
  return ((rows + kBM - 1) / kBM) * ((cols + kBN - 1) / kBN);
}

// (d) one launch over dW1 [d_in, f] tiles, dW2 [f, d_out] tiles (K = N,
// the longest, first), then dx [N, d_in] tiles (K = f)
__global__ void __launch_bounds__(kThreads, 2)
    ffn_bwd_weights(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* smem = ring_base(smem_raw);
  int t = blockIdx.x;
  const int t1 = tiles(p.din, p.f), t2 = tiles(p.f, p.dout);
  Acc acc;
  if (t < t1 + t2) {
    const bool first = t < t1;
    if (!first) t -= t1;
    const int cols = first ? p.f : p.dout;
    const int rows = first ? p.din : p.f;
    const int per_row = (cols + kBN - 1) / kBN;
    const int m0 = (t / per_row) * kBM, n0 = (t % per_row) * kBN;
    // dW1 = X^T @ dh, dW2 = H_d^T @ dY: A stored [K = N][M], B [K = N][N]
    const bf16* a = (const bf16*)(first ? p.x : p.hd);
    const bf16* b = (const bf16*)(first ? p.dh : p.dy);
    mma_tile<false, false, kStages>(a, rows, b, cols, rows, cols, p.n, m0,
                                    n0, smem, acc);
    float* out = first ? p.dw1 : p.dw2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + frag_row(h), col = n0 + frag_col(j);
        if (row < rows && col < cols)
          *reinterpret_cast<float2*>(out + (size_t)row * cols + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    return;
  }
  t -= t1 + t2;
  const int per_row = (p.din + kBN - 1) / kBN;
  const int m0 = (t / per_row) * kBM, n0 = (t % per_row) * kBN;
  // dx = dh @ W1^T: W1 [d_in, f] is B stored [N = d_in][K = f]
  mma_tile<true, true, kStages>((const bf16*)p.dh, p.f, (const bf16*)p.w1,
                                p.f, p.n, p.din, p.f, m0, n0, smem, acc);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      put2(smem, frag_row(h), frag_col(j),
           round2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
  __syncthreads();
  store_tile((bf16*)p.y, p.din, p.n, p.din, m0, n0, smem);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t s) {
  cudaError_t err = zt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t forward(const Params& p, cudaStream_t s) {
  const int row_tiles = (p.n + kBM - 1) / kBM;
  cudaError_t err = launch(ffn_hidden, dim3((p.f + kBN - 1) / kBN, row_tiles),
                           ring_bytes(kStages), p, s);
  if (err != cudaSuccess) return err;
  return launch(ffn_out, dim3((p.dout + kBN - 1) / kBN, row_tiles),
                ring_bytes(kOutStages), p, s);
}

cudaError_t backward(const Params& p, float* db1, float* db2,
                     cudaStream_t s) {
  const int row_tiles = (p.n + kBM - 1) / kBM;
  cudaError_t err = launch(
      ffn_bwd_hidden, dim3((p.f + kBN - 1) / kBN, row_tiles),
      ring_bytes(kBwdStages) + sizeof(bf16) * kStaged, p, s);
  if (err != cudaSuccess) return err;
  err = launch(ffn_bwd_weights,
               dim3(tiles(p.din, p.f) + tiles(p.f, p.dout) +
                    tiles(p.n, p.din)),
               ring_bytes(kStages), p, s);
  if (err != cudaSuccess) return err;
  const int ld = p.f + p.dout;
  column_sums<float><<<(p.f + 31) / 32, kThreads, 0, s>>>(p.db1_part, db1,
                                                          row_tiles, p.f, ld);
  column_sums<float><<<(p.dout + 31) / 32, kThreads, 0, s>>>(
      p.db1_part + p.f, db2, row_tiles, p.dout, ld);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 launches
// ---------------------------------------------------------------------------
template <int OC>
cudaError_t forward_oc(const Params& p, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (size_t)(kRowsPerBlock * (p.din + kChunk));
  cudaError_t err = zt::allow_smem(ffn_forward<float, OC>, bytes);
  if (err != cudaSuccess) return err;
  ffn_forward<float, OC><<<(p.n + kRowsPerBlock - 1) / kRowsPerBlock,
                           kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

cudaError_t forward_f32(const Params& p, cudaStream_t s) {
  if (p.dout <= 256) return forward_oc<1>(p, s);
  if (p.dout <= 512) return forward_oc<2>(p, s);
  if (p.dout <= 1024) return forward_oc<4>(p, s);
  return cudaErrorInvalidValue;
}

template <int IC>
cudaError_t backward_rows_ic(const Params& p, cudaStream_t s) {
  const size_t bytes = sizeof(float) *
      (size_t)(kRowsPerBlock * (p.din + p.dout + kChunk) +
               (kThreads / kChunk) * kChunk + staged_weights(p.din));
  cudaError_t err = zt::allow_smem(ffn_backward_rows<float, IC>, bytes);
  if (err != cudaSuccess) return err;
  ffn_backward_rows<float, IC><<<(p.n + kRowsPerBlock - 1) / kRowsPerBlock,
                                 kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

cudaError_t backward_f32(const Params& p, float* db1, float* db2,
                         cudaStream_t s) {
  cudaError_t err;
  if (p.din <= 256) err = backward_rows_ic<1>(p, s);
  else if (p.din <= 512) err = backward_rows_ic<2>(p, s);
  else if (p.din <= 1024) err = backward_rows_ic<4>(p, s);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  // dW1 [d_in, f] = x^T @ dh ; dW2 [f, d_out] = h_d^T @ dy
  dim3 g1((p.f + kGT - 1) / kGT, (p.din + kGT - 1) / kGT);
  gemm_tn<float><<<g1, kThreads, 0, s>>>((const float*)p.x,
                                         (const float*)p.dh, p.dw1, p.n,
                                         p.din, p.f);
  dim3 g2((p.dout + kGT - 1) / kGT, (p.f + kGT - 1) / kGT);
  gemm_tn<float><<<g2, kThreads, 0, s>>>((const float*)p.hd,
                                         (const float*)p.dy, p.dw2, p.n, p.f,
                                         p.dout);
  const int blocks = (p.n + kRowsPerBlock - 1) / kRowsPerBlock;
  column_sums<float><<<(p.f + 31) / 32, kThreads, 0, s>>>(
      p.db1_part, db1, blocks, p.f, p.f + p.dout);
  column_sums<float><<<(p.dout + 31) / 32, kThreads, 0, s>>>(
      (const float*)p.dy, db2, p.n, p.dout, p.dout);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* w1, const void* b1,
                   const void* w2, int n, int din, int f, int dout,
                   int dropout, int t, float inv, unsigned int s0,
                   unsigned int s1, unsigned int index_base,
                   unsigned int f_total, unsigned int f_offset,
                   unsigned int l_local, unsigned int l_whole,
                   unsigned int l_offset) {
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
  p.index_base = index_base;
  p.f_total = f_total;
  p.f_offset = f_offset;
  p.l_local = l_local;
  p.l_whole = l_whole;
  p.l_offset = l_offset;
  return p;
}

}  // namespace

// dtype 0: fp32 (hd unused); 1: bf16 (hd: [N, f] scratch for H_d)
extern "C" int zt_ffn_forward(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y,
                              void* hd, int dtype, int n, int din, int f,
                              int dout, int dropout, int t, float inv,
                              unsigned int s0, unsigned int s1,
                              unsigned int index_base, unsigned int f_total,
                              unsigned int f_offset, unsigned int l_local,
    unsigned int l_whole, unsigned int l_offset, void* stream) {
  Params p = make_params(x, w1, b1, w2, n, din, f, dout, dropout, t, inv, s0,
                         s1, index_base, f_total, f_offset, l_local,
                         l_whole, l_offset);
  p.b2 = b2;
  p.y = y;
  p.hd = hd;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)forward_f32(p, s);
  if (dtype == 1) return (int)tc::forward(p, s);
  return (int)cudaErrorInvalidValue;
}

// db1_part: [ceil(N / 16), f + d_out] (fp32) or [ceil(N / 128), f + d_out]
// (bf16) scratch
extern "C" int zt_ffn_backward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* dy, void* dx, void* hd, void* dh, void* db1_part, void* dw1,
    void* db1, void* dw2, void* db2, int dtype, int n, int din, int f,
    int dout, int dropout, int t, float inv, unsigned int s0,
    unsigned int s1, unsigned int index_base, unsigned int f_total,
    unsigned int f_offset, unsigned int l_local,
    unsigned int l_whole, unsigned int l_offset, void* stream) {
  Params p = make_params(x, w1, b1, w2, n, din, f, dout, dropout, t, inv, s0,
                         s1, index_base, f_total, f_offset, l_local,
                         l_whole, l_offset);
  p.dy = dy;
  p.y = dx;
  p.hd = hd;
  p.dh = dh;
  p.db1_part = (float*)db1_part;
  p.dw1 = (float*)dw1;
  p.dw2 = (float*)dw2;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)backward_f32(p, (float*)db1, (float*)db2, s);
  if (dtype == 1) return (int)tc::backward(p, (float*)db1, (float*)db2, s);
  return (int)cudaErrorInvalidValue;
}
