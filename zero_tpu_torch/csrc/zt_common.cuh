// Helpers shared by the port's kernels (decode_attention.cu,
// fused_attention.cu, fused_attention_rpr.cu, fused_ffn.cu,
// streaming_attention.cu): dtype conversion, rounding to the
// compute dtype, warp reductions, the counter-hash dropout bits of
// zero_tpu/ops/common.py:_hash_bits and the row-seeded attention keep bit
// built on them, and the dynamic shared-memory cap.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace zt {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T and back (identity for fp32): the points where
// the plain PyTorch version (and the JAX graph) store a value in the compute
// dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// murmur3 fmix32 over an element's linear index with the two seed words
// xor'd in: bit-identical to zero_tpu/ops/common.py:_hash_bits.
__device__ __forceinline__ uint32_t hash_bits(uint32_t index, uint32_t s0,
                                              uint32_t s1) {
  uint32_t x = index ^ s0;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 16)) * 0xC2B2AE35u;
  return x ^ (x >> 16) ^ s1;
}

// Attention dropout, shared by every attention kernel (#1-#7): element (row
// r = row_base + global_row(bh, i), key j) keeps iff hash_bits(j,
// row_seed(r), s1) < threshold, row_base the rows (b * H * Lq) of the global
// batch before this launch's (data parallelism; 0 in one process). A
// per-row seed word, then the key index: no B*H*Lq*Lk linear index that
// wraps at 2^32. A kernel hashes each row's seed once and keeps
// it beside the row.
__device__ __forceinline__ uint32_t row_seed(uint32_t row, uint32_t s0,
                                             uint32_t s1) {
  return hash_bits(row, s0, s1);
}

// The row of query i of launch head bh = b * heads + h in the global [B, H,
// Lq] rows: (b * H + head_offset + h) * Lq + i, the launch holding heads
// [head_offset, head_offset + heads) of H (tensor parallelism); bh * Lq + i
// when it holds them all. Lq is the whole query length: a launch over a
// sequence block (sequence parallelism) passes the whole sequence's and
// adds the block's first query to row_base.
__device__ __forceinline__ uint32_t global_row(int bh, int i, int heads,
                                               uint32_t heads_total,
                                               uint32_t head_offset, int lq) {
  const uint32_t b = (uint32_t)bh / (uint32_t)heads;
  const uint32_t h = (uint32_t)bh - b * (uint32_t)heads;
  return (b * heads_total + head_offset + h) * (uint32_t)lq + (uint32_t)i;
}

__device__ __forceinline__ bool keep_key(uint32_t seed, int j, uint32_t s1,
                                         uint32_t threshold) {
  return hash_bits((uint32_t)j, seed, s1) < threshold;
}

// Raise the dynamic shared-memory cap of a kernel when it needs more than
// the 48 KB default.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace zt
