// Helpers shared by the port's kernels (decode_attention.cu,
// fused_attention.cu, fused_attention_rpr.cu, fused_ffn.cu,
// streaming_attention.cu): dtype conversion, rounding to the
// compute dtype, warp reductions, the counter-hash dropout bits of
// zero_tpu/ops/common.py:_hash_bits, and the dynamic shared-memory cap.

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
