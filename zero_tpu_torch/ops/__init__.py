"""Tensor-op library of the port (counterpart of zero_tpu/ops) and its
hand-written CUDA kernels (ops/kernels)."""
