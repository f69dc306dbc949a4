"""Hand-written CUDA kernels for Hopper that replace the Pallas TPU kernels
of zero_tpu/ops/kernels, each beside its plain PyTorch version."""
