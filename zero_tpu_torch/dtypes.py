"""Precision policy: fp32 parameter storage with a configurable compute dtype.

Counterpart of ``zero_tpu/dtypes.py``. The JAX package keeps fp32 params
and casts them to the compute dtype on every jitted call; the port casts
the parameter module ONCE after loading. The cast is idempotent, so the
numbers are the same. Softmaxes, norm statistics and logits stay fp32.
"""

from __future__ import annotations

import torch

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtype(cfg) -> torch.dtype:
    """The configured compute dtype (cfg.default_dtype)."""
    return _NAMES[getattr(cfg, "default_dtype", "float32")]


def cast_to_compute(module: torch.nn.Module, cfg) -> torch.nn.Module:
    """Cast every floating parameter of ``module`` to the compute dtype,
    in place; returns the module."""
    return module.to(compute_dtype(cfg))
