"""Weight initializers matching ``zero_tpu/ops/initializers.py``.

uniform / normal / {normal,uniform}_unit_scaling (TF variance_scaling with
mode=fan_avg). Each initializer is ``init(generator, shape, dtype)``: an
explicit ``torch.Generator`` takes the place of a JAX PRNG key. The two
draw different numbers from the same seed; tests that compare the packages
bridge the JAX package's weights instead (saver.params_from_flat).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Initializer = Callable[..., torch.Tensor]


def uniform(gain: float) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).uniform_(-gain, gain,
                                                        generator=gen)
    return init


def normal(stddev: float) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).normal_(0.0, stddev,
                                                       generator=gen)
    return init


def zeros() -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)
    return init


def scale(factor: float, base: Initializer) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return factor * base(gen, shape, dtype)
    return init


def _fans(shape) -> tuple:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1.0
    for d in shape[:-2]:
        receptive *= d
    return float(shape[-2]) * receptive, float(shape[-1]) * receptive


def variance_scaling(scale: float, distribution: str = "uniform") -> Initializer:
    """TF variance_scaling with mode=fan_avg. The normal flavour is
    truncated at 2 sigma like TF's."""
    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        n = max((fan_in + fan_out) / 2.0, 1.0)
        if distribution == "uniform":
            limit = math.sqrt(3.0 * scale / n)
            return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                            generator=gen)
        stddev = math.sqrt(scale / n) / 0.87962566103423978
        t = torch.empty(shape, dtype=dtype)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return stddev * t
    return init


def get_initializer(name: str, gain: float) -> Initializer:
    if name == "uniform":
        return uniform(gain)
    if name == "normal":
        return normal(gain)
    if name == "normal_unit_scaling":
        return variance_scaling(gain, "normal")
    if name == "uniform_unit_scaling":
        return variance_scaling(gain, "uniform")
    # default: glorot uniform
    return variance_scaling(1.0, "uniform")


def depth_scaled(layer: int, gain: float) -> Initializer:
    """Depth-scaled init for deep transformers: variance_scaling with
    gain*(layer+1)^-0.5, fan_avg, uniform."""
    return variance_scaling(gain * (layer + 1) ** -0.5, "uniform")
