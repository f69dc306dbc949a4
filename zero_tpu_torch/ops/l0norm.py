"""L0 regularisation through hard-concrete gates.

Counterpart of ``zero_tpu/ops/l0norm.py``: hard-concrete sampling and mean
(beta=2/3, gamma=-0.1, zeta=1.1), the expected-L0 penalty and the ramp-up
of the penalty's weight. Foundation of transformer_l0drop.

The JAX package draws the sampler's uniform noise with ``jax.random``
(threefry), which torch cannot reproduce. Here the noise comes from a
dropout site's two seed words through the counter hash of
ops/common.py (``uniform_noise``, on the tensor's device), and the
transform from noise to gate is a function of its own
(``hard_concrete_from_noise``), which the tests hold to JAX on noise that
JAX drew.
"""

from __future__ import annotations

import math

import torch

from zero_tpu_torch.ops import common

EPSILON = 1e-8
BETA = 2.0 / 3.0
GAMMA = -0.1
ZETA = 1.1


def uniform_noise(words, shape, device, split=None) -> torch.Tensor:
    """Uniform fp32 noise in [0, 1) from the seed words: the low 24 bits
    of each element's counter hash (ops/common.py:_hash_bits, by the
    global batch row under data parallelism and the whole sequence's
    position where ``split`` names a sequence block), exact in fp32."""
    bits = common._hash_bits(words, shape, device, split=split) & 0xFFFFFF
    return bits.to(torch.float32) * (1.0 / 2 ** 24)


def hard_concrete_from_noise(noise, log_alpha, beta=BETA, gamma=GAMMA,
                             zeta=ZETA, eps=EPSILON):
    """Stretched-and-clipped hard-concrete gates in [0, 1] from uniform
    ``noise`` of log_alpha's shape."""
    noise = noise.to(log_alpha.dtype)
    gate_inputs = torch.log(noise + eps) - torch.log1p(-noise)
    gate_inputs = torch.sigmoid((gate_inputs + log_alpha) / beta)
    stretched = gate_inputs * (zeta - gamma) + gamma
    return torch.clamp(stretched, 0.0, 1.0)


def hard_concrete_sample(words, log_alpha, beta=BETA, gamma=GAMMA,
                         zeta=ZETA, eps=EPSILON, split=None):
    """Sample gates with noise from a site's seed words; ``split``: the
    sequence block log_alpha holds (ops/common.py:seq_split)."""
    if words is None:
        raise ValueError("hard-concrete gates are sampled from dropout seed "
                         "words: training needs a generator")
    if split is None:
        noise = uniform_noise(words, log_alpha.shape, log_alpha.device)
    else:
        noise = uniform_noise(words, log_alpha.shape, log_alpha.device,
                              split)
    return hard_concrete_from_noise(noise, log_alpha, beta, gamma, zeta, eps)


def hard_concrete_mean(log_alpha, gamma=GAMMA, zeta=ZETA):
    """Deterministic eval-time gate: the clipped stretched sigmoid."""
    stretched = torch.sigmoid(log_alpha) * (zeta - gamma) + gamma
    return torch.clamp(stretched, 0.0, 1.0)


def l0_norm(log_alpha, beta=BETA, gamma=GAMMA, zeta=ZETA):
    """Expected-L0 contribution per gate: the stretched concrete's CDF
    above 0."""
    return torch.sigmoid(log_alpha - beta * math.log(-gamma / zeta))


def var_train(words, weight_parameters, beta=BETA, gamma=GAMMA, zeta=ZETA,
              eps=EPSILON):
    """(theta, log_alpha) -> (gated weights, sampled gates)."""
    theta, log_alpha = weight_parameters
    noise = hard_concrete_sample(words, log_alpha, beta, gamma, zeta, eps)
    return theta * noise, noise


def var_eval(weight_parameters, gamma=GAMMA, zeta=ZETA):
    """(theta, log_alpha) -> (gated weights, mean gates)."""
    theta, log_alpha = weight_parameters
    noise = hard_concrete_mean(log_alpha, gamma, zeta)
    return theta * noise, noise


def l0_regularization_loss(l0_norm_loss, step, reg_scalar=1.0,
                           start_reg_ramp_up=0, end_reg_ramp_up=1000,
                           warm_up=True):
    """Ramp the penalty's weight linearly over [start, end] steps; the
    fraction is computed in fp32 on the host, as the JAX graph does."""
    f32 = torch.float32
    current = torch.clamp(torch.tensor(float(step), dtype=f32)
                          - float(start_reg_ramp_up), min=0.0)
    fraction = torch.clamp(
        current / float(max(end_reg_ramp_up - start_reg_ramp_up, 1)),
        max=1.0)
    if warm_up:
        reg_scalar = (fraction * torch.tensor(reg_scalar, dtype=f32)).item()
    return reg_scalar * l0_norm_loss
