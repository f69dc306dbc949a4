"""Shared functional utilities of ``zero_tpu/ops/common.py``: dropout-seed
threading, counter-hash dropout, label-smoothed losses, log-probs, gumbel
noise and the beam gather.

Dropout seeds. The JAX package threads PRNG keys; a dropout site hashes
each element's linear index with the key's two raw u32 words
(``_hash_bits``). The port threads those two words directly, as a tuple
``(s0, s1)`` of host ints: ``RngGen`` draws a fresh pair per site from a
host ``torch.Generator``, and the kernels take the pair by value, so a
train step needs no device-to-host copy for seeds. Given the same words,
``_hash_bits`` and ``dropout`` are bit-identical to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Words = Tuple[int, int]
_U32 = 0xFFFFFFFF


class RngGen:
    """Per-site dropout seeds: each call returns a fresh ``(s0, s1)`` pair
    of u32 words from ``gen``, or None when ``gen`` is None (dropout off:
    eval and scoring)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self._gen = gen

    def __call__(self) -> Optional[Words]:
        if self._gen is None:
            return None
        s0, s1 = torch.randint(0, 2 ** 32, (2,), generator=self._gen,
                               dtype=torch.int64).tolist()
        return int(s0), int(s1)


def _mul32(x: torch.Tensor, mult: int) -> torch.Tensor:
    """(x * mult) mod 2^32 for int64 x in [0, 2^32), without int64
    overflow: the multiplier is split into 16-bit halves."""
    lo = x * (mult & 0xFFFF)
    hi = ((x * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor, mult: int) -> torch.Tensor:
    x = x ^ (x >> 16)
    return _mul32(x, mult)


def _hash_bits(words: Words, shape, device=None) -> torch.Tensor:
    """Uniform u32 draws (held in int64) from the murmur3 fmix32 finalizer
    over each element's linear index, seeded by the two key words:
    ``zero_tpu/ops/common.py:_hash_bits``, bit for bit."""
    s0, s1 = int(words[0]) & _U32, int(words[-1]) & _U32
    n = math.prod(shape)
    x = (torch.arange(max(n, 1), dtype=torch.int64, device=device) & _U32)
    x = x[:n].reshape(shape)
    x = _mix32(x ^ s0, 0x85EBCA6B)
    x = _mix32(x, 0xC2B2AE35)
    return x ^ (x >> 16) ^ s1


def keep_threshold(rate: Optional[float]) -> int:
    """t of the 8-bit threshold dropout (keep = low8(bits) < t, scale
    256/t); 256 means dropout is off."""
    if rate is None or not (0.0 < rate < 1.0):
        return 256
    return min(int(round((1.0 - rate) * 256.0)), 256)


def dropout(rng: Optional[Words], x: torch.Tensor,
            rate: Optional[float]) -> torch.Tensor:
    """Inverted dropout with 8-bit threshold masks from the counter hash;
    a no-op when ``rng`` is None or the rate is falsy/invalid."""
    if rng is None:
        return x
    t = keep_threshold(rate)
    if t >= 256:
        return x
    if t <= 0:
        return torch.zeros_like(x)
    keep = (_hash_bits(rng, x.shape, x.device) & 255) < t
    return torch.where(keep, x * keep_scale(t, x.dtype), torch.zeros_like(x))


def keep_scale(t: int, dtype) -> float:
    """256/t rounded to ``dtype``, as a host float: multiplying a tensor of
    that dtype by it rounds like the JAX graph's product of two
    ``dtype`` values, and needs no host-to-device copy."""
    return float(torch.tensor(256.0 / t, dtype=dtype))


def log_prob_from_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def _smoothing(vocab_size: int, factor: float):
    """(p, q, normalizer) of label smoothing; the normalizer is computed
    in fp32 like the JAX graph, on the host."""
    n = float(vocab_size - 1)
    p = 1.0 - factor
    q = factor / n
    f32 = torch.float32
    normalizer = -(torch.tensor(p, dtype=f32)
                   * torch.log(torch.tensor(p, dtype=f32))
                   + torch.tensor(n * q, dtype=f32)
                   * torch.log(torch.tensor(q + 1e-20, dtype=f32)))
    return p, q, normalizer.item()


def smoothed_centropy(logits: torch.Tensor, labels: torch.Tensor,
                      factor: float) -> torch.Tensor:
    """Per-position label-smoothed CE minus the smoothing normalizer,
    fp32. Shape = labels'."""
    logits = logits.float()
    vocab_size = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    gold_logp = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if 0.0 < factor < 1.0:
        p, q, normalizer = _smoothing(vocab_size, factor)
        sum_logp = logp.sum(dim=-1)
        centropy = -(p * gold_logp + q * (sum_logp - gold_logp))
        return centropy - normalizer
    return -gold_logp


def smoothed_centropy_reduced(logits: torch.Tensor, labels: torch.Tensor,
                              factor: float) -> torch.Tensor:
    """smoothed_centropy as per-token reductions over the vocabulary (max,
    log-sum-exp, centred logit sum, gold logit): no [N, V] log-prob tensor
    is kept. The max is detached, the standard stable-lse step."""
    logits = logits.float()
    vocab_size = logits.shape[-1]
    m = logits.max(dim=-1).values.detach()
    centered = logits - m[..., None]
    sum_exp = torch.exp(centered).sum(dim=-1)
    lse = m + torch.log(sum_exp)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    gold_logp = gold - lse
    if 0.0 < factor < 1.0:
        p, q, normalizer = _smoothing(vocab_size, factor)
        csum = centered.sum(dim=-1)
        sum_logp = csum - float(vocab_size) * torch.log(sum_exp)
        centropy = -(p * gold_logp + q * (sum_logp - gold_logp))
        return centropy - normalizer
    return -gold_logp


def sentence_mean_loss(centropy: torch.Tensor, mask: torch.Tensor):
    """Per-sentence mean, then batch mean over the sentences that have a
    token (all-pad rows contribute 0 and are left out). Returns (scalar
    loss, per-sentence loss [B])."""
    mask = mask.float()
    msum = mask.sum(dim=-1)
    per_sample = (centropy * mask).sum(dim=-1) / torch.clamp(msum, min=1.0)
    valid = (msum > 0).float()
    loss = (per_sample * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return loss, per_sample


def label_smooth_loss(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, factor: float = 0.1):
    return sentence_mean_loss(smoothed_centropy(logits, labels, factor), mask)


def gumbel_noise(gen: torch.Generator, shape, device,
                 eps: float = 1e-8) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u + eps) + eps)


def gather_beams(x: torch.Tensor, beam_indices: torch.Tensor, batch: int,
                 beam_size: int) -> torch.Tensor:
    """Reorder the beam axis of a [B*K, ...] tensor by [B, K] indices."""
    y = x.reshape((batch, beam_size) + x.shape[1:])
    idx = beam_indices.reshape((batch, beam_size) + (1,) * (y.dim() - 2))
    y = torch.take_along_dim(y, idx.long(), dim=1)
    return y.reshape((batch * beam_size,) + x.shape[1:])
