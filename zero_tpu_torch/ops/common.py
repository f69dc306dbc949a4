"""Inference utilities of ``zero_tpu/ops/common.py``: log-probs, gumbel
noise and the beam gather. Dropout and the losses come with the training
slice."""

from __future__ import annotations

import torch


def log_prob_from_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


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
