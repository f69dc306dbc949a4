"""Connectionist temporal classification loss (CTC).

A port of optax's ``ctc_loss`` (``ctc_loss_with_forward_probs``), which
transformer_afs's CTC regulariser calls in the JAX package: the forward
recursion over the blank-inserted label sequence in log space, with
``log_epsilon`` (-1e5) standing in for log 0, so an infeasible row (more
labels than frames can carry) gives a large finite loss where
``torch.nn.functional.ctc_loss`` gives inf, and an all-pad row gives 0
with finite grads. Paddings come as 1.0/0.0 masks (1 = padded); labels
are right-padded. One Python loop over the frames, each step vectorised
over the rows and label positions; autograd runs the backward. The JAX
package has no kernel for it.

One deliberate difference: the recursion runs in fp64 and the loss is
returned in the logits' dtype. An infeasible row's log-probabilities sit
near -1e5, where an fp32 ulp is 0.0078, so fp32 gradients there carry
errors of ~1e-3 in any implementation (optax's own fp32 gradients are
2.7e-3 off its fp64 ones on such a row); in fp64 the port equals optax's
fp64 recursion and, on feasible rows, its fp32 one to ~1e-6.
"""

from __future__ import annotations

import torch

LOG_EPSILON = -1e5


def _update_phi(phi, added):
    """phi[:, 1:] logaddexp'ed with ``added``; phi[:, 0] kept."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                     dim=-1)


def ctc_loss(logits, logit_paddings, labels, label_paddings,
             blank_id: int = 0, log_epsilon: float = LOG_EPSILON):
    """Per-sequence CTC loss [B]: the negative log-probability of
    ``labels`` [B, N] under ``logits`` [B, T, K] (fp32), frames padded by
    ``logit_paddings`` [B, T] and labels by ``label_paddings`` [B, N]."""
    out_dtype = logits.dtype
    logits = logits.double()
    batch, _, _ = logits.shape
    max_label_len = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    label_lens = max_label_len - label_paddings.sum(dim=1).to(torch.int64)

    # repeat[b, n] = 1 where label n+1 repeats label n
    labels = labels.long()
    repeat = (labels[:, :-1] == labels[:, 1:]).double()
    repeat = torch.nn.functional.pad(repeat, (0, 1))

    logprobs_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]
    logprobs_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(-1, logprobs.shape[1], -1))
    logprobs_emit = logprobs_emit.transpose(0, 1)               # [T, B, N]
    pads = logit_paddings.double().transpose(0, 1)[..., None]   # [T, B, 1]

    phi = torch.full((batch, max_label_len + 1), log_epsilon,
                     dtype=logits.dtype, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((batch, max_label_len), log_epsilon,
                      dtype=logits.dtype, device=logits.device)
    for t in range(logprobs.shape[1]):
        prev_phi, prev_emit = phi, emit
        # emit-to-phi epsilon transition, except into a repeated label
        phi_eps = _update_phi(prev_phi, prev_emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t]
        # phi-to-emit transition and the emit self-loop
        next_emit = torch.logaddexp(phi_eps[:, :-1] + lp_emit,
                                    prev_emit + lp_emit)
        # phi self-loop; emit-to-phi blank transition only before a repeat
        next_phi = _update_phi(
            phi_eps + lp_phi,
            prev_emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * prev_emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi + (1.0 - pad) * next_phi

    # the last epsilon transition
    phi_last = _update_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lens[:, None])[:, 0].to(
        out_dtype)
