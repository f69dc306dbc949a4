"""Mixture-of-experts FFN (Switch/GShard pattern).

Counterpart of ``zero_tpu/ops/moe.py``:
  * top-1 (Switch: the gate is the router probability, which carries the
    router's task-loss gradient) or top-2 (GShard: gates renormalised over
    the chosen k) routing, ties broken toward the lower expert index
    (search.top_k, lax.top_k's order);
  * per-row capacity C = ceil(S * capacity_factor * k / E); each batch row
    is its own dispatch group, and eval lifts the cap (C = S), so the
    decode step routes without loss;
  * tokens past an expert's capacity contribute zero here and survive
    through the residual connection;
  * the load-balance aux loss E * sum_e f_e * P_e over primary choices,
    f_e and P_e means over the global batch under data parallelism.

Two dispatch backends with the same semantics:
  * "einsum": dense [B, S, E, C] one-hot dispatch and combine products;
  * "scatter": tokens scatter-add into a per-row [E*C + 1, d] buffer by
    slot index (row E*C is the sink of dropped tokens, never read back)
    and gather back at combine.

The router's softmax runs in fp32 whatever the activation dtype; the
experts' products are batched matmuls (the JAX package runs them outside
any Pallas kernel).

Expert parallelism (``mesh_expert``; parallel/tensor.py): a process holds
E/W of the expert stacks. The router, the capacity and the aux loss are
computed whole on every process of the expert line, whose batch rows are
the same; the einsum dispatch fills the process's experts, the token
input and the combine weights entering through copy_in, and the combine
of its experts' outputs is summed over the line (reduce_out). The expert
dropout draws at the global expert index.
"""

from __future__ import annotations

import math

import torch

from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import dropout, global_count, global_sum
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp
from zero_tpu_torch.search import top_k as stable_top_k


class Experts(torch.nn.Module):
    """Expert-stacked two-layer FFN weights: ``w1`` [E, d_in, d_hidden],
    ``b1`` [E, d_hidden], ``w2`` [E, d_hidden, d_out], ``b2`` [E, d_out]."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1 = torch.nn.Parameter(w1)
        self.b1 = torch.nn.Parameter(b1)
        self.w2 = torch.nn.Parameter(w2)
        self.b2 = torch.nn.Parameter(b2)


class MoE(torch.nn.Module):
    """``router`` (a bias-free Linear to E logits) and ``experts``."""

    def __init__(self, router, experts):
        super().__init__()
        self.router = router
        self.experts = experts


def init_moe_ffn(gen, d_in: int, d_hidden: int, d_out: int,
                 num_experts: int, weight_init=None) -> MoE:
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    e = num_experts
    router = nn.init_linear(gen, d_in, e, bias=False,
                            weight_init=weight_init)
    return MoE(router, Experts(weight_init(gen, (e, d_in, d_hidden)),
                               torch.zeros(e, d_hidden),
                               weight_init(gen, (e, d_hidden, d_out)),
                               torch.zeros(e, d_out)))


def capacity(seq_len: int, num_experts: int, capacity_factor: float,
             top_k: int) -> int:
    return max(1, int(math.ceil(seq_len * capacity_factor * top_k
                                / num_experts)))


def _one_hot(idx, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row (jax.nn.one_hot's rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(top_idx, num_experts: int, c: int):
    """Buffer positions of every (token, slot): (pos [B, S, k] int64,
    1-based position in the chosen expert's buffer; keep [B, S, k] bool).
    Primary choices claim capacity first; within a slot, tokens claim it
    in sequence order. The counts are exact integers: a position one off
    would merge two tokens under the scatter backend."""
    b, _, k = top_idx.shape
    count = torch.zeros((b, num_experts), dtype=torch.int64,
                        device=top_idx.device)
    pos_slots, keep_slots = [], []
    for slot in range(k):
        idx = top_idx[..., slot]
        onehot = torch.nn.functional.one_hot(idx, num_experts)   # [B,S,E]
        grid = (torch.cumsum(onehot, dim=1) + count[:, None, :]) * onehot
        pos = torch.gather(grid, 2, idx[..., None])[..., 0]
        keep = (pos > 0) & (pos <= c)
        count = count + (onehot * keep[..., None]).sum(dim=1)
        pos_slots.append(pos)
        keep_slots.append(keep)
    return torch.stack(pos_slots, dim=-1), torch.stack(keep_slots, dim=-1)


def _expert_ffn(ex: Experts, xin, rngs, drop, split=None):
    """Expert-batched relu FFN on [E, T, d] inputs; the weights are cast
    to the activation dtype, as every dense layer does. ``split`` = (0,
    offset, whole count): the E experts are a process's part."""
    dt = xin.dtype
    h = torch.bmm(xin, ex.w1.to(dt)) + ex.b1.to(dt)[:, None, :]
    h = torch.relu(h)
    if rngs is not None:
        # expert-major [E, B*C, d_h]: under data parallelism the hash
        # indexes the global [E, B_global*C, d_h] tensor, E strided
        # blocks of which are this process's (common.global_index)
        h = dropout(rngs(), h, drop, batch_axis=1, split=split)
    return torch.bmm(h, ex.w2.to(dt)) + ex.b2.to(dt)[:, None, :]


def moe_ffn(params: MoE, x, rngs=None, drop=None, *, num_experts: int,
            top_k: int = 1, capacity_factor: float = 1.25, aux_sums=None,
            training: bool = True, dispatch: str = "scatter"):
    """Switch/GShard FFN on [B, S, d] inputs; returns [B, S, d_out].

    aux_sums: an optional list collecting this layer's scalar
    load-balance loss. training=False lifts the capacity cap (C = S).
    dispatch: "scatter" or "einsum"; any other raises ValueError."""
    if dispatch not in ("einsum", "scatter"):
        raise ValueError("moe dispatch must be 'einsum' or 'scatter', "
                         "got %r" % (dispatch,))
    b, s, d = x.shape
    e = num_experts
    c = capacity(s, e, capacity_factor, top_k) if training else s

    logits = nn.linear(params.router, x).float()                  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = stable_top_k(probs, top_k)               # [B,S,k]
    if top_k == 1:
        gates = top_probs
    else:
        gates = top_probs / torch.clamp(top_probs.sum(-1, keepdim=True),
                                        min=1e-9)
    pos, keep = _route(top_idx, e, c)

    if aux_sums is not None:
        # Switch load-balance loss over primary assignments (fractions
        # before the cap keep the gradient signal when experts overflow);
        # under data parallelism f_e and P_e are means over the global
        # [B, S], and their product is taken after the means
        primary = _one_hot(top_idx[..., 0], e)
        means = global_sum(torch.cat([primary.sum(dim=(0, 1)),
                                      probs.sum(dim=(0, 1))])) \
            / global_count(b * s)
        f_e, p_e = means[:e], means[e:]
        aux_sums.append(e * (f_e * p_e).sum())

    ex = params.experts
    tag = tp.leaf_part(ex, "w1")
    if tag is not None and dispatch != "einsum":
        raise NotImplementedError(
            "moe_dispatch=%s under expert parallelism: not ported to "
            "zero_tpu_torch yet: it comes with a later slice (einsum runs)"
            % dispatch)
    if dispatch == "einsum":
        combine = x.new_zeros((b, s, e, c), dtype=torch.float32)
        for slot in range(top_k):
            e_oh = _one_hot(top_idx[..., slot], e)                # [B,S,E]
            c_oh = _one_hot(pos[..., slot] - 1, c)                # [B,S,C]
            kf = keep[..., slot].float()
            combine = combine + (e_oh[..., :, None] * c_oh[..., None, :]
                                 * (kf * gates[..., slot])[..., None, None])
        disp = (combine > 0).to(x.dtype)                          # [B,S,E,C]
        if tag is not None:
            return _expert_parallel(ex, tag[0], x, combine, disp, rngs,
                                    drop)
        xin = torch.einsum("bsec,bsd->ebcd", disp, x).reshape(e, b * c, d)
        out = _expert_ffn(ex, xin, rngs, drop).reshape(e, b, c, -1)
        return torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), out)

    sink = e * c
    slot_idx = torch.where(keep, top_idx * c + (pos - 1),
                           torch.full_like(pos, sink))            # [B,S,k]
    flat_idx = slot_idx.reshape(b, s * top_k)
    xk = x[:, :, None, :].expand(b, s, top_k, d).reshape(b, s * top_k, d)
    # kept slot indices are unique per row, so add is set there; only the
    # sink row adds up collisions
    buf = x.new_zeros((b, e * c + 1, d)).scatter_add(
        1, flat_idx[..., None].expand(b, s * top_k, d), xk)
    xin = buf[:, :e * c].reshape(b, e, c, d).transpose(0, 1) \
        .reshape(e, b * c, d)
    out = _expert_ffn(ex, xin, rngs, drop)
    d_out = out.shape[-1]
    out_b = out.reshape(e, b, c, d_out).transpose(0, 1) \
        .reshape(b, e * c, d_out)
    back = torch.gather(
        out_b, 1, torch.clamp(flat_idx, 0, e * c - 1)[..., None]
        .expand(b, s * top_k, d_out)).reshape(b, s, top_k, d_out)
    w = (gates * keep.float()).to(x.dtype)
    return torch.einsum("bsk,bskd->bsd", w, back)


def _expert_parallel(ex: Experts, part, x, combine, disp, rngs, drop):
    """The einsum dispatch and combine of this process's experts (part
    ``part`` of the E experts): the tokens and the combine weights enter
    the line's region, the combined outputs are summed over it."""
    b, s, e, c = combine.shape
    d = x.shape[-1]
    local = e // part.degree
    lo = part.offset(local)
    x = dist.copy_in(x, part.axis)
    combine = dist.copy_in(combine, part.axis)[:, :, lo:lo + local]
    xin = torch.einsum("bsec,bsd->ebcd", disp[:, :, lo:lo + local],
                       x).reshape(local, b * c, d)
    out = _expert_ffn(ex, xin, rngs, drop, split=(0, lo, e)) \
        .reshape(local, b, c, -1)
    return dist.reduce_out(
        torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), out), part.axis)
