"""Transformer-L0Drop: differentiable pruning of the encoder's outputs.

Counterpart of ``zero_tpu/models/transformer_l0drop.py``. Each source
position's gate log-alpha is ``x . w`` (``source_pruning``). Training
samples hard-concrete gates (ops/l0norm.py; the noise from a seed pair of
the step's generator), multiplies the encodings by them, restricts cross
attention to the surviving positions and adds the ramped expected-L0
penalty; evaluation uses the mean gates and zeroes the dropped encodings,
which equals the reference's compacted memory with its count-carrying pad
slot. ``l0_compact_ratio > 0`` compacts the memory to a static
ceil(S * ratio) positions plus that pad slot (``compact_encodings``),
whose count softmax runs on the composite cross attention.

As in the JAX package, scoring uses the deterministic mean gates, and the
layers are transformer's, kernel flags included.
"""

from __future__ import annotations

import math

import torch

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import common as common_ops
from zero_tpu_torch.ops import l0norm, nn
from zero_tpu_torch.search import top_k


def compact_encodings(encodes, mask, keep_score, ratio: float):
    """Static-k compaction: the top ceil(ratio * S) positions by
    keep_score (> 0 survivors; ties at 0 go to the lower index, as
    lax.top_k's) gathered into a shorter memory headed by a ZERO pad slot
    whose softmax count is the number of positions left out, so the count
    softmax equals full-length attention with the dropped encodings
    zeroed. Exact when k covers the survivors; excess survivors fold into
    the pad slot as zero vectors. Returns (memory [B, k+1, d], mask
    [B, k+1], count [B, k+1])."""
    s_len = mask.shape[1]
    k = min(max(int(math.ceil(s_len * ratio)), 1), s_len)

    score = keep_score * mask
    top_vals, top_idx = top_k(score, k)
    g_x = torch.take_along_dim(encodes, top_idx[..., None], dim=1)
    g_mask = (top_vals > 0).to(mask.dtype)
    g_x = g_x * g_mask[..., None].to(encodes.dtype)

    kept = g_mask.sum(dim=1)
    total = mask.sum(dim=1)
    dropped = torch.clamp(total - kept, min=0.0)
    pad_flag = (dropped > 0).to(mask.dtype)

    memory = torch.cat([torch.zeros_like(g_x[:, :1]), g_x], dim=1)
    new_mask = torch.cat([pad_flag[:, None], g_mask], dim=1)
    count = torch.cat([torch.clamp(dropped, min=1.0)[:, None],
                       torch.ones_like(g_mask)], dim=1)
    return memory, new_mask, count


def extra_init(gen, cfg):
    return {"source_pruning": nn.init_linear(
        gen, cfg.hidden_size, 1, weight_init=common.config_initializer(cfg))}


def l0_penalty(log_alpha, mask):
    """The expected-L0 penalty: per-sentence mean over the valid positions,
    then the mean over the sentences that have one (of the global batch
    under data parallelism). log_alpha [B, S, 1] fp32, mask [B, S]."""
    penalty = l0norm.l0_norm(log_alpha)[..., 0]
    maskf = mask.float()
    penalty = (penalty * maskf).sum(dim=-1) / torch.clamp(
        maskf.sum(dim=-1), min=1.0)
    valid = (maskf.sum(dim=-1) > 0).float()
    return common_ops.masked_mean(penalty, valid)


def post_encode(params, state, cfg, rngs, training):
    encodes = state["encodes"]
    mask = state["mask"]
    log_alpha = nn.linear(params.source_pruning, encodes).float()  # [B,S,1]

    if training:
        gates = l0norm.hard_concrete_sample(rngs(), log_alpha)
        gated = encodes * gates.to(encodes.dtype)
        # only attend to the surviving positions
        new_mask = (gates[..., 0] > 0).to(mask.dtype) * mask
        # under a split sequence every process gates the gathered
        # encoder output: the penalty is the whole sequences' on each
        return dict(state, encodes=gated, mask=new_mask,
                    l0_penalty=common_ops.seq_shared(
                        l0_penalty(log_alpha, mask)))
    gates = l0norm.hard_concrete_mean(log_alpha)
    keep = (gates > 0).to(encodes.dtype)
    gated = (encodes * (gates.to(encodes.dtype) * keep)
             * mask[..., None].to(encodes.dtype))
    if cfg.l0_compact_ratio > 0:
        memory, new_mask, count = compact_encodings(
            gated, mask, gates[..., 0].to(mask.dtype), cfg.l0_compact_ratio)
        return dict(state, encodes=memory, mask=new_mask, count=count)
    return dict(state, encodes=gated)


def extra_loss(params, state, cfg, step):
    return l0norm.l0_regularization_loss(
        state["l0_penalty"], step,
        reg_scalar=cfg.l0_norm_reg_scalar,
        start_reg_ramp_up=cfg.l0_norm_start_reg_ramp_up,
        end_reg_ramp_up=cfg.l0_norm_end_reg_ramp_up,
        warm_up=cfg.l0_norm_warm_up)


HOOKS = common.LayerHooks(
    init_enc_layer=base.init_enc_layer,
    enc_layer=base.enc_layer,
    init_dec_layer=base.init_dec_layer,
    dec_layer_train=base.dec_layer_train,
    dec_layer_precompute=base.dec_layer_precompute,
    init_dec_layer_cache=base.init_dec_layer_cache,
    dec_layer_step=base.dec_layer_step,
    post_encode=post_encode,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(
    HOOKS, extra_init=extra_init, extra_loss=extra_loss)

model_register("transformer_l0drop", init_fn, train_fn, score_fn, infer_fn)
