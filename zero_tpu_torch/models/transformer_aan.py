"""Transformer-AAN: decoder self-attention replaced by average attention.

Counterpart of ``zero_tpu/models/transformer_aan.py``: the decoder's
self-attention becomes the cumulative (masked) average of the layer inputs
(ops/nn.py:aan_cummean, the O(L) cumsum form), optionally through an FFN
(``use_ffn``: ``aan_ffn``), mixed back by the input/forget gate
``z_project`` over ``[x, y]``. Decode keeps an O(1) cache, the running sum
``{"aan": [B, 1, hidden]}`` in the compute dtype, which every beam reorder
gathers (it is no pool). The encoder is transformer's, kernel flags
included; the decoder's cross attention and FFN run the composite, as in
the JAX file.
"""

from __future__ import annotations

import torch

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import attention, nn
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp


def init_dec_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    parts = {
        "z_project": nn.init_linear(gen, 2 * h, 2 * h, weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "cross": attention.init_attention(gen, h, h, self_attention=False,
                                          d_memory=h, weight_init=init),
        "ln2": nn.init_layer_norm(h),
        "ffn": nn.init_ffn(gen, h, cfg.filter_size, h, weight_init=init),
        "ln3": nn.init_layer_norm(h),
    }
    if cfg.use_ffn:
        parts["aan_ffn"] = nn.init_ffn(gen, h, cfg.filter_size, h,
                                       weight_init=init)
    return common.Layer(parts)


def _gate(p, x, y):
    """Input/forget gating: z = linear([x, y]); sig(i) * x + sig(f) * y.
    Under tensor parallelism ``z_project`` holds a process's columns of
    z (at W = 2 rank 0 all of i, rank 1 all of f): they are gathered
    whole before the chunk."""
    xy = torch.cat([x, y], dim=-1)
    part = tp.column(p.z_project)
    if part is None:
        z = nn.linear(p.z_project, xy)
    else:
        z = dist.gather_cols(nn.linear(p.z_project,
                                       dist.copy_in(xy, part.axis)),
                             part.axis)
    i, f = z.chunk(2, dim=-1)
    return torch.sigmoid(i) * x + torch.sigmoid(f) * y


def dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask):
    x_fwd = nn.aan_cummean(x, tgt_mask, masked=bool(cfg.aan_mask))
    y = (nn.ffn(p.aan_ffn, x_fwd, rngs(), cfg.relu_dropout) if cfg.use_ffn
         else x_fwd)
    y = _gate(p, x, y)
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = attention.attn_train(p.cross, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout)["output"]
    x = nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def init_dec_layer_cache(p, batch, max_len, cfg, dtype, device):
    return {"aan": torch.zeros((batch, 1, cfg.hidden_size), dtype=dtype,
                               device=device)}


def dec_layer_step(p, x_t, layer_state, state, cache, time, cfg):
    new_sum = cache["aan"] + x_t
    x_fwd = new_sum / nn.aan_step_count(time, x_t.dtype)
    y = nn.ffn(p.aan_ffn, x_fwd) if cfg.use_ffn else x_fwd
    y = _gate(p, x_t, y)
    x_t = nn.layer_norm(p.ln1, x_t + y)
    y = attention.cross_attn_step(p.cross, x_t, layer_state, state["mask"],
                                  cfg.num_heads)
    x_t = nn.layer_norm(p.ln2, x_t + y)
    y = nn.ffn(p.ffn, x_t)
    x_t = nn.layer_norm(p.ln3, x_t + y)
    return x_t, {"aan": new_sum}


HOOKS = common.LayerHooks(
    init_enc_layer=base.init_enc_layer,
    enc_layer=base.enc_layer,
    init_dec_layer=init_dec_layer,
    dec_layer_train=dec_layer_train,
    dec_layer_precompute=base.dec_layer_precompute,
    init_dec_layer_cache=init_dec_layer_cache,
    dec_layer_step=dec_layer_step,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(HOOKS)

model_register("transformer_aan", init_fn, train_fn, score_fn, infer_fn)
