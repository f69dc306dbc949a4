"""Transformer with merged attention (MAtt): fused cross attention + AAN.

Counterpart of ``zero_tpu/models/transformer_fuse.py``: the decoder layer
is one ``fuse`` attention (cross attention whose output is summed with the
AAN cumulative average of the query side through the shared ``v``
projection, ops/attention.py) followed by the FFN: two sublayers per
decoder layer instead of three. It pairs with deep_transformer_init for
12-30 layer models (configs/deep_transformer_fuse_l0drop.json). The
encoder is transformer's, kernel flags included; the decoder's merged
attention and FFN take no kernel flag, as in the JAX file. Decode keeps an
O(1) cache, the running sum ``{"aan": [B, 1, hidden]}``.
"""

from __future__ import annotations

import torch

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import attention, nn


def init_dec_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    return common.Layer({
        "fuse": attention.init_attention(gen, h, h, self_attention=False,
                                         d_memory=h, fuse=True,
                                         weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "ffn": nn.init_ffn(gen, h, cfg.filter_size, h, weight_init=init),
        "ln2": nn.init_layer_norm(h),
    })


def dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask):
    y = attention.attn_train(p.fuse, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout,
                             fuse_mask=tgt_mask)["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def dec_layer_precompute(p, encodes, cfg):
    return attention.cross_attn_precompute(p.fuse, encodes)


def init_dec_layer_cache(p, batch, max_len, cfg, dtype, device):
    return {"aan": torch.zeros((batch, 1, cfg.hidden_size), dtype=dtype,
                               device=device)}


def dec_layer_step(p, x_t, layer_state, state, cache, time, cfg):
    y, new_sum = attention.cross_attn_step(
        p.fuse, x_t, layer_state, state["mask"], cfg.num_heads,
        aan_sum=cache["aan"], time=time)
    x_t = nn.layer_norm(p.ln1, x_t + y)
    y = nn.ffn(p.ffn, x_t)
    x_t = nn.layer_norm(p.ln2, x_t + y)
    return x_t, {"aan": new_sum}


HOOKS = common.LayerHooks(
    init_enc_layer=base.init_enc_layer,
    enc_layer=base.enc_layer,
    init_dec_layer=init_dec_layer,
    dec_layer_train=dec_layer_train,
    dec_layer_precompute=dec_layer_precompute,
    init_dec_layer_cache=init_dec_layer_cache,
    dec_layer_step=dec_layer_step,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(HOOKS)

model_register("transformer_fuse", init_fn, train_fn, score_fn, infer_fn)
