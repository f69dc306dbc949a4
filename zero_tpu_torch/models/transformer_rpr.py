"""Transformer with Shaw relative-position representations (RPR).

Counterpart of ``zero_tpu/models/transformer_rpr.py``: relative positions in
encoder self-attention, decoder causal self-attention and decoder cross
attention, each attention block owning its own key/value tables at per-head
depth (``self_rpr``, ``cross_rpr``). With use_flash_attention the three
training attentions ride the RPR kernels (#3/#4) wherever the JAX package
runs its RPR kernel (ops/attention.py:_rpr_flash_ok). The FFN is never
fused, and decode uses the single-distance-row form with both decode
kernels off (``pool_kernel=False``).
"""

from __future__ import annotations

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import attention, nn


def _tables(gen, cfg, init):
    return attention.init_rpr_tables(gen, cfg.hidden_size, cfg.num_heads,
                                     cfg.max_relative_position,
                                     weight_init=init)


def init_enc_layer(gen, cfg, layer):
    p = base.init_enc_layer(gen, cfg, layer)
    p.add_module("self_rpr",
                 _tables(gen, cfg, common.layer_initializer(cfg, layer)))
    return p


def enc_layer(p, x, src_keep, cfg, rngs):
    y = attention.attn_train(
        p.self, x, None, src_keep, cfg.num_heads, rng=rngs(),
        drop=cfg.attention_dropout, use_flash=cfg.use_flash_attention,
        pad_mask=src_keep[:, 0, 0, :], rpr_tables=p.self_rpr,
        max_relative_position=cfg.max_relative_position)["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def init_dec_layer(gen, cfg, layer):
    p = base.init_dec_layer(gen, cfg, layer)
    init = common.layer_initializer(cfg, layer)
    p.add_module("self_rpr", _tables(gen, cfg, init))
    p.add_module("cross_rpr", _tables(gen, cfg, init))
    return p


def dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask):
    y = attention.attn_train(
        p.self, x, None, self_keep, cfg.num_heads, rng=rngs(),
        drop=cfg.attention_dropout, use_flash=cfg.use_flash_attention,
        causal=True, rpr_tables=p.self_rpr,
        max_relative_position=cfg.max_relative_position)["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = attention.attn_train(
        p.cross, x, state["encodes"], mem_keep, cfg.num_heads, rng=rngs(),
        drop=cfg.attention_dropout, use_flash=cfg.use_flash_attention,
        pad_mask=mem_keep[:, 0, 0, :], rpr_tables=p.cross_rpr,
        max_relative_position=cfg.max_relative_position)["output"]
    x = nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def dec_layer_step(p, x_t, layer_state, state, cache, time, cfg):
    y, cache = attention.self_attn_step(
        p.self, x_t, cache, time, cfg.num_heads, rpr_tables=p.self_rpr,
        max_relative_position=cfg.max_relative_position)
    x_t = nn.layer_norm(p.ln1, x_t + y)
    y = attention.cross_attn_step(
        p.cross, x_t, layer_state, state["mask"], cfg.num_heads, time=time,
        rpr_tables=p.cross_rpr,
        max_relative_position=cfg.max_relative_position)
    x_t = nn.layer_norm(p.ln2, x_t + y)
    y = nn.ffn(p.ffn, x_t)
    x_t = nn.layer_norm(p.ln3, x_t + y)
    return x_t, cache


HOOKS = common.LayerHooks(
    init_enc_layer=init_enc_layer,
    enc_layer=enc_layer,
    init_dec_layer=init_dec_layer,
    dec_layer_train=dec_layer_train,
    dec_layer_precompute=base.dec_layer_precompute,
    init_dec_layer_cache=base.init_dec_layer_cache,
    dec_layer_step=dec_layer_step,
    pool_kernel=False,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(HOOKS)

model_register("transformer_rpr", init_fn, train_fn, score_fn, infer_fn)
