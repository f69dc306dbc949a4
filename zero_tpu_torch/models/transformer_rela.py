"""Transformer-ReLA: every attention's softmax replaced by ReLU weights.

Counterpart of ``zero_tpu/models/transformer_rela.py``: encoder
self-attention, decoder causal self-attention and cross attention all run
ReLA (ops/attention.py ``relu=True``: multiplicative masking, ReLU weights
and the gated-RMSNorm epilogue ``post``). Training keeps the composite
attention even with use_flash_attention, and the FFN is never fused, as
in the JAX file. Beam decode runs the pool kernel's relu mode over the
ancestry pools (``pool_kernel=True``); single-beam decode never takes the
dense decode kernel.
"""

from __future__ import annotations

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import attention, nn


def init_enc_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    return common.Layer({
        "self": attention.init_attention(gen, h, h, self_attention=True,
                                         rela=True, weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "ffn": nn.init_ffn(gen, h, cfg.filter_size, h, weight_init=init),
        "ln2": nn.init_layer_norm(h),
    })


def enc_layer(p, x, src_keep, cfg, rngs):
    y = attention.attn_train(p.self, x, None, src_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             relu=True,
                             pad_mask=src_keep[:, 0, 0, :])["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def init_dec_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    return common.Layer({
        "self": attention.init_attention(gen, h, h, self_attention=True,
                                         rela=True, weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "cross": attention.init_attention(gen, h, h, self_attention=False,
                                          d_memory=h, rela=True,
                                          weight_init=init),
        "ln2": nn.init_layer_norm(h),
        "ffn": nn.init_ffn(gen, h, cfg.filter_size, h, weight_init=init),
        "ln3": nn.init_layer_norm(h),
    })


def dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask):
    y = attention.attn_train(p.self, x, None, self_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             relu=True, causal=True)["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = attention.attn_train(p.cross, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout, relu=True)["output"]
    x = nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def dec_layer_step(p, x_t, layer_state, state, cache, time, cfg):
    y, cache = attention.self_attn_step(p.self, x_t, cache, time,
                                        cfg.num_heads, relu=True,
                                        use_flash=cfg.use_flash_decode)
    x_t = nn.layer_norm(p.ln1, x_t + y)
    y = attention.cross_attn_step(p.cross, x_t, layer_state, state["mask"],
                                  cfg.num_heads, relu=True)
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
    # the pool kernel's relu mode serves ReLA's beam decode; the epilogue
    # runs in self_attn_step after the kernel
    pool_kernel=True,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(HOOKS)

model_register("transformer_rela", init_fn, train_fn, score_fn, infer_fn)
