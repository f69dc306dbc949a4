"""Transformer-Fixup: deep training without layer normalisation.

Counterpart of ``zero_tpu/models/transformer_fixup.py``: no layer norm
anywhere; every attention sublayer shifts its input and scales its output
with scalar parameters; the FFN carries its own shift/scale sandwich;
numblocks = 2 * encoder layers + 3 * decoder layers; the encoder ends with
scale(shift(x)) and the decoder with shift(x) (the skeleton's ``enc_post``
and ``dec_post``); a separate softmax table is zero-initialised. Its
layers pass no kernel flag, as in the JAX file: training runs the
composite, and beam decode the pool kernel where use_flash_decode says.
"""

from __future__ import annotations

from zero_tpu_torch.models import common
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import attention, fixup, nn


def _numblocks(cfg):
    return 2 * cfg.num_encoder_layer + 3 * cfg.num_decoder_layer


def _attention(gen, cfg, layer, self_attention):
    h = cfg.hidden_size
    return fixup.init_fixup_attention(
        gen, h, h, self_attention=self_attention, numblocks=_numblocks(cfg),
        d_memory=None if self_attention else h,
        base_init=common.layer_initializer(cfg, layer))


def _ffn(gen, cfg, layer):
    h = cfg.hidden_size
    return fixup.init_fixup_ffn(gen, h, cfg.filter_size, h,
                                numblocks=_numblocks(cfg),
                                base_init=common.layer_initializer(cfg, layer))


def init_enc_layer(gen, cfg, layer):
    return common.Layer({
        "self_shift": fixup.init_shift(),
        "self": _attention(gen, cfg, layer, True),
        "self_scale": fixup.init_scale(),
        "ffn": _ffn(gen, cfg, layer),
    })


def enc_layer(p, x, src_keep, cfg, rngs):
    y = attention.attn_train(p.self, fixup.shift(p.self_shift, x), None,
                             src_keep, cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout)["output"]
    y = fixup.scale(p.self_scale, y)
    x = nn.residual_fn(x, y, rngs(), cfg.residual_dropout)
    y = fixup.fixup_ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.residual_fn(x, y, rngs(), cfg.residual_dropout)


def init_dec_layer(gen, cfg, layer):
    return common.Layer({
        "self_shift": fixup.init_shift(),
        "self": _attention(gen, cfg, layer, True),
        "self_scale": fixup.init_scale(),
        "cross_shift": fixup.init_shift(),
        "cross": _attention(gen, cfg, layer, False),
        "cross_scale": fixup.init_scale(),
        "ffn": _ffn(gen, cfg, layer),
    })


def dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask):
    y = attention.attn_train(p.self, fixup.shift(p.self_shift, x), None,
                             self_keep, cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout)["output"]
    y = fixup.scale(p.self_scale, y)
    x = nn.residual_fn(x, y, rngs(), cfg.residual_dropout)
    y = attention.attn_train(p.cross, fixup.shift(p.cross_shift, x),
                             state["encodes"], mem_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout)["output"]
    y = fixup.scale(p.cross_scale, y)
    x = nn.residual_fn(x, y, rngs(), cfg.residual_dropout)
    y = fixup.fixup_ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return nn.residual_fn(x, y, rngs(), cfg.residual_dropout)


def dec_layer_precompute(p, encodes, cfg):
    return attention.cross_attn_precompute(p.cross, encodes)


def init_dec_layer_cache(p, batch, max_len, cfg, dtype, device):
    return attention.init_self_cache(batch, max_len, cfg.hidden_size, dtype,
                                     device)


def dec_layer_step(p, x_t, layer_state, state, cache, time, cfg):
    y, cache = attention.self_attn_step(p.self,
                                        fixup.shift(p.self_shift, x_t),
                                        cache, time, cfg.num_heads,
                                        use_flash=cfg.use_flash_decode)
    x_t = x_t + fixup.scale(p.self_scale, y)
    y = attention.cross_attn_step(p.cross, fixup.shift(p.cross_shift, x_t),
                                  layer_state, state["mask"], cfg.num_heads)
    x_t = x_t + fixup.scale(p.cross_scale, y)
    return x_t + fixup.fixup_ffn(p.ffn, x_t), cache


def init_enc_post(gen, cfg):
    return common.Layer({"shift": fixup.init_shift(),
                         "scale": fixup.init_scale()})


def enc_post(p, x):
    # scale(shift(x)) after the encoder stack
    return fixup.scale(p.scale, fixup.shift(p.shift, x))


def init_dec_post(gen, cfg):
    return common.Layer({"shift": fixup.init_shift()})


def dec_post(p, x):
    # shift(x) after the decoder stack
    return fixup.shift(p.shift, x)


HOOKS = common.LayerHooks(
    init_enc_layer=init_enc_layer,
    enc_layer=enc_layer,
    init_dec_layer=init_dec_layer,
    dec_layer_train=dec_layer_train,
    dec_layer_precompute=dec_layer_precompute,
    init_dec_layer_cache=init_dec_layer_cache,
    dec_layer_step=dec_layer_step,
    init_enc_post=init_enc_post,
    enc_post=enc_post,
    init_dec_post=init_dec_post,
    dec_post=dec_post,
)

init_fn, train_fn, score_fn, infer_fn = common.make_transformer(
    HOOKS, zero_softmax=True)

model_register("transformer_fixup", init_fn, train_fn, score_fn, infer_fn)
