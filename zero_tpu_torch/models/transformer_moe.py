"""Transformer with mixture-of-experts FFNs (Switch/GShard).

Counterpart of ``zero_tpu/models/transformer_moe.py``: the post-LN
transformer with every encoder and decoder FFN replaced by a routed expert
FFN (ops/moe.py), and the load-balance aux loss, the mean over layers
weighted by ``moe_aux_weight``, added to the training loss.

Its own init_fn and train_fn, as in the JAX package, which therefore
ignores ``use_remat`` and ``scan_layers`` for this model: so does the
port. Its layers pass no kernel flag in training (no fused attention or
FFN); decode takes #10 under ``use_flash_decode`` over the classic cache,
which the search permutes (no reorder_cache). Training runs the
activations in the compute dtype over the fp32 weights, cast at each op;
the eval modes encode and decode in fp32, with fp32 weights.

Config: moe_num_experts, moe_top_k, moe_capacity_factor, moe_aux_weight,
moe_dispatch ("auto" is "einsum").
"""

from __future__ import annotations

import torch

from zero_tpu_torch import dtypes
from zero_tpu_torch.models import common
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.ops import attention, moe, nn
from zero_tpu_torch.ops.common import RngGen, dropout


def _moe_args(cfg):
    mode = getattr(cfg, "moe_dispatch", "auto")
    if mode == "auto":
        # the JAX package's choice: einsum everywhere
        mode = "einsum"
    return dict(num_experts=int(cfg.moe_num_experts),
                top_k=int(cfg.moe_top_k),
                capacity_factor=float(cfg.moe_capacity_factor),
                dispatch=mode)


def init_enc_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    return common.Layer({
        "self": attention.init_attention(gen, h, h, self_attention=True,
                                         weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "moe": moe.init_moe_ffn(gen, h, cfg.filter_size, h,
                                int(cfg.moe_num_experts), weight_init=init),
        "ln2": nn.init_layer_norm(h),
    })


def init_dec_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    return common.Layer({
        "self": attention.init_attention(gen, h, h, self_attention=True,
                                         weight_init=init),
        "ln1": nn.init_layer_norm(h),
        "cross": attention.init_attention(gen, h, h, self_attention=False,
                                          d_memory=h, weight_init=init),
        "ln2": nn.init_layer_norm(h),
        "moe": moe.init_moe_ffn(gen, h, cfg.filter_size, h,
                                int(cfg.moe_num_experts), weight_init=init),
        "ln3": nn.init_layer_norm(h),
    })


def init_fn(gen, cfg) -> common.Seq2Seq:
    tables = common.init_embeddings(gen, cfg)
    return common.Seq2Seq(
        tables,
        [init_enc_layer(gen, cfg, l) for l in range(cfg.num_encoder_layer)],
        [init_dec_layer(gen, cfg, l) for l in range(cfg.num_decoder_layer)])


def _enc_layer(p, x, src_keep, cfg, rngs, training, aux_sums):
    y = attention.attn_train(p.self, x, None, src_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             pad_mask=src_keep[:, 0, 0, :])["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = moe.moe_ffn(p.moe, x, rngs, cfg.relu_dropout, aux_sums=aux_sums,
                    training=training, **_moe_args(cfg))
    return nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def _dec_layer(p, x, state, self_keep, mem_keep, cfg, rngs, training,
               aux_sums):
    y = attention.attn_train(p.self, x, None, self_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             causal=True)["output"]
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = attention.attn_train(p.cross, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout,
                             pad_mask=mem_keep[:, 0, 0, :])["output"]
    x = nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = moe.moe_ffn(p.moe, x, rngs, cfg.relu_dropout, aux_sums=aux_sums,
                    training=training, **_moe_args(cfg))
    return nn.layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def _encode(params, source, cfg, rngs, training, aux_sums):
    dtype = dtypes.compute_dtype(cfg) if training else torch.float32
    mask = (source != 0).to(dtype)
    src_table, _, _ = common.emb_tables(params, cfg)
    x = common.embed_scaled(src_table, source, params.emb_bias, cfg, dtype)
    x = nn.add_timing_signal(x)
    x = dropout(rngs(), x, cfg.dropout if training else None)
    src_keep = nn.masking_mask(mask)
    for p in params.encoder:
        x = _enc_layer(p, x, src_keep, cfg, rngs, training, aux_sums)
    return {"encodes": x, "mask": mask}


def _decode_train(params, target, state, cfg, rngs, training, aux_sums):
    dtype = state["encodes"].dtype
    mask = (target != 0).to(dtype)
    _, tgt_table, soft_table = common.emb_tables(params, cfg)
    x = common.embed_scaled(tgt_table, target, params.emb_bias, cfg, dtype)
    x = common.shift_right(x)
    x = nn.add_timing_signal(x)
    x = dropout(rngs(), x, cfg.dropout if training else None)
    self_keep = nn.causal_mask(target.shape[1], device=target.device)
    mem_keep = nn.masking_mask(state["mask"])
    for p in params.decoder:
        x = _dec_layer(p, x, state, self_keep, mem_keep, cfg, rngs, training,
                       aux_sums)
    return x, soft_table, mask


def train_fn(params, features, cfg, gen, step=0):
    common.check_ported(cfg)
    rngs = RngGen(gen)
    aux_sums = []
    state = _encode(params, features["source"], cfg, rngs, True, aux_sums)
    feat, soft_table, mask = _decode_train(params, features["target"], state,
                                           cfg, rngs, True, aux_sums)
    loss, _ = common.ce_from_feature(feat, soft_table, features["target"],
                                     mask, cfg, cfg.label_smooth)
    aux = sum(aux_sums) / max(len(aux_sums), 1)
    return {"loss": loss + cfg.moe_aux_weight * aux, "moe_aux": aux}


def score_fn(params, features, cfg):
    rngs = RngGen(None)
    state = _encode(params, features["source"], cfg, rngs, False, None)
    feat, soft_table, mask = _decode_train(params, features["target"], state,
                                           cfg, rngs, False, None)
    _, per_sample = common.ce_from_feature(feat, soft_table,
                                           features["target"], mask, cfg, 0.0)
    return {"score": per_sample}


def infer_fn(cfg):
    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False, None)
        state["layers"] = [
            attention.cross_attn_precompute(p.cross, state["encodes"])
            for p in params.decoder]
        return state

    def init_cache(params, state, batch, max_len):
        return {"layers": [attention.init_self_cache(
            batch, max_len, cfg.hidden_size, torch.float32,
            state["mask"].device) for _ in params.decoder]}

    def decode_step(params, prev_tok, state, cache, time):
        _, tgt_table, soft_table = common.emb_tables(params, cfg)
        x = common.embed_scaled(tgt_table, prev_tok, params.emb_bias, cfg,
                                torch.float32)
        if time == 0:
            x = torch.zeros_like(x)
        x = nn.add_timing_signal(x, time=time)
        new_caches = []
        for p, lstate, lcache in zip(params.decoder, state["layers"],
                                     cache["layers"]):
            y, new_c = attention.self_attn_step(p.self, x, lcache, time,
                                                cfg.num_heads,
                                                use_flash=cfg.use_flash_decode)
            x = nn.layer_norm(p.ln1, x + y)
            y = attention.cross_attn_step(p.cross, x, lstate, state["mask"],
                                          cfg.num_heads)
            x = nn.layer_norm(p.ln2, x + y)
            y = moe.moe_ffn(p.moe, x, training=False, **_moe_args(cfg))
            x = nn.layer_norm(p.ln3, x + y)
            new_caches.append(new_c)
        logits = common.output_logits(x[:, 0], soft_table)
        return logits, {"layers": new_caches}

    def decode_prefix(params, tgt_buffer, state, time):
        feat, soft_table, _ = _decode_train(params, tgt_buffer, state, cfg,
                                            RngGen(None), False, None)
        return common.output_logits(feat[:, time], soft_table)

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step, decode_prefix=decode_prefix)


model_register("transformer_moe", init_fn, train_fn, score_fn, infer_fn,
               eval_cast=False)
