"""CLSR: conditional language-specific routing for multilingual NMT.

Counterpart of ``zero_tpu/models/transformer_clsr.py``. Every sublayer's
output passes through a CLSR unit that routes between a shared projection
and a per-language projection with a learned hard gate:

    CLSR(x) = g(x) * W_lang[lang] x + (1 - g(x)) * W_shared x

g is a per-position scalar gate: a hard-concrete sample in training (the
gate noise from a dropout site's seed words, ops/l0norm.py), the
deterministic mean at eval. The budget loss |mean(g) - clsr_budget|,
weighted by clsr_alpha, is added to the training loss. The target
language comes from the leading source tag (transformer_multilingual).

Its own init_fn and train_fn, as in the JAX package, which therefore
ignores ``use_remat`` and ``scan_layers`` for this model: so does the
port. No layer passes a kernel flag in training; decode takes #10 under
``use_flash_decode`` over the classic cache, which the search permutes.
The model computes in fp32 whatever ``default_dtype`` says, with fp32
weights, as the JAX package does.
"""

from __future__ import annotations

import torch

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.models.transformer_multilingual import (
    init_lang_cache, lang_from_source, lang_matmul)
from zero_tpu_torch.ops import attention, l0norm, nn
from zero_tpu_torch.ops import common as ops_common
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp


# -- CLSR unit ----------------------------------------------------------------

class ClsrUnit(torch.nn.Module):
    """``gate`` (Linear to 1), ``shared`` (Linear) and the per-language
    projections ``lang`` [num_languages, d, d]."""

    def __init__(self, gate, shared, lang):
        super().__init__()
        self.gate = gate
        self.shared = shared
        self.lang = torch.nn.Parameter(lang)


def init_clsr(gen, cfg) -> ClsrUnit:
    init = common.config_initializer(cfg)
    h = cfg.hidden_size
    return ClsrUnit(nn.init_linear(gen, h, 1, weight_init=init),
                    nn.init_linear(gen, h, h, weight_init=init),
                    # identity-initialised
                    torch.eye(h)[None].repeat(cfg.num_languages, 1, 1))


def clsr(params: ClsrUnit, x, lang, rngs, training, gate_sums):
    """Apply one CLSR unit; appends (sum g, count) to gate_sums. Under
    tensor parallelism ``shared`` and ``lang`` hold a process's columns:
    the gate and its noise are whole and the same on every process of
    the line, and both projections are gathered whole (one call) before
    the gate mixes them."""
    log_alpha = nn.linear(params.gate, x).float()                 # [B,L,1]
    if training:
        # x may be a sequence block: its noise indexes the whole sequence
        g = l0norm.hard_concrete_sample(
            rngs(), log_alpha,
            split=ops_common.seq_split(1, log_alpha.shape[1]))
    else:
        g = l0norm.hard_concrete_mean(log_alpha)
    part = tp.column(params.shared)
    if part is None:
        h_shared = nn.linear(params.shared, x)
        h_lang = lang_matmul(x, params.lang, lang)
    else:
        xs = dist.copy_in(x, part.axis)
        h_lang, h_shared = dist.gather_cols(torch.stack([
            lang_matmul(xs, params.lang, lang),
            nn.linear(params.shared, xs)]), part.axis).unbind(0)
    gx = g.to(x.dtype)
    out = gx * h_lang + (1.0 - gx) * h_shared
    if gate_sums is not None:
        gate_sums.append((g.sum(), float(g.numel())))
    return out


# -- model --------------------------------------------------------------------

def init_enc_layer(gen, cfg, layer):
    p = base.init_enc_layer(gen, cfg, layer)
    p.add_module("clsr1", init_clsr(gen, cfg))
    p.add_module("clsr2", init_clsr(gen, cfg))
    return p


def init_dec_layer(gen, cfg, layer):
    p = base.init_dec_layer(gen, cfg, layer)
    for name in ("clsr1", "clsr2", "clsr3"):
        p.add_module(name, init_clsr(gen, cfg))
    return p


def init_fn(gen, cfg) -> common.Seq2Seq:
    tables = common.init_embeddings(gen, cfg)
    return common.Seq2Seq(
        tables,
        [init_enc_layer(gen, cfg, l) for l in range(cfg.num_encoder_layer)],
        [init_dec_layer(gen, cfg, l) for l in range(cfg.num_decoder_layer)])


def _enc_layer(p, x, src_keep, lang, cfg, rngs, training, gate_sums):
    y = attention.attn_train(p.self, x, None, src_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             pad_mask=src_keep[:, 0, 0, :])["output"]
    y = clsr(p.clsr1, y, lang, rngs, training, gate_sums)
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    y = clsr(p.clsr2, y, lang, rngs, training, gate_sums)
    return nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def _dec_layer(p, x, state, self_keep, mem_keep, lang, cfg, rngs, training,
               gate_sums):
    y = attention.attn_train(p.self, x, None, self_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             causal=True)["output"]
    y = clsr(p.clsr1, y, lang, rngs, training, gate_sums)
    x = nn.layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = attention.attn_train(p.cross, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout)["output"]
    y = clsr(p.clsr2, y, lang, rngs, training, gate_sums)
    x = nn.layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                            cfg.residual_dropout))
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    y = clsr(p.clsr3, y, lang, rngs, training, gate_sums)
    return nn.layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                               cfg.residual_dropout))


def _encode(params, source, cfg, rngs, training, gate_sums):
    mask = (source != 0).float()
    lang = lang_from_source(source, cfg)
    src_table, _, _ = common.emb_tables(params, cfg)
    x = common.embed_scaled(src_table, source, params.emb_bias, cfg,
                            torch.float32)
    x = common.seq_inputs(x, rngs(), cfg.dropout if training else None)
    keep = nn.masking_mask(mask)
    for p in params.encoder:
        x = _enc_layer(p, x, keep, lang, cfg, rngs, training, gate_sums)
    return {"encodes": common.gather_encodes(x), "mask": mask, "lang": lang}


def _decode_train(params, target, state, cfg, rngs, training, gate_sums):
    mask = common.seq_block((target != 0).float())
    _, tgt_table, soft_table = common.emb_tables(params, cfg)
    x = common.embed_scaled(tgt_table, target, params.emb_bias, cfg,
                            torch.float32)
    x = common.seq_inputs(common.shift_right(x), rngs(),
                          cfg.dropout if training else None)
    self_keep = nn.causal_mask(target.shape[1], device=target.device)
    mem_keep = nn.masking_mask(state["mask"])
    for p in params.decoder:
        x = _dec_layer(p, x, state, self_keep, mem_keep, state["lang"], cfg,
                       rngs, training, gate_sums)
    return x, soft_table, mask


def budget_loss(gate_sums, cfg):
    """|mean gate over every unit's positions - clsr_budget|, the
    positions of the global batch under data parallelism and of the whole
    sequences under sequence parallelism."""
    total_g = ops_common.global_sum(ops_common.seq_sum(
        sum(s for s, _ in gate_sums)))
    total_n = ops_common.global_count(ops_common.seq_count(
        sum(n for _, n in gate_sums)))
    return torch.abs(total_g / max(total_n, 1.0) - cfg.clsr_budget)


def train_fn(params, features, cfg, gen, step=0):
    common.check_ported(cfg)
    features = common.seq_padded(features)
    rngs = RngGen(gen)
    gate_sums = []
    state = _encode(params, features["source"], cfg, rngs, True, gate_sums)
    feat, soft_table, mask = _decode_train(params, features["target"], state,
                                           cfg, rngs, True, gate_sums)
    loss, _ = common.ce_from_feature(feat, soft_table,
                                     common.seq_block(features["target"]),
                                     mask, cfg, cfg.label_smooth)
    return {"loss": loss + cfg.clsr_alpha * budget_loss(gate_sums, cfg)}


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
        state["layers"] = [base.dec_layer_precompute(p, state["encodes"], cfg)
                           for p in params.decoder]
        return state

    def init_cache(params, state, batch, max_len):
        device = state["mask"].device
        return {"lang": init_lang_cache(state, batch),
                "layers": [base.init_dec_layer_cache(
                    p, batch, max_len, cfg, torch.float32, device)
                    for p in params.decoder]}

    def decode_step(params, prev_tok, state, cache, time):
        _, tgt_table, soft_table = common.emb_tables(params, cfg)
        x = common.embed_scaled(tgt_table, prev_tok, params.emb_bias, cfg,
                                torch.float32)
        if time == 0:
            x = torch.zeros_like(x)
        x = nn.add_timing_signal(x, time=time)
        rngs = RngGen(None)
        lang = cache["lang"]
        new_caches = []
        for p, lstate, lcache in zip(params.decoder, state["layers"],
                                     cache["layers"]):
            y, new_c = attention.self_attn_step(p.self, x, lcache, time,
                                                cfg.num_heads,
                                                use_flash=cfg.use_flash_decode)
            y = clsr(p.clsr1, y, lang, rngs, False, None)
            x = nn.layer_norm(p.ln1, x + y)
            y = attention.cross_attn_step(p.cross, x, lstate, state["mask"],
                                          cfg.num_heads)
            y = clsr(p.clsr2, y, lang, rngs, False, None)
            x = nn.layer_norm(p.ln2, x + y)
            y = clsr(p.clsr3, nn.ffn(p.ffn, x), lang, rngs, False, None)
            x = nn.layer_norm(p.ln3, x + y)
            new_caches.append(new_c)
        logits = common.output_logits(x[:, 0], soft_table)
        return logits, {"lang": lang, "layers": new_caches}

    def decode_prefix(params, tgt_buffer, state, time):
        feat, soft_table, _ = _decode_train(params, tgt_buffer, state, cfg,
                                            RngGen(None), False, None)
        return common.output_logits(feat[:, time], soft_table)

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step, decode_prefix=decode_prefix)


model_register("transformer_clsr", init_fn, train_fn, score_fn, infer_fn,
               eval_cast=False)
