"""Multilingual Transformer with language-aware components (LaLN + LaLT).

Counterpart of ``zero_tpu/models/transformer_multilingual.py``: the
decoder's layer norms own per-target-language scale and offset vectors
(LaLN), and a per-target-language projection maps the decoder output
before the shared softmax (LaLT, identity-initialised). The target
language comes from the leading source token, a language tag whose id
lies in [lang_id_offset, lang_id_offset + num_languages). Random online
back-translation (``robt=true``) lives in robt.py and train_step.py.

Its own init_fn and train_fn, as in the JAX package, which therefore
ignores ``use_remat`` and ``scan_layers`` for this model: so does the
port (the multilingual config sets use_remat; it trains as without).
The encoder is the base transformer's layer, so ``use_flash_attention``
and ``use_fused_ffn`` route it to the fused kernels; the decoder passes no
kernel flag. The model computes in fp32 whatever ``default_dtype`` says
(the JAX package embeds in fp32 and never casts the weights), so its
encoder kernels take their fp32 routes. Decode takes #10 under
``use_flash_decode`` over the classic cache, which the search permutes,
the per-beam language ids with it.
"""

from __future__ import annotations

import torch

from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.ops import attention, nn
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp


def lang_from_source(source, cfg):
    """Target-language index from the leading language-tag token."""
    return torch.clamp(source[:, 0].long() - cfg.lang_id_offset, 0,
                       cfg.num_languages - 1)


class _LangMatmul(torch.autograd.Function):
    """y[b] = x[b] @ w[lang[b]]. The backward gathers the weights again
    instead of keeping the [B, d, f] gathered copy (B MiB a product at
    d = f = 512 in fp32), and sums the rows' weight grads per language."""

    @staticmethod
    def forward(ctx, x, w, lang):
        ctx.save_for_backward(x, w, lang)
        return torch.bmm(x, w[lang].to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, w, lang = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dy, w[lang].to(dy.dtype).transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = torch.zeros_like(w).index_add_(
                0, lang, torch.bmm(x.transpose(1, 2), dy).to(w.dtype))
        return dx, dw, None


def lang_matmul(x, w, lang):
    """Per-row language projection: x [B, ..., d] times w[lang] [B, d, f]
    (the JAX package's einsum("b...d,bdf->b...f", x, w[lang]))."""
    shape = x.shape
    y = _LangMatmul.apply(x.reshape(shape[0], -1, shape[-1]), w,
                          lang.long())
    return y.reshape(shape[:-1] + (w.shape[-1],))


# -- language-aware layer norm ------------------------------------------------

class LangLayerNorm(torch.nn.Module):
    """Per-language ``scale`` and ``offset``, [num_languages, size]."""

    def __init__(self, num_languages: int, size: int):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(num_languages, size))
        self.offset = torch.nn.Parameter(torch.zeros(num_languages, size))


def init_lang_ln(num_languages: int, size: int) -> LangLayerNorm:
    return LangLayerNorm(num_languages, size)


def lang_layer_norm(params: LangLayerNorm, x, lang, eps: float = 1e-8):
    """LayerNorm with per-language scale/offset (statistics in fp32);
    lang: [B] int."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    lang = lang.long()
    scale = params.scale[lang].float()
    offset = params.offset[lang].float()
    while scale.dim() < x.dim():
        scale = scale[:, None]
        offset = offset[:, None]
    return (scale * normed + offset).to(x.dtype)


# -- model --------------------------------------------------------------------

def init_dec_layer(gen, cfg, layer):
    init = common.layer_initializer(cfg, layer)
    h = cfg.hidden_size
    nl = cfg.num_languages
    return common.Layer({
        "self": attention.init_attention(gen, h, h, self_attention=True,
                                         weight_init=init),
        "ln1": init_lang_ln(nl, h),
        "cross": attention.init_attention(gen, h, h, self_attention=False,
                                          d_memory=h, weight_init=init),
        "ln2": init_lang_ln(nl, h),
        "ffn": nn.init_ffn(gen, h, cfg.filter_size, h, weight_init=init),
        "ln3": init_lang_ln(nl, h),
    })


def init_fn(gen, cfg) -> common.Seq2Seq:
    tables = common.init_embeddings(gen, cfg)
    encoder = [base.init_enc_layer(gen, cfg, l)
               for l in range(cfg.num_encoder_layer)]
    decoder = [init_dec_layer(gen, cfg, l)
               for l in range(cfg.num_decoder_layer)]
    # LaLT: identity-initialised, so early training matches the shared
    # model
    tables["lalt"] = torch.eye(cfg.embed_size)[None].repeat(
        cfg.num_languages, 1, 1)
    return common.Seq2Seq(tables, encoder, decoder)


def _encode(params, source, cfg, rngs, training):
    mask = (source != 0).float()
    src_table, _, _ = common.emb_tables(params, cfg)
    x = common.embed_scaled(src_table, source, params.emb_bias, cfg,
                            torch.float32)
    x = common.seq_inputs(x, rngs(), cfg.dropout if training else None)
    keep = nn.masking_mask(mask)
    for p in params.encoder:
        x = base.enc_layer(p, x, keep, cfg, rngs)
    return {"encodes": common.gather_encodes(x), "mask": mask,
            "lang": lang_from_source(source, cfg)}


def _dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs, lang):
    y = attention.attn_train(p.self, x, None, self_keep, cfg.num_heads,
                             rng=rngs(), drop=cfg.attention_dropout,
                             causal=True)["output"]
    x = lang_layer_norm(p.ln1, nn.residual_fn(x, y, rngs(),
                                              cfg.residual_dropout), lang)
    y = attention.attn_train(p.cross, x, state["encodes"], mem_keep,
                             cfg.num_heads, rng=rngs(),
                             drop=cfg.attention_dropout)["output"]
    x = lang_layer_norm(p.ln2, nn.residual_fn(x, y, rngs(),
                                              cfg.residual_dropout), lang)
    y = nn.ffn(p.ffn, x, rngs(), cfg.relu_dropout)
    return lang_layer_norm(p.ln3, nn.residual_fn(x, y, rngs(),
                                                 cfg.residual_dropout), lang)


def _lalt(params, x, lang):
    """LaLT. Under tensor parallelism ``lalt`` holds a process's columns
    of every language's projection: they are gathered whole before the
    vocab-parallel cross entropy."""
    tag = tp.leaf_part(params, "lalt")
    if tag is None:
        return lang_matmul(x, params.lalt, lang)
    axis = tag[0].axis
    return dist.gather_cols(lang_matmul(dist.copy_in(x, axis), params.lalt,
                                        lang), axis)


def _decode_train(params, target, state, cfg, rngs, training):
    mask = common.seq_block((target != 0).float())
    _, tgt_table, soft_table = common.emb_tables(params, cfg)
    x = common.embed_scaled(tgt_table, target, params.emb_bias, cfg,
                            torch.float32)
    x = common.seq_inputs(common.shift_right(x), rngs(),
                          cfg.dropout if training else None)
    lang = state["lang"]
    self_keep = nn.causal_mask(target.shape[1], device=target.device)
    mem_keep = nn.masking_mask(state["mask"])
    for p in params.decoder:
        x = _dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs,
                             lang)
    return _lalt(params, x, lang), soft_table, mask


def train_fn(params, features, cfg, gen, step=0):
    common.check_ported(cfg)
    features = common.seq_padded(features)
    rngs = RngGen(gen)
    state = _encode(params, features["source"], cfg, rngs, True)
    feat, soft_table, mask = _decode_train(params, features["target"], state,
                                           cfg, rngs, True)
    loss, _ = common.ce_from_feature(feat, soft_table,
                                     common.seq_block(features["target"]),
                                     mask, cfg, cfg.label_smooth)
    return {"loss": loss}


def score_fn(params, features, cfg):
    rngs = RngGen(None)
    state = _encode(params, features["source"], cfg, rngs, False)
    feat, soft_table, mask = _decode_train(params, features["target"], state,
                                           cfg, rngs, False)
    _, per_sample = common.ce_from_feature(feat, soft_table,
                                           features["target"], mask, cfg, 0.0)
    return {"score": per_sample}


def init_lang_cache(state, batch):
    """Per-beam copies of the language ids (the queries are per beam, the
    memory is not)."""
    lang = state["lang"]
    return lang.repeat_interleave(batch // lang.shape[0], dim=0)


def infer_fn(cfg):
    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False)
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
        lang = cache["lang"]
        new_caches = []
        for p, lstate, lcache in zip(params.decoder, state["layers"],
                                     cache["layers"]):
            y, new_c = attention.self_attn_step(p.self, x, lcache, time,
                                                cfg.num_heads,
                                                use_flash=cfg.use_flash_decode)
            x = lang_layer_norm(p.ln1, x + y, lang)
            y = attention.cross_attn_step(p.cross, x, lstate, state["mask"],
                                          cfg.num_heads)
            x = lang_layer_norm(p.ln2, x + y, lang)
            y = nn.ffn(p.ffn, x)
            x = lang_layer_norm(p.ln3, x + y, lang)
            new_caches.append(new_c)
        x = _lalt(params, x, lang)
        logits = common.output_logits(x[:, 0], soft_table)
        return logits, {"lang": lang, "layers": new_caches}

    def decode_prefix(params, tgt_buffer, state, time):
        feat, soft_table, _ = _decode_train(params, tgt_buffer, state, cfg,
                                            RngGen(None), False)
        return common.output_logits(feat[:, time], soft_table)

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step, decode_prefix=decode_prefix)


model_register("transformer_multilingual", init_fn, train_fn, score_fn,
               infer_fn, eval_cast=False)
