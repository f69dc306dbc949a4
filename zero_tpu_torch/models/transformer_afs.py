"""Transformer-AFS: end-to-end speech translation with adaptive feature
selection and (coarse-label) CTC regularisation.

Counterpart of ``zero_tpu/models/transformer_afs.py``:
  * frontend: log-mel frames cast to the compute dtype, optional k-frame
    stacking (``audio_frame_stride``; the last t mod k frames dropped, the
    mask the max over each group), linear to hidden + sinusoidal positions
  * ASR encoder: num_encoder_layer transformer layers
  * AFS: hard-concrete gates pruning the ASR outputs in time
    (input-dependent log-alpha, computed in fp32; ``afs_mode='t'``) and
    per feature (a global log-alpha vector, ``afs_mode='tf'``); the
    expected-L0 penalties, weighted by ``afs_l0_scalar``, ramp up as
    L0Drop's. Training attends only to the surviving frames; evaluation
    uses the mean gates with the dropped frames zeroed and, with
    ``l0_compact_ratio > 0``, compacts them before the ST encoder
    (transformer_l0drop.compact_encodings), which puts ``count`` into the
    state: cross attention then takes the count softmax on the composite
  * ``st_context``: the previous segment runs through the same frontend,
    ASR encoder and gates, and its features are prepended (no CTC or
    penalty from it)
  * ST encoder: num_st_encoder_layer transformer layers over the gated
    features; decoder: transformer's, static caches
  * CTC head on the ASR encoder output (``ctc_enable``, ``ctc_alpha``;
    labels are the transcript ids, folded into a coarse space by the
    dataset under CoLaCTC, ``coarse_label_base``), the loss of ops/ctc.py
    in fp32

The layers are transformer's, so ``use_flash_attention`` routes the
encoders' and the decoder's attention to the fused kernels and
``use_flash_decode`` the decode self-attention to #10 (the search gathers
the classic cache). The gate noise comes from a dropout site's seed words
(ops/l0norm.py). Its own init_fn, as in the JAX package, so ``use_remat``
and ``scan_layers`` are ignored.
"""

from __future__ import annotations

import functools

import torch

from zero_tpu_torch import dtypes
from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.models.transformer_l0drop import compact_encodings
from zero_tpu_torch.ops import common as ops_common
from zero_tpu_torch.ops import ctc, l0norm, nn
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import tensor as tp


def _ctc_vocab_size(cfg) -> int:
    if cfg.coarse_label_base > 0:
        return cfg.coarse_label_base + 3  # specials pass through
    return cfg.src_vocab.size()


def init_fn(gen, cfg) -> common.Seq2Seq:
    """The JAX paths: ``frontend``, ``asr_encoder.<l>``, ``st_encoder.<l>``,
    ``decoder.<l>``, ``afs_temporal``, ``afs_feature`` (mode tf),
    ``tgt_embedding``, ``softmax_embedding`` (unshared), ``emb_bias`` and
    ``ctc_head`` (ctc_enable); the skeleton's ``encoder`` stays empty."""
    init = common.config_initializer(cfg)
    h = cfg.hidden_size
    k = max(int(cfg.audio_frame_stride), 1)
    modules = {
        "frontend": nn.init_linear(gen, cfg.audio_num_mel_bins * k, h,
                                   weight_init=init),
        "asr_encoder": torch.nn.ModuleList(
            [base.init_enc_layer(gen, cfg, l)
             for l in range(cfg.num_encoder_layer)]),
        "st_encoder": torch.nn.ModuleList(
            [base.init_enc_layer(gen, cfg, l)
             for l in range(cfg.num_st_encoder_layer)]),
        "afs_temporal": nn.init_linear(gen, h, 1, weight_init=init),
    }
    decoder = [base.init_dec_layer(gen, cfg, l)
               for l in range(cfg.num_decoder_layer)]
    tables = {}
    if cfg.afs_mode == "tf":
        tables["afs_feature"] = torch.zeros(h)
    tgt_vocab = cfg.tgt_vocab.size()
    tables["tgt_embedding"] = init(gen, (tgt_vocab, cfg.embed_size))
    if not cfg.shared_target_softmax_embedding:
        tables["softmax_embedding"] = init(gen, (tgt_vocab, cfg.embed_size))
    tables["emb_bias"] = init(gen, (cfg.embed_size,))
    if cfg.ctc_enable:
        modules["ctc_head"] = nn.init_linear(gen, h, _ctc_vocab_size(cfg),
                                             weight_init=init)
    return common.Seq2Seq(tables, [], decoder, modules)


def _tgt_table(params):
    """The target table, or its VocabPart where split."""
    return tp.table(params, "tgt_embedding", params.tgt_embedding)


def _soft_table(params, cfg):
    if cfg.shared_target_softmax_embedding:
        return _tgt_table(params)
    return tp.table(params, "softmax_embedding", params.softmax_embedding)


def _frontend(params, audio, mask, cfg, rngs, training):
    """Frame-stack, project, add positions. Returns (x [B, T', h], mask')."""
    audio = audio.to(dtypes.compute_dtype(cfg))
    k = max(int(cfg.audio_frame_stride), 1)
    b, t, m = audio.shape
    if k > 1:
        t2 = t // k
        audio = audio[:, :t2 * k].reshape(b, t2, m * k)
        mask = mask[:, :t2 * k].reshape(b, t2, k).amax(dim=-1)
    x = nn.linear(params.frontend, audio)
    if cfg.sinusoid_posenc:
        x = nn.add_timing_signal(x)
    x = dropout(rngs(), x, cfg.dropout if training else None)
    return x, mask


def _encode_stack(layers, x, mask, cfg, rngs):
    keep = nn.masking_mask(mask)
    for p in layers:
        x = base.enc_layer(p, x, keep, cfg, rngs)
    return x


def _afs_gate(params, x, mask, cfg, rngs, training):
    """Apply the temporal (and feature) hard-concrete gates. Returns
    (gated features, new mask, penalty scalar, keep_score): in training
    the mask of the surviving frames and keep_score None; at eval the
    dropped frames zeroed, the mask unchanged and the gates' keep_score."""
    log_alpha_t = nn.linear(params.afs_temporal, x).float()
    maskf = mask.float()
    penalty = torch.zeros((), dtype=torch.float32, device=x.device)

    if training:
        g_t = l0norm.hard_concrete_sample(rngs(), log_alpha_t)
        pen_t = l0norm.l0_norm(log_alpha_t)[..., 0]
        pen_t = (pen_t * maskf).sum(dim=-1) / torch.clamp(
            maskf.sum(dim=-1), min=1.0)
        valid = (maskf.sum(dim=-1) > 0).float()
        penalty = penalty + ops_common.masked_mean(pen_t, valid)
    else:
        g_t = l0norm.hard_concrete_mean(log_alpha_t)

    x = x * g_t.to(x.dtype)

    if cfg.afs_mode == "tf" and hasattr(params, "afs_feature"):
        log_alpha_f = params.afs_feature.float()
        if training:
            # one gate a feature, no batch row: the same noise and the
            # same penalty on every process, as a replicated JAX array
            with ops_common.replicated_draws():
                g_f = l0norm.hard_concrete_sample(rngs(), log_alpha_f)
            penalty = penalty + ops_common.shared_term(
                l0norm.l0_norm(log_alpha_f).mean())
        else:
            g_f = l0norm.hard_concrete_mean(log_alpha_f)
        x = x * g_f.to(x.dtype)[None, None, :]

    if training:
        # attend only to the surviving frames (L0Drop's rule)
        new_mask = (g_t[..., 0] > 0).to(mask.dtype) * mask
        keep_score = None
    else:
        # the zero-vector equivalence; the mask unchanged
        x = x * ((g_t[..., 0] > 0).to(x.dtype)
                 * maskf.to(x.dtype))[..., None]
        new_mask = mask
        keep_score = g_t[..., 0].float() * maskf
    return x, new_mask, penalty, keep_score


def _encode(params, audio, mask, cfg, rngs, training, context=None,
            context_mask=None):
    x, mask = _frontend(params, audio, mask, cfg, rngs, training)
    asr_out = _encode_stack(params.asr_encoder, x, mask, cfg, rngs)
    gated, st_mask, penalty, keep_score = _afs_gate(params, asr_out, mask,
                                                   cfg, rngs, training)
    if cfg.st_context and context is not None:
        # context-aware ST: the previous segment through the shared
        # frontend/ASR/AFS stack, its reduced features prepended; no CTC
        # or penalty from it
        cx, cmask = _frontend(params, context, context_mask, cfg, rngs,
                              training)
        c_asr = _encode_stack(params.asr_encoder, cx, cmask, cfg, rngs)
        c_gated, c_st_mask, _, c_score = _afs_gate(params, c_asr, cmask, cfg,
                                                  rngs, training)
        gated = torch.cat([c_gated, gated], dim=1)
        st_mask = torch.cat([c_st_mask, st_mask], dim=1)
        if keep_score is not None:
            keep_score = torch.cat([c_score, keep_score], dim=1)

    count = None
    if not training and cfg.l0_compact_ratio > 0:
        # static-k compaction BEFORE the ST encoder: a shorter ST encoder
        # and decoder memory
        gated, st_mask, count = compact_encodings(
            gated, st_mask, keep_score, cfg.l0_compact_ratio)

    encodes = _encode_stack(params.st_encoder, gated, st_mask, cfg, rngs)
    state = {"encodes": encodes, "mask": st_mask, "asr_out": asr_out,
             "asr_mask": mask, "afs_penalty": penalty}
    if count is not None:
        state["count"] = count
    return state


def _decode_train(params, target, state, cfg, rngs, training):
    dmask = (target != 0).float()
    x = common.embed_scaled(_tgt_table(params), target, params.emb_bias,
                            cfg, dtypes.compute_dtype(cfg))
    x = nn.add_timing_signal(common.shift_right(x))
    x = dropout(rngs(), x, cfg.dropout if training else None)
    # built on first use, by a layer on the composite path
    self_keep = functools.cache(functools.partial(
        nn.causal_mask, target.shape[1], device=target.device))
    mem_keep = nn.masking_mask(state["mask"])
    for p in params.decoder:
        x = base.dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs,
                                 dmask)
    return x, dmask


def _ctc_loss(params, state, transcript, cfg):
    """CTC regularisation over the ASR encoder output: the per-sequence
    loss over its label length, averaged over the rows with a label (a
    row without one contributes 0, by selection)."""
    logits = nn.linear(params.ctc_head, state["asr_out"]).float()
    logit_pad = 1.0 - state["asr_mask"].float()
    label_pad = (transcript == 0).float()
    per_seq = ctc.ctc_loss(logits, logit_pad, transcript, label_pad,
                           blank_id=0)
    label_len = (1.0 - label_pad).sum(dim=-1)
    valid = label_len > 0
    per_seq = torch.where(valid, per_seq / torch.clamp(label_len, min=1.0),
                          torch.zeros_like(per_seq))
    return ops_common.masked_mean(per_seq, valid.float())


def _features_state(params, features, cfg, rngs, training):
    return _encode(params, features["audio"], features["audio_mask"], cfg,
                   rngs, training, context=features.get("context"),
                   context_mask=features.get("context_mask"))


def train_fn(params, features, cfg, gen, step=0):
    """features: 'audio' [B, T, mels], 'audio_mask' [B, T], 'target',
    optionally 'transcript' (CTC) and 'context'/'context_mask'."""
    common.check_ported(cfg)

    def body(cparams):
        rngs = RngGen(gen)
        state = _features_state(cparams, features, cfg, rngs, True)
        feat, dmask = _decode_train(cparams, features["target"], state, cfg,
                                    rngs, True)
        loss, _ = common.ce_from_feature(feat, _soft_table(cparams, cfg),
                                         features["target"], dmask, cfg,
                                         cfg.label_smooth)
        loss = loss + l0norm.l0_regularization_loss(
            state["afs_penalty"], step, reg_scalar=cfg.afs_l0_scalar,
            start_reg_ramp_up=cfg.l0_norm_start_reg_ramp_up,
            end_reg_ramp_up=cfg.l0_norm_end_reg_ramp_up,
            warm_up=cfg.l0_norm_warm_up)
        if cfg.ctc_enable and "transcript" in features:
            loss = loss + cfg.ctc_alpha * _ctc_loss(
                cparams, state, features["transcript"], cfg)
        return loss

    return {"loss": common.compute_call(params, dtypes.compute_dtype(cfg),
                                        body)}


def score_fn(params, features, cfg):
    def body(cparams):
        rngs = RngGen(None)
        state = _features_state(cparams, features, cfg, rngs, False)
        feat, dmask = _decode_train(cparams, features["target"], state, cfg,
                                    rngs, False)
        _, per_sample = common.ce_from_feature(
            feat, _soft_table(cparams, cfg), features["target"], dmask, cfg,
            0.0)
        return per_sample

    return {"score": common.compute_call(params, dtypes.compute_dtype(cfg),
                                         body)}


def infer_fn(cfg):
    dtype = dtypes.compute_dtype(cfg)

    def encode(params, source):
        """source: {'audio', 'mask'[, 'context', 'context_mask']}."""
        state = _encode(params, source["audio"], source["mask"], cfg,
                        RngGen(None), False, context=source.get("context"),
                        context_mask=source.get("context_mask"))
        for key in ("asr_out", "asr_mask", "afs_penalty"):
            state.pop(key)
        state["layers"] = [base.dec_layer_precompute(p, state["encodes"], cfg)
                           for p in params.decoder]
        return state

    def init_cache(params, state, batch, max_len):
        device = state["mask"].device
        return {"layers": [base.init_dec_layer_cache(p, batch, max_len, cfg,
                                                     dtype, device)
                           for p in params.decoder]}

    def decode_step(params, prev_tok, state, cache, time):
        x = common.embed_scaled(_tgt_table(params), prev_tok,
                                params.emb_bias, cfg, dtype)
        if time == 0:
            x = torch.zeros_like(x)
        x = nn.add_timing_signal(x, time=time)
        new_caches = []
        for p, lstate, lcache in zip(params.decoder, state["layers"],
                                     cache["layers"]):
            x, new_c = base.dec_layer_step(p, x, lstate, state, lcache, time,
                                           cfg)
            new_caches.append(new_c)
        logits = common.output_logits(x[:, 0], _soft_table(params, cfg))
        return logits, {"layers": new_caches}

    def decode_prefix(params, tgt_buffer, state, time):
        feat, _ = _decode_train(params, tgt_buffer, state, cfg, RngGen(None),
                                False)
        return common.output_logits(feat[:, time], _soft_table(params, cfg))

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step, decode_prefix=decode_prefix)


model_register("transformer_afs", init_fn, train_fn, score_fn, infer_fn)
