"""Shared transformer-family skeleton: embeddings, encoder/decoder stacks,
the loss, and the static-cache inference API.

Counterpart of ``zero_tpu/models/common.py``. Variants supply a
``LayerHooks`` bundle and share one skeleton. Semantics kept:
  * embeddings scaled by sqrt(hidden) plus one bias shared between source
    and target sides
  * decoder-input shift-right after the bias add, so position 0's input is
    the zero vector + timing signal
  * sharing flags: shared_source_target_embedding ties all three tables;
    shared_target_softmax_embedding ties softmax to target
  * logits of the tied softmax in the compute dtype, returned as fp32
  * label-smoothed CE minus normalizer, per-sentence mean then batch mean,
    in fp32, over chunks of ``loss_chunk_tokens`` positions whose logits
    are recomputed in the backward (``chunked_tied_ce``)
  * fp32 master parameters: the loss casts them to the compute dtype with
    a differentiable cast, so the gradients reach the fp32 parameters

``scan_layers`` and ``use_remat`` are a later slice: both raise.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from zero_tpu_torch import dtypes
from zero_tpu_torch.models.base import Inference
from zero_tpu_torch.ops import common as ops_common
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout


class LayerHooks(NamedTuple):
    """Per-variant layer constructors/applications. Training hooks take a
    dropout-seed source ``rngs`` (RngGen); decode hooks are dropout-free."""
    init_enc_layer: Callable  # (gen, cfg, layer) -> module
    enc_layer: Callable       # (p, x, src_keep, cfg, rngs) -> x
    init_dec_layer: Callable  # (gen, cfg, layer) -> module
    # self_keep: the causal keep-mask, or a callable building it
    dec_layer_train: Callable  # (p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask) -> x
    dec_layer_precompute: Callable  # (p, encodes, cfg) -> layer_state
    init_dec_layer_cache: Callable  # (p, batch, max_len, cfg, dtype, device) -> cache
    dec_layer_step: Callable  # (p, x_t, layer_state, state, cache, time, cfg) -> (x_t, cache)
    # False for variants whose decode self-attention the pool kernel cannot
    # serve (RPR's relative-position tables): on the card they keep the
    # classic permuted cache instead of the ancestry pools
    pool_kernel: bool = True


class Layer(torch.nn.Module):
    """A named group of sub-modules (one transformer layer: 'self', 'ln1',
    'cross', 'ffn', ...)."""

    def __init__(self, parts: dict):
        super().__init__()
        for name, part in parts.items():
            self.add_module(name, part)


class Seq2Seq(torch.nn.Module):
    """Parameters of a transformer-family model. State-dict keys are the
    JAX param paths with '/' turned into '.': ``embedding``, ``emb_bias``,
    ``encoder.<l>....``, ``decoder.<l>....``."""

    def __init__(self, tables: dict, encoder, decoder):
        super().__init__()
        for name, t in tables.items():
            self.register_parameter(name, torch.nn.Parameter(t))
        self.encoder = torch.nn.ModuleList(encoder)
        self.decoder = torch.nn.ModuleList(decoder)

    def forward(self, fn):
        """fn(self): lets torch.func.functional_call run a function of the
        module on substituted (compute-dtype) parameters."""
        return fn(self)


def config_initializer(cfg):
    return inits.get_initializer(cfg.initializer, cfg.initializer_gain)


def layer_initializer(cfg, layer: int):
    """Depth-scaled per-layer initializer when deep_transformer_init is
    on, else the config initializer."""
    if cfg.deep_transformer_init:
        return inits.depth_scaled(layer, cfg.initializer_gain)
    return config_initializer(cfg)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embeddings(gen, cfg) -> dict:
    """Embedding tables per the sharing flags + the shared scale bias."""
    emb_init = inits.normal(cfg.hidden_size ** -0.5)
    tables = {}
    src_vocab = cfg.src_vocab.size()
    tgt_vocab = cfg.tgt_vocab.size()
    if cfg.shared_source_target_embedding:
        tables["embedding"] = emb_init(gen, (src_vocab, cfg.embed_size))
    else:
        tables["src_embedding"] = emb_init(gen, (src_vocab, cfg.embed_size))
        tables["tgt_embedding"] = emb_init(gen, (tgt_vocab, cfg.embed_size))
        if not cfg.shared_target_softmax_embedding:
            tables["softmax_embedding"] = emb_init(
                gen, (tgt_vocab, cfg.embed_size))
    tables["emb_bias"] = config_initializer(cfg)(gen, (cfg.embed_size,))
    return tables


def emb_tables(params: Seq2Seq, cfg):
    """Resolve (src, tgt, softmax) tables under the sharing flags."""
    if cfg.shared_source_target_embedding:
        e = params.embedding
        return e, e, e
    src = params.src_embedding
    tgt = params.tgt_embedding
    soft = (tgt if cfg.shared_target_softmax_embedding
            else params.softmax_embedding)
    return src, tgt, soft


def embed_scaled(table, ids, bias, cfg, dtype):
    """gather(emb) * sqrt(hidden) + bias."""
    x = torch.nn.functional.embedding(ids.long(), table).to(dtype)
    x = x * (cfg.hidden_size ** 0.5)
    return x + bias.to(dtype)


def shift_right(x):
    """Prepend a zero vector and drop the last position (applied post-bias,
    so the zero survives)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]


def output_logits(feature, softmax_table):
    """Weight-tied softmax logits: product in the compute dtype, then fp32."""
    logits = torch.matmul(feature, softmax_table.to(feature.dtype).t())
    return logits.float()


def _chunk_ce(xc, lc, table, factor):
    return ops_common.smoothed_centropy_reduced(output_logits(xc, table), lc,
                                                factor)


def chunked_tied_ce(feature, soft_table, labels, factor, chunk_tokens):
    """Per-position label-smoothed CE without keeping the full logits: the
    [B*L, V] positions run in ``chunk_tokens``-row chunks, and under
    autograd each chunk is checkpointed, so the backward recomputes its
    logits instead of storing them. Per-position math is that of
    smoothed_centropy(output_logits(...)). feature: [B, L, d]; returns
    centropy [B, L] fp32."""
    b, l, d = feature.shape
    n = b * l
    xf = feature.reshape(n, d)
    lf = labels.reshape(n).long()
    chunk = max(1, min(int(chunk_tokens), n))
    pad = (-n) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
        lf = torch.cat([lf, lf.new_zeros((pad,))])
    grad = torch.is_grad_enabled()
    cents = []
    for c0 in range(0, n + pad, chunk):
        args = (xf[c0:c0 + chunk], lf[c0:c0 + chunk], soft_table, factor)
        cents.append(checkpoint(_chunk_ce, *args, use_reentrant=False)
                     if grad else _chunk_ce(*args))
    return torch.cat(cents)[:n].reshape(b, l)


def ce_from_feature(feature, soft_table, labels, mask, cfg, factor):
    """Tied-softmax label-smoothed CE from decoder features: chunked when
    cfg.loss_chunk_tokens > 0, full logits otherwise. Returns (scalar loss,
    per-sentence [B])."""
    chunk = int(getattr(cfg, "loss_chunk_tokens", 0) or 0)
    if chunk > 0:
        return ops_common.sentence_mean_loss(
            chunked_tied_ce(feature, soft_table, labels, factor, chunk),
            mask)
    return ops_common.label_smooth_loss(output_logits(feature, soft_table),
                                        labels, mask, factor)


def check_ported(cfg):
    """Raise on training options of a later slice instead of ignoring
    them."""
    for key in ("scan_layers", "use_remat"):
        if bool(getattr(cfg, key, False)):
            raise NotImplementedError(
                "%s=true is not ported to zero_tpu_torch yet: it comes with "
                "a later slice" % key)


# ---------------------------------------------------------------------------
# skeleton model
# ---------------------------------------------------------------------------

def make_transformer(hooks: LayerHooks):
    """Build (init_fn, train_fn, score_fn, infer_fn) from layer hooks."""

    def init_fn(gen, cfg) -> Seq2Seq:
        return Seq2Seq(
            init_embeddings(gen, cfg),
            [hooks.init_enc_layer(gen, cfg, l)
             for l in range(cfg.num_encoder_layer)],
            [hooks.init_dec_layer(gen, cfg, l)
             for l in range(cfg.num_decoder_layer)])

    def _encode(params, source, cfg, rngs, dtype, training):
        mask = (source != 0).to(dtype)
        src_table, _, _ = emb_tables(params, cfg)
        x = embed_scaled(src_table, source, params.emb_bias, cfg, dtype)
        x = nn.add_timing_signal(x)
        x = dropout(rngs(), x, cfg.dropout if training else None)
        src_keep = nn.masking_mask(mask)
        for p in params.encoder:
            x = hooks.enc_layer(p, x, src_keep, cfg, rngs)
        return {"encodes": x, "mask": mask}

    def _decode_train(params, target, state, cfg, rngs, dtype, training):
        mask = (target != 0).to(dtype)
        _, tgt_table, soft_table = emb_tables(params, cfg)
        x = embed_scaled(tgt_table, target, params.emb_bias, cfg, dtype)
        x = shift_right(x)
        x = nn.add_timing_signal(x)
        x = dropout(rngs(), x, cfg.dropout if training else None)
        # built on first use, by a layer on the composite path: a layer
        # whose self-attention takes a kernel needs only the causal flag,
        # and an [L, L] fp32 mask is 1 GiB at L = 16384
        self_keep = functools.cache(functools.partial(
            nn.causal_mask, target.shape[1], device=target.device))
        mem_keep = nn.masking_mask(state["mask"])
        for p in params.decoder:
            x = hooks.dec_layer_train(p, x, state, self_keep, mem_keep, cfg,
                                      rngs, mask)
        return x, soft_table, mask

    def _loss(params, features, cfg, gen, training, label_smooth):
        """Cast the fp32 parameters to the compute dtype (differentiably),
        encode, decode, CE. Returns (scalar loss, per-sentence [B])."""
        check_ported(cfg)
        dtype = dtypes.compute_dtype(cfg)

        def body(cparams):
            rngs = RngGen(gen if training else None)
            state = _encode(cparams, features["source"], cfg, rngs, dtype,
                            training)
            feature, soft_table, mask = _decode_train(
                cparams, features["target"], state, cfg, rngs, dtype,
                training)
            return ce_from_feature(feature, soft_table, features["target"],
                                   mask, cfg, label_smooth)

        cast = {name: p.to(dtype) for name, p in params.named_parameters()}
        return torch.func.functional_call(params, cast, (body,))

    def train_fn(params, features, cfg, gen, step=0):
        loss, _ = _loss(params, features, cfg, gen, True, cfg.label_smooth)
        return {"loss": loss}

    def score_fn(params, features, cfg):
        # dropout off, label smoothing off
        _, per_sample = _loss(params, features, cfg, None, False, 0.0)
        return {"score": per_sample}

    def infer_fn(cfg):
        dtype = dtypes.compute_dtype(cfg)

        def encode(params, source):
            state = _encode(params, source, cfg, RngGen(None), dtype, False)
            # per-layer beam-invariant decode state (cross mk/mv)
            state["layers"] = [
                hooks.dec_layer_precompute(p, state["encodes"], cfg)
                for p in params.decoder]
            return state

        def _use_ancestry(beams, device):
            """Ancestry-indexed pools for beam decode. On the card they pay
            off only where the pool kernel runs (hooks.pool_kernel and
            use_flash_decode); elsewhere the classic permuted cache runs.
            The CPU takes them for every beam > 1, as the JAX package does
            off the TPU, so the tests exercise them; decode_ancestry on/off
            overrides for A/B measurement."""
            if beams <= 1:
                return False
            mode = str(getattr(cfg, "decode_ancestry", "auto"))
            if mode in ("on", "off"):
                return mode == "on"
            if device.type != "cuda":
                return True
            return bool(hooks.pool_kernel and cfg.use_flash_decode)

        def init_cache(params, state, batch, max_len):
            # ancestry[b, i, t] = pool row whose position-t KV belongs to
            # live beam i; beam count inferred from the beam-invariant
            # encoder state (batch = B * K). All-zeros start: every beam
            # descends from slot 0, matching the init_log_probs tie-break.
            device = state["mask"].device
            beams = max(batch // state["mask"].shape[0], 1)
            cache = {"layers": [
                hooks.init_dec_layer_cache(p, batch, max_len, cfg, dtype,
                                           device)
                for p in params.decoder]}
            if _use_ancestry(beams, device):
                cache["ancestry"] = torch.zeros(
                    (batch // beams, beams, max_len), dtype=torch.int32,
                    device=device)
            return cache

        def _embed_step(params, prev_tok, time):
            _, tgt_table, _ = emb_tables(params, cfg)
            x = embed_scaled(tgt_table, prev_tok, params.emb_bias, cfg, dtype)
            if time == 0:
                # position 0's input is the zero vector (shift-right)
                x = torch.zeros_like(x)
            return nn.add_timing_signal(x, time=time)

        def decode_step(params, prev_tok, state, cache, time):
            _, _, soft_table = emb_tables(params, cfg)
            x = _embed_step(params, prev_tok, time)
            anc = cache.get("ancestry")
            new_layer_caches = []
            for p, lstate, lcache in zip(params.decoder, state["layers"],
                                         cache["layers"]):
                if anc is not None:
                    lcache = dict(lcache, ancestry=anc)
                x, new_c = hooks.dec_layer_step(p, x, lstate, state, lcache,
                                                time, cfg)
                new_c.pop("ancestry", None)
                new_layer_caches.append(new_c)
            logits = output_logits(x[:, 0], soft_table)
            out_cache = {"layers": new_layer_caches}
            if anc is not None:
                out_cache["ancestry"] = anc
            return logits, out_cache

        def reorder_cache(cache, beam_indices, batch, beam_size, time,
                          span=1):
            """Beam-reorder the cache WITHOUT copying the KV pools.

            The just-written positions [time, time+span) sit in each
            beam's own row: record that as identity ancestry, then permute
            the [B, K, T] index by the surviving-beam indices. Every other
            tensor gets the plain beam gather."""
            if "ancestry" not in cache:
                # classic mode: permute every tensor, pools included
                return {"layers": [
                    {k: ops_common.gather_beams(v, beam_indices, batch,
                                                beam_size)
                     for k, v in lc.items()} for lc in cache["layers"]]}
            anc = cache["ancestry"]
            anc[:, :, time:time + span] = torch.arange(
                beam_size, dtype=anc.dtype, device=anc.device)[None, :, None]
            anc = torch.take_along_dim(anc, beam_indices[:, :, None].long(),
                                       dim=1)
            new_layers = [
                {k: (v if k.startswith("pool_")
                     else ops_common.gather_beams(v, beam_indices, batch,
                                                  beam_size))
                 for k, v in lc.items()} for lc in cache["layers"]]
            return {"layers": new_layers, "ancestry": anc}

        def decode_prefix(params, tgt_buffer, state, time):
            """Dev-mode oracle: full causal recompute over the [B, T_max]
            buffer; positions > time are garbage but causally invisible."""
            _, tgt_table, soft_table = emb_tables(params, cfg)
            x = embed_scaled(tgt_table, tgt_buffer, params.emb_bias, cfg,
                             dtype)
            x = shift_right(x)
            x = nn.add_timing_signal(x)
            self_keep = nn.causal_mask(tgt_buffer.shape[1],
                                       device=tgt_buffer.device)
            mem_keep = nn.masking_mask(state["mask"])
            mask = torch.ones_like(tgt_buffer).to(dtype)
            for p in params.decoder:
                x = hooks.dec_layer_train(p, x, state, self_keep, mem_keep,
                                          cfg, RngGen(None), mask)
            return output_logits(x[:, time], soft_table)

        return Inference(encode=encode, init_cache=init_cache,
                         decode_step=decode_step, decode_prefix=decode_prefix,
                         reorder_cache=reorder_cache)

    return init_fn, train_fn, score_fn, infer_fn
