"""Interleaved bidirectional Transformer decoder (IBDecoder).

Counterpart of ``zero_tpu/models/transformer_ibdecoder.py``: the target's
left-to-right and right-to-left streams are interleaved,
  z = [y1, yN, y2, yN-1, ...]
each stream closed by its own eos, so a standard decoder emits TWO tokens
per step, one per direction. Both members of pair i carry stream position
i plus a direction embedding (``dir_embedding`` [2, E]); the decoder input
is shifted by one pair (pair i sees pair i-1) under the pair-granular mask
q//2 <= p//2; the loss is the label-smoothed CE over the z positions.
Decoding runs the pair beam search (search.py:ib_beam_search) and
``unfold`` reassembles y = l2r + reversed(r2l) on the host.

As in the JAX package:
  * its own init_fn, so ``use_remat`` and ``scan_layers`` are ignored;
  * the positions are added in fp32, which promotes the decoder to fp32
    under a bf16 compute dtype (the encoder stays in the compute dtype;
    attention promotes the bf16 memory and cache, ops/attention.py);
  * the decoder layers are transformer's, which declare the causal flag:
    with ``use_flash_attention`` the self-attention takes the fused
    kernels under the token-causal flag and the pair mask is dropped, so
    the l2r slot of a pair does not see the r2l slot in training and
    scoring, while the cached pair step lets both slots see each other.
    Only with the flag off does the cache decode equal ``decode_prefix``;
  * the cached pair step attends over two positions, which the decode
    kernels do not take: it stays on the composite.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from zero_tpu_torch import dtypes
from zero_tpu_torch.models import common
from zero_tpu_torch.models import transformer as base
from zero_tpu_torch.models.base import model_register
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import tensor as tp


# ---------------------------------------------------------------------------
# target interleaving
# ---------------------------------------------------------------------------

def interleave_target(target: torch.Tensor, eos_id: int) -> torch.Tensor:
    """[B, M] eos-terminated padded targets -> [B, Z] interleaved streams.

    Z = M+2 rounded up to even; each stream ends with its own eos; the
    shorter (r2l) stream is zero-padded after its eos. The length counts
    the non-zero tokens; the gather indices are clipped into the row."""
    b, m_dim = target.shape
    z_len = m_dim + 2 + (m_dim % 2)
    num_pairs = z_len // 2
    target = target.long()

    lens = (target != 0).sum(dim=1)
    m = torch.clamp(lens - 1, min=0)             # content length (no eos)
    half_l = ((m + 1) // 2)[:, None]
    half_r = (m // 2)[:, None]

    i = torch.arange(num_pairs, device=target.device)[None, :]
    zero = torch.zeros((), dtype=target.dtype, device=target.device)
    eos = torch.full((), eos_id, dtype=target.dtype, device=target.device)
    l_idx = torch.clamp(i, max=m_dim - 1).expand(b, -1)
    l_tok = torch.gather(target, 1, l_idx)
    l_tok = torch.where(i < half_l, l_tok,
                        torch.where(i == half_l, eos, zero))

    r_idx = torch.clamp(m[:, None] - 1 - i, 0, m_dim - 1)
    r_tok = torch.gather(target, 1, r_idx)
    r_tok = torch.where(i < half_r, r_tok,
                        torch.where(i == half_r, eos, zero))

    return torch.stack([l_tok, r_tok], dim=2).reshape(b, z_len)


def unfold(z_seq: np.ndarray, eos_id: int) -> list:
    """Host-side reassembly of one interleaved sequence into y tokens."""
    l_toks, r_toks = [], []
    for pos, tok in enumerate(z_seq):
        stream = l_toks if pos % 2 == 0 else r_toks
        done = (eos_id in stream) or (0 in stream)
        if not done:
            stream.append(int(tok))

    def strip(toks):
        out = []
        for t in toks:
            if t == eos_id or t == 0:
                break
            out.append(t)
        return out

    return strip(l_toks) + list(reversed(strip(r_toks)))


def pair_causal_mask(z_len: int, dtype=torch.float32, device=None):
    """[1, 1, Z, Z] keep-mask with pair granularity: q//2 <= p//2."""
    pos = torch.arange(z_len, device=device) // 2
    return (pos[None, :] <= pos[:, None]).to(dtype)[None, None]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init_fn(gen, cfg) -> common.Seq2Seq:
    tables = common.init_embeddings(gen, cfg)
    tables["dir_embedding"] = common.config_initializer(cfg)(
        gen, (2, cfg.embed_size))
    return common.Seq2Seq(
        tables,
        [base.init_enc_layer(gen, cfg, l)
         for l in range(cfg.num_encoder_layer)],
        [base.init_dec_layer(gen, cfg, l)
         for l in range(cfg.num_decoder_layer)])


def _encode(params, source, cfg, rngs, training):
    dtype = dtypes.compute_dtype(cfg)
    mask = (source != 0).float()
    src_table, _, _ = common.emb_tables(params, cfg)
    x = common.embed_scaled(src_table, source, params.emb_bias, cfg, dtype)
    x = nn.add_timing_signal(x)
    x = dropout(rngs(), x, cfg.dropout if training else None)
    keep = nn.masking_mask(mask)
    for p in params.encoder:
        x = base.enc_layer(p, x, keep, cfg, rngs)
    return {"encodes": x, "mask": mask}


def _embed_z(params, z, cfg):
    """Interleaved-stream embeddings: token + stream position (i for both
    members of pair i, fp32) + direction embedding by parity."""
    _, tgt_table, _ = common.emb_tables(params, cfg)
    x = common.embed_scaled(tgt_table, z, params.emb_bias, cfg,
                            dtypes.compute_dtype(cfg))
    z_len = z.shape[1]
    slots = torch.arange(z_len, device=z.device)
    sig = nn.timing_signal(z_len, cfg.embed_size, device=z.device)  # [Z, E]
    x = x + sig[slots // 2][None]
    # split over its two rows under tensor parallelism (a VocabPart)
    dirs = tp.table(params, "dir_embedding", params.dir_embedding)
    return x + common.lookup(dirs, slots % 2, x.dtype)[None]


def _pair_shift(x):
    """Shift inputs by one pair: pair i sees pair i-1; pair 0 sees zeros."""
    return torch.nn.functional.pad(x, (0, 0, 2, 0))[:, :-2, :]


def _decode_train(params, z, state, cfg, rngs, training):
    x = _pair_shift(_embed_z(params, z, cfg))
    x = dropout(rngs(), x, cfg.dropout if training else None)
    # built on first use, by a layer on the composite path (a layer whose
    # self-attention takes a kernel passes the causal flag instead, R1)
    self_keep = functools.cache(functools.partial(
        pair_causal_mask, z.shape[1], device=z.device))
    mem_keep = nn.masking_mask(state["mask"])
    zmask = (z != 0).float()
    for p in params.decoder:
        x = base.dec_layer_train(p, x, state, self_keep, mem_keep, cfg, rngs,
                                 zmask)
    _, _, soft_table = common.emb_tables(params, cfg)
    return x, soft_table, zmask


def _loss(params, features, cfg, gen, training, label_smooth):
    """(scalar loss, per-sentence [B]) of the interleaved target, in the
    compute dtype (cast differentiably); dropout from ``gen`` in
    training."""
    common.check_ported(cfg, training)

    def body(cparams):
        rngs = RngGen(gen if training else None)
        state = _encode(cparams, features["source"], cfg, rngs, training)
        z = interleave_target(features["target"], cfg.tgt_vocab.eos())
        feat, soft_table, zmask = _decode_train(cparams, z, state, cfg, rngs,
                                                training)
        return common.ce_from_feature(feat, soft_table, z, zmask, cfg,
                                      label_smooth)

    return common.compute_call(params, dtypes.compute_dtype(cfg), body)


def train_fn(params, features, cfg, gen, step=0):
    loss, _ = _loss(params, features, cfg, gen, True, cfg.label_smooth)
    return {"loss": loss}


def score_fn(params, features, cfg):
    # dropout off, label smoothing off
    _, per_sample = _loss(params, features, cfg, None, False, 0.0)
    return {"score": per_sample}


class IBInference(NamedTuple):
    encode: Callable
    init_cache: Callable
    decode_pair: Callable    # (params, prev_pair [B, 2], state, cache, i)
    decode_prefix: Callable  # (params, z_buffer, state, i) -> [B, 2, V]
    # no ancestry-indexed pools: the pair search gathers every cache tensor
    reorder_cache: Optional[Callable] = None


def infer_fn(cfg):
    dtype = dtypes.compute_dtype(cfg)

    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False)
        state["layers"] = [base.dec_layer_precompute(p, state["encodes"], cfg)
                           for p in params.decoder]
        return state

    def init_cache(params, state, batch, max_z_len):
        device = state["mask"].device
        return {"layers": [base.init_dec_layer_cache(p, batch, max_z_len, cfg,
                                                     dtype, device)
                           for p in params.decoder]}

    def decode_pair(params, prev_pair, state, cache, pair_i: int):
        """One pair step: feed pair i-1's tokens, emit logits for both
        members of pair i. prev_pair [B, 2] (ignored at pair 0).

        The training inputs of pair i's slots are pair i-1's embeddings at
        pair position i-1 with their direction parity; pair 0's are zero.
        The position is rebuilt as the JAX package does: the signal of
        position 0 off, that of max(i-1, 0) on."""
        x = _embed_z(params, prev_pair, cfg)     # pos(0) + dirs of slots 0, 1
        sig0 = nn.timing_signal(1, cfg.embed_size, device=x.device)[0]
        sig_prev = nn.timing_signal(
            torch.full((1,), float(max(pair_i - 1, 0)), device=x.device),
            cfg.embed_size)
        x = x - sig0[None, None, :] + sig_prev[None]
        if pair_i == 0:
            x = torch.zeros_like(x)
        time = 2 * pair_i
        new_caches = []
        for p, lstate, lcache in zip(params.decoder, state["layers"],
                                     cache["layers"]):
            x, new_c = base.dec_layer_step(p, x, lstate, state, lcache, time,
                                           cfg)
            new_caches.append(new_c)
        _, _, soft_table = common.emb_tables(params, cfg)
        return common.output_logits(x, soft_table), {"layers": new_caches}

    def decode_prefix(params, z_buffer, state, pair_i: int):
        """Dev-mode oracle: the full pair-shifted decoder over the buffer;
        the logits of pair i's two slots, [B, 2, V]."""
        feat, soft_table, _ = _decode_train(params, z_buffer, state, cfg,
                                            RngGen(None), False)
        return common.output_logits(feat[:, 2 * pair_i:2 * pair_i + 2],
                                    soft_table)

    return IBInference(encode=encode, init_cache=init_cache,
                       decode_pair=decode_pair, decode_prefix=decode_prefix)


model_register("transformer_ibdecoder", init_fn, train_fn, score_fn,
               infer_fn)
