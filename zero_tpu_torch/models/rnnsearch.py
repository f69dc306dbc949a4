"""RNNSearch: attention-based RNN seq2seq (Bahdanau-style).

Counterpart of ``zero_tpu/models/rnnsearch.py``: a bidirectional encoder
(a forward and a backward RNN, or the CAEncoder: the backward pass runs
one2one over the forward pass's outputs), the tanh'd initial decoder state
from the encoder's final state, the conditional attention decoder
(rnns.cond_rnn) and the readout tanh(linear([outputs, contexts, inputs])),
over the cell of the ``cell`` option. Embeddings carry no sqrt scale and
no timing signal.

As in the JAX package the model never casts to the compute dtype: its
fp32 tables and weights keep it in fp32 whatever ``default_dtype`` says
(registered with ``eval_cast=False``). The transformer options it does
not read (``use_remat``, ``scan_layers``, the kernel flags) are ignored
there too. Decode caches {"h"} [B*K, state], which the search permutes
with its beam gather (no reorder_cache); the memory's projection is
computed once at encode.
"""

from __future__ import annotations

import torch

from zero_tpu_torch import rnns
from zero_tpu_torch.models import common
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import tensor as tp


def init_tables(gen, cfg, init) -> dict:
    """The embedding tables under the sharing flags (config initializer)
    and the shared bias ``emb_bias``."""
    e = cfg.embed_size
    src_vocab, tgt_vocab = cfg.src_vocab.size(), cfg.tgt_vocab.size()
    if cfg.shared_source_target_embedding:
        parts = {"embedding": init(gen, (src_vocab, e))}
    else:
        parts = {"src_embedding": init(gen, (src_vocab, e)),
                 "tgt_embedding": init(gen, (tgt_vocab, e))}
        if not cfg.shared_target_softmax_embedding:
            parts["softmax_embedding"] = init(gen, (tgt_vocab, e))
    parts["emb_bias"] = init(gen, (e,))
    return parts


def tables(params, cfg):
    """(source, target, softmax) tables under the sharing flags; a table
    split over the vocabulary (tensor parallelism) as its VocabPart."""
    def table(name):
        return tp.table(params, name, params[name])
    if cfg.shared_source_target_embedding:
        e = table("embedding")
        return e, e, e
    soft = (table("tgt_embedding") if cfg.shared_target_softmax_embedding
            else table("softmax_embedding"))
    return table("src_embedding"), table("tgt_embedding"), soft


def embed(table, ids, bias):
    """The rows of ``table`` (or of its VocabPart, summed over its line)
    at ``ids``, plus ``bias``."""
    return common.lookup(table, ids) + bias


def shifted_inputs(params, target, cfg, rngs, training):
    """The decoder's inputs: target embeddings shifted right by one (a zero
    vector first), with the input dropout."""
    _, tgt_table, _ = tables(params, cfg)
    inputs = common.shift_right(embed(tgt_table, target, params["emb_bias"]))
    return dropout(rngs(), inputs, cfg.dropout if training else None)


def step_input(params, prev_tok, time, cfg):
    """A decode step's input: the previous token's embedding, the zero
    vector at time 0."""
    _, tgt_table, _ = tables(params, cfg)
    x = embed(tgt_table, prev_tok[:, 0], params["emb_bias"])
    return torch.zeros_like(x) if time == 0 else x


def prefix_mask(tgt_buffer, time):
    """Dev mode's mask over the [B, T] buffer: every step up to ``time``
    updates the state, as the cache decode does."""
    positions = torch.arange(tgt_buffer.shape[1], device=tgt_buffer.device)
    return (positions[None, :] <= time).float().expand(tgt_buffer.shape)


def init_fn(gen, cfg) -> rnns.Tree:
    init = common.config_initializer(cfg)
    cell = rnns.get_cell(cfg.cell)
    d, e, ln = cfg.hidden_size, cfg.embed_size, cfg.layer_norm

    parts = init_tables(gen, cfg, init)
    parts["forward"] = cell.init(gen, e, d, ln, init)
    if cfg.caencoder:
        parts["backward"] = rnns.init_cond_rnn(
            gen, cfg.cell, e, d, d, ln=ln, weight_init=init, one2one=True,
            att_num_heads=cfg.num_heads)
    else:
        parts["backward"] = cell.init(gen, e, d, ln, init)
    enc_dim = d if cfg.caencoder else 2 * d
    parts["decoder_init"] = rnns.init_state_params(gen, cell, enc_dim, d, ln,
                                                   init)
    parts["decoder"] = rnns.init_cond_rnn(
        gen, cfg.cell, e, enc_dim, d, ln=ln, weight_init=init,
        att_num_heads=cfg.num_heads)
    parts["pre_logits"] = nn.init_linear(gen, [d, enc_dim, e], e,
                                         weight_init=init, ln=ln)
    return rnns.Tree(parts)


def _encode(params, source, cfg, rngs, training):
    cell = rnns.get_cell(cfg.cell)
    d, ln = cfg.hidden_size, cfg.layer_norm
    mask = (source != 0).float()
    src_table, _, _ = tables(params, cfg)
    inputs = embed(src_table, source, params["emb_bias"])
    inputs = dropout(rngs(), inputs, cfg.dropout if training else None)

    _, (out_fw, state_fw) = rnns.rnn(cell, params["forward"], inputs, d,
                                     mask=mask, ln=ln)
    rev_inputs = torch.flip(inputs, [1])
    rev_mask = torch.flip(mask, [1])
    if cfg.caencoder:
        _, (out_bw, state_bw), _, _ = rnns.cond_rnn(
            cfg.cell, params["backward"], rev_inputs,
            torch.flip(out_fw, [1]), d, mask=rev_mask, ln=ln, one2one=True,
            num_heads=cfg.num_heads)
    else:
        _, (out_bw, state_bw) = rnns.rnn(cell, params["backward"],
                                         rev_inputs, d, mask=rev_mask, ln=ln)
    out_bw = torch.flip(out_bw, [1])

    if cfg.caencoder:
        encodes, feature = out_bw, state_bw
    else:
        encodes = torch.cat([out_fw, out_bw], dim=-1)
        feature = torch.cat([state_fw, state_bw], dim=-1)
    init_state = torch.tanh(rnns.init_state_from(params["decoder_init"], cell,
                                                 feature, ln=ln))
    return {"encodes": encodes, "mask": mask,
            "decoder_initializer": init_state}


def _decode_train(params, target, state, cfg, rngs, training,
                  mask_override=None):
    ln = cfg.layer_norm
    mask = mask_override if mask_override is not None \
        else (target != 0).float()
    _, _, soft_table = tables(params, cfg)
    inputs = shifted_inputs(params, target, cfg, rngs, training)
    _, (outputs, _), contexts, _ = rnns.cond_rnn(
        cfg.cell, params["decoder"], inputs, state["encodes"],
        cfg.hidden_size, init_state=state["decoder_initializer"], mask=mask,
        mem_mask=state["mask"], ln=ln, num_heads=cfg.num_heads)
    feature = torch.tanh(nn.linear(params["pre_logits"],
                                   [outputs, contexts, inputs], ln=ln))
    feature = dropout(rngs(), feature, cfg.dropout if training else None)
    return feature, soft_table


def make_fns(encode_fn, decode_fn):
    """train_fn and score_fn of an RNN model from its
    ``encode_fn(params, source, cfg, rngs, training)`` and
    ``decode_fn(params, target, state, cfg, rngs, training)`` -> (feature,
    softmax table); fp32 throughout (no compute-dtype cast, as in the JAX
    package)."""

    def _loss(params, features, cfg, gen, training, factor):
        common.check_ported(cfg, training)
        rngs = RngGen(gen if training else None)
        state = encode_fn(params, features["source"], cfg, rngs, training)
        feature, soft_table = decode_fn(params, features["target"], state,
                                        cfg, rngs, training)
        mask = (features["target"] != 0).float()
        return common.ce_from_feature(feature, soft_table,
                                      features["target"], mask, cfg, factor)

    def train_fn(params, features, cfg, gen, step=0):
        loss, _ = _loss(params, features, cfg, gen, True, cfg.label_smooth)
        return {"loss": loss}

    def score_fn(params, features, cfg):
        _, per_sample = _loss(params, features, cfg, None, False, 0.0)
        return {"score": per_sample}

    return train_fn, score_fn


def make_decode_prefix(decode_fn, cfg):
    """Dev-mode oracle: the teacher-forced decoder over the whole buffer
    with every step up to ``time`` valid; the logits at ``time``."""

    def decode_prefix(params, tgt_buffer, state, time):
        feature, soft_table = decode_fn(
            params, tgt_buffer, state, cfg, RngGen(None), False,
            mask_override=prefix_mask(tgt_buffer, time))
        return common.output_logits(feature[:, time], soft_table)

    return decode_prefix


train_fn, score_fn = make_fns(_encode, _decode_train)


def repeat_beams(h0, batch):
    """[B, ...] -> [batch, ...], each row repeated batch // B times."""
    return h0.repeat_interleave(batch // h0.shape[0], dim=0)


def infer_fn(cfg):
    ln = cfg.layer_norm

    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False)
        state["proj_memories"] = nn.linear(params["decoder"]["context_att"],
                                           state["encodes"], ln=ln)
        return state

    def init_cache(params, state, batch, max_len):
        return {"h": repeat_beams(state["decoder_initializer"], batch)}

    def decode_step(params, prev_tok, state, cache, time):
        _, _, soft_table = tables(params, cfg)
        x = step_input(params, prev_tok, time, cfg)
        h, hidden, context = rnns.cond_rnn_step(
            cfg.cell, params["decoder"], cache["h"], x, state["encodes"],
            state["mask"], state["proj_memories"], ln=ln,
            num_heads=cfg.num_heads)
        feature = torch.tanh(nn.linear(params["pre_logits"],
                                       [hidden, context, x], ln=ln))
        return common.output_logits(feature, soft_table), {"h": h}

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step,
                     decode_prefix=make_decode_prefix(_decode_train, cfg))


model_register("rnnsearch", init_fn, train_fn, score_fn, infer_fn,
               eval_cast=False)
