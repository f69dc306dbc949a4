"""RNNSearch with deep attention.

Counterpart of ``zero_tpu/models/rnnsearch_deepatt.py``: the encoder is a
plain RNN followed by one2one cond_rnn stacks of alternating direction
over the previous layer's hidden sequence; the decoder is its own time
loop, where each step runs the lower cell and then ``depth``
(num_decoder_layer) stages of attention -> higher cell, every stage with
its own attention over one shared projected memory; the readout is
tanh(linear([hidden, all the stages' contexts, inputs])).

fp32 throughout and ``eval_cast=False``, as rnnsearch.py says.
"""

from __future__ import annotations

import torch

from zero_tpu_torch import rnns
from zero_tpu_torch.models import common
from zero_tpu_torch.models.base import Inference, model_register
from zero_tpu_torch.models.rnnsearch import (embed, init_tables,
                                             make_decode_prefix, make_fns,
                                             repeat_beams, shifted_inputs,
                                             step_input, tables)
from zero_tpu_torch.ops import attention as attn_mod
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout


def init_fn(gen, cfg) -> rnns.Tree:
    init = common.config_initializer(cfg)
    cell = rnns.get_cell(cfg.cell)
    d, e, ln = cfg.hidden_size, cfg.embed_size, cfg.layer_norm
    depth = cfg.num_decoder_layer

    parts = init_tables(gen, cfg, init)
    parts["enc0"] = cell.init(gen, e, d, ln, init)
    parts["encoder"] = [
        rnns.init_cond_rnn(gen, cfg.cell, e, d, d, ln=ln, weight_init=init,
                           one2one=True, att_num_heads=cfg.num_heads)
        for _ in range(cfg.num_encoder_layer)]
    parts["decoder_init"] = rnns.init_state_params(gen, cell, d, d, ln, init)
    parts["dec_lower"] = cell.init(gen, e, d, ln, init)
    parts["dec_higher"] = [cell.init(gen, d, d, ln, init)
                           for _ in range(depth)]
    parts["dec_att"] = [
        attn_mod.init_additive_attention(gen, d, d, d,
                                         num_heads=cfg.num_heads,
                                         weight_init=init)
        for _ in range(depth)]
    parts["context_att"] = nn.init_linear(gen, d, d, bias=False,
                                          weight_init=init, ln=ln)
    parts["ff"] = nn.init_linear(gen, [d, depth * d, e], e, weight_init=init,
                                 ln=ln)
    return rnns.Tree(parts)


def _encode(params, source, cfg, rngs, training):
    cell = rnns.get_cell(cfg.cell)
    d, ln = cfg.hidden_size, cfg.layer_norm
    mask = (source != 0).float()
    src_table, _, _ = tables(params, cfg)
    x = embed(src_table, source, params["emb_bias"])
    x = dropout(rngs(), x, cfg.dropout if training else None)

    _, (h, z) = rnns.rnn(cell, params["enc0"], x, d, mask=mask, ln=ln)
    for layer, lp in enumerate(params["encoder"]):
        # layers 0, 2, ... run right to left
        flip = ((lambda v: torch.flip(v, [1])) if layer % 2 == 0
                else (lambda v: v))
        _, (h, z), _, _ = rnns.cond_rnn(
            cfg.cell, lp, flip(x), flip(h), d, mask=flip(mask), ln=ln,
            one2one=True, num_heads=cfg.num_heads)
        h = flip(h)
    init_state = rnns.init_state_from(params["decoder_init"], cell, z, ln=ln)
    return {"encodes": h, "mask": mask, "decoder_initializer": init_state}


def _dec_stage(params, s, memory, mem_mask, proj_memories, cfg, m=None):
    """The ``depth`` attention -> higher-cell stages from state s; with
    ``m`` (the step's keep column) a pad step carries each stage's state.
    Returns (final state, the stages' contexts)."""
    cell = rnns.get_cell(cfg.cell)
    ln = cfg.layer_norm
    ctxs = []
    for att, higher in zip(params["dec_att"], params["dec_higher"]):
        c = attn_mod.additive_attention(
            att, cell.get_hidden(s), memory, mem_mask,
            num_heads=cfg.num_heads, proj_memory=proj_memories)["output"]
        ctxs.append(c)
        ss = cell.step(higher, s, cell.fetch(higher, c, ln), ln)
        s = ss if m is None else rnns.carry(s, ss, m)
    return s, ctxs


def _decode_train(params, target, state, cfg, rngs, training,
                  mask_override=None):
    cell = rnns.get_cell(cfg.cell)
    ln = cfg.layer_norm
    mask = mask_override if mask_override is not None \
        else (target != 0).float()
    _, _, soft_table = tables(params, cfg)
    inputs = shifted_inputs(params, target, cfg, rngs, training)
    memory, mem_mask = state["encodes"], state["mask"]
    proj_memories = nn.linear(params["context_att"], memory, ln=ln)

    keep = rnns.step_masks(mask, inputs.shape[1], inputs.shape[0], inputs)
    fetched = cell.fetch(params["dec_lower"], inputs, ln)
    h = state["decoder_initializer"]
    outs, contexts = [], []
    for t, vs in enumerate(rnns.step_views(fetched)):
        s = rnns.carry(h, cell.step(params["dec_lower"], h, vs, ln), keep[t])
        h, ctxs = _dec_stage(params, s, memory, mem_mask, proj_memories, cfg,
                             m=keep[t])
        outs.append(h)
        contexts.append(torch.cat(ctxs, dim=-1))
    hidden = cell.get_hidden(torch.stack(outs, dim=1))
    feature = torch.tanh(nn.linear(
        params["ff"], [hidden, torch.stack(contexts, dim=1), inputs], ln=ln))
    feature = dropout(rngs(), feature, cfg.dropout if training else None)
    return feature, soft_table


train_fn, score_fn = make_fns(_encode, _decode_train)


def infer_fn(cfg):
    cell = rnns.get_cell(cfg.cell)
    ln = cfg.layer_norm

    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False)
        state["proj_memories"] = nn.linear(params["context_att"],
                                           state["encodes"], ln=ln)
        return state

    def init_cache(params, state, batch, max_len):
        return {"h": repeat_beams(state["decoder_initializer"], batch)}

    def decode_step(params, prev_tok, state, cache, time):
        _, _, soft_table = tables(params, cfg)
        x = step_input(params, prev_tok, time, cfg)
        s = cell.step(params["dec_lower"], cache["h"],
                      cell.fetch(params["dec_lower"], x, ln), ln)
        h, ctxs = _dec_stage(params, s, state["encodes"], state["mask"],
                             state["proj_memories"], cfg)
        feature = torch.tanh(nn.linear(
            params["ff"], [cell.get_hidden(h), torch.cat(ctxs, dim=-1), x],
            ln=ln))
        return common.output_logits(feature, soft_table), {"h": h}

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step,
                     decode_prefix=make_decode_prefix(_decode_train, cfg))


model_register("rnnsearch_deepatt", init_fn, train_fn, score_fn, infer_fn,
               eval_cast=False)
