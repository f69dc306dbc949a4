"""DeepNMT: GNMT-style deep RNN stacks.

Counterpart of ``zero_tpu/models/deepnmt.py``: encoder layer 0
bidirectional (or the CAEncoder), layers 1.. unidirectional, each followed
by an ``ff`` projection to embed_size with a residual where the widths
agree and an optional LayerNorm; ``x_map``/``x_map_ln`` lift the top to
hidden_size when embed_size differs; per-decoder-layer initial states
from the top encoder state; a deep decoder whose layer 0 (every layer
under ``use_deep_att``) runs the attention cond_rnn, and whose upper layers
read the contexts (one2one under caencoder, else a plain RNN over
[x, c]); the dl4mt re-dict readout. As the JAX package, both the cache
decode and the dev-mode oracle read the re-dict feature.

fp32 throughout and ``eval_cast=False``, as rnnsearch.py says. The decode
state's ``proj_memories`` holds a (0,)-shaped placeholder for each layer
that does not attend (the search tiles it to (0,) in dev mode).
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
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout


def _attends(cfg, layer: int) -> bool:
    return layer == 0 or bool(cfg.use_deep_att)


def init_fn(gen, cfg) -> rnns.Tree:
    init = common.config_initializer(cfg)
    cell = rnns.get_cell(cfg.cell)
    d, e, ln = cfg.hidden_size, cfg.embed_size, cfg.layer_norm

    parts = init_tables(gen, cfg, init)
    encoder = []
    for layer in range(cfg.num_encoder_layer):
        lp = {"forward": cell.init(gen, e, d, ln, init)}
        y_dim = d
        if layer == 0:
            if cfg.caencoder:
                lp["backward"] = rnns.init_cond_rnn(
                    gen, cfg.cell, e, d, d, ln=ln, weight_init=init,
                    one2one=True, att_num_heads=cfg.num_heads)
            else:
                lp["backward"] = cell.init(gen, e, d, ln, init)
                y_dim = 2 * d
        lp["ff"] = nn.init_linear(gen, y_dim, e, weight_init=init)
        if ln:
            lp["ln"] = nn.init_layer_norm(e)
        encoder.append(rnns.Tree(lp))
    parts["encoder"] = encoder
    if e != d:
        parts["x_map"] = nn.init_linear(gen, e, d, weight_init=init)
        parts["x_map_ln"] = nn.init_layer_norm(d)

    # z, the top layer's final state, is 2d only when the single layer is
    # the bidirectional one without caencoder
    z_dim = 2 * d if (cfg.num_encoder_layer == 1 and not cfg.caencoder) \
        else d
    parts["decoder_init"] = [
        rnns.init_state_params(gen, cell, z_dim, d, ln, init)
        for _ in range(cfg.num_decoder_layer)]

    decoder = []
    for layer in range(cfg.num_decoder_layer):
        if _attends(cfg, layer) or cfg.caencoder:
            lp = {"cond": rnns.init_cond_rnn(
                gen, cfg.cell, e, d, d, ln=ln, weight_init=init,
                one2one=not _attends(cfg, layer),
                att_num_heads=cfg.num_heads)}
        else:
            lp = {"plain": cell.init(gen, e + d, d, ln, init)}
        lp["ff"] = nn.init_linear(gen, d, e, weight_init=init)
        if ln:
            lp["ln"] = nn.init_layer_norm(e)
        decoder.append(rnns.Tree(lp))
    parts["decoder"] = decoder

    if cfg.dl4mt_redict:
        parts["redict"] = nn.init_linear(gen, e + d, e, weight_init=init,
                                         ln=ln)
    return rnns.Tree(parts)


def _residual(lp, x, y, cfg, rngs, training):
    """x + dropout(y) where the widths agree (one dropout seed), else y;
    then the layer's LayerNorm."""
    if x.shape[-1] == y.shape[-1]:
        x = nn.residual_fn(x, y, rngs(), cfg.dropout if training else None)
    else:
        x = y
    return nn.layer_norm(lp["ln"], x) if cfg.layer_norm else x


def _encode(params, source, cfg, rngs, training):
    cell = rnns.get_cell(cfg.cell)
    d, ln = cfg.hidden_size, cfg.layer_norm
    mask = (source != 0).float()
    src_table, _, _ = tables(params, cfg)
    x = embed(src_table, source, params["emb_bias"])
    x = dropout(rngs(), x, cfg.dropout if training else None)

    z = None
    for layer, lp in enumerate(params["encoder"]):
        _, (out_fw, state_fw) = rnns.rnn(cell, lp["forward"], x, d,
                                         mask=mask, ln=ln)
        if layer == 0:
            rev_x = torch.flip(x, [1])
            rev_mask = torch.flip(mask, [1])
            if cfg.caencoder:
                _, (out_bw, z), _, _ = rnns.cond_rnn(
                    cfg.cell, lp["backward"], rev_x, torch.flip(out_fw, [1]),
                    d, mask=rev_mask, ln=ln, one2one=True,
                    num_heads=cfg.num_heads)
                y = torch.flip(out_bw, [1])
            else:
                _, (out_bw, state_bw) = rnns.rnn(
                    cell, lp["backward"], rev_x, d, mask=rev_mask, ln=ln)
                y = torch.cat([out_fw, torch.flip(out_bw, [1])], dim=-1)
                z = torch.cat([state_fw, state_bw], dim=-1)
        else:
            y, z = out_fw, state_fw
        x = _residual(lp, x, nn.linear(lp["ff"], y), cfg, rngs, training)

    if cfg.embed_size != d:
        x = nn.layer_norm(params["x_map_ln"], nn.linear(params["x_map"], x))
    init_states = [rnns.init_state_from(p, cell, z, ln=ln)
                   for p in params["decoder_init"]]
    return {"encodes": x, "mask": mask, "decoder_initializer": init_states}


def _decode_train(params, target, state, cfg, rngs, training,
                  mask_override=None):
    cell = rnns.get_cell(cfg.cell)
    d, ln = cfg.hidden_size, cfg.layer_norm
    mask = mask_override if mask_override is not None \
        else (target != 0).float()
    _, _, soft_table = tables(params, cfg)
    x = shifted_inputs(params, target, cfg, rngs, training)

    c = None
    for layer, lp in enumerate(params["decoder"]):
        init_state = state["decoder_initializer"][layer]
        if _attends(cfg, layer):
            _, (outputs, _), c, _ = rnns.cond_rnn(
                cfg.cell, lp["cond"], x, state["encodes"], d,
                init_state=init_state, mask=mask, mem_mask=state["mask"],
                ln=ln, num_heads=cfg.num_heads)
        elif cfg.caencoder:
            _, (outputs, _), _, _ = rnns.cond_rnn(
                cfg.cell, lp["cond"], x, c, d, init_state=init_state,
                mask=mask, mem_mask=mask, ln=ln, one2one=True,
                num_heads=cfg.num_heads)
        else:
            _, (outputs, _) = rnns.rnn(
                cell, lp["plain"], torch.cat([x, c], dim=-1), d, mask=mask,
                ln=ln, init_state=init_state)
        x = _residual(lp, x, nn.linear(lp["ff"], outputs), cfg, rngs,
                      training)

    if cfg.dl4mt_redict:
        feature = torch.tanh(nn.linear(params["redict"],
                                       torch.cat([x, c], dim=-1), ln=ln))
        feature = dropout(rngs(), feature, cfg.dropout if training else None)
    else:
        feature = x
    return feature, soft_table


train_fn, score_fn = make_fns(_encode, _decode_train)


def infer_fn(cfg):
    cell = rnns.get_cell(cfg.cell)
    ln = cfg.layer_norm

    def encode(params, source):
        state = _encode(params, source, cfg, RngGen(None), False)
        state["proj_memories"] = [
            nn.linear(lp["cond"]["context_att"], state["encodes"], ln=ln)
            if _attends(cfg, layer) else state["encodes"].new_zeros((0,))
            for layer, lp in enumerate(params["decoder"])]
        return state

    def init_cache(params, state, batch, max_len):
        return {"layers": [repeat_beams(h0, batch)
                           for h0 in state["decoder_initializer"]]}

    def _one_step(p, h_, x):
        """A cell's single step on x [B, d_in] (no mask: decode)."""
        return cell.step(p, h_, cell.fetch(p, x, ln), ln)

    def decode_step(params, prev_tok, state, cache, time):
        _, _, soft_table = tables(params, cfg)
        x = step_input(params, prev_tok, time, cfg)
        c = None
        new_states = []
        for layer, lp in enumerate(params["decoder"]):
            h_ = cache["layers"][layer]
            if _attends(cfg, layer):
                h, hidden, c = rnns.cond_rnn_step(
                    cfg.cell, lp["cond"], h_, x, state["encodes"],
                    state["mask"], state["proj_memories"][layer], ln=ln,
                    num_heads=cfg.num_heads)
            elif cfg.caencoder:
                s = _one_step(lp["cond"]["lower"], h_, x)
                h = _one_step(lp["cond"]["higher"], s, c)
                hidden = cell.get_hidden(h)
            else:
                h = _one_step(lp["plain"], h_, torch.cat([x, c], dim=-1))
                hidden = cell.get_hidden(h)
            new_states.append(h)
            y = nn.linear(lp["ff"], hidden)
            x = x + y if x.shape[-1] == y.shape[-1] else y
            if ln:
                x = nn.layer_norm(lp["ln"], x)

        if cfg.dl4mt_redict:
            feature = torch.tanh(nn.linear(params["redict"],
                                           torch.cat([x, c], dim=-1), ln=ln))
        else:
            feature = x
        return (common.output_logits(feature, soft_table),
                {"layers": new_states})

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step,
                     decode_prefix=make_decode_prefix(_decode_train, cfg))


model_register("deepnmt", init_fn, train_fn, score_fn, infer_fn,
               eval_cast=False)
