"""Random online back-translation (ROBT) for zero-shot multilingual NMT.

Counterpart of ``zero_tpu/robt.py``: for every training pair (x -> y),
draw an intermediate language z uniformly, back-translate y into z with
the current model by greedy decoding, and train on the synthetic pair
(bt(y, z) -> y) too (train_step.py weighs the two losses). Needs a model
whose source carries the leading target-language tag
(transformer_multilingual). The back-translation runs without autograd,
on the parameters from before the step's update, and keeps the batch's
padded shapes. Under tensor parallelism it runs on whole weights,
gathered without gradient once a microbatch (the decode steps read no
split tag), so every process of a model line decodes the same tokens.
"""

from __future__ import annotations

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp

F32_MIN = torch.finfo(torch.float32).min


def greedy_decode(params, source, inference, cfg, out_len: int):
    """Greedy (argmax) incremental decode to a fixed ``out_len``: position
    0's input is <pad>, eos is blocked at the first step, and a stream
    that emitted eos is pinned to <pad>. Runs all ``out_len`` steps, as the
    JAX package's scan does. Returns [B, out_len] rows shaped like source
    sentences (tokens, eos, pads), in source's dtype."""
    batch = source.shape[0]
    eos_id = cfg.tgt_vocab.eos()
    state = inference.encode(params, source)
    cache = inference.init_cache(params, state, batch, out_len)
    prev = torch.zeros((batch, 1), dtype=source.dtype, device=source.device)
    done = torch.zeros((batch,), dtype=torch.bool, device=source.device)
    toks = []
    for t in range(out_len):
        logits, cache = inference.decode_step(params, prev, state, cache, t)
        logits = logits.float()
        if t < 1:
            logits[:, eos_id] = F32_MIN
        nxt = torch.argmax(logits, dim=-1).to(source.dtype)         # [B]
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        done = done | (nxt == eos_id)
        prev = nxt[:, None]
        toks.append(nxt)
    return torch.stack(toks, dim=1)


def whole_call(params, layout, fn):
    """fn(params) on whole weights: under ``layout``'s model or expert
    splits each split leaf gathered whole over its line and the split
    tags set aside, so the module runs as on one device. COLLECTIVE
    there."""
    if layout is None or not layout.splits:
        return fn(params)
    wholes = dist.whole_parts(params, layout)
    with tp.untagged(params):
        return torch.func.functional_call(params, wholes, (fn,))


def draw_languages(gen: torch.Generator, rows: int, num_languages: int,
                   device) -> torch.Tensor:
    """The intermediate language index of each row, uniform over
    [0, num_languages), from the step's generator: [rows, 1] int64. Within
    a global batch (ops/common.py:global_batch) the draw covers the global
    rows and this process keeps its own."""
    offset, local, total = common.global_rows()
    if not local:
        offset, total = 0, rows
    z = torch.randint(0, num_languages, (total, 1), generator=gen)
    return z[offset:offset + rows].to(device)


def make_augment(model, cfg):
    """(params, feats, gen, layout) -> the synthetic ROBT feature dict
    (``layout``: the state's, whose split leaves the decode gathers): per
    row, the source [tag(z), y] is back-translated greedily, and the
    synthetic tokens are paired with the row's ORIGINAL tag, so the model
    learns z -> lang(y). Rows of padding (an all-pad target) stay
    all-pad."""
    inference = model.infer_fn(cfg)
    num_languages = int(cfg.num_languages)
    lang_id_offset = int(cfg.lang_id_offset)

    def augment(params, feats, gen, layout=None):
        src, tgt = feats["source"], feats["target"]
        z_tag = (draw_languages(gen, src.shape[0], num_languages, src.device)
                 + lang_id_offset).to(tgt.dtype)
        bt_input = torch.cat([z_tag, tgt], dim=1)
        with torch.no_grad():
            synth = whole_call(params, layout, lambda m: greedy_decode(
                m, bt_input, inference, cfg, src.shape[1] - 1))
        new_src = torch.cat([src[:, :1], synth.to(src.dtype)], dim=1)
        real = (tgt != 0).sum(dim=1) > 0
        out = dict(feats)
        out["source"] = new_src * real[:, None].to(new_src.dtype)
        return out

    return augment
