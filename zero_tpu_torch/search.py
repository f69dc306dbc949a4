"""Beam search over preallocated caches.

Counterpart of ``zero_tpu/search.py:beam_search``: 2k-candidate expansion
with a two-stage exact top-k, k alive / k finished bookkeeping, GNMT length
penalty ((5+len)/6)^alpha, worst-finished >= best-alive termination, forced
EOS-block at t<1, gumbel noise + temperature options, per-sentence length
budget source_len + decode_length, and alive-fallback when nothing
finished. The sequence buffers are preallocated [B, K, T_max+1] and written
at time+1 each step; the model cache is reordered by the model's
``reorder_cache`` (ancestry index) or a beam gather.

JAX's ``lax.while_loop`` becomes a Python loop with a host ``time``; the
termination test costs one device-to-host sync per step.
"""

from __future__ import annotations

from typing import Optional

import torch

from zero_tpu_torch.ops.common import gather_beams, gumbel_noise

F32_MIN = torch.finfo(torch.float32).min


def top_k(x: torch.Tensor, k: int):
    """Top-k over the last axis with ``lax.top_k``'s order: descending, and
    among equal values the lower index first. ``torch.topk`` promises no
    order among ties, and beam search has exact ties by construction
    (F32_MIN-initialised beams and finished slots). A stable descending
    sort keeps the lax rule. Returns (values, int64 indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _tile_beam(x, beam_size):
    """[B, ...] -> [B*K, ...] by repeating each row K times."""
    return x.repeat_interleave(beam_size, dim=0)


def _penalty(length: torch.Tensor, alpha: float):
    """GNMT length penalty ((5 + len) / 6) ** alpha in fp32."""
    return torch.pow((5.0 + length.float()) / 6.0, alpha)


def beam_search(params, source, inference, cfg,
                generator: Optional[torch.Generator] = None):
    """Run beam search over a padded int token batch ``source`` [B, Ls].

    Returns {'seq': [B, K, T_max] int64, 'score': [B, K] f32, 'steps': int
    (loop iterations; the whole batch steps until every row is done)}.
    """
    beam_size = int(cfg.beam_size)
    alpha = float(cfg.decode_alpha)
    eos_id = cfg.tgt_vocab.eos()
    device = source.device
    src_mask = (source != 0).float()
    batch, src_len = src_mask.shape
    t_max = min(int(cfg.decode_max_len), src_len + int(cfg.decode_length))
    dev_mode = cfg.search_mode != "cache"

    # encode once. In cache mode the beam-invariant state stays UNTILED at
    # [B, ...]: cross attention folds beams into the query axis. Dev mode
    # recomputes the full decoder over per-beam buffers, so there the
    # state is tiled.
    state = inference.encode(params, source)
    if dev_mode:
        state = _tree_map(lambda x: _tile_beam(x, beam_size), state)

    source_length = src_mask.sum(-1)                                # [B]
    max_target_length = torch.clamp(source_length + cfg.decode_length,
                                    max=t_max).to(torch.int32)      # [B]
    max_penalty = _penalty(max_target_length, alpha)

    cache = inference.init_cache(params, state, batch * beam_size, t_max)

    init_log_probs = torch.tensor(
        [[0.0] + [F32_MIN] * (beam_size - 1)], dtype=torch.float32,
        device=device).repeat(batch, 1)
    alive_seq = torch.zeros((batch, beam_size, t_max + 1), dtype=torch.long,
                            device=device)
    alive_log_probs = init_log_probs
    alive_scores = torch.zeros_like(init_log_probs)
    fin_seq = torch.zeros_like(alive_seq)
    fin_scores = torch.full((batch, beam_size), F32_MIN, dtype=torch.float32,
                            device=device)
    fin_flags = torch.zeros((batch, beam_size), dtype=torch.bool,
                            device=device)

    def not_finished(time):
        # worst finished vs best possible alive
        best_alive = alive_log_probs[:, 0] / max_penalty
        worst_finish = torch.min(fin_scores * fin_flags.float(), dim=1).values
        worst_finish = worst_finish + (
            1.0 - fin_flags.any(dim=1).float()) * F32_MIN
        bound_is_met = torch.all(worst_finish > best_alive)
        length_is_met = torch.any(time < max_target_length)
        return bool(torch.logical_and(~bound_is_met, length_is_met))

    time = 0
    while not_finished(time):
        # 1. expand: previous tokens -> next-token logits
        prev_tok = alive_seq[:, :, time].reshape(batch * beam_size, 1)
        if dev_mode:
            buffer = alive_seq[:, :, 1:].reshape(batch * beam_size, t_max)
            logits = inference.decode_prefix(params, buffer, state, time)
        else:
            logits, cache = inference.decode_step(params, prev_tok, state,
                                                  cache, time)
        logits = logits.float()
        if cfg.enable_noise_beam_search and generator is not None:
            logits = logits + gumbel_noise(generator, logits.shape, device)
        logits = logits / cfg.beam_search_temperature
        vocab = logits.shape[-1]

        # force decoding: no eos before the first real token
        blocked = logits
        if time < 1:
            eos_block = (torch.arange(vocab, device=device) == eos_id) \
                .float() * F32_MIN
            blocked = logits + eos_block[None]

        # 2. score 2k candidates: per-row top-2K over the raw logits, then
        # exact rescoring and top-2K over the K*2K survivors (same ranks
        # and tie order as top-2K over the flat [B, K*V] scores)
        lse = torch.logsumexp(logits, dim=-1)                     # [B*K]
        kprime = min(2 * beam_size, vocab)
        cand_val, cand_idx = top_k(blocked, kprime)
        # a host float holding the fp32 value: no device round trip
        penalty = _penalty(torch.tensor(time + 1), alpha).item()
        cand_scores = (alive_log_probs.reshape(-1, 1) + cand_val
                       - lse[:, None]) / penalty                  # [B*K, K']
        flat = cand_scores.reshape(batch, beam_size * kprime)
        topk_scores, pos = top_k(flat, 2 * beam_size)
        curr_beam = pos // kprime                                 # [B, 2K]
        curr_symbol = torch.gather(
            cand_idx.reshape(batch, beam_size * kprime), 1, pos)  # [B, 2K]

        # candidate sequences: reorder beams, write symbol at time+1
        curr_seq = torch.take_along_dim(alive_seq, curr_beam[:, :, None],
                                        dim=1)                    # [B,2K,T+1]
        curr_seq[:, :, time + 1] = curr_symbol

        # 3. alive: top-k non-finished of the 2k
        curr_fin = (curr_symbol == eos_id) | \
            (time >= max_target_length)[:, None]
        alive_cand = topk_scores + curr_fin.float() * F32_MIN
        alive_scores, alive_idx = top_k(alive_cand, beam_size)
        alive_seq = torch.take_along_dim(curr_seq, alive_idx[:, :, None],
                                         dim=1)
        alive_beam = torch.gather(curr_beam, 1, alive_idx)
        alive_log_probs = alive_scores * penalty
        if dev_mode:
            pass  # decode_prefix recomputes from the buffer: no cache
        elif inference.reorder_cache is not None:
            cache = inference.reorder_cache(cache, alive_beam, batch,
                                            beam_size, time)
        else:
            cache = _tree_map(
                lambda x: gather_beams(x, alive_beam, batch, beam_size),
                cache)

        # 4. finished: top-k of previous k + current 2k
        curr_fin_scores = topk_scores + (1.0 - curr_fin.float()) * F32_MIN
        fin_flags_pool = torch.cat([fin_flags, curr_fin], dim=1)
        fin_scores_pool = torch.cat([fin_scores, curr_fin_scores], dim=1)
        fin_seq_pool = torch.cat([fin_seq, curr_seq], dim=1)
        fin_scores, fin_idx = top_k(fin_scores_pool, beam_size)
        fin_flags = torch.gather(fin_flags_pool, 1, fin_idx)
        fin_seq = torch.take_along_dim(fin_seq_pool, fin_idx[:, :, None],
                                       dim=1)
        time += 1

    never_finished = ~fin_flags.any(dim=1)
    seqs = torch.where(never_finished[:, None, None], alive_seq, fin_seq)
    scores = torch.where(never_finished[:, None], alive_scores, fin_scores)
    return {"seq": seqs[:, :, 1:], "score": scores, "steps": time}


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list (state, cache)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return [_tree_map(fn, v) for v in tree]
