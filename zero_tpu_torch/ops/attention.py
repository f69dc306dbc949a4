"""Multi-head attention: full-sequence (training, scoring, the encoder,
``decode_prefix``) and static-cache decoding.

Counterpart of ``zero_tpu/ops/attention.py`` for the post-LN Transformer:
the softmax path. The decode KV cache is PREALLOCATED at [B, T_max, hidden]
and written at the current step -- in place here, where JAX returns an
updated copy; validity is a ``position <= time`` mask. Softmax runs in fp32
regardless of the compute dtype. Self-attention uses one fused qkv
projection; cross attention computes the memory k/v once at encode time.
"""

from __future__ import annotations

from typing import Optional

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops import rpr as rpr_mod
from zero_tpu_torch.ops.kernels import decode_attention as da
from zero_tpu_torch.ops.kernels import fused_attention as fa
from zero_tpu_torch.ops.kernels import streaming_attention as sa

NEG_INF = da.NEG_INF


def kernels_supported(lq: int, lk: int) -> bool:
    """Fused-kernel eligibility: keys up to ``fa.MAX_LK`` ride the fused
    kernels (#1/#2), longer ones stream (#5-#7). The port's kernels take
    any lengths (no TPU tiling gate), so only an empty shape is refused."""
    return sa.supported(lq, lk)


class Attention(torch.nn.Module):
    """Attention projections: fused ``qkv`` (self-attention) or ``q``,
    ``k``, ``v`` (cross attention), and the output map ``o``."""

    def __init__(self, projections: dict):
        super().__init__()
        for name, lin in projections.items():
            self.add_module(name, lin)


def init_attention(gen, d_query: int, hidden: int, self_attention: bool,
                   d_memory: Optional[int] = None, out_map: bool = True,
                   bias: bool = True, weight_init=None) -> Attention:
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    proj = {}
    if self_attention:
        proj["qkv"] = nn.init_linear(gen, d_query, hidden * 3, bias=bias,
                                     weight_init=weight_init)
    else:
        d_memory = d_memory if d_memory is not None else d_query
        proj["q"] = nn.init_linear(gen, d_query, hidden, bias=bias,
                                   weight_init=weight_init)
        proj["k"] = nn.init_linear(gen, d_memory, hidden, bias=bias,
                                   weight_init=weight_init)
        proj["v"] = nn.init_linear(gen, d_memory, hidden, bias=bias,
                                   weight_init=weight_init)
    if out_map:
        proj["o"] = nn.init_linear(gen, hidden, hidden, bias=bias,
                                   weight_init=weight_init)
    return Attention(proj)


def init_rpr_tables(gen, hidden: int, num_heads: int,
                    max_relative_position: int,
                    weight_init=None) -> rpr_mod.RprTables:
    """RPR tables at per-head depth, hidden / heads."""
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    return rpr_mod.init_rpr(gen, max_relative_position, hidden // num_heads,
                            weight_init)


def _rpr_flash_ok(lq: int, lk: int, max_rel, causal, pad_mask) -> bool:
    """RPR rides the fused kernels where the JAX package lets it: the
    standard clipped-distance matrix (max_relative_position given), a mask
    that decomposes into a causal flag plus a key-side pad mask, and the
    kernel's geometry (fa.rpr_supported: 2m < Lk <= 8192)."""
    return (max_rel is not None and (causal or pad_mask is not None)
            and fa.rpr_supported(lq, lk, max_rel))


def _out_map(params: Attention, o):
    return nn.linear(params.o, o) if hasattr(params, "o") else o


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*Dh] -> [B, H, L, Dh]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _attn_core(q, k, v, keep_mask, num_heads, *, rng=None, drop=None,
               rpr_tables=None, rpr_ids=None, rpr_max=None):
    """Softmax attention on [B, L, hidden] projections, with dropout on the
    weights (8-bit threshold masks of ops/common.py:dropout).

    keep_mask: broadcastable to [B, 1, Lq, Lk]; 1 = attend, 0 = block; or
    a callable that builds it (models/common.py's lazy causal mask).
    RPR: with ``rpr_max`` the relative terms run in the bucket-one-hot
    form (ops/rpr.py); ``rpr_ids`` without ``rpr_max`` (decode rows) and
    shapes whose one-hot constant would be oversized take the gathered
    form. Returns ([B, Lq, hidden], weights [B, H, Lq, Lk])."""
    qh = split_heads(q, num_heads)
    kh = split_heads(k, num_heads)
    vh = split_heads(v, num_heads)
    dh = qh.shape[-1]
    qh = qh * (dh ** -0.5)
    lq, lk = qh.shape[2], kh.shape[2]

    use_onehot = (rpr_tables is not None and rpr_max is not None
                  and rpr_mod.onehot_supported(lq, lk, rpr_max))
    if rpr_tables is not None and not use_onehot and rpr_ids is None:
        rpr_ids = rpr_mod.relative_positions_matrix(lq, lk, rpr_max,
                                                    q.device)
    if use_onehot:
        logits = rpr_mod.logits_with_rpr_onehot(qh, kh, rpr_tables.keys,
                                                rpr_max)
    elif rpr_tables is not None:
        logits = rpr_mod.logits_with_rpr(
            qh, kh, rpr_mod.gather_embeddings(rpr_tables.keys, rpr_ids))
    else:
        logits = torch.matmul(qh, kh.transpose(-1, -2))
    logits = logits.float()
    if callable(keep_mask):
        keep_mask = keep_mask()
    if keep_mask is not None:
        logits = torch.where(keep_mask > 0, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    dweights = common.dropout(rng, weights, drop).to(q.dtype)
    if use_onehot:
        o = rpr_mod.output_with_rpr_onehot(dweights, vh, rpr_tables.values,
                                           rpr_max)
    elif rpr_tables is not None:
        o = rpr_mod.output_with_rpr(
            dweights, vh, rpr_mod.gather_embeddings(rpr_tables.values,
                                                    rpr_ids))
    else:
        o = torch.matmul(dweights, vh)
    return combine_heads(o), weights


def attn_train(params: Attention, query, memory, keep_mask, num_heads, *,
               rng=None, drop=None, use_flash=False, causal=False,
               pad_mask=None, rpr_tables=None, max_relative_position=None):
    """Full-sequence attention; memory=None -> self-attention through the
    fused qkv projection. keep_mask: [B or 1, 1, Lq, Lk] 1/0, or a callable
    that builds it (only the composite path calls it); the caller combines
    causal and padding.

    use_flash routes through the kernels (their plain versions for CPU
    tensors), whose mask is the causal flag plus the key-side [B, Lk]
    ``pad_mask`` the caller declares: up to ``fa.MAX_LK`` keys the fused
    kernels of ops/kernels/fused_attention.py, beyond them the streaming
    kernels of ops/kernels/streaming_attention.py, as the JAX package
    routes them (its ops/attention.py:288-314).

    rpr_tables (ops/rpr.py:RprTables) adds Shaw relative positions. With
    use_flash they ride the RPR kernels (#3/#4) only where _rpr_flash_ok
    holds, as in the JAX package; elsewhere (e.g. Lk <= 2m) the composite
    _attn_core runs; RPR never streams, so past fa.MAX_LK keys it takes
    _attn_core, as in JAX. Returns {'output', 'weights'} (weights None on
    the kernel paths)."""
    if memory is None:
        q, k, v = nn.linear(params.qkv, query).chunk(3, dim=-1)
    else:
        q = nn.linear(params.q, query)
        k = nn.linear(params.k, memory)
        v = nn.linear(params.v, memory)
    lq, lk = q.shape[1], k.shape[1]
    if use_flash and rpr_tables is not None:
        use_flash = _rpr_flash_ok(lq, lk, max_relative_position, causal,
                                  pad_mask)
    elif use_flash:
        use_flash = kernels_supported(lq, lk)
    if use_flash:
        drop_rate = float(drop) if (drop and rng is not None) else 0.0
        heads = [split_heads(x, num_heads) for x in (q, k, v)]
        if rpr_tables is None and lk > fa.MAX_LK:
            o = sa.streaming_attention(*heads, pad_mask, causal=causal,
                                       dropout_rate=drop_rate, rng=rng)
        else:
            o = fa.fused_attention(*heads, pad_mask, causal=causal,
                                   dropout_rate=drop_rate, rng=rng,
                                   rpr_tables=rpr_tables,
                                   max_relative_position=max_relative_position)
        o, weights = combine_heads(o.to(q.dtype)), None
    else:
        o, weights = _attn_core(q, k, v, keep_mask, num_heads, rng=rng,
                                drop=drop, rpr_tables=rpr_tables,
                                rpr_max=max_relative_position)
    return {"output": _out_map(params, o), "weights": weights}


# ---------------------------------------------------------------------------
# decode: static caches
# ---------------------------------------------------------------------------

def init_self_cache(batch: int, max_len: int, hidden: int, dtype, device):
    """Preallocated self-attention KV pool.

    The ``pool_`` prefix marks leaves that an ancestry-indexed beam reorder
    must NOT permute (models/common.py reorder_cache): each row's K/V stay
    where they were written and ``self_attn_step`` resolves beam ancestry
    at read time."""
    return {
        "pool_k": torch.zeros((batch, max_len, hidden), dtype=dtype,
                              device=device),
        "pool_v": torch.zeros((batch, max_len, hidden), dtype=dtype,
                              device=device),
    }


def _ancestry_attn(q, k, v, ancestry, time, num_heads, *, span=1,
                   rpr_tables=None, max_relative_position=None):
    """Self-attention over an UNPERMUTED beam KV pool via ancestry indices,
    in the masked flat form of the JAX package: the pool is one [K*T] key
    axis per sentence and (row j, position t) pairs that ancestry does not
    select are masked; the in-flight span [time, time+span) lives in each
    beam's own row. RPR adds the step's distance row, tiled over the K pool
    rows.

    q: [B*K, s, hidden]; k, v: [B*K, T, hidden] pools; ancestry: [B, K, T].
    """
    batch, beams, t_max = ancestry.shape
    s = q.shape[1]
    dev = q.device
    qh = split_heads(q, num_heads)                       # [B*K, H, s, dh]
    dh = qh.shape[-1]
    qh = (qh * (dh ** -0.5)).reshape(batch, beams, num_heads, s, dh)
    kh = split_heads(k.reshape(batch, beams * t_max, -1), num_heads)
    vh = split_heads(v.reshape(batch, beams * t_max, -1), num_heads)

    logits = torch.einsum("bihsd,bhjd->bhisj", qh, kh).float()

    pos = torch.arange(t_max, device=dev)
    rows = torch.arange(beams, device=dev)
    sel = ancestry[:, :, None, :] == rows[None, None, :, None]  # [B,i,j,t]
    ident = rows[:, None] == rows[None, :]
    in_span = (pos >= time) & (pos <= time + (s - 1))
    sel = torch.where(in_span[None, None, None, :], ident[None, :, :, None],
                      sel)
    keep = (sel & (pos <= time + (s - 1))[None, None, None, :]) \
        .reshape(batch, beams, beams * t_max)
    keep = keep[:, None, :, None, :]                     # [B,1,i,1,jt]

    if rpr_tables is not None:
        # the same distance row for every pool row j of a position t
        rpr_ids = rpr_mod.relative_positions_row(time, t_max,
                                                 max_relative_position, dev)
        r_k = rpr_mod.gather_embeddings(rpr_tables.keys, rpr_ids)
        r_k = r_k.repeat(1, beams, 1)                    # [1, K*T, dh]
        logits = logits + torch.einsum("bihsd,sjd->bhisj", qh,
                                       r_k.to(qh.dtype)).float()

    logits = torch.where(keep, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhisj,bhjd->bihsd", weights, vh)
    if rpr_tables is not None:
        r_v = rpr_mod.gather_embeddings(rpr_tables.values, rpr_ids)
        r_v = r_v.repeat(1, beams, 1)
        o = o + torch.einsum("bhisj,sjd->bihsd", weights, r_v.to(q.dtype))
    return combine_heads(o.reshape(batch * beams, num_heads, s, dh))


def self_attn_step(params: Attention, x_t, cache, time: int, num_heads, *,
                   use_flash=False, rpr_tables=None,
                   max_relative_position=None):
    """One-step self-attention with a static cache.

    x_t: [B, 1, d]; cache: {'pool_k','pool_v': [B, T_max, hidden]}, written
    IN PLACE at position ``time``; attends over positions <= time. Returns
    (output [B, 1, hidden], cache).

    cache['ancestry'] ([B, K, T] int32, injected by the skeleton's
    decode_step) switches beam decode to the ancestry-indexed pools, which
    are never beam-permuted. use_flash routes single-position steps through
    the decode kernels of ops/kernels/decode_attention.py (their plain
    versions for CPU tensors); RPR (``rpr_tables``) keeps both kernels off,
    as in the JAX package; otherwise the plain attention code here runs.
    """
    q, k_t, v_t = nn.linear(params.qkv, x_t).chunk(3, dim=-1)
    span = x_t.shape[1]
    k, v = cache["pool_k"], cache["pool_v"]
    k[:, time:time + span] = k_t.to(k.dtype)
    v[:, time:time + span] = v_t.to(v.dtype)
    t_max, hidden = k.shape[1], k.shape[2]
    use_kernel = use_flash and span == 1 and rpr_tables is None

    ancestry = cache.get("ancestry")
    if ancestry is not None and ancestry.shape[1] > 1:
        batch, beams = ancestry.shape[:2]
        if use_kernel:
            # the in-flight position lives in each beam's own row: set the
            # ancestry column at ``time`` to identity for the kernel
            anc_eff = ancestry.clone()
            anc_eff[:, :, time] = torch.arange(beams, dtype=ancestry.dtype,
                                               device=ancestry.device)
            o = da.decode_pool_attention(
                q.reshape(batch, beams, hidden).contiguous(),
                k.view(batch, beams, t_max, hidden),
                v.view(batch, beams, t_max, hidden),
                anc_eff, time, num_heads)
            o = o.reshape(batch * beams, 1, hidden)
        else:
            o = _ancestry_attn(q, k, v, ancestry, time, num_heads, span=span,
                               rpr_tables=rpr_tables,
                               max_relative_position=max_relative_position)
    elif use_kernel:
        o = da.decode_attention(q.contiguous(), k, v, time, num_heads)
    else:
        # multi-position steps may attend across all freshly-written slots
        keep = (torch.arange(t_max, device=k.device) <= time + (span - 1)) \
            .float()[None, None, None, :]
        rpr_ids = None
        if rpr_tables is not None:
            rpr_ids = rpr_mod.relative_positions_row(
                time, t_max, max_relative_position, k.device)
        o, _ = _attn_core(q, k, v, keep, num_heads, rpr_tables=rpr_tables,
                          rpr_ids=rpr_ids)
    return _out_map(params, o), cache


def cross_attn_precompute(params: Attention, memory):
    """Memory-side projections, computed once per sentence."""
    return {"mk": nn.linear(params.k, memory),
            "mv": nn.linear(params.v, memory)}


def cross_attn_step(params: Attention, x_t, mkv, mem_keep, num_heads, *,
                    time=None, rpr_tables=None, max_relative_position=None):
    """One-step cross attention over precomputed memory projections.

    The memory stays UNTILED at [B, S, hidden] while queries come per beam
    at [B*K, 1, hidden]: the beams fold into the query-length dimension,
    so k/v are read once per sentence instead of once per beam.
    mem_keep: [B, S] 1/0 pad mask. rpr_tables: relative positions between
    decode step ``time`` and the memory positions. Returns
    [B*K, 1, hidden]."""
    q = nn.linear(params.q, x_t)
    mem_batch = mkv["mk"].shape[0]
    q_batch = q.shape[0]
    beams = q_batch // mem_batch
    q2 = q.reshape(mem_batch, beams * q.shape[1], q.shape[2])
    keep = mem_keep.float()[:, None, None, :]
    rpr_ids = None
    if rpr_tables is not None:
        # the same decode position for every beam-query row
        rpr_ids = rpr_mod.relative_positions_row(
            time, mkv["mk"].shape[1], max_relative_position,
            q.device).repeat(q2.shape[1], 1)
    o, _ = _attn_core(q2, mkv["mk"], mkv["mv"], keep, num_heads,
                      rpr_tables=rpr_tables, rpr_ids=rpr_ids)
    o = o.reshape(q_batch, q.shape[1], -1)
    return _out_map(params, o)
