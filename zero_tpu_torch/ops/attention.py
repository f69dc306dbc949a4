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
from zero_tpu_torch.ops.kernels import decode_attention as da
from zero_tpu_torch.ops.kernels import fused_attention as fa

NEG_INF = da.NEG_INF


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


def _attn_core(q, k, v, keep_mask, num_heads, *, rng=None, drop=None):
    """Softmax attention on [B, L, hidden] projections, with dropout on the
    weights (8-bit threshold masks of ops/common.py:dropout).

    keep_mask: broadcastable to [B, 1, Lq, Lk]; 1 = attend, 0 = block.
    Returns ([B, Lq, hidden], weights [B, H, Lq, Lk])."""
    qh = split_heads(q, num_heads)
    kh = split_heads(k, num_heads)
    vh = split_heads(v, num_heads)
    dh = qh.shape[-1]
    qh = qh * (dh ** -0.5)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()
    if keep_mask is not None:
        logits = torch.where(keep_mask > 0, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    dweights = common.dropout(rng, weights, drop).to(q.dtype)
    o = torch.matmul(dweights, vh)
    return combine_heads(o), weights


def attn_train(params: Attention, query, memory, keep_mask, num_heads, *,
               rng=None, drop=None, use_flash=False, causal=False,
               pad_mask=None):
    """Full-sequence attention; memory=None -> self-attention through the
    fused qkv projection. keep_mask: [B or 1, 1, Lq, Lk] 1/0; the caller
    combines causal and padding.

    use_flash routes through the fused kernels of
    ops/kernels/fused_attention.py (their plain version for CPU tensors),
    whose mask is the causal flag plus the key-side [B, Lk] ``pad_mask``
    the caller declares. Keys beyond the fused kernel's 8192 raise: the
    JAX package streams them through kernels #5-#7, not ported yet.
    Returns {'output', 'weights'} (weights None on the fused path)."""
    if memory is None:
        q, k, v = nn.linear(params.qkv, query).chunk(3, dim=-1)
    else:
        q = nn.linear(params.q, query)
        k = nn.linear(params.k, memory)
        v = nn.linear(params.v, memory)
    if use_flash:
        if k.shape[1] > fa.MAX_LK:
            raise NotImplementedError(
                "attention over %d > %d keys needs the streaming-attention "
                "kernels (#5-#7 of zero_tpu/ops/kernels/"
                "streaming_attention.py), not ported yet"
                % (k.shape[1], fa.MAX_LK))
        drop_rate = float(drop) if (drop and rng is not None) else 0.0
        o = fa.fused_attention(split_heads(q, num_heads),
                               split_heads(k, num_heads),
                               split_heads(v, num_heads), pad_mask,
                               causal=causal, dropout_rate=drop_rate, rng=rng)
        o, weights = combine_heads(o.to(q.dtype)), None
    else:
        o, weights = _attn_core(q, k, v, keep_mask, num_heads, rng=rng,
                                drop=drop)
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


def _ancestry_attn(q, k, v, ancestry, time, num_heads, *, span=1):
    """Self-attention over an UNPERMUTED beam KV pool via ancestry indices,
    in the masked flat form of the JAX package: the pool is one [K*T] key
    axis per sentence and (row j, position t) pairs that ancestry does not
    select are masked; the in-flight span [time, time+span) lives in each
    beam's own row.

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

    logits = torch.where(keep, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhisj,bhjd->bihsd", weights, vh)
    return combine_heads(o.reshape(batch * beams, num_heads, s, dh))


def self_attn_step(params: Attention, x_t, cache, time: int, num_heads, *,
                   use_flash=False):
    """One-step self-attention with a static cache.

    x_t: [B, 1, d]; cache: {'pool_k','pool_v': [B, T_max, hidden]}, written
    IN PLACE at position ``time``; attends over positions <= time. Returns
    (output [B, 1, hidden], cache).

    cache['ancestry'] ([B, K, T] int32, injected by the skeleton's
    decode_step) switches beam decode to the ancestry-indexed pools, which
    are never beam-permuted. use_flash routes single-position steps through
    the decode kernels of ops/kernels/decode_attention.py (their plain
    versions for CPU tensors); otherwise the plain attention code here runs.
    """
    q, k_t, v_t = nn.linear(params.qkv, x_t).chunk(3, dim=-1)
    span = x_t.shape[1]
    k, v = cache["pool_k"], cache["pool_v"]
    k[:, time:time + span] = k_t.to(k.dtype)
    v[:, time:time + span] = v_t.to(v.dtype)
    t_max, hidden = k.shape[1], k.shape[2]

    ancestry = cache.get("ancestry")
    if ancestry is not None and ancestry.shape[1] > 1:
        batch, beams = ancestry.shape[:2]
        if use_flash and span == 1:
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
            o = _ancestry_attn(q, k, v, ancestry, time, num_heads, span=span)
    elif use_flash and span == 1:
        o = da.decode_attention(q.contiguous(), k, v, time, num_heads)
    else:
        # multi-position steps may attend across all freshly-written slots
        keep = (torch.arange(t_max, device=k.device) <= time + (span - 1)) \
            .float()[None, None, None, :]
        o, _ = _attn_core(q, k, v, keep, num_heads)
    return _out_map(params, o), cache


def cross_attn_precompute(params: Attention, memory):
    """Memory-side projections, computed once per sentence."""
    return {"mk": nn.linear(params.k, memory),
            "mv": nn.linear(params.v, memory)}


def cross_attn_step(params: Attention, x_t, mkv, mem_keep, num_heads):
    """One-step cross attention over precomputed memory projections.

    The memory stays UNTILED at [B, S, hidden] while queries come per beam
    at [B*K, 1, hidden]: the beams fold into the query-length dimension,
    so k/v are read once per sentence instead of once per beam.
    mem_keep: [B, S] 1/0 pad mask. Returns [B*K, 1, hidden]."""
    q = nn.linear(params.q, x_t)
    mem_batch = mkv["mk"].shape[0]
    q_batch = q.shape[0]
    beams = q_batch // mem_batch
    q2 = q.reshape(mem_batch, beams * q.shape[1], q.shape[2])
    keep = mem_keep.float()[:, None, None, :]
    o, _ = _attn_core(q2, mkv["mk"], mkv["mv"], keep, num_heads)
    o = o.reshape(q_batch, q.shape[1], -1)
    return _out_map(params, o)
