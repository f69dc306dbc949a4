"""Multi-head attention: full-sequence (training, scoring, the encoder,
``decode_prefix``) and static-cache decoding.

Counterpart of ``zero_tpu/ops/attention.py`` for the post-LN Transformer:
the softmax path, ReLA's (``relu=True``: multiply-masked relu weights and
the gated-RMSNorm epilogue ``post``), the merged attention of
transformer_fuse (cross attention plus the AAN cumulative average of the
query side through the shared ``v`` projection; at decode an O(1) running
sum) and L0Drop's count softmax (``count_weights``). The decode KV cache is
PREALLOCATED at [B, T_max, hidden] and written at the current step -- in
place here, where JAX returns an updated copy; validity is a ``position <=
time`` mask. Softmax runs in fp32 regardless of the compute dtype.
Self-attention uses one fused qkv projection; cross attention computes the
memory k/v once at encode time.

Tensor parallelism (``attn_train``; parallel/tensor.py): where the
projections are column-split, a process holds its heads' columns of q,
k and v (of the fused qkv: three blocks) and of ReLA's epilogue, runs
attention over those heads (the kernels too, at the whole heads' dropout
rows) and the row-split output map sums its partial product over the
line.

Sequence parallelism (``attn_train`` under ops/common.py:seq_parallel):
the query is this process's block of the sequence. A self-attention runs
the ring of parallel/ring.py, before the kernel or composite branch, as
the JAX package's does, over the process's heads under TP too; a
cross-attention runs the block's queries against the whole (gathered)
memory, its dropout rows and (RPR) its distances the whole sequence's, on
the kernels under ``use_flash`` as in one process. A self-attention the
ring cannot take raises: it must never attend within a block alone.
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
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import ring
from zero_tpu_torch.parallel import tensor as tp

NEG_INF = da.NEG_INF


def kernels_supported(lq: int, lk: int) -> bool:
    """Fused-kernel eligibility: keys up to ``fa.MAX_LK`` ride the fused
    kernels (#1/#2), longer ones stream (#5-#7). The port's kernels take
    any lengths (no TPU tiling gate), so only an empty shape is refused."""
    return sa.supported(lq, lk)


class Attention(torch.nn.Module):
    """Attention projections: fused ``qkv`` (self-attention) or ``q``,
    ``k``, ``v`` (cross attention), the output map ``o``, and ReLA's
    epilogue ``post``."""

    def __init__(self, projections: dict):
        super().__init__()
        for name, lin in projections.items():
            self.add_module(name, lin)


class GatedRmsNorm(torch.nn.Module):
    """ReLA's epilogue parameters: ``scale`` and ``gate``, [hidden]."""

    def __init__(self, scale: torch.Tensor, gate: torch.Tensor):
        super().__init__()
        self.scale = torch.nn.Parameter(scale)
        self.gate = torch.nn.Parameter(gate)


def init_attention(gen, d_query: int, hidden: int, self_attention: bool,
                   d_memory: Optional[int] = None, fuse: bool = False,
                   out_map: bool = True, bias: bool = True, weight_init=None,
                   out_init=None, rela: bool = False) -> Attention:
    """``fuse`` adds no parameter (the merged attention reuses ``v`` on the
    query side). ``out_init`` overrides the initializer of ``o`` (Fixup's
    zeros). ``rela`` adds the gated-RMSNorm epilogue ``post`` (scale ones,
    gate from ``weight_init``)."""
    del fuse
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
                                   weight_init=out_init or weight_init)
    if rela:
        proj["post"] = GatedRmsNorm(torch.ones(hidden),
                                    weight_init(gen, (hidden,)))
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


def _out_map(params: Attention, o, relu=False, aan=None, part=None):
    """ReLA's epilogue (relu attention with ``post`` params), the merged
    attention's AAN add-on ``aan``, then the output map (row-parallel
    over ``part``'s line where ``o`` holds a process's heads)."""
    if relu and hasattr(params, "post"):
        o = gated_rms_norm(params.post, o, part=part)
    if aan is not None:
        o = o + aan
    return tp.row_linear(params.o, o) if hasattr(params, "o") else o


def gated_rms_norm(params: GatedRmsNorm, x, eps: float = 1e-8, part=None):
    """ReLA epilogue, in fp32: scale * x * rsqrt(mean(x^2) + eps) *
    sigmoid(gate * x). With ``part`` (tensor parallelism) ``x`` is a
    process's slice of the hidden width: its sum of squares is summed over
    the line and the replicated ``scale`` and ``gate`` are sliced."""
    xf = x.float()
    scale, gate = params.scale.float(), params.gate.float()
    if part is None:
        ms = xf.square().mean(dim=-1, keepdim=True)
    else:
        width = xf.shape[-1]
        ms = dist.sum_both(xf.square().sum(dim=-1, keepdim=True),
                           part.axis) / (width * part.degree)
        lo = part.offset(width)
        scale = dist.copy_in(scale, part.axis)[lo:lo + width]
        gate = dist.copy_in(gate, part.axis)[lo:lo + width]
    out = scale * xf * torch.rsqrt(ms + eps) * torch.sigmoid(gate * xf)
    return out.to(x.dtype)


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


def promote(q, k, v):
    """q, k and v in the widest of their dtypes, as the JAX package's
    products of mixed dtypes promote: transformer_ibdecoder's decoder runs
    in fp32 under a bf16 compute dtype (its fp32 positions promote the
    embeddings) over a bf16 encoder memory and a bf16 decode cache."""
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _attn_core(q, k, v, keep_mask, num_heads, *, rng=None, drop=None,
               rpr_tables=None, rpr_ids=None, rpr_max=None, relu=False,
               count_weights=None, heads=None, qrows=None):
    """Softmax attention on [B, L, hidden] projections, with dropout on the
    weights (8-bit threshold masks of ops/common.py:dropout). relu=True
    switches to ReLA's weights: logits times the keep-mask, then relu.
    count_weights [B, Lk] multiplies the exp-logits before they are
    normalised (L0Drop's count softmax over a compacted memory).

    keep_mask: broadcastable to [B, 1, Lq, Lk]; 1 = attend, 0 = block; or
    a callable that builds it (models/common.py's lazy causal mask).
    RPR: with ``rpr_max`` the relative terms run in the bucket-one-hot
    form (ops/rpr.py); ``rpr_ids`` without ``rpr_max`` (decode rows) and
    shapes whose one-hot constant would be oversized take the gathered
    form. ``heads`` = (offset, whole count): the num_heads heads are a
    process's part (tensor parallelism), whose dropout draws index the
    whole heads; ``qrows`` = (offset, whole length): the Lq queries are a
    block of the sequence (sequence parallelism), whose draws index the
    whole sequence. Returns ([B, Lq, hidden], weights [B, H, Lq, Lk])."""
    q, k, v = promote(q, k, v)
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
    if relu:
        if keep_mask is not None:
            logits = logits * keep_mask.float()
        weights = torch.relu(logits)
    elif count_weights is not None:
        if keep_mask is not None:
            logits = torch.where(keep_mask > 0, logits, NEG_INF)
        logits = logits - logits.amax(dim=-1, keepdim=True)
        exp = torch.exp(logits) * count_weights.float()[:, None, None, :]
        weights = exp / exp.sum(dim=-1, keepdim=True)
    else:
        if keep_mask is not None:
            logits = torch.where(keep_mask > 0, logits, NEG_INF)
        weights = torch.softmax(logits, dim=-1)
    splits = [] if heads is None else [(1,) + tuple(heads)]
    if qrows is not None:
        splits.append((2,) + tuple(qrows))
    dweights = common.dropout(rng, weights, drop, split=splits).to(q.dtype)
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
               pad_mask=None, rpr_tables=None, max_relative_position=None,
               relu=False, fuse_weight=None, fuse_mask=None,
               count_weights=None):
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
    _attn_core, as in JAX. ReLA (``relu``) keeps _attn_core at every
    length, use_flash or not, as the JAX package does; its epilogue runs
    before the output map.

    The merged attention (transformer_fuse) adds the AAN average of the
    query side through the shared ``v`` projection before the output map:
    ``fuse_mask`` is the raw [B, Lq] target pad mask (the O(L) masked
    cumulative mean, nn.aan_cummean), ``fuse_weight`` a [B, Lq, Lq]
    averaging matrix. count_weights (L0Drop's count softmax) keeps the
    composite, as in the JAX package. Under tensor parallelism (a
    column-split qkv or q) the process attends over its num_heads / W
    heads, every route included. Returns {'output', 'weights'} (weights
    None on the kernel paths)."""
    part = tp.column(params.qkv if memory is None else params.q)
    heads = None
    if part is not None:
        if num_heads % part.degree:
            raise ValueError("num_heads %d is not divisible by mesh_%s %d"
                             % (num_heads, part.axis, part.degree))
        query = dist.copy_in(query, part.axis)
        if memory is not None:
            memory = dist.copy_in(memory, part.axis)
        local = num_heads // part.degree
        heads = (part.offset(local), num_heads)
        num_heads = local
        if rpr_tables is not None:
            # every head reads the replicated tables: their gradient is
            # summed over the line
            rpr_tables = rpr_mod.TableView(
                dist.copy_in(rpr_tables.keys, part.axis),
                dist.copy_in(rpr_tables.values, part.axis))
    if memory is None:
        q, k, v = nn.linear(params.qkv, query).chunk(3, dim=-1)
    else:
        q = nn.linear(params.q, query)
        k = nn.linear(params.k, memory)
        v = nn.linear(params.v, memory)
    q, k, v = promote(q, k, v)
    lq, lk = q.shape[1], k.shape[1]
    qrows = rpr_ids = None
    if common.seq_degree() > 1:
        if memory is None:
            return _ring_self_attention(
                params, q, k, v, num_heads, rng=rng, drop=drop,
                use_flash=use_flash, causal=causal, pad_mask=pad_mask,
                rpr_tables=rpr_tables, max_rel=max_relative_position,
                relu=relu, fuse=fuse_weight is not None
                or fuse_mask is not None, count_weights=count_weights,
                heads=heads, part=part)
        split = common.seq_split(1, lq)
        qrows = (split[1], split[2])
    use_flash = use_flash and not relu and count_weights is None
    if use_flash and rpr_tables is not None:
        use_flash = _rpr_flash_ok(lq, lk, max_relative_position, causal,
                                  pad_mask)
    elif use_flash:
        use_flash = kernels_supported(lq, lk)
    if use_flash:
        drop_rate = float(drop) if (drop and rng is not None) else 0.0
        qkv = [split_heads(x, num_heads) for x in (q, k, v)]
        if rpr_tables is None and lk > fa.MAX_LK:
            o = sa.streaming_attention(*qkv, pad_mask, causal=causal,
                                       dropout_rate=drop_rate, rng=rng,
                                       heads=heads, qrows=qrows)
        else:
            o = fa.fused_attention(*qkv, pad_mask, causal=causal,
                                   dropout_rate=drop_rate, rng=rng,
                                   rpr_tables=rpr_tables,
                                   max_relative_position=max_relative_position,
                                   heads=heads, qrows=qrows)
        o, weights = combine_heads(o.to(q.dtype)), None
    else:
        if qrows is not None and rpr_tables is not None:
            # the block's distances from its global query positions
            rpr_ids = rpr_mod.relative_positions_matrix(
                lq, lk, max_relative_position, q.device, qrows[0])
        o, weights = _attn_core(
            q, k, v, keep_mask, num_heads, rng=rng, drop=drop,
            rpr_tables=rpr_tables, rpr_ids=rpr_ids,
            rpr_max=max_relative_position if rpr_ids is None else None,
            relu=relu, count_weights=count_weights, heads=heads, qrows=qrows)
    aan = None
    if fuse_mask is not None:
        aan = nn.aan_cummean(nn.linear(params.v, query), fuse_mask,
                             masked=True)
    elif fuse_weight is not None:
        v_q = nn.linear(params.v, query)
        aan = torch.einsum("bqk,bkd->bqd", fuse_weight.to(v_q.dtype), v_q)
    return {"output": _out_map(params, o, relu, aan, part),
            "weights": weights}


def _ring_self_attention(params: Attention, q, k, v, num_heads, *,
                         rng, drop, use_flash, causal, pad_mask, rpr_tables,
                         max_rel, relu, fuse, count_weights, heads, part):
    """A self-attention over this process's block of the sequence: the ring
    (parallel/ring.py), its blocks on #5-#7 under ``use_flash`` in softmax
    mode; the epilogue as attn_train's. A mask the ring cannot take (no
    causal flag or key pad mask declared, L0Drop's count softmax, the
    merged attention, RPR without its clipping distance) raises, and so
    does a shape that fails ring.ring_route_ok (the JAX ring's rule)."""
    if (count_weights is not None or fuse
            or not (causal or pad_mask is not None)
            or (rpr_tables is not None and max_rel is None)):
        raise ValueError(
            "self-attention variant is not ring-capable under mesh_seq=%d: "
            "its mask does not decompose into a causal flag and a key pad "
            "mask (it would attend within a sequence block alone)"
            % common.seq_degree())
    whole = q.shape[1] * common.seq_degree()
    batch = q.shape[0] * dist.grid().degree("data")
    heads_total = num_heads if heads is None else heads[1]
    if not ring.ring_route_ok(batch, heads_total, whole, whole):
        raise ValueError(
            "self-attention of batch %d, %d heads and length %d does not "
            "take the ring under mesh_seq=%d" % (batch, heads_total, whole,
                                                 common.seq_degree()))
    qh, kh, vh = (split_heads(x, num_heads) for x in (q, k, v))
    o = ring.ring_attention(
        qh, kh, vh, pad_mask, causal=causal, words=rng, drop=drop,
        relu=relu, max_rel=max_rel, heads=heads, use_kernels=use_flash,
        rpr_tables=None if rpr_tables is None else (rpr_tables.keys,
                                                    rpr_tables.values))
    return {"output": _out_map(params, combine_heads(o.to(q.dtype)), relu,
                               None, part),
            "weights": None}


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
                   rpr_tables=None, max_relative_position=None, relu=False):
    """Self-attention over an UNPERMUTED beam KV pool via ancestry indices,
    in the masked flat form of the JAX package: the pool is one [K*T] key
    axis per sentence and (row j, position t) pairs that ancestry does not
    select are masked; the in-flight span [time, time+span) lives in each
    beam's own row. RPR adds the step's distance row, tiled over the K pool
    rows. relu: ReLA's weights, the logits times the selection, then relu.

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

    if relu:
        weights = torch.relu(logits * keep.float())
    else:
        weights = torch.softmax(torch.where(keep, logits, NEG_INF), dim=-1)
    weights = weights.to(q.dtype)
    o = torch.einsum("bhisj,bhjd->bihsd", weights, vh)
    if rpr_tables is not None:
        r_v = rpr_mod.gather_embeddings(rpr_tables.values, rpr_ids)
        r_v = r_v.repeat(1, beams, 1)
        o = o + torch.einsum("bhisj,sjd->bihsd", weights, r_v.to(q.dtype))
    return combine_heads(o.reshape(batch * beams, num_heads, s, dh))


def self_attn_step(params: Attention, x_t, cache, time: int, num_heads, *,
                   use_flash=False, rpr_tables=None,
                   max_relative_position=None, relu=False):
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
    ReLA (``relu``) takes the pool kernel's relu mode on the ancestry pools
    and never the single-beam kernel, as in the JAX package.
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
                anc_eff, time, num_heads, relu=relu)
            o = o.reshape(batch * beams, 1, hidden)
        else:
            o = _ancestry_attn(q, k, v, ancestry, time, num_heads, span=span,
                               rpr_tables=rpr_tables,
                               max_relative_position=max_relative_position,
                               relu=relu)
    elif use_kernel and not relu:
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
                          rpr_ids=rpr_ids, relu=relu)
    return _out_map(params, o, relu), cache


def cross_attn_precompute(params: Attention, memory):
    """Memory-side projections, computed once per sentence."""
    return {"mk": nn.linear(params.k, memory),
            "mv": nn.linear(params.v, memory)}


def cross_attn_step(params: Attention, x_t, mkv, mem_keep, num_heads, *,
                    time=None, rpr_tables=None, max_relative_position=None,
                    relu=False, aan_sum=None, count_weights=None):
    """One-step cross attention over precomputed memory projections.

    The memory stays UNTILED at [B, S, hidden] while queries come per beam
    at [B*K, 1, hidden]: the beams fold into the query-length dimension,
    so k/v are read once per sentence instead of once per beam.
    mem_keep: [B, S] 1/0 pad mask. rpr_tables: relative positions between
    decode step ``time`` and the memory positions. relu: ReLA's weights
    and epilogue. count_weights: [B, S] exp-weights of L0Drop's count
    softmax. Returns [B*K, 1, hidden].

    aan_sum ([B*K, 1, hidden], the merged attention's running sum of the
    query side's ``v`` projections) adds (aan_sum + v_q) / (time + 1),
    divided in the compute dtype, and makes the return a pair (output,
    the new running sum)."""
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
                      rpr_tables=rpr_tables, rpr_ids=rpr_ids, relu=relu,
                      count_weights=count_weights)
    o = o.reshape(q_batch, q.shape[1], -1)
    if aan_sum is None:
        return _out_map(params, o, relu)
    new_sum = aan_sum + nn.linear(params.v, x_t)
    aan = new_sum / nn.aan_step_count(time, new_sum.dtype)
    return _out_map(params, o, relu, aan), new_sum


# ---------------------------------------------------------------------------
# additive (Bahdanau) attention of the RNN decoders
# ---------------------------------------------------------------------------

class AdditiveAttention(torch.nn.Module):
    """``feed_memory`` (unused where the caller passes the memory's
    projection, as every RNN model does), ``feed_query`` and
    ``feed_logits`` (per-head depth -> 1)."""

    def __init__(self, feed_memory, feed_query, feed_logits):
        super().__init__()
        self.feed_memory = feed_memory
        self.feed_query = feed_query
        self.feed_logits = feed_logits


def init_additive_attention(gen, d_query: int, d_memory: int, hidden: int,
                            num_heads: int = 1,
                            weight_init=None) -> AdditiveAttention:
    return AdditiveAttention(
        nn.init_linear(gen, d_memory, hidden, weight_init=weight_init),
        nn.init_linear(gen, d_query, hidden, weight_init=weight_init),
        nn.init_linear(gen, hidden // num_heads, 1, weight_init=weight_init))


def additive_attention(params: AdditiveAttention, query, memory, mem_mask,
                       num_heads: int = 1, *, proj_memory=None, rng=None,
                       drop=None):
    """Bahdanau attention, ``zero_tpu/ops/attention.py:additive_attention``.

    query: [B, d] or [B*K, d] against the untiled memory [B, S, dm] (the
    K beams fold into a query axis, so the memory is read once a row);
    mem_mask: [B, S]. Pads get logit -1e9 in fp32, so an all-pad row
    averages every position. Returns {'output': [B(*K), dm], 'weights':
    [B(*K), H, S], 'cache_state': the projected memory}."""
    if proj_memory is None:
        proj_memory = nn.linear(params.feed_memory, memory)
    mem_batch = memory.shape[0]
    beams = query.shape[0] // mem_batch
    q = nn.linear(params.feed_query, query).reshape(mem_batch, beams, -1)
    qh = split_heads(q, num_heads)                     # [B, H, K, hidden/H]
    pmh = split_heads(proj_memory, num_heads)          # [B, H, S, hidden/H]
    value = torch.tanh(qh[:, :, :, None, :] + pmh[:, :, None, :, :])
    logits = nn.linear(params.feed_logits, value)[..., 0].float()
    logits = logits.masked_fill(mem_mask[:, None, None, :] <= 0, -1e9)
    weights = torch.softmax(logits, dim=-1)            # [B, H, K, S]
    dweights = common.dropout(rng, weights, drop)
    mh = split_heads(memory, num_heads)                # [B, H, S, dm/H]
    out = torch.einsum("bhks,bhsd->bkhd", dweights.to(memory.dtype), mh)
    out = out.reshape(query.shape[0], -1)              # [B*K, dm]
    weights = weights.transpose(1, 2).reshape(query.shape[0], num_heads, -1)
    return {"weights": weights, "output": out, "cache_state": proj_memory}
