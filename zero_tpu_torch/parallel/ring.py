"""Ring attention: sequence-parallel self-attention over the 'seq' line.

Counterpart of ``zero_tpu/parallel/ring.py``. Under ``mesh_seq`` = n > 1
each process of a seq line holds block ``coord`` of every sequence
(ops/common.py:seq_parallel): q, k and v are [B, H, L/n, Dh] blocks. The
ring runs n steps; at step s a process holds the K/V block of owner
``(coord - s) % n`` and merges that block's attention into its rows, then
passes K and V to the next process (parallel/distributed.py:ring_shift).
The backward runs a second ring in the same order, with the gradients
dK and dV travelling with their block; a last shift brings each block's
gradients home. No [L, L] score tensor and no gathered K/V exist.

Semantics (``_block_attn`` of the JAX ring):
  * masked logits are -1e9 (the key pad mask, and the causal flag compared
    by global position), so a row with no valid key in any block gets the
    uniform average over all L keys, and no NaN;
  * fp32 accumulation; the blocks merge by their row max m and sum l
    (o = sum_b o_b l_b e^(m_b - M) / sum_b l_b e^(m_b - M));
  * ReLA's mode (``relu``): multiply-masked relu weights, no
    normalisation, so the blocks simply add;
  * RPR's mode (``rpr``): Shaw's terms from the blocks' global positions;
  * attention dropout draws block (me, owner)'s mask from the seed words
    ``fold_in(fold_in(words, me), owner)`` (JAX's threefry fold_in,
    ops/common.py) over the block's [B, H, L/n, L/n] weights, the batch
    rows and heads global (``_hash_bits``): bit for bit the JAX ring's.

Blocks above the diagonal of a causal ring are skipped (the K/V still
travel) where they add exactly nothing: in ReLA's mode and on the kernel
route, whose causal rows see only their earlier keys. The JAX ring's
softmax visits them, as a row with no valid key averages over all L.

The kernel route (``use_flash_attention``, softmax mode): each block is one
launch of the streaming forward #5 (ops/kernels/streaming_attention.py,
on the route ``sa.route`` picks), the diagonal block under the causal flag
and a lower block without it; the backward launches #6 and #7 per block
against the merged m and l, the final o and delta. Its masks are the
kernels' (-1e30, a causal row's later keys absent) and its dropout the
kernels' row-seeded family from the block's folded words, so it equals
the plain ring at dropout 0 and the plain kernel-form ring (``family``
"kernel", run on CPU tensors) at any rate. A CUDA tensor on the kernel
route launches the kernels or raises. RPR and ReLA blocks stay plain on
the card, as the JAX ring is XLA there (ROADMAP.md section 3).

The plain backward recomputes each block under autograd against the
final M, L and delta: the surrogate sum(dO * num_b) - sum(delta * den_b)
(num_b the block's dropped weights times V, den_b its softmax weights)
has the block's exact gradients, whatever the mode.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, NamedTuple, Optional

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops.kernels import streaming_attention as sa
from zero_tpu_torch.parallel import distributed as dist

NEG = -1e9           # the JAX ring's masked logits
KERNEL_NEG = sa.NEG_INF

launches: collections.Counter = collections.Counter()


def seq_degree() -> int:
    """The number of blocks of a sequence under the active split (1 =
    sequence parallelism off)."""
    return common.seq_degree()


def ring_route_ok(batch: int, num_heads: int, lq: int, lk: int,
                  degrees: Optional[dict] = None) -> bool:
    """The JAX ring's route rule (``ring_route_ok``) over whole lengths:
    a seq degree above 1, a self-attention shape (lq == lk) that the
    degree divides, and a batch and head count that the data and model
    degrees divide. ``degrees``: {axis: degree}, the current grid's by
    default."""
    if degrees is None:
        g = dist.grid()
        degrees = {a: g.degree(a) for a in ("data", "model")}
        degrees["seq"] = seq_degree()
    n = int(degrees.get("seq", 1))
    return (n > 1 and lq == lk and lq % n == 0 and lk % n == 0
            and batch % int(degrees.get("data", 1)) == 0
            and num_heads % int(degrees.get("model", 1)) == 0)


class Opts(NamedTuple):
    keep: torch.Tensor          # [B, L] whole key pad mask (1 = attend)
    causal: bool
    words: Optional[tuple]      # the site's seed words (None: no dropout)
    drop: float
    relu: bool
    max_rel: Optional[int]
    heads: Optional[tuple]      # (offset, whole count) of the H heads
    family: str                 # "jax" (the JAX ring) or "kernel"
    route: str                  # "plain", "cuda_cores" or "tensor_cores"
    me: int                     # this block's place in the line
    n: int                      # the line's length
    shift: Callable             # distributed.ring_shift's contract


def block_words(words, me: int, owner: int):
    """The seed words of block (me, owner): fold_in(fold_in(words, me),
    owner)."""
    return common.fold_in(common.fold_in(words, me), owner)


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


def _scores(q, k, keep, qpos, kpos, o: Opts, tk=None):
    """Masked fp32 scores [B, H, lq, lk] of one block (q, k fp32, the
    Dh^-0.5 scale inside), with RPR's key term; in ReLA's mode the raw
    logits and the multiplicative mask instead."""
    qs = q * (q.shape[-1] ** -0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k)
    if tk is not None:
        ids = torch.clamp(qpos[:, None] - kpos[None, :], -o.max_rel,
                          o.max_rel) + o.max_rel
        s = s + torch.einsum("bhqd,qkd->bhqk", qs, tk.float()[ids])
    allowed = (kpos[None, :] <= qpos[:, None]) if o.causal else None
    if o.relu:
        mult = keep[:, None, None, :].float()
        if allowed is not None:
            mult = mult * allowed[None, None].float()
        return s, mult
    neg = NEG if o.family == "jax" else KERNEL_NEG
    s = torch.where(keep[:, None, None, :] > 0, s, neg)
    if allowed is not None:
        # the JAX ring masks a causal key at -1e9; the kernels leave it out
        s = torch.where(allowed[None, None], s,
                        NEG if o.family == "jax" else float("-inf"))
    return s, None


def _dropped(w, words, o: Opts):
    """The block's weights w [B, H, lq, lk] under its dropout mask."""
    if words is None or not o.drop:
        return w
    if o.family == "jax":
        split = None if o.heads is None else (1,) + tuple(o.heads)
        return common.dropout(words, w, o.drop, split=split)
    b, h, lq, lk = w.shape
    keep = sa.keep_mask(words, b * h, lq, range(lq), lk, o.drop, w.device,
                        sa.head_split(h, o.heads)).reshape(w.shape)
    return torch.where(keep, w * (1.0 / (1.0 - o.drop)), torch.zeros_like(w))


def _values(w, v, qpos, kpos, o: Opts, tv=None):
    out = torch.einsum("bhqk,bhkd->bhqd", w, v)
    if tv is not None:
        ids = torch.clamp(qpos[:, None] - kpos[None, :], -o.max_rel,
                          o.max_rel) + o.max_rel
        out = out + torch.einsum("bhqk,qkd->bhqd", w, tv.float()[ids])
    return out


def _plain_block(q, k, v, keep, qpos, kpos, words, o: Opts, tk, tv):
    """(o_b, m_b, l_b) of one block in fp32: o_b normalised within the
    block (softmax), or the relu block sum with m_b, l_b None."""
    launches["ring_block_ref"] += 1
    s, mult = _scores(q, k, keep, qpos, kpos, o, tk)
    if o.relu:
        w = _dropped(torch.relu(s * mult), words, o)
        return _values(w, v, qpos, kpos, o, tv), None, None
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = _values(_dropped(p, words, o), v, qpos, kpos, o, tv)
    return out / l[..., None], m, l


def _kernel_words(words, q, o: Opts):
    """The launch words of a block over q (its own [B, H, L/n] rows)."""
    return sa.kernel_words(words, q.shape, o.drop if words else 0.0,
                           o.heads)


def _kernel_block(q, k, v, pad, causal, words, o: Opts):
    """#5 over one block: (o_b, m_b, l_b)."""
    kw = _kernel_words(words, q, o)
    rate = o.drop if words is not None else 0.0
    if o.route == "tensor_cores":
        return sa._forward_tc(q, k, v, pad, causal, rate, kw)
    return sa._forward(q, k, v, pad, causal, rate, kw)


def _block_inputs(o: Opts, owner: int, lb: int):
    """(the seed words, the key pad mask [B, lb]) of block ``owner``."""
    words = (block_words(o.words, o.me, owner)
             if o.words is not None and o.drop else None)
    return words, o.keep[:, owner * lb:(owner + 1) * lb]


def _skipped(o: Opts, owner: int) -> bool:
    """Whether block ``owner`` lies above the diagonal of a causal ring
    where it adds nothing (ReLA's mode, the kernel route)."""
    return (o.causal and owner > o.me
            and (o.relu or o.family == "kernel"))


def _merge(state, ob, mb, lb, relu):
    """Merge one block's (o_b, m_b, l_b) into the running (acc, M, L)."""
    ob = ob.float()
    if state is None:
        if relu:
            return ob, None, None
        return ob * lb[..., None], mb, lb
    acc, big_m, big_l = state
    if relu:
        return acc + ob, None, None
    new_m = torch.maximum(big_m, mb)
    a = torch.exp(big_m - new_m)
    b = torch.exp(mb - new_m) * lb
    return acc * a[..., None] + ob * b[..., None], new_m, big_l * a + b


def ring_forward(q, k, v, tk, tv, o: Opts):
    """The ring's forward over this block: (out in q's dtype, the merged
    row max M and sum L, fp32; None in ReLA's mode). COLLECTIVE."""
    n, me = o.n, o.me
    lb = q.shape[2]
    qpos = _positions(me * lb, lb, q.device)
    kernel = o.route != "plain"
    qf = q if kernel else q.float()
    kb, vb = k, v
    state = None
    for s in range(n):
        owner = (me - s) % n
        if not _skipped(o, owner):
            words, keep = _block_inputs(o, owner, lb)
            if kernel:
                ob, mb, lbk = _kernel_block(
                    qf, kb, vb, keep.float().contiguous(),
                    o.causal and owner == me, words, o)
            else:
                ob, mb, lbk = _plain_block(
                    qf, kb.float(), vb.float(), keep, qpos,
                    _positions(owner * lb, lb, q.device), words, o, tk,
                    tv)
            state = _merge(state, ob, mb, lbk, o.relu)
        if s < n - 1:
            kb, vb = o.shift([kb, vb])
    acc, big_m, big_l = state
    out = acc if o.relu else acc / big_l[..., None]
    return out.to(q.dtype), big_m, big_l


def ring_backward(q, k, v, tk, tv, out, big_m, big_l, dout, o: Opts):
    """The ring's backward: (dq, dk, dv, dtk, dtv) of this block (the
    tables' partial), dK and dV travelling with their block. COLLECTIVE."""
    me, n = o.me, o.n
    lb = q.shape[2]
    kernel = o.route != "plain"
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dtk = None if tk is None else torch.zeros_like(tk, dtype=torch.float32)
    dtv = None if tv is None else torch.zeros_like(tv, dtype=torch.float32)
    qpos = _positions(me * lb, lb, q.device)
    if kernel:
        do_k = dout.to(q.dtype).contiguous()
        if o.route == "tensor_cores":
            do_k = sa._aligned(do_k)
    else:
        do_f = dout.float()
        delta = None if o.relu else (do_f * out.float()).sum(dim=-1)
    kb, vb = k, v
    for s in range(n):
        owner = (me - s) % n
        if not _skipped(o, owner):
            words, keep = _block_inputs(o, owner, lb)
            if kernel:
                gq, gk, gv = _kernel_block_grads(
                    q, kb, vb, keep.float().contiguous(), out, do_k,
                    big_m, big_l, o.causal and owner == me, words, o)
                gt = (None, None)
            else:
                gq, gk, gv, *gt = _plain_block_grads(
                    q, kb, vb, keep, qpos,
                    _positions(owner * lb, lb, q.device), words, o, tk,
                    tv, do_f, delta, big_m, big_l)
            dq += gq
            dk += gk
            dv += gv
            if dtk is not None and gt[0] is not None:
                dtk += gt[0]
                dtv += gt[1]
        if s < n - 1:
            kb, vb, dk, dv = o.shift([kb, vb, dk, dv])
    # the last shift brings each block's gradients home
    dk, dv = o.shift([dk, dv])
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None if dtk is None else dtk.to(tk.dtype),
            None if dtv is None else dtv.to(tv.dtype))


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, tk, tv, o: Opts):
        out, big_m, big_l = ring_forward(q, k, v, tk, tv, o)
        ctx.o = o
        ctx.save_for_backward(q, k, v, tk, tv, out, big_m, big_l)
        return out

    @staticmethod
    def backward(ctx, dout):
        return ring_backward(*ctx.saved_tensors, dout, ctx.o) + (None,)


def _plain_block_grads(q, k, v, keep, qpos, kpos, words, o: Opts, tk, tv,
                       do_f, delta, big_m, big_l):
    """(dq, dk, dv, dtk, dtv) of one block, fp32: the gradients of the
    surrogate sum(dO * num) - sum(delta * den) against the final M, L."""
    leaves = [q.detach().float().requires_grad_(),
              k.detach().float().requires_grad_(),
              v.detach().float().requires_grad_()]
    tables = [None, None]
    if tk is not None:
        tables = [tk.detach().float().requires_grad_(),
                  tv.detach().float().requires_grad_()]
    with torch.enable_grad():
        s, mult = _scores(leaves[0], leaves[1], keep, qpos, kpos, o,
                          tables[0])
        if o.relu:
            w = _dropped(torch.relu(s * mult), words, o)
            surrogate = (do_f * _values(w, leaves[2], qpos, kpos, o,
                                        tables[1])).sum()
        else:
            a = torch.exp(s - big_m[..., None]) / big_l[..., None]
            num = _values(_dropped(a, words, o), leaves[2], qpos, kpos, o,
                          tables[1])
            surrogate = (do_f * num).sum() - (delta[..., None] * a).sum()
        wrt = leaves + [t for t in tables if t is not None]
        grads = torch.autograd.grad(surrogate, wrt, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(wrt, grads)]
    return tuple(grads[:3]) + (tuple(grads[3:]) if tk is not None
                               else (None, None))


def _kernel_block_grads(q, k, v, pad, out, do, big_m, big_l, causal, words,
                        o: Opts):
    """#6 then #7 over one block against the merged M and L: (dq, dk,
    dv) in fp32."""
    kw = _kernel_words(words, q, o)
    rate = o.drop if words is not None else 0.0
    m, l = big_m.contiguous(), big_l.contiguous()
    if o.route == "tensor_cores":
        dq, delta = sa._backward_dq_tc(q, k, v, pad, out, do, m, l, causal,
                                       rate, kw)
        dk, dv = sa._backward_dkdv_tc(q, k, v, pad, do, m, l, delta, causal,
                                      rate, kw)
    else:
        dq, delta = sa._backward_dq(q, k, v, pad, out, do, m, l, causal,
                                    rate, kw)
        dk, dv = sa._backward_dkdv(q, k, v, pad, do, m, l, delta, causal,
                                   rate, kw)
    return dq.float(), dk.float(), dv.float()


def ring_attention(q, k, v, keep, *, causal=False, words=None, drop=None,
                   relu=False, rpr_tables=None, max_rel=None, heads=None,
                   use_kernels=False, line=None) -> torch.Tensor:
    """Sequence-parallel self-attention over this process's [B, H, L/n,
    Dh] blocks of q, k and v; ``keep`` the whole [B, L] key pad mask (1 =
    attend) or None. ``words``/``drop``: the site's dropout; ``relu``:
    ReLA's mode; ``rpr_tables`` (keys, values [2m+1, Dh]) with
    ``max_rel``: Shaw's; ``heads``: (offset, whole count) of the H heads
    (tensor parallelism). ``use_kernels`` (softmax mode only): the blocks
    run #5-#7 on a CUDA tensor, their plain kernel-form version on a CPU
    one. ``line`` = (coord, n, shift): this block's place, the line's
    length and its shift (ring_shift's contract); by default the seq
    split's and ``distributed.ring_shift``. Returns [B, H, L/n, Dh] in
    q's dtype. COLLECTIVE over the seq line, forward and backward."""
    q, k, v, tk, tv, o = prepare(
        q, k, v, keep, causal=causal, words=words, drop=drop, relu=relu,
        rpr_tables=rpr_tables, max_rel=max_rel, heads=heads,
        use_kernels=use_kernels, line=line)
    return _Ring.apply(q, k, v, tk, tv, o)


def prepare(q, k, v, keep, *, causal=False, words=None, drop=None,
            relu=False, rpr_tables=None, max_rel=None, heads=None,
            use_kernels=False, line=None):
    """ring_attention's arguments -> (q, k, v, tk, tv, Opts) as
    ring_forward and ring_backward take them (a CUDA tensor on the kernel
    route checked, contiguous and aligned)."""
    b, lb = q.shape[0], q.shape[2]
    me, n, shift = line if line is not None else (
        common.seq_coord(), seq_degree(), dist.ring_shift)
    if keep is None:
        keep = torch.ones((b, lb * n), dtype=torch.float32, device=q.device)
    drop = float(drop) if (drop and words is not None) else 0.0
    kernel = use_kernels and not relu and rpr_tables is None
    if kernel:
        route = sa.route(q.device.type, q.dtype, q.shape[-1])
        if route != "plain":
            if not q.is_cuda:
                raise ValueError("ring attention: unsupported device %s"
                                 % q.device)
            sa._check(q, k, v, keep[:, :lb].float())
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if route == "tensor_cores":
                q, k, v = map(sa._aligned, (q, k, v))
    else:
        route = "plain"
    o = Opts(keep=keep, causal=bool(causal),
             words=None if not drop else tuple(words), drop=drop,
             relu=bool(relu),
             max_rel=None if max_rel is None else int(max_rel),
             heads=None if heads is None else tuple(heads),
             family="kernel" if kernel else "jax", route=route, me=int(me),
             n=int(n), shift=shift)
    tk = tv = None
    if rpr_tables is not None:
        tk, tv = rpr_tables[0], rpr_tables[1]
    return q, k, v, tk, tv, o


def simulate(n: int, fn):
    """``fn(coord, shift)`` for the n blocks of a line, each in a thread of
    this process: ``shift`` hands a list of tensors to block coord + 1 and
    returns block coord - 1's (ring_shift's contract), so a ring runs in
    one process (``ring_attention(..., line=(coord, n, shift))``) as it
    runs over n processes. Returns the n results in order; the first
    error raises."""
    barrier = threading.Barrier(n)
    slots, out, errors = [None] * n, [None] * n, []

    def shift_of(me):
        def shift(tensors):
            slots[me] = [t.clone() for t in tensors]
            barrier.wait()
            got = slots[(me - 1) % n]
            barrier.wait()
            return got
        return shift

    def run(me):
        try:
            out[me] = fn(me, shift_of(me))
        except BaseException as e:     # noqa: BLE001 -- raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(me,)) for me in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
