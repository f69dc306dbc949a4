"""Streaming (key-blocked) attention for long sequences: CUDA kernels for
Hopper and their plain PyTorch version.

Replaces the Pallas TPU kernels of
``zero_tpu/ops/kernels/streaming_attention.py``, which the JAX package runs
where keys outnumber the fused kernel's ``MAX_LK = 8192``:

* #5 forward -- ``_streaming_forward`` (``pallas_call`` at :308,
  ``_fwd_kernel``): scores q.k^T * Dh^-0.5 under a key pad mask and a
  causal flag (masked scores -1e30), an fp32 online softmax over key tiles,
  dropout on the accumulated p only (l undropped).
* #6 dq -- the first ``pallas_call`` of ``_bwd_rule`` (:353,
  ``_dq_kernel``): delta = rowsum(dO * O), dq over the key tiles.
* #7 dk/dv -- the second (:371, ``_dkv_kernel``): per key tile, walking the
  query tiles.

They run ``csrc/streaming_attention.cu`` (its header gives the design and
the bound), in one ``torch.autograd.Function`` whose backward launches #6
and then #7. The contract is the JAX one: q [B, H, Lq, Dh], k/v
[B, H, Lk, Dh] in, [B, H, Lq, Dh] out in the query dtype.

Which version runs is ``route(device, dtype, Dh)``, a pure function that
``streaming_attention`` calls once: on the CPU the plain version, forward
and backward; on the card the tensor-core #5, #6 and #7 (``wgmma``, bf16
in, fp32 accumulation) for bf16 with a head depth that is a multiple of 16
up to 128; the CUDA-core #5, #6 and #7 for fp32 (which must stay exact:
TF32 would give ~1e-3 against the fp32 models' 1e-4 tolerance) and for
bf16 at any other depth up to 256. A launch that fails raises; nothing
falls back.

Where the port differs from the TPU kernel (ROADMAP.md section 3):
* the kernels take any Lq and Lk; JAX streams only where Lq % 8 == 0 and
  Lk % 128 == 0 (``_blocks``) and falls back to the dense XLA form
  elsewhere;
* under the causal flag, keys past a row are absent rather than masked, so
  tiles above the diagonal are skipped without changing a number: a causal
  row with no valid key normalises over the keys up to it;
* m and l are kept apart (no lse), so a row whose keys are all padded gets
  softmax's gradients: zero dq and dk, a 1/Lk share of dO in dv;
* the tensor-core #5 rounds the weights P to bf16 before the product with
  V, where the TPU kernel multiplies in fp32;
* dropout: element (row r = (b*H + h)*Lq + i, key j) keeps iff
  ``hash(j, hash(r, s0, s1), s1) < threshold`` (the murmur3 finalizer of
  ``ops/common.py:_hash_bits``), the 32-bit threshold and 1/(1 - rate)
  scale of ``_dropout_keep``. A per-row seed word and the key index: no
  linear index over B*H*Lq*Lk, which wraps at 2^32 (B=2, H=8, L=16384).

``streaming_attention_ref`` is the same math in fp32: it walks the query
rows in chunks, each checkpointed under autograd, so neither its forward
nor its backward holds more than [B*H, chunk, Lk] at a time.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor goes
to ``streaming_attention_ref``. ``launches`` counts the kernel launches by
wrapper ("streaming_attention", "streaming_attention_dq",
"streaming_attention_dkdv" on the CUDA cores; "streaming_attention_tc",
"streaming_attention_dq_tc", "streaming_attention_dkdv_tc" on the tensor
cores) and the plain version's calls ("streaming_attention_ref").
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops.kernels import cuda_build

NEG_INF = -1e30          # masked scores, as in the TPU kernel
MAX_HEAD_DIM = 256       # the CUDA kernels' register tiles
TC_MAX_HEAD_DIM = 128    # the tensor-core kernels: depth padded to 64, 128
# the plain version's query chunk holds at most this many fp32 scores
REF_CHUNK_ELEMS = 1 << 24
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()


def supported(lq: int, lk: int) -> bool:
    """Where the streaming kernels run: any positive lengths. The TPU
    kernel's tiling gate (Lq % 8, Lk % 128) is not copied."""
    return lq > 0 and lk > 0


def route(device: str, dtype: torch.dtype, dh: int) -> str:
    """Which version of the attention runs on ``device`` ("cpu" or "cuda")
    in ``dtype`` at head depth ``dh``: "plain" (the CPU: the plain version,
    forward and backward), or on the card #5, #6 and #7 on the
    "tensor_cores" (bf16, dh a multiple of 16 up to 128) or the
    "cuda_cores" (the rest)."""
    if device == "cpu":
        return "plain"
    if dtype == torch.bfloat16 and dh % 16 == 0 and dh <= TC_MAX_HEAD_DIM:
        return "tensor_cores"
    return "cuda_cores"


def dropout_threshold(rate: float) -> int:
    """The 32-bit keep threshold of ``_dropout_keep``."""
    return int((1.0 - rate) * 4294967295.0)


def _fmix(x: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """``ops/common.py:_hash_bits`` of the int64 indices ``x`` (in
    [0, 2^32)) under the words s0, s1: the kernels' ``zt::hash_bits``."""
    x = common._mix32(x ^ s0, 0x85EBCA6B)
    x = common._mix32(x, 0xC2B2AE35)
    return x ^ (x >> 16) ^ s1


def head_split(h: int, heads=None):
    """(H held, offset, whole count) of a launch over H = ``h`` heads that
    are the part ``heads`` = (offset, whole count) of the heads; all of
    them without ``heads``."""
    offset, total = heads if heads is not None else (0, h)
    return int(h), int(offset), int(total)


def kernel_words(rng, shape, rate: float, heads=None, qrows=None):
    """The kernels' (s0, s1, row base, whole heads, head offset, whole
    query length) of a launch over q [B, H, Lq, Dh] whose H heads are the
    part ``heads`` = (offset, whole count) of the heads (all of them by
    default) and whose Lq query rows are the part ``qrows`` = (offset,
    whole length) of a longer sequence (a sequence block; all of it by
    default): the seed words, the global row of row 0 and the splits;
    zero words and row base without dropout."""
    b, h, lq = shape[:3]
    _, offset, total = head_split(h, heads)
    first, whole = qrows if qrows is not None else (0, lq)
    if not rate:
        return 0, 0, 0, total, offset, whole
    return (int(rng[0]) & 0xFFFFFFFF, int(rng[-1]) & 0xFFFFFFFF,
            (common.index_base((b, total, whole)) + int(first)) & 0xFFFFFFFF,
            total, offset, whole)


def launch_words(words):
    """kernel_words' six words as u32 launch arguments."""
    return tuple(int(w) & 0xFFFFFFFF for w in words)


def keep_mask(words, bh: int, lq: int, rows: range, lk: int, rate: float,
              device=None, heads=None, qrows=None) -> torch.Tensor:
    """The dropout keep mask [B*H, len(rows), Lk] of query rows ``rows``;
    within a global batch the rows are the global batch's
    (ops/common.py:index_base). ``heads`` = (H held, offset, whole count)
    (head_split): the launch's head bh = b * H + h is head offset + h of
    the whole count; ``qrows`` = (offset, whole length): the Lq rows are
    a block of a longer sequence; the kernels' ``zt::global_row``."""
    s0, s1 = int(words[0]) & 0xFFFFFFFF, int(words[-1]) & 0xFFFFFFFF
    local = torch.arange(bh, dtype=torch.int64, device=device)
    first, whole = qrows if qrows is not None else (0, lq)
    h, offset, total = heads if heads is not None else (1, 0, 1)
    first = (((local // h) * total + offset + local % h) * whole + first
             + common.index_base((bh // h, total, whole)))
    row = (first[:, None]
           + torch.arange(rows.start, rows.stop, dtype=torch.int64,
                          device=device)[None, :]) & 0xFFFFFFFF
    seeds = _fmix(row, s0, s1)
    keys = torch.arange(lk, dtype=torch.int64, device=device)
    return _fmix(keys[None, None, :] ^ seeds[:, :, None], 0, s1) \
        < dropout_threshold(rate)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _chunk(qc, k, v, keep_keys, i0: int, lq: int, causal: bool, rate: float,
           words, heads=None, qrows=None):
    """Attention of query rows [i0, i0 + c) in fp32: qc [BH, c, Dh], k/v
    [BH, Lk, Dh], keep_keys [BH, Lk] bool."""
    c, lk = qc.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qc, k) * qc.shape[-1] ** -0.5
    s = torch.where(keep_keys[:, None, :], s, NEG_INF)
    if causal:
        rows = torch.arange(i0, i0 + c, device=qc.device)[:, None]
        cols = torch.arange(lk, device=qc.device)[None, :]
        s = torch.where((cols <= rows)[None], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = keep_mask(words, qc.shape[0], lq, range(i0, i0 + c), lk, rate,
                         qc.device, heads, qrows)
        w = torch.where(keep, w * (1.0 / (1.0 - rate)), torch.zeros_like(w))
    return torch.einsum("bqk,bkd->bqd", w, v)


def streaming_attention_ref(q, k, v, pad_mask, causal: bool = False,
                            dropout_rate: float = 0.0, rng=None,
                            chunk: Optional[int] = None, heads=None,
                            qrows=None):
    """Plain PyTorch streaming attention, computed in fp32 over chunks of
    query rows and returned in the query dtype. q/k/v: [B, H, L, Dh];
    pad_mask: [B, Lk] 1/0. Dropout runs when ``rng`` (two seed words) is
    given and 0 < dropout_rate < 1; ``heads``: (offset, whole count) of
    the H heads (tensor parallelism); ``qrows``: (offset, whole length) of
    the Lq query rows (a sequence block)."""
    launches["streaming_attention_ref"] += 1
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    rate = float(dropout_rate) if (rng is not None
                                   and 0.0 < dropout_rate < 1.0) else 0.0
    q3 = q.float().reshape(b * h, lq, dh)
    k3 = k.float().reshape(b * h, lk, dh)
    v3 = v.float().reshape(b * h, lk, dh)
    keep_keys = (pad_mask > 0).repeat_interleave(h, dim=0)
    if chunk is None:
        chunk = max(1, REF_CHUNK_ELEMS // max(1, b * h * lk))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for i0 in range(0, lq, chunk):
        args = (q3[:, i0:i0 + chunk], k3, v3, keep_keys, i0, lq, bool(causal),
                rate, rng, head_split(h, heads), qrows)
        outs.append(checkpoint(_chunk, *args, use_reentrant=False)
                    if grad else _chunk(*args))
    return torch.cat(outs, dim=1).reshape(b, h, lq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_TAIL = ([ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_float] + [ctypes.c_uint] * 6
         + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("streaming_attention")
    fns = []
    for name, pointers in (("zt_streaming_forward", 7),
                           ("zt_streaming_backward_dq", 10),
                           ("zt_streaming_backward_dkdv", 10),
                           ("zt_streaming_backward_dq_tc", 10),
                           ("zt_streaming_backward_dkdv_tc", 10),
                           ("zt_streaming_forward_tc", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + _TAIL
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _args(q, k, causal, rate, words):
    """The launch's trailing arguments: dtype, shape, causal flag, scale,
    dropout words, row base and head split (kernel_words), stream."""
    b, h, lq, dh = q.shape
    if rate > 0.0:
        drop = (1, dropout_threshold(rate),
                1.0 / (1.0 - rate)) + launch_words(words)
    else:
        drop = (0, 0, 1.0) + launch_words(words)
    return (_DTYPES[q.dtype], b, h, lq, k.shape[2], dh, int(causal),
            float(dh) ** -0.5) + drop + (
                torch.cuda.current_stream(q.device).cuda_stream,)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError("streaming attention %s kernel launch failed: "
                           "CUDA error %d" % (what, err))


def _fwd(which, key, q, k, v, pad, causal, rate, words):
    o = torch.empty_like(q)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[which](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                pad.data_ptr(), o.data_ptr(), m.data_ptr(),
                                l.data_ptr(),
                                *_args(q, k, causal, rate, words))
    _raise_on(err, key)
    launches[key] += 1
    return o, m, l


def _forward(q, k, v, pad, causal, rate, words):
    """#5 on the CUDA cores: (o, m, l)."""
    return _fwd(0, "streaming_attention", q, k, v, pad, causal, rate, words)


def _forward_tc(q, k, v, pad, causal, rate, words):
    """#5 on the tensor cores (bf16; 16-byte aligned q, k, v)."""
    return _fwd(5, "streaming_attention_tc", q, k, v, pad, causal, rate,
                words)


def _dq(which, key, q, k, v, pad, o, do, m, l, causal, rate, words):
    dq = torch.empty_like(q)
    delta = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[which](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                pad.data_ptr(), o.data_ptr(), do.data_ptr(),
                                m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                                dq.data_ptr(),
                                *_args(q, k, causal, rate, words))
    _raise_on(err, key)
    launches[key] += 1
    return dq, delta


def _dkdv(which, key, q, k, v, pad, do, m, l, delta, causal, rate, words):
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library()[which](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                pad.data_ptr(), do.data_ptr(), m.data_ptr(),
                                l.data_ptr(), delta.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(),
                                *_args(q, k, causal, rate, words))
    _raise_on(err, key)
    launches[key] += 1
    return dk, dv


def _backward_dq(q, k, v, pad, o, do, m, l, causal, rate, words):
    """#6 on the CUDA cores: (dq, delta)."""
    return _dq(1, "streaming_attention_dq", q, k, v, pad, o, do, m, l,
               causal, rate, words)


def _backward_dkdv(q, k, v, pad, do, m, l, delta, causal, rate, words):
    """#7 on the CUDA cores: (dk, dv)."""
    return _dkdv(2, "streaming_attention_dkdv", q, k, v, pad, do, m, l,
                 delta, causal, rate, words)


def _backward_dq_tc(q, k, v, pad, o, do, m, l, causal, rate, words):
    """#6 on the tensor cores (bf16; 16-byte aligned q, k, v, o, do)."""
    return _dq(3, "streaming_attention_dq_tc", q, k, v, pad, o, do, m, l,
               causal, rate, words)


def _backward_dkdv_tc(q, k, v, pad, do, m, l, delta, causal, rate, words):
    """#7 on the tensor cores (bf16; 16-byte aligned q, k, v, do)."""
    return _dkdv(4, "streaming_attention_dkdv_tc", q, k, v, pad, do, m, l,
                 delta, causal, rate, words)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where it does not start on 16 bytes (the
    tensor-core kernels copy 16-byte chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _StreamingAttention(torch.autograd.Function):
    """Forward kernel #5; backward #6 (delta, dq) then #7 (dk, dv), all on
    the route that ``route`` picked."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, rate, words, route):
        if route == "tensor_cores":
            q, k, v = map(_aligned, (q, k, v))
            o, m, l = _forward_tc(q, k, v, pad, causal, rate, words)
        else:
            o, m, l = _forward(q, k, v, pad, causal, rate, words)
        ctx.save_for_backward(q, k, v, pad, o, m, l)
        ctx.args = (causal, rate, words)
        ctx.route = route
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, o, m, l = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if ctx.route == "tensor_cores":
            do = _aligned(do)
            dq, delta = _backward_dq_tc(q, k, v, pad, o, do, m, l, *ctx.args)
            dk, dv = _backward_dkdv_tc(q, k, v, pad, do, m, l, delta,
                                       *ctx.args)
        else:
            dq, delta = _backward_dq(q, k, v, pad, o, do, m, l, *ctx.args)
            dk, dv = _backward_dkdv(q, k, v, pad, do, m, l, delta,
                                    *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, pad):
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError("streaming_attention: q/k/v must share one dtype of "
                         "%s, got %s/%s/%s" % (list(_DTYPES), q.dtype,
                                               k.dtype, v.dtype))
    if not (q.device == k.device == v.device == pad.device):
        raise ValueError("streaming_attention: inputs on different devices")
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh \
            or tuple(pad.shape) != (b, k.shape[2]):
        raise ValueError("streaming_attention: need q [B,H,Lq,Dh], k/v "
                         "[B,H,Lk,Dh], pad_mask [B,Lk]; got %s, %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape),
                            tuple(pad.shape)))
    if not supported(lq, k.shape[2]) or dh > MAX_HEAD_DIM \
            or b * h > 65535 or b * h * lq >= 2 ** 32:
        raise ValueError("streaming_attention: need Lq, Lk >= 1, head depth "
                         "<= %d, B*H <= 65535 and B*H*Lq < 2^32; got Lq %d, "
                         "Lk %d, Dh %d, B*H %d" % (MAX_HEAD_DIM, lq,
                                                   k.shape[2], dh, b * h))


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor] = None, *,
                        causal: bool = False, dropout_rate: float = 0.0,
                        rng=None, heads=None, qrows=None) -> torch.Tensor:
    """Key-blocked attention over [B, H, L, Dh] projections; Lk bounded by
    device memory only.

    pad_mask: [B, Lk] 1/0 key-side padding mask (None = all valid); the
    Dh^-0.5 scaling happens inside. Dropout runs when ``rng`` (a pair of
    seed words) is given and 0 < dropout_rate < 1. ``heads``: (offset,
    whole count) of the H heads; ``qrows``: (offset, whole length) of the
    Lq query rows (a sequence block's, whose dropout rows are the whole
    sequence's). Returns [B, H, Lq, Dh] in the query dtype.
    """
    b, lk = q.shape[0], k.shape[2]
    if pad_mask is None:
        pad_mask = torch.ones((b, lk), dtype=torch.float32, device=q.device)
    pad = pad_mask.float().contiguous()
    rate = float(dropout_rate) if (rng is not None
                                   and 0.0 < dropout_rate < 1.0) else 0.0
    words = kernel_words(rng, q.shape, rate, heads, qrows)
    which = route(q.device.type, q.dtype, q.shape[-1])
    if which == "plain":
        return streaming_attention_ref(q, k, v, pad, causal, rate, rng,
                                       heads=heads, qrows=qrows)
    if not q.is_cuda:
        raise ValueError("streaming_attention: unsupported device %s"
                         % q.device)
    _check(q, k, v, pad)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _StreamingAttention.apply(q, k, v, pad, bool(causal), rate, words,
                                     which)
