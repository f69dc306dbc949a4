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

Where the port differs from the TPU kernel (ROADMAP.md section 3):
* the kernels take any Lq and Lk; JAX streams only where Lq % 8 == 0 and
  Lk % 128 == 0 (``_blocks``) and falls back to the dense XLA form
  elsewhere;
* under the causal flag, keys past a row are absent rather than masked, so
  tiles above the diagonal are skipped without changing a number: a causal
  row with no valid key normalises over the keys up to it;
* m and l are kept apart (no lse), so a row whose keys are all padded gets
  softmax's gradients: zero dq and dk, a 1/Lk share of dO in dv;
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
"streaming_attention_dkdv") and the plain version's calls
("streaming_attention_ref").
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
# the plain version's query chunk holds at most this many fp32 scores
REF_CHUNK_ELEMS = 1 << 24
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()


def supported(lq: int, lk: int) -> bool:
    """Where the streaming kernels run: any positive lengths. The TPU
    kernel's tiling gate (Lq % 8, Lk % 128) is not copied."""
    return lq > 0 and lk > 0


def dropout_threshold(rate: float) -> int:
    """The 32-bit keep threshold of ``_dropout_keep``."""
    return int((1.0 - rate) * 4294967295.0)


def _fmix(x: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """``ops/common.py:_hash_bits`` of the int64 indices ``x`` (in
    [0, 2^32)) under the words s0, s1: the kernels' ``zt::hash_bits``."""
    x = common._mix32(x ^ s0, 0x85EBCA6B)
    x = common._mix32(x, 0xC2B2AE35)
    return x ^ (x >> 16) ^ s1


def keep_mask(words, bh: int, lq: int, rows: range, lk: int, rate: float,
              device=None) -> torch.Tensor:
    """The dropout keep mask [B*H, len(rows), Lk] of query rows ``rows``."""
    s0, s1 = int(words[0]) & 0xFFFFFFFF, int(words[-1]) & 0xFFFFFFFF
    row = (torch.arange(bh, dtype=torch.int64, device=device)[:, None] * lq
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
           words):
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
                         qc.device)
        w = torch.where(keep, w * (1.0 / (1.0 - rate)), torch.zeros_like(w))
    return torch.einsum("bqk,bkd->bqd", w, v)


def streaming_attention_ref(q, k, v, pad_mask, causal: bool = False,
                            dropout_rate: float = 0.0, rng=None,
                            chunk: Optional[int] = None):
    """Plain PyTorch streaming attention, computed in fp32 over chunks of
    query rows and returned in the query dtype. q/k/v: [B, H, L, Dh];
    pad_mask: [B, Lk] 1/0. Dropout runs when ``rng`` (two seed words) is
    given and 0 < dropout_rate < 1."""
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
                rate, rng)
        outs.append(checkpoint(_chunk, *args, use_reentrant=False)
                    if grad else _chunk(*args))
    return torch.cat(outs, dim=1).reshape(b, h, lq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_TAIL = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                              ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("streaming_attention")
    fns = []
    for name, pointers in (("zt_streaming_forward", 7),
                           ("zt_streaming_backward_dq", 10),
                           ("zt_streaming_backward_dkdv", 10)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + _TAIL
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _args(q, k, causal, rate, words):
    """The launch's trailing arguments: dtype, shape, causal flag, scale,
    dropout words, stream."""
    b, h, lq, dh = q.shape
    if rate > 0.0:
        drop = (1, dropout_threshold(rate), 1.0 / (1.0 - rate),
                int(words[0]) & 0xFFFFFFFF, int(words[-1]) & 0xFFFFFFFF)
    else:
        drop = (0, 0, 1.0, 0, 0)
    return (_DTYPES[q.dtype], b, h, lq, k.shape[2], dh, int(causal),
            float(dh) ** -0.5) + drop + (
                torch.cuda.current_stream(q.device).cuda_stream,)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError("streaming attention %s kernel launch failed: "
                           "CUDA error %d" % (what, err))


def _forward(q, k, v, pad, causal, rate, words):
    o = torch.empty_like(q)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            pad.data_ptr(), o.data_ptr(), m.data_ptr(),
                            l.data_ptr(), *_args(q, k, causal, rate, words))
    _raise_on(err, "forward")
    launches["streaming_attention"] += 1
    return o, m, l


def _backward_dq(q, k, v, pad, o, do, m, l, causal, rate, words):
    dq = torch.empty_like(q)
    delta = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            pad.data_ptr(), o.data_ptr(), do.data_ptr(),
                            m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(), *_args(q, k, causal, rate, words))
    _raise_on(err, "dq")
    launches["streaming_attention_dq"] += 1
    return dq, delta


def _backward_dkdv(q, k, v, pad, do, m, l, delta, causal, rate, words):
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            pad.data_ptr(), do.data_ptr(), m.data_ptr(),
                            l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), *_args(q, k, causal, rate, words))
    _raise_on(err, "dk/dv")
    launches["streaming_attention_dkdv"] += 1
    return dk, dv


class _StreamingAttention(torch.autograd.Function):
    """Forward kernel #5; backward #6 (delta, dq) then #7 (dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, rate, words):
        o, m, l = _forward(q, k, v, pad, causal, rate, words)
        ctx.save_for_backward(q, k, v, pad, o, m, l)
        ctx.args = (causal, rate, words)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, o, m, l = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, delta = _backward_dq(q, k, v, pad, o, do, m, l, *ctx.args)
        dk, dv = _backward_dkdv(q, k, v, pad, do, m, l, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


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
                        rng=None) -> torch.Tensor:
    """Key-blocked attention over [B, H, L, Dh] projections; Lk bounded by
    device memory only.

    pad_mask: [B, Lk] 1/0 key-side padding mask (None = all valid); the
    Dh^-0.5 scaling happens inside. Dropout runs when ``rng`` (a pair of
    seed words) is given and 0 < dropout_rate < 1. Returns [B, H, Lq, Dh]
    in the query dtype.
    """
    b, lk = q.shape[0], k.shape[2]
    if pad_mask is None:
        pad_mask = torch.ones((b, lk), dtype=torch.float32, device=q.device)
    pad = pad_mask.float().contiguous()
    rate = float(dropout_rate) if (rng is not None
                                   and 0.0 < dropout_rate < 1.0) else 0.0
    words = tuple(rng) if rate else (0, 0)
    if q.device.type == "cpu":
        return streaming_attention_ref(q, k, v, pad, causal, rate, rng)
    if not q.is_cuda:
        raise ValueError("streaming_attention: unsupported device %s"
                         % q.device)
    _check(q, k, v, pad)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _StreamingAttention.apply(q, k, v, pad, bool(causal), rate, words)
