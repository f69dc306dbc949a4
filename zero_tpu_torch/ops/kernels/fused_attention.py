"""Fused multi-head attention for training: CUDA kernels for Hopper and
their plain PyTorch version.

Replaces the Pallas TPU kernels of ``zero_tpu/ops/kernels/fused_attention.py``:

* forward -- ``_fused_forward`` (``pallas_call`` at :488, ``_fwd_kernel``):
  scores q.k^T * Dh^-0.5 under a key-side pad mask and a causal flag, an
  fp32 max-subtracted softmax, attention dropout, product with V.
* backward -- ``_fused_bwd_rule`` (``pallas_call`` at :525,
  ``_bwd_kernel``): the softmax recomputed, dq per query tile and dk/dv
  per key tile, ds zero at masked entries.

Both run ``csrc/fused_attention.cu`` (its header gives the design and the
bound), wrapped in one ``torch.autograd.Function`` whose backward is the
backward kernel.

Dropout. The TPU kernels seed the TPU's hardware PRNG per grid block; the
port draws element (b, h, i, j)'s keep bit from ``ops/common.py:_hash_bits``
over the linear index ((b*H + h)*Lq + i)*Lk + j with the site's two seed
words, against the 32-bit threshold of ``_dropout_keep``, scale
1/(1 - rate). The plain version draws the same mask, so the kernels are held
to it with dropout on.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor goes
to ``fused_attention_ref``. ``launches`` counts the kernel launches by
wrapper ("fused_attention", "fused_attention_backward") and the plain
version's calls ("fused_attention_ref").
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops.kernels import cuda_build

NEG_INF = -1e30          # masked scores, as in the TPU kernel
MAX_LK = 8192            # the TPU kernel's limit; longer keys stream (#5-#7)
MAX_HEAD_DIM = 256       # the CUDA kernels' register tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()


def dropout_threshold(rate: float) -> int:
    """The 32-bit keep threshold of ``_dropout_keep``."""
    return int((1.0 - rate) * 4294967295.0)


def keep_mask(words, shape, rate: float, device=None) -> torch.Tensor:
    """The attention dropout keep mask over [B, H, Lq, Lk]."""
    return common._hash_bits(words, shape, device) < dropout_threshold(rate)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def fused_attention_ref(q, k, v, pad_mask, causal: bool = False,
                        dropout_rate: float = 0.0, rng=None):
    """Plain PyTorch fused attention, computed in fp32 and returned in the
    query dtype. q/k/v: [B, H, L, Dh]; pad_mask: [B, Lk] 1/0."""
    launches["fused_attention_ref"] += 1
    dh = q.shape[-1]
    lq, lk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    keep = (pad_mask > 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                 device=q.device).tril()[None, None]
    w = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        drop = keep_mask(rng, w.shape, dropout_rate, q.device)
        w = torch.where(drop, w * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(w))
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("fused_attention")
    fwd = lib.zt_attention_forward
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.zt_attention_backward
    bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _dropout_args(rate: float, words):
    if rate > 0.0:
        return (1, dropout_threshold(rate), 1.0 / (1.0 - rate),
                int(words[0]) & 0xFFFFFFFF, int(words[-1]) & 0xFFFFFFFF)
    return 0, 0, 1.0, 0, 0


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError("fused attention %s kernel launch failed: CUDA "
                           "error %d" % (what, err))


def _forward(q, k, v, pad, causal, rate, words):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    o = torch.empty_like(q)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), _DTYPES[q.dtype],
            b, h, lq, lk, dh, int(causal), float(dh) ** -0.5,
            *_dropout_args(rate, words),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "forward")
    launches["fused_attention"] += 1
    return o, m, l


def _backward(q, k, v, pad, o, do, m, l, causal, rate, words):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _library()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], b, h, lq, lk, dh, int(causal),
            float(dh) ** -0.5, *_dropout_args(rate, words),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "backward")
    launches["fused_attention_backward"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward kernel; backward kernels for dq, dk, dv (no grad for the
    pad mask)."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, rate, words):
        o, m, l = _forward(q, k, v, pad, causal, rate, words)
        ctx.save_for_backward(q, k, v, pad, o, m, l)
        ctx.args = (causal, rate, words)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, o, m, l = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, pad, o, do.contiguous(), m, l,
                               *ctx.args)
        return dq, dk, dv, None, None, None, None


def _check(q, k, v, pad):
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError("fused_attention: q/k/v must share one dtype of %s, "
                         "got %s/%s/%s" % (list(_DTYPES), q.dtype, k.dtype,
                                           v.dtype))
    if not (q.device == k.device == v.device == pad.device):
        raise ValueError("fused_attention: inputs on different devices")
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh \
            or tuple(pad.shape) != (b, k.shape[2]):
        raise ValueError("fused_attention: need q [B,H,Lq,Dh], k/v "
                         "[B,H,Lk,Dh], pad_mask [B,Lk]; got %s, %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape),
                            tuple(pad.shape)))
    if dh > MAX_HEAD_DIM or k.shape[2] > MAX_LK or b * h > 65535:
        raise ValueError("fused_attention: head depth %d > %d, keys %d > %d "
                         "or B*H %d > 65535" % (dh, MAX_HEAD_DIM, k.shape[2],
                                                MAX_LK, b * h))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, dropout_rate: float = 0.0,
                    rng=None) -> torch.Tensor:
    """Fused attention over [B, H, L, Dh] projections.

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
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v, pad, causal, rate, rng)
    if not q.is_cuda:
        raise ValueError("fused_attention: unsupported device %s" % q.device)
    _check(q, k, v, pad)
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), pad, bool(causal), rate,
                                 tuple(rng) if rate else (0, 0))
