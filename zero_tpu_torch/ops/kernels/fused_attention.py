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

The Shaw RPR variant (``rpr_tables`` + ``max_relative_position``) replaces

* ``_fused_forward_rpr`` (``pallas_call`` at :580, ``_fwd_kernel_rpr``):
  the forward plus q.Tk[c(i,j)] in the scores and the value-side term
  sum_j w_d,ij Tv[c(i,j)], c(i,j) = clip(i - j, -m, m) + m;
* ``_fused_bwd_rule_rpr`` (``pallas_call`` at :624, ``_bwd_kernel_rpr``):
  dq, dk, dv and the table gradients dTk, dTv summed over the whole grid.

They run ``csrc/fused_attention_rpr.cu``, one more ``autograd.Function``.
The TPU kernel works on bucket-flipped tables; these take the tables in
the order given and return their gradients in that order. The plain
version is ``fused_attention_rpr_ref``.

Dropout. The TPU kernels seed the TPU's hardware PRNG per grid block; the
port draws element (b, h, i, j)'s keep bit from ``ops/common.py:_hash_bits``
over the linear index ((b*H + h)*Lq + i)*Lk + j with the site's two seed
words, against the 32-bit threshold of ``_dropout_keep``, scale
1/(1 - rate). The plain version draws the same mask, so the kernels are held
to it with dropout on.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor goes
to ``fused_attention_ref`` (``fused_attention_rpr_ref`` with tables).
``launches`` counts the kernel launches by wrapper ("fused_attention",
"fused_attention_backward", "fused_attention_rpr",
"fused_attention_rpr_backward") and the plain versions' calls
("fused_attention_ref", "fused_attention_rpr_ref").
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops import rpr as rpr_mod
from zero_tpu_torch.ops.kernels import cuda_build

NEG_INF = -1e30          # masked scores, as in the TPU kernel
MAX_LK = 8192            # the TPU kernel's limit; longer keys stream (#5-#7)
MAX_HEAD_DIM = 256       # the CUDA kernels' register tiles
MAX_RELATIVE_POSITION = 64   # R = 2m + 1 <= 129 buckets in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()


def rpr_supported(lq: int, lk: int, max_rel: int) -> bool:
    """Where the JAX package runs the RPR kernel: 2m < Lk <= 8192 (its
    lane-roll skew needs the band inside the keys). Elsewhere attention
    takes the composite one-hot form. The TPU kernel's VMEM q-block rule
    (a block dividing Lq, or Lq*Lk <= 2^20) is not copied: it never binds
    at the configurations' lengths, and the CUDA kernel takes any Lq."""
    return 2 * max_rel < lk <= MAX_LK


def dropout_threshold(rate: float) -> int:
    """The 32-bit keep threshold of ``_dropout_keep``."""
    return int((1.0 - rate) * 4294967295.0)


def keep_mask(words, shape, rate: float, device=None) -> torch.Tensor:
    """The attention dropout keep mask over [B, H, Lq, Lk]."""
    return common._hash_bits(words, shape, device) < dropout_threshold(rate)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _weights(s, pad_mask, causal: bool, dropout_rate: float, rng):
    """The fp32 softmax of scores s [B, H, Lq, Lk] under the key pad mask
    and the causal flag (masked scores NEG_INF), then the kernels'
    dropout."""
    lq, lk = s.shape[-2:]
    keep = (pad_mask > 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                 device=s.device).tril()[None, None]
    w = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        drop = keep_mask(rng, w.shape, dropout_rate, s.device)
        w = torch.where(drop, w * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(w))
    return w


def fused_attention_ref(q, k, v, pad_mask, causal: bool = False,
                        dropout_rate: float = 0.0, rng=None):
    """Plain PyTorch fused attention, computed in fp32 and returned in the
    query dtype. q/k/v: [B, H, L, Dh]; pad_mask: [B, Lk] 1/0."""
    launches["fused_attention_ref"] += 1
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    w = _weights(s, pad_mask, causal, dropout_rate, rng)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def fused_attention_rpr_ref(q, k, v, pad_mask, tk, tv, max_rel: int,
                            causal: bool = False, dropout_rate: float = 0.0,
                            rng=None):
    """Plain PyTorch Shaw-RPR attention: the one-hot form of
    ``_xla_equivalent_rpr`` computed in fp32, with the dropout mask of the
    kernels; returned in the query dtype. tk/tv: [2m+1, Dh]."""
    launches["fused_attention_rpr_ref"] += 1
    s = rpr_mod.logits_with_rpr_onehot(q.float() * q.shape[-1] ** -0.5,
                                       k.float(), tk.float(), max_rel)
    w = _weights(s, pad_mask, causal, dropout_rate, rng)
    return rpr_mod.output_with_rpr_onehot(w, v.float(), tv.float(),
                                          max_rel).to(q.dtype)


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


@functools.lru_cache(maxsize=None)
def _rpr_library():
    lib = cuda_build.load("fused_attention_rpr")
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fwd = lib.zt_attention_rpr_forward
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + tail
    fwd.restype = ctypes.c_int
    bwd = lib.zt_attention_rpr_backward
    bwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + tail
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


def _forward_rpr(q, k, v, pad, tk, tv, max_rel, causal, rate, words):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    o = torch.empty_like(q)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _rpr_library()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            tk.data_ptr(), tv.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), _DTYPES[q.dtype], b, h, lq, lk, dh, max_rel,
            int(causal), float(dh) ** -0.5, *_dropout_args(rate, words),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "RPR forward")
    launches["fused_attention_rpr"] += 1
    return o, m, l


def _backward_rpr(q, k, v, pad, tk, tv, o, do, m, l, max_rel, causal, rate,
                  words):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    buckets = tk.shape[0]
    blocks = b * h * -(-lq // 32)     # the dq kernel's grid: 32 rows a block
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dtk, dtv = torch.empty_like(tk), torch.empty_like(tv)
    delta = torch.empty_like(m)
    qr = torch.empty((b * h, lq, buckets), **f32)
    dwb = torch.empty_like(qr)
    part_tk = torch.empty((blocks, buckets, dh), **f32)
    part_tv = torch.empty_like(part_tk)
    with torch.cuda.device(q.device):
        err = _rpr_library()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            tk.data_ptr(), tv.data_ptr(), o.data_ptr(), do.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr(), qr.data_ptr(),
            dwb.data_ptr(), part_tk.data_ptr(), part_tv.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dtk.data_ptr(),
            dtv.data_ptr(), _DTYPES[q.dtype], b, h, lq, lk, dh, max_rel,
            int(causal), float(dh) ** -0.5, *_dropout_args(rate, words),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "RPR backward")
    launches["fused_attention_rpr_backward"] += 1
    return dq, dk, dv, dtk, dtv


class _FusedAttentionRpr(torch.autograd.Function):
    """RPR forward kernel; backward kernels for dq, dk, dv, dTk, dTv."""

    @staticmethod
    def forward(ctx, q, k, v, pad, tk, tv, max_rel, causal, rate, words):
        o, m, l = _forward_rpr(q, k, v, pad, tk, tv, max_rel, causal, rate,
                               words)
        ctx.save_for_backward(q, k, v, pad, tk, tv, o, m, l)
        ctx.args = (max_rel, causal, rate, words)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, tk, tv, o, m, l = ctx.saved_tensors
        dq, dk, dv, dtk, dtv = _backward_rpr(q, k, v, pad, tk, tv, o,
                                             do.contiguous(), m, l,
                                             *ctx.args)
        return dq, dk, dv, None, dtk, dtv, None, None, None, None


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


def _check_rpr(q, tk, tv, max_rel: int):
    dh = q.shape[-1]
    if not 0 <= max_rel <= MAX_RELATIVE_POSITION:
        raise ValueError("fused_attention: max_relative_position %d outside "
                         "[0, %d]" % (max_rel, MAX_RELATIVE_POSITION))
    if tuple(tk.shape) != (2 * max_rel + 1, dh) or tk.shape != tv.shape \
            or tk.device != q.device:
        raise ValueError("fused_attention: RPR tables must be [2m+1, Dh] = "
                         "[%d, %d] on %s; got %s, %s" % (
                             2 * max_rel + 1, dh, q.device, tuple(tk.shape),
                             tuple(tv.shape)))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, dropout_rate: float = 0.0,
                    rng=None, rpr_tables=None,
                    max_relative_position: Optional[int] = None
                    ) -> torch.Tensor:
    """Fused attention over [B, H, L, Dh] projections.

    pad_mask: [B, Lk] 1/0 key-side padding mask (None = all valid); the
    Dh^-0.5 scaling happens inside. Dropout runs when ``rng`` (a pair of
    seed words) is given and 0 < dropout_rate < 1. ``rpr_tables`` (an
    object with [2m+1, Dh] ``keys`` and ``values``, as ops/rpr.py:RprTables)
    with ``max_relative_position`` m adds Shaw relative positions; the
    tables are cast to the query dtype, differentiably. Returns
    [B, H, Lq, Dh] in the query dtype.
    """
    b, lk = q.shape[0], k.shape[2]
    if pad_mask is None:
        pad_mask = torch.ones((b, lk), dtype=torch.float32, device=q.device)
    pad = pad_mask.float().contiguous()
    rate = float(dropout_rate) if (rng is not None
                                   and 0.0 < dropout_rate < 1.0) else 0.0
    words = tuple(rng) if rate else (0, 0)
    tables = None
    if rpr_tables is not None:
        if max_relative_position is None:
            raise ValueError("fused_attention: rpr_tables needs "
                             "max_relative_position")
        max_rel = int(max_relative_position)
        tables = (rpr_tables.keys.to(q.dtype).contiguous(),
                  rpr_tables.values.to(q.dtype).contiguous())
    if q.device.type == "cpu":
        if tables is not None:
            return fused_attention_rpr_ref(q, k, v, pad, *tables, max_rel,
                                           causal, rate, rng)
        return fused_attention_ref(q, k, v, pad, causal, rate, rng)
    if not q.is_cuda:
        raise ValueError("fused_attention: unsupported device %s" % q.device)
    _check(q, k, v, pad)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if tables is not None:
        _check_rpr(q, *tables, max_rel)
        return _FusedAttentionRpr.apply(q, k, v, pad, *tables, max_rel,
                                        bool(causal), rate, words)
    return _FusedAttention.apply(q, k, v, pad, bool(causal), rate, words)
