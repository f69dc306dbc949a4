"""Fused FFN (linear -> ReLU -> dropout -> linear) for training: CUDA
kernels for Hopper and their plain PyTorch version.

Replaces the Pallas TPU kernels of ``zero_tpu/ops/kernels/fused_ffn.py``:

* forward -- ``_fused_forward`` (``pallas_call`` at :186, ``_fwd_kernel``):
  relu(x @ W1 + b1) rounded to the compute dtype after the product and
  after the bias, 8-bit threshold dropout (keep = low8(bits) < t, scale
  256/t), then @ W2 + b2; the [rows, filter] hidden tile is never stored.
* backward -- ``_bwd_rule`` (``pallas_call`` at :214, ``_bwd_kernel``):
  the hidden tile and its mask regenerated, then dx, dW1, db1, dW2, db2
  with fp32 accumulation.

Both run ``csrc/fused_ffn.cu`` (its header gives the design and the bound),
wrapped in one ``torch.autograd.Function`` whose backward is the backward
kernel.

Dropout. The TPU kernels seed the TPU's hardware PRNG per row block, which
ties the forward and backward to one tiling. The port draws hidden element
(row, col)'s keep bit from ``ops/common.py:_hash_bits`` over the linear
index row*filter + col with the site's two seed words: the mask is
bit-identical to the one ``ops/common.py:dropout`` (and the JAX package's
composite ``ffn``) draws over the [N, filter] hidden tensor from the same
words. The scale 256/t is rounded to the compute dtype, as there.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor goes
to ``fused_ffn_ref``. ``launches`` counts the kernel launches by wrapper
("fused_ffn", "fused_ffn_backward") and the plain version's calls
("fused_ffn_ref").
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops.kernels import cuda_build

MAX_WIDTH = 1024     # d_in, d_out: the kernels' register and shared tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()


def _drop_args(rate: float, words, dtype):
    """(t, scale) of the 8-bit threshold dropout, the scale rounded to the
    compute dtype; t = 256 when dropout is off."""
    t = common.keep_threshold(rate) if words is not None else 256
    if t >= 256:
        return 256, 1.0
    return t, common.keep_scale(t, dtype)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def fused_ffn_ref(x, w1, b1, w2, b2, rng=None, rate: float = 0.0):
    """Plain PyTorch fused FFN over x [N, d_in] (all in x's dtype)."""
    launches["fused_ffn_ref"] += 1
    t, inv = _drop_args(rate, rng, x.dtype)
    h = torch.relu(torch.matmul(x, w1) + b1)
    if t < 256:
        keep = (common._hash_bits(rng, h.shape, h.device) & 255) < t
        h = torch.where(keep, h * inv, torch.zeros_like(h))
    return torch.matmul(h, w2) + b2


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("fused_ffn")
    fwd = lib.zt_ffn_forward
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.zt_ffn_backward
    bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _seeds(words):
    if words is None:
        return 0, 0
    return int(words[0]) & 0xFFFFFFFF, int(words[-1]) & 0xFFFFFFFF


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError("fused FFN %s kernel launch failed: CUDA error %d"
                           % (what, err))


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, t, inv, words):
        n, d_in = x.shape
        f, d_out = w2.shape
        y = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            err = _library()[0](
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], n, d_in, f,
                d_out, int(t < 256), t, inv, *_seeds(words),
                torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "forward")
        launches["fused_ffn"] += 1
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.args = (t, inv, words)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        t, inv, words = ctx.args
        dy = dy.contiguous()
        n, d_in = x.shape
        f, d_out = w2.shape
        dev = x.device
        rows = (n + 15) // 16
        dx = torch.empty_like(x)
        hd = torch.empty((n, f), dtype=x.dtype, device=dev)
        dh = torch.empty_like(hd)
        part = torch.empty((rows, f), dtype=torch.float32, device=dev)
        dw1 = torch.empty((d_in, f), dtype=torch.float32, device=dev)
        dw2 = torch.empty((f, d_out), dtype=torch.float32, device=dev)
        db1 = torch.empty((f,), dtype=torch.float32, device=dev)
        db2 = torch.empty((d_out,), dtype=torch.float32, device=dev)
        w1t = w1.t().contiguous()
        w2t = w2.t().contiguous()
        with torch.cuda.device(dev):
            err = _library()[1](
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                w1t.data_ptr(), w2t.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                hd.data_ptr(), dh.data_ptr(), part.data_ptr(),
                dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                db2.data_ptr(), _DTYPES[x.dtype], n, d_in, f, d_out,
                int(t < 256), t, inv, *_seeds(words),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "backward")
        launches["fused_ffn_backward"] += 1
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(w2.dtype), None, None, None)


def _check(x, w1, b1, w2, b2):
    tensors = (x, w1, b1, w2, b2)
    if len({t.dtype for t in tensors}) != 1 or x.dtype not in _DTYPES:
        raise ValueError("fused_ffn: x/W/b must share one dtype of %s, got %s"
                         % (list(_DTYPES), [t.dtype for t in tensors]))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_ffn: inputs on different devices")
    d_in, f = w1.shape
    if x.shape[1] != d_in or w2.shape[0] != f or b1.shape != (f,) \
            or b2.shape != (w2.shape[1],):
        raise ValueError("fused_ffn: need x [N, d_in], W1 [d_in, f], b1 [f], "
                         "W2 [f, d_out], b2 [d_out]; got %s"
                         % [tuple(t.shape) for t in tensors])
    if max(d_in, w2.shape[1]) > MAX_WIDTH:
        raise ValueError("fused_ffn: widths %d, %d exceed %d"
                         % (d_in, w2.shape[1], MAX_WIDTH))


def fused_ffn(x: torch.Tensor, w1, b1, w2, b2, rng=None,
              rate: float = 0.0) -> torch.Tensor:
    """relu(x @ W1 + b1) -> dropout -> @ W2 + b2 over x [..., d_in], all in
    x's dtype. Dropout runs when ``rng`` (a pair of seed words) is given and
    0 < rate < 1. Returns [..., d_out]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = fused_ffn_ref(x2, w1, b1, w2, b2, rng, rate)
    elif not x.is_cuda:
        raise ValueError("fused_ffn: unsupported device %s" % x.device)
    else:
        _check(x2, w1, b1, w2, b2)
        t, inv = _drop_args(rate, rng, x.dtype)
        y = _FusedFFN.apply(x2.contiguous(), w1.contiguous(), b1.contiguous(),
                            w2.contiguous(), b2.contiguous(), t, inv,
                            tuple(rng) if t < 256 else None)
    return y.reshape(*lead, w2.shape[1])
