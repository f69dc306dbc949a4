"""Fused FFN (linear -> ReLU -> dropout -> linear) for training: CUDA
kernels for Hopper and their plain PyTorch version.

Replaces the Pallas TPU kernels of ``zero_tpu/ops/kernels/fused_ffn.py``:

* forward -- ``_fused_forward`` (``pallas_call`` at :186, ``_fwd_kernel``):
  relu(x @ W1 + b1) rounded to the compute dtype after the product and
  after the bias, 8-bit threshold dropout (keep = low8(bits) < t, scale
  256/t), then @ W2 + b2.
* backward -- ``_bwd_rule`` (``pallas_call`` at :214, ``_bwd_kernel``):
  the hidden tile and its mask regenerated, then dx, dW1, db1, dW2, db2
  with fp32 accumulation.

Both run ``csrc/fused_ffn.cu`` (its header gives the design and the bound),
wrapped in one ``torch.autograd.Function`` whose backward is the backward
kernel. The dtype picks the kernels: bf16 runs tensor-core kernels
(``wgmma``; the forward stores the dropped hidden [N, filter] once in bf16
between its two products), fp32 the CUDA-core kernels, exact in fp32
(tensor cores would be TF32 there). Neither transposes a weight.

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

MAX_WIDTH = 1024     # d_in, d_out: the fp32 kernels' register and shared tiles
BF16_MULTIPLE = 16   # bf16 widths: the tensor-core kernels copy 16-byte chunks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# token rows behind one partial column sum (the kernels' row tiles)
_PART_ROWS = {torch.float32: 16, torch.bfloat16: 128}

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

def fused_ffn_ref(x, w1, b1, w2, b2, rng=None, rate: float = 0.0,
                  hidden=None, tokens=None):
    """Plain PyTorch fused FFN over x [N, d_in] (all in x's dtype);
    ``hidden`` = (offset, whole width) of a slice of the hidden width;
    ``tokens`` = (local, whole, offset): the N rows are N / local sequence
    blocks of ``local`` tokens at ``offset`` in sequences of ``whole``."""
    launches["fused_ffn_ref"] += 1
    t, inv = _drop_args(rate, rng, x.dtype)
    h = torch.relu(torch.matmul(x, w1) + b1)
    if t < 256:
        splits = [] if hidden is None else [(-1,) + tuple(hidden)]
        shape = h.shape
        if tokens is not None:
            local, whole, offset = tokens
            shape = (h.shape[0] // local, local, h.shape[1])
            splits.append((1, offset, whole))
        keep = (common._hash_bits(rng, shape, h.device, split=splits)
                & 255).reshape(h.shape) < t
        h = torch.where(keep, h * inv, torch.zeros_like(h))
    return torch.matmul(h, w2) + b2


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("fused_ffn")
    fwd = lib.zt_ffn_forward
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                    + [ctypes.c_float] + [ctypes.c_uint] * 8
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.zt_ffn_backward
    bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                    + [ctypes.c_float] + [ctypes.c_uint] * 8
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _seeds(words):
    """(s0, s1, index base, whole width, column offset, block tokens, whole
    tokens, token offset) as u32 launch arguments; all zeros without
    dropout (``words`` None), which the kernels then do not read."""
    if words is None:
        return (0,) * 8
    return tuple(int(w) & 0xFFFFFFFF for w in words)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError("fused FFN %s kernel launch failed: CUDA error %d"
                           % (what, err))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the tensor-core kernels copy
    16-byte chunks); a misaligned view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, t, inv, words):
        n, d_in = x.shape
        f, d_out = w2.shape
        y = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
        # bf16: the dropped hidden between the two products
        hd = (torch.empty((n, f), dtype=x.dtype, device=x.device)
              if x.dtype == torch.bfloat16 else None)
        with torch.cuda.device(x.device):
            err = _library()[0](
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), y.data_ptr(),
                None if hd is None else hd.data_ptr(), _DTYPES[x.dtype], n,
                d_in, f, d_out, int(t < 256), t, inv, *_seeds(words),
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
        dy = _aligned(dy)
        n, d_in = x.shape
        f, d_out = w2.shape
        dev = x.device
        rows = -(-n // _PART_ROWS[x.dtype])
        dx = torch.empty_like(x)
        hd = torch.empty((n, f), dtype=x.dtype, device=dev)
        dh = torch.empty_like(hd)
        part = torch.empty((rows, f + d_out), dtype=torch.float32,
                           device=dev)
        dw1 = torch.empty((d_in, f), dtype=torch.float32, device=dev)
        dw2 = torch.empty((f, d_out), dtype=torch.float32, device=dev)
        db1 = torch.empty((f,), dtype=torch.float32, device=dev)
        db2 = torch.empty((d_out,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _library()[1](
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                dy.data_ptr(), dx.data_ptr(),
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
    if x.dtype == torch.bfloat16 and any(
            w % BF16_MULTIPLE for w in (d_in, f, w2.shape[1])):
        raise ValueError("fused_ffn: bf16 widths d_in, f, d_out must be "
                         "multiples of %d, got %d, %d, %d"
                         % (BF16_MULTIPLE, d_in, f, w2.shape[1]))


def fused_ffn(x: torch.Tensor, w1, b1, w2, b2, rng=None,
              rate: float = 0.0, hidden=None, tokens=None) -> torch.Tensor:
    """relu(x @ W1 + b1) -> dropout -> @ W2 + b2 over x [..., d_in], all in
    x's dtype. Dropout runs when ``rng`` (a pair of seed words) is given and
    0 < rate < 1. ``hidden`` = (offset, whole width): W1's columns are the
    slice [offset, offset + f) of a wider hidden layer (tensor
    parallelism), whose dropout index is the whole layer's. ``tokens`` =
    (local, whole, offset): x's rows are sequence blocks of ``local``
    tokens at ``offset`` in sequences of ``whole`` (sequence parallelism),
    whose dropout index is the whole sequences' (the kernels' row map).
    Returns [..., d_out]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = fused_ffn_ref(x2, w1, b1, w2, b2, rng, rate, hidden, tokens)
    elif not x.is_cuda:
        raise ValueError("fused_ffn: unsupported device %s" % x.device)
    else:
        _check(x2, w1, b1, w2, b2)
        t, inv = _drop_args(rate, rng, x.dtype)
        # the seed words, the global index of hidden element 0 (data
        # parallelism: ops/common.py:index_base) and the hidden slice
        offset, width = hidden if hidden is not None else (0, w1.shape[1])
        if tokens is None:
            local, whole, first = x2.shape[0], x2.shape[0], 0
            base = common.index_base((x2.shape[0], width))
        else:
            local, whole, first = tokens
            base = common.index_base((x2.shape[0] // local, whole, width))
        words = ((rng[0], rng[-1], base, width, offset, local, whole, first)
                 if t < 256 else None)
        y = _FusedFFN.apply(_aligned(x2), _aligned(w1), b1.contiguous(),
                            _aligned(w2), b2.contiguous(), t, inv, words)
    return y.reshape(*lead, w2.shape[1])
