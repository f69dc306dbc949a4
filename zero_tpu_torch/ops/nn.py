"""Core NN primitives: linear, layer norm, FFN, positional signal, masks.

Counterparts of ``zero_tpu/ops/nn.py``. Each primitive is an (init_*, *)
pair as there: ``init_*`` builds a parameter module whose state-dict names
follow the JAX param paths (``ws.0``, ``b``, ``scale``, ``offset``,
``enlarge``, ``output``), and the apply function is a plain function of
(module, inputs).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops.kernels import fused_ffn as fused_ffn_mod


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

class Linear(torch.nn.Module):
    """Multi-input dense layer: one [in_i, out] weight per input in ``ws``
    (summed; equivalent to one weight over the concatenated inputs) and an
    optional bias ``b``."""

    def __init__(self, ws: Sequence[torch.Tensor], b=None):
        super().__init__()
        self.ws = torch.nn.ParameterList(
            [torch.nn.Parameter(w) for w in ws])
        self.b = None if b is None else torch.nn.Parameter(b)


def init_linear(gen, in_sizes: Union[int, Sequence[int]], out_size: int,
                bias: bool = True, weight_init=None) -> Linear:
    if isinstance(in_sizes, int):
        in_sizes = [in_sizes]
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    ws = [weight_init(gen, (isz, out_size)) for isz in in_sizes]
    return Linear(ws, torch.zeros(out_size) if bias else None)


def linear(params: Linear, xs):
    """Apply a (possibly multi-input) dense layer; xs is a tensor or list."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    o = None
    for x, w in zip(xs, params.ws):
        y = torch.matmul(x, w.to(x.dtype))
        o = y if o is None else o + y
    if params.b is not None:
        o = o + params.b.to(o.dtype)
    return o


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class LayerNorm(torch.nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(size))
        self.offset = torch.nn.Parameter(torch.zeros(size))


def init_layer_norm(size: int) -> LayerNorm:
    return LayerNorm(size)


def layer_norm(params: LayerNorm, x, eps: float = 1e-8):
    """LayerNorm with the biased-variance formula; statistics in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = params.scale.float() * normed + params.offset.float()
    return out.to(x.dtype)


def residual_fn(x, y, rng=None, drop: Optional[float] = None):
    """Residual connection with dropout on the branch."""
    return x + common.dropout(rng, y, drop)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

class FFN(torch.nn.Module):
    def __init__(self, enlarge: Linear, output: Linear):
        super().__init__()
        self.enlarge = enlarge
        self.output = output


def init_ffn(gen, d_in: int, d_hidden: int, d_out: int,
             weight_init=None) -> FFN:
    return FFN(init_linear(gen, d_in, d_hidden, weight_init=weight_init),
               init_linear(gen, d_hidden, d_out, weight_init=weight_init))


def ffn(params: FFN, x, rng=None, relu_dropout: Optional[float] = None,
        fused: bool = False):
    """ReLU FFN with dropout on the hidden activation.

    fused=True routes through the fused kernels of
    ops/kernels/fused_ffn.py (their plain version for CPU tensors). Both
    paths draw the same dropout mask from ``rng``'s seed words."""
    if fused:
        if params.enlarge.b is None or params.output.b is None:
            raise ValueError("fused FFN needs biases on both linears")
        dtype = x.dtype
        rate = relu_dropout if (rng is not None and relu_dropout) else 0.0
        return fused_ffn_mod.fused_ffn(
            x, params.enlarge.ws[0].to(dtype), params.enlarge.b.to(dtype),
            params.output.ws[0].to(dtype), params.output.b.to(dtype), rng,
            rate)
    h = torch.relu(linear(params.enlarge, x))
    h = common.dropout(rng, h, relu_dropout)
    return linear(params.output, h)


# ---------------------------------------------------------------------------
# positional encoding
# ---------------------------------------------------------------------------

def timing_signal(length_or_position, channels: int,
                  min_timescale: float = 1.0, max_timescale: float = 1.0e4,
                  dtype=torch.float32, device=None):
    """Sin/cos positional signal [len, channels], computed in fp32.

    ``length_or_position`` is either an int length (positions 0..L-1) or
    a tensor of positions (decode: the current time)."""
    if isinstance(length_or_position, int):
        position = torch.arange(length_or_position, dtype=torch.float32,
                                device=device)
    else:
        position = length_or_position.to(torch.float32).reshape(-1)
        device = position.device
    num_timescales = channels // 2
    log_inc = (math.log(max_timescale / min_timescale)
               / max(num_timescales - 1, 1))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_inc)
    scaled = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if channels % 2:
        signal = torch.nn.functional.pad(signal, (0, 1))
    return signal.to(dtype)


def add_timing_signal(x, time=None):
    """Add the positional signal; an int ``time`` selects decode-position
    mode (the signal of that one position)."""
    length, channels = x.shape[-2], x.shape[-1]
    if time is None:
        sig = timing_signal(length, channels, dtype=x.dtype, device=x.device)
    else:
        position = torch.full((1,), float(time), device=x.device)
        sig = timing_signal(position, channels, dtype=x.dtype)
    return x + sig[None, :, :]


# ---------------------------------------------------------------------------
# attention masks
# ---------------------------------------------------------------------------

def causal_mask(length: int, dtype=torch.float32, device=None):
    """[1, 1, L, L] 1/0 lower-triangular keep-mask."""
    return torch.tril(torch.ones((length, length), dtype=dtype,
                                 device=device))[None, None, :, :]


def masking_mask(mask, dtype=torch.float32):
    """[B, 1, 1, S] keep-mask from a [B, S] 0/1 pad mask."""
    return mask.to(dtype)[:, None, None, :]
