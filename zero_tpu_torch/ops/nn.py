"""Core NN primitives: linear, layer norm, FFN, positional signal, masks,
and AAN's cumulative average.

Counterparts of ``zero_tpu/ops/nn.py``. Each primitive is an (init_*, *)
pair as there: ``init_*`` builds a parameter module whose state-dict names
follow the JAX param paths (``ws.0``, ``b``, ``lns.0.scale``, ``scale``,
``offset``, ``enlarge``, ``output``), and the apply function is a plain
function of (module, inputs).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from zero_tpu_torch.ops import common
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops.kernels import fused_ffn as fused_ffn_mod
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

class Linear(torch.nn.Module):
    """Multi-input dense layer: one [in_i, out] weight per input in ``ws``
    (summed; equivalent to one weight over the concatenated inputs), an
    optional bias ``b`` and, for the RNN models' variant, one LayerNorm
    per input in ``lns`` (no ``lns`` key without it)."""

    def __init__(self, ws: Sequence[torch.Tensor], b=None, lns=None):
        super().__init__()
        self.ws = torch.nn.ParameterList(
            [torch.nn.Parameter(w) for w in ws])
        self.b = None if b is None else torch.nn.Parameter(b)
        self.lns = None if lns is None else torch.nn.ModuleList(lns)


def init_linear(gen, in_sizes: Union[int, Sequence[int]], out_size: int,
                bias: bool = True, weight_init=None,
                ln: bool = False) -> Linear:
    """``ln=True`` adds a LayerNorm per input projection, applied before
    the sum (``linear(..., ln=True)``)."""
    if isinstance(in_sizes, int):
        in_sizes = [in_sizes]
    weight_init = weight_init or inits.variance_scaling(1.0, "uniform")
    ws = [weight_init(gen, (isz, out_size)) for isz in in_sizes]
    lns = [init_layer_norm(out_size) for _ in in_sizes] if ln else None
    return Linear(ws, torch.zeros(out_size) if bias else None, lns)


def linear(params: Linear, xs, ln: bool = False, eps: float = 1e-8):
    """Apply a (possibly multi-input) dense layer; xs is a tensor or list.
    ``ln``: each input's projection is layer-normed before the sum."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    o = None
    for i, (x, w) in enumerate(zip(xs, params.ws)):
        y = torch.matmul(x, w.to(x.dtype))
        if ln:
            y = fused_layer_norm(params.lns[i], y, eps=eps)
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


def fused_layer_norm(params: LayerNorm, x, eps: float = 1e-8):
    """layer_norm's formula (biased variance, statistics in fp32) as torch's
    one-kernel layer norm: the RNN models run a per-input norm in every
    time step's products, where launches set the step's time."""
    out = torch.nn.functional.layer_norm(x.float(), x.shape[-1:],
                                         params.scale.float(),
                                         params.offset.float(), eps)
    return out.to(x.dtype)


def residual_fn(x, y, rng=None, drop: Optional[float] = None):
    """Residual connection with dropout on the branch; y [B, L, d] may be
    a sequence block (its draws index the whole sequence)."""
    split = common.seq_split(1, y.shape[1]) if y.dim() == 3 else None
    return x + common.dropout(rng, y, drop, split=split)


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
    paths draw the same dropout mask from ``rng``'s seed words.

    Under tensor parallelism (a column-split ``enlarge``,
    parallel/tensor.py) the process runs its slice of the hidden width,
    the kernels included, with the whole width's dropout index; the
    partial output is summed over the line, then ``output``'s bias is
    added once. Over a split sequence x [B, L/n, d] is a block, whose
    dropout index is the whole sequence's (the kernels' row map)."""
    part = tp.column(params.enlarge)
    hidden = None
    seq = common.seq_split(1, x.shape[1]) if x.dim() == 3 else None
    if part is not None:
        x = dist.copy_in(x, part.axis)
        width = params.enlarge.ws[0].shape[-1]
        hidden = (part.offset(width), width * part.degree)
    if fused:
        if params.enlarge.b is None or params.output.b is None:
            raise ValueError("fused FFN needs biases on both linears")
        dtype = x.dtype
        rate = relu_dropout if (rng is not None and relu_dropout) else 0.0
        b2 = params.output.b.to(dtype)
        y = fused_ffn_mod.fused_ffn(
            x, params.enlarge.ws[0].to(dtype), params.enlarge.b.to(dtype),
            params.output.ws[0].to(dtype),
            b2 if part is None else torch.zeros_like(b2), rng, rate, hidden,
            None if seq is None else (x.shape[1], seq[2], seq[1]))
        if part is None:
            return y
        return dist.reduce_out(y, part.axis) + b2
    h = torch.relu(linear(params.enlarge, x))
    splits = [] if hidden is None else [(-1,) + hidden]
    if seq is not None:
        splits.append(seq)
    h = common.dropout(rng, h, relu_dropout, split=splits)
    return tp.row_linear(params.output, h)


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


def add_timing_signal(x, time=None, offset: int = 0):
    """Add the positional signal; an int ``time`` selects decode-position
    mode (the signal of that one position); ``offset``: x holds positions
    [offset, offset + L) (a sequence block)."""
    length, channels = x.shape[-2], x.shape[-1]
    if time is None and offset:
        position = torch.arange(offset, offset + length, device=x.device)
        sig = timing_signal(position, channels, dtype=x.dtype)
    elif time is None:
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


# ---------------------------------------------------------------------------
# average attention (AAN)
# ---------------------------------------------------------------------------

def aan_cummean(x, mask, masked: bool = True):
    """AAN cumulative (masked) mean, O(L) cumsum form, fp32 accumulation.

    Per position g, equal to ``einsum(aan_weight(mask), x)``:
      masked:   m_g * (sum_{j<=g} m_j x_j) / max(sum_{j<=g} m_j, 1)
      unmasked: (sum_{j<=g} x_j)          / max(sum_{j<=g} m_j, 1)
    x: [B, L, d]; mask: [B, L] 0/1."""
    mf = mask.float()
    xf = x.float()
    num = torch.cumsum(xf * mf[..., None] if masked else xf, dim=1)
    cnt = torch.cumsum(mf, dim=1)
    out = num / torch.clamp(cnt, min=1.0)[..., None]
    if masked:
        out = out * mf[..., None]
    return out.to(x.dtype)


def aan_step_count(time: int, dtype) -> float:
    """The decode step's count of positions, time + 1, rounded to the
    compute dtype (the JAX package divides the running sum by it in that
    dtype), as a host float: no host-to-device copy."""
    return torch.tensor(float(time + 1)).to(dtype).item()


def aan_weight(mask, dtype=torch.float32):
    """AAN weight matrix [B, L, L]: the row-normalised cumulative average
    over valid positions, w[i, j] = m[i, j] / sum_j m[i, j] with
    m = outer(mask) * tril (rows without a valid position are 0)."""
    length = mask.shape[1]
    tril = torch.tril(torch.ones((length, length), device=mask.device))
    mf = mask.float()
    m = mf[:, :, None] * mf[:, None, :] * tril[None]
    denom = m.sum(dim=-1, keepdim=True)
    w = torch.where(denom > 0, m / torch.clamp(denom, min=1.0), 0.0)
    return w.to(dtype)
