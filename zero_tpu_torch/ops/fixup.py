"""Fixup components: training deep transformers without layer norm.

Counterpart of ``zero_tpu/ops/fixup.py``: scalar shift and scale
parameters ((1,)-shaped ``offset`` and ``scale`` leaves), an FFN with a
numblocks^-1/2-scaled input init, a zero-init output and a shift/scale
sandwich, and attention with input inits scaled by numblocks^-1/6 (or
^-1/8 on the fuse path), biasless projections and a zero-init ``o``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from zero_tpu_torch.ops import attention
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import dropout
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp


class Shift(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.offset = torch.nn.Parameter(torch.zeros(1))

    @staticmethod
    def of(offset: torch.Tensor):
        """A stand-in holding ``offset`` as it enters a computation."""
        return _ShiftView(offset)


class Scale(torch.nn.Module):
    def __init__(self, init: float = 1.0):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.full((1,), float(init)))


class _ShiftView(NamedTuple):
    offset: torch.Tensor


def init_shift() -> Shift:
    return Shift()


def shift(params: Shift, x):
    return x - params.offset.to(x.dtype)


def init_scale(init: float = 1.0) -> Scale:
    return Scale(init)


def scale(params: Scale, x):
    return x * params.scale.to(x.dtype)


class FixupFFN(torch.nn.Module):
    def __init__(self, parts: dict):
        super().__init__()
        for name, part in parts.items():
            self.add_module(name, part)


def init_fixup_ffn(gen, d_in: int, d_hidden: int, d_out: int, numblocks: int,
                   base_init=None) -> FixupFFN:
    """Input weight scaled by numblocks^-1/2, output weight zero, no
    biases, three shifts and one scale."""
    base_init = base_init or inits.variance_scaling(1.0, "uniform")
    in_init = inits.scale(math.pow(numblocks, -0.5), base_init)
    return FixupFFN({
        "shift0": init_shift(),
        "enlarge": nn.init_linear(gen, d_in, d_hidden, bias=False,
                                  weight_init=in_init),
        "shift1": init_shift(),
        "shift2": init_shift(),
        "output": nn.init_linear(gen, d_hidden, d_out, bias=False,
                                 weight_init=inits.zeros()),
        "scale": init_scale(1.0),
    })


def fixup_ffn(params: FixupFFN, x, rng=None, relu_dropout=None):
    """The shift/scale sandwich around relu(x W1) W2. Under tensor
    parallelism (a column-split ``enlarge``) the process runs its slice
    of the hidden width; the shifts inside it are replicated scalars whose
    gradient is summed over the line, and the row-split output is summed
    over it."""
    x = shift(params.shift0, x)
    part = tp.column(params.enlarge)
    inner1, inner2, split = params.shift1, params.shift2, None
    if part is not None:
        x = dist.copy_in(x, part.axis)
        inner1 = Shift.of(dist.copy_in(params.shift1.offset, part.axis))
        inner2 = Shift.of(dist.copy_in(params.shift2.offset, part.axis))
        width = params.enlarge.ws[0].shape[-1]
        split = (-1, part.offset(width), width * part.degree)
    h = nn.linear(params.enlarge, x)
    h = shift(inner1, h)
    h = torch.relu(h)
    h = dropout(rng, h, relu_dropout, split=split)
    h = shift(inner2, h)
    out = tp.row_linear(params.output, h)
    return scale(params.scale, out)


def init_fixup_attention(gen, d_query: int, hidden: int, self_attention: bool,
                         numblocks: int, d_memory=None, fuse: bool = False,
                         base_init=None) -> attention.Attention:
    """Input inits scaled by numblocks^(-1/6), ^(-1/8) on the fuse path;
    biasless projections; zero-init ``o``."""
    base_init = base_init or inits.variance_scaling(1.0, "uniform")
    scale_base = 8.0 if fuse else 6.0
    in_init = inits.scale(math.pow(numblocks, -1.0 / scale_base), base_init)
    return attention.init_attention(
        gen, d_query, hidden, self_attention, d_memory=d_memory, fuse=fuse,
        bias=False, weight_init=in_init, out_init=inits.zeros())
