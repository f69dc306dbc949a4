"""Tensor ('model') and expert ('expert') parallelism inside the model.

The JAX package lays the parameters out over its mesh
(``zero_tpu/parallel/mesh.py:param_sharding``) and lets GSPMD partition
every product, the Pallas kernels' included. Here each process holds its
part of every split leaf (parallel/mesh.py:Layout) and the model code
runs Megatron's regions on it:

  * column-parallel ``qkv``/``q``/``k``/``v``/``enlarge``: the replicated
    input enters through ``copy_in`` and the process computes its heads
    (attention) or its slice of the hidden width (FFN); the kernels #1-#4
    and #11/#12 run on those;
  * row-parallel ``o``/``output``: the partial product leaves through
    ``reduce_out``, then the replicated bias is added once;
  * vocab-parallel embeddings: a lookup of the ids in the process's rows,
    zero elsewhere, summed by ``reduce_out``; the tied softmax's
    label-smoothed cross entropy over [N, V/W] logits with four sums over
    the line (Megatron's vocab-parallel cross entropy);
  * expert parallelism (ops/moe.py): the process runs its experts.

``tag_module`` marks each module whose tensors are parts with
``tp_parts`` ({leaf: (Part, dim counted from the end)}: a scan_layers
stack's layer slice keeps it); the model code reads the tags, so a
module gathered whole (distributed.host_fetchable, clear_tags) runs as
on one device. A leaf that the divisibility fallback leaves whole is not
tagged and runs whole on every process of the line, as under GSPMD.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch


@dataclass(frozen=True)
class Part:
    """This process's place on mesh axis ``axis``: part ``coord`` of
    ``degree``."""
    axis: str
    degree: int
    coord: int

    def offset(self, local: int) -> int:
        """The whole dim's index of the part's first element, for a part
        ``local`` long."""
        return self.coord * local


def _owner(name: str):
    """(the owning module's path, the leaf's path under it) of parameter
    ``name``: a Linear owns ``ws.<i>`` and ``b``."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "ws":
        return ".".join(parts[:-2]), ".".join(parts[-2:])
    return ".".join(parts[:-1]), parts[-1]


def tag_module(module: torch.nn.Module, layout) -> None:
    """Mark the owners of ``layout``'s split leaves (their tensors must
    already be this process's parts)."""
    for name, split in layout.splits.items():
        owner, leaf = _owner(name)
        target = module.get_submodule(owner) if owner else module
        tags = target.__dict__.setdefault("tp_parts", {})
        tags[leaf] = (Part(split.axis, split.degree, split.coord),
                      split.dim - len(layout.wholes[name]))


def clear_tags(module: torch.nn.Module) -> None:
    for sub in module.modules():
        sub.__dict__.pop("tp_parts", None)


@contextlib.contextmanager
def untagged(module: torch.nn.Module):
    """Within: ``module`` carries no split tag (it runs on whole tensors
    substituted through functional_call); the tags come back after."""
    saved = [(sub, sub.__dict__.pop("tp_parts")) for sub in module.modules()
             if "tp_parts" in sub.__dict__]
    try:
        yield
    finally:
        for sub, tags in saved:
            sub.__dict__["tp_parts"] = tags


def leaf_part(module, leaf: str) -> Optional[tuple]:
    """(Part, dim from the end) of ``module``'s leaf ``leaf``, or None
    when whole."""
    tags = getattr(module, "tp_parts", None)
    return None if tags is None else tags.get(leaf)


def column(linear) -> Optional[Part]:
    """The Part of a column-parallel Linear (its output dim split)."""
    tag = leaf_part(linear, "ws.0")
    if tag is None or tag[1] != -1:
        return None
    return tag[0]


def row(linear) -> Optional[Part]:
    """The Part of a row-parallel Linear (its input dim split)."""
    tag = leaf_part(linear, "ws.0")
    if tag is None or tag[1] != -2:
        return None
    return tag[0]


def row_linear(linear, x):
    """A Linear on ``x``: row-parallel (the partial product summed over
    the line, then the bias once) where it is split, else whole."""
    from zero_tpu_torch.ops import nn
    from zero_tpu_torch.parallel import distributed as dist
    part = row(linear)
    if part is None:
        return nn.linear(linear, x)
    y = dist.reduce_out(torch.matmul(x, linear.ws[0].to(x.dtype)), part.axis)
    return y if linear.b is None else y + linear.b.to(y.dtype)


def stack_tensors(stack) -> dict:
    """{name: tensor} of a scan_layers stack, each leaf with every layer:
    a leaf that a line splits along its layer dim (a row layer's stacked
    bias [L, d], which param_specs splits at dim 0 where the degree
    divides L, as the JAX spec does) is made whole, its layers put in
    place and summed over the line (``reduce_out``: each process gets
    the gradient of its own layers back). COLLECTIVE for such leaves."""
    from zero_tpu_torch.parallel import distributed as dist
    out = {}
    for name, t in stack.named_parameters():
        owner, leaf = _owner(name)
        tag = leaf_part(stack.get_submodule(owner) if owner else stack,
                        leaf)
        if tag is not None and tag[1] == -t.dim():
            part, rows = tag[0], t.shape[0]
            before = part.offset(rows)
            after = rows * part.degree - before - rows
            t = dist.reduce_out(torch.cat(
                [t.new_zeros((before,) + t.shape[1:]), t,
                 t.new_zeros((after,) + t.shape[1:])]), part.axis)
        out[name] = t
    return out


class VocabPart(NamedTuple):
    """An embedding table held as its rows [offset, offset + rows) of a
    ``total``-row vocabulary, split over mesh axis ``axis``."""
    table: torch.Tensor
    offset: int
    total: int
    axis: str


def table(module, name: str, t: torch.Tensor):
    """``t`` (module's table ``name``), or its VocabPart where split."""
    tag = leaf_part(module, name)
    if tag is None:
        return t
    part = tag[0]
    rows = t.shape[0]
    return VocabPart(t, part.offset(rows), rows * part.degree, part.axis)
