"""ZeRO's layout over the 'data' axis: which dim of each parameter-shaped
tensor is split over the processes, one device a process.

Counterpart of ``zero_tpu/parallel/mesh.py:zero1_sharding`` and
``per_device_bytes``. The JAX package gives each leaf its base spec
(``spec_for_param``/``param_sharding``: Megatron splits over 'model',
layers over 'pipe', experts over 'expert') and puts 'data' on the first
dim that is still free and divisible by the data degree. The port runs no
model, pipe or expert axis yet (``mesh_model`` = ``mesh_pipe`` =
``mesh_expert`` = 1), so every base spec is free (a size-1 axis is
layout-free there too) and the rule reduces to: the first dim divisible
by the data degree W; a leaf with none, and a scalar, stays whole on
every process. ``spec_for_param`` and ``param_sharding`` come with tensor
parallelism.

The same table lays out Adam's moments and the EMA (stage 1 and up) and
the parameters (stage 3), so the sharded checkpoint's keys
(``saver.py``, ``key@a:b,c:d``) are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def shard_dim(shape, world: int) -> Optional[int]:
    """The dim of a leaf of ``shape`` split over ``world`` processes: the
    first divisible by ``world``; None (whole on every process) for a
    scalar, a leaf with no such dim, or a world of one."""
    if world <= 1:
        return None
    for d, n in enumerate(shape):
        if int(n) % world == 0:
            return d
    return None


def zero_dims(shapes: Dict[str, tuple], world: int) -> Dict[str, Optional[int]]:
    """The layout rule as a plain per-leaf table: {name: dim or None}."""
    return {name: shard_dim(shape, world) for name, shape in shapes.items()}


def shard_slices(shape, dim: Optional[int], rank: int, world: int):
    """The index (a tuple of slices) of process ``rank``'s shard of a leaf
    of ``shape`` split along ``dim`` (every dim whole when None)."""
    out = [slice(0, int(n)) for n in shape]
    if dim is not None:
        step = int(shape[dim]) // world
        out[dim] = slice(rank * step, (rank + 1) * step)
    return tuple(out)


def shard_of(full, dim: Optional[int], rank: int, world: int):
    """Process ``rank``'s shard of ``full`` (a tensor or an array) along
    ``dim``: a view; ``full`` itself when ``dim`` is None."""
    if dim is None:
        return full
    return full[shard_slices(full.shape, dim, rank, world)]


def join_shards(shards, dim: Optional[int]):
    """The inverse of shard_of: the processes' shards, in rank order,
    joined along ``dim``."""
    if dim is None:
        return shards[0]
    if isinstance(shards[0], torch.Tensor):
        return torch.cat(list(shards), dim=dim)
    return np.concatenate(list(shards), axis=dim)


def index_key(index) -> str:
    """``zero_tpu/saver.py:_index_key``'s text of an index: every dim as
    ``start:stop``, full dims ``0:n``."""
    return ",".join("%d:%d" % (sl.start, sl.stop) for sl in index)


@dataclass
class Layout:
    """One process's place in ZeRO's layout: the rule's table ``dims``
    ({name: dim or None}) over the leaves' whole ``shapes``, the data
    degree ``world`` and this process's ``rank``."""
    dims: Dict[str, Optional[int]]
    shapes: Dict[str, Tuple[int, ...]]
    world: int
    rank: int

    @classmethod
    def of(cls, named, world: int, rank: int) -> "Layout":
        """The layout of ``named`` ((name, tensor) pairs of whole leaves)."""
        shapes = {n: tuple(int(d) for d in t.shape) for n, t in named}
        return cls(zero_dims(shapes, world), shapes, int(world), int(rank))

    def dim(self, name: str) -> Optional[int]:
        return self.dims.get(name)

    def is_shard(self, name: Optional[str], t) -> bool:
        """Whether ``t`` is a shard of leaf ``name`` (not its whole)."""
        return (name in self.dims and self.dims[name] is not None
                and tuple(t.shape) != self.shapes[name])

    def local(self, name: str, full):
        """This process's shard of the whole leaf ``full``."""
        return shard_of(full, self.dims[name], self.rank, self.world)

    def index(self, name: str):
        return shard_slices(self.shapes[name], self.dims[name], self.rank,
                            self.world)

    def index_key(self, name: str) -> str:
        return index_key(self.index(name))


def per_rank_bytes(tree) -> int:
    """Bytes this process holds of a state tree, each leaf counted as held
    (a shard's own size): a module, a {name: tensor} dict, the Adam state
    {'count', 'mu', 'nu'}, or None. The counterpart of
    ``per_device_bytes``."""
    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(per_rank_bytes(v) for v in tree.values())
