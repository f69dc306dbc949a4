"""The partition table: which part of each parameter-shaped tensor a
process holds, one device a process.

Counterpart of ``zero_tpu/parallel/mesh.py``: ``spec_for_param``,
``param_sharding``'s rules (the Megatron splits over 'model', the expert
stacks over 'expert', the divisibility fallback), ``unsharded_big_params``
and ``zero1_sharding``'s ZeRO layout over 'data', with ``per_rank_bytes``
for ``per_device_bytes``. The processes form the mesh grid ``data x model
[x expert]`` in ``make_mesh``'s device order (parallel/distributed.py:
Grid); a leaf is cut along each axis that its spec names:

  * 'model' or 'expert' (``Split``): the leaf's dim is cut into
    ``degree`` equal parts and the process keeps part ``coord``. The
    fused self-attention projection ``qkv`` [d, 3d] is the one leaf cut
    as three blocks: the process keeps its heads' columns of q, of k and
    of v (three rectangles of the whole leaf), where the JAX package's
    ``P(None, 'model')`` keeps one contiguous third-of-a-third; the bytes
    a process holds are the same;
  * 'data' (ZeRO, ``zero_stage`` 1-3): the first dim that no other axis
    cuts and the data degree divides, ``zero1_sharding``'s rule; it cuts
    the process's model/expert part further.

``Layout`` is one process's place in that table: its parts, the
rectangles of the whole leaves that they are (the sharded checkpoint's
``key@a:b,c:d``) and the ZeRO slices of them. The same table lays out
Adam's moments and the EMA (stage 1 and up) and the parameters.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("zero_tpu_torch.mesh")

# Megatron-style tensor-parallel layout (zero_tpu/parallel/mesh.py:72-90):
# column-parallel qkv/q/k/v/enlarge (output dim split), row-parallel
# o/output (input dim split), vocab-dim split embeddings; everything else
# (LN, biases of row-parallel layers, scalars) is replicated.
_COL_PAT = re.compile(
    r"(qkv|q_map|\bq\b|\bk\b|\bv\b|enlarge|z_project|lalt|\blang\b|shared)")
_ROW_PAT = re.compile(r"(\bo\b|output)")
_EMB_PAT = re.compile(r"(embedding)$")

# matmul weights replicated by design (RNN recurrences, gates, the router
# and the expert stacks, which split over 'expert'): not reported
_TP_REPLICATED_OK = re.compile(
    r"(hide_x|hide_h|gate_x|gate_h|feed_query|feed_memory|feed_logits"
    r"|context_att|decoder_init|pre_logits|redict|\bff\b|_rpr|\bkeys\b"
    r"|\bvalues\b|source_pruning|\bgate\b|\bln\d?\b|offset|scale"
    r"|frontend|cond|forward|backward|enc\d|dec_"
    r"|router|experts)")


def path_of(name: str) -> str:
    """The JAX tree path of a port parameter name (``a.0.b`` -> ``a/0/b``)."""
    return name.replace(".", "/")


def spec_for_param(path: str, shape) -> Tuple[Optional[str], ...]:
    """The partition spec (a tuple of axis names or None, one per dim, as
    long as the JAX spec) of one parameter by its tree path and shape:
    ``zero_tpu/parallel/mesh.py:spec_for_param``."""
    parts = path.split("/")
    if _EMB_PAT.search(parts[-1] if parts else path) and len(shape) == 2:
        return ("model", None)
    module = ""
    for comp in reversed(parts):
        if comp in ("ws", "b", "lns") or comp.isdigit():
            continue
        module = comp
        break
    if len(shape) in (2, 3):
        lead = (None,) * (len(shape) - 2)
        if _COL_PAT.search(module):
            return lead + (None, "model")
        if _ROW_PAT.search(module):
            return lead + ("model", None)
    if len(shape) == 1 and parts and parts[-1] != "b":
        return ()
    if len(shape) == 1 and _COL_PAT.search(module):
        return ("model",)
    return ()


def param_specs(shapes: Dict[str, tuple], model: int = 1,
                expert: int = 1) -> Dict[str, Tuple[Optional[str], ...]]:
    """{name: spec} of ``param_sharding`` over a mesh of these degrees:
    the expert rule first (a leaf under ``experts`` whose leading dim the
    expert degree divides), then spec_for_param with every axis that does
    not divide its dim dropped (the divisibility fallback), padded to the
    leaf's rank."""
    degrees = {"model": int(model), "expert": int(expert)}
    out = {}
    for name, shape in shapes.items():
        path = path_of(name)
        if expert > 1 and "/experts/" in "/" + path + "/" and len(shape) \
                and shape[0] % expert == 0:
            out[name] = ("expert",) + (None,) * (len(shape) - 1)
            continue
        spec = list(spec_for_param(path, shape))
        spec += [None] * (len(shape) - len(spec))
        out[name] = tuple(
            axis if axis is not None and shape[d] % degrees[axis] == 0
            else None for d, axis in enumerate(spec))
    return out


def unsharded_big_params(shapes: Dict[str, tuple], model: int,
                         min_elems: int = 65536) -> List[str]:
    """JAX paths of large >= 2-D weights that no 'model' rule splits and
    that are not on the replicated-by-design list (empty without TP)."""
    if model <= 1:
        return []
    out = []
    for name, shape in shapes.items():
        if len(shape) < 2 or int(np.prod(shape)) < min_elems:
            continue
        path = path_of(name)
        if any(ax is not None for ax in spec_for_param(path, shape)):
            continue
        if _TP_REPLICATED_OK.search(path):
            continue
        out.append(path)
    return sorted(out)


def warn_unsharded(shapes: Dict[str, tuple], model: int) -> None:
    """param_sharding's loud report of a large weight TP leaves whole."""
    for p in unsharded_big_params(shapes, model):
        log.warning("TP active but param %r matched no partition rule and "
                    "is fully replicated; extend mesh.py rules or add it to "
                    "the replicated-by-design list", p)


# ---------------------------------------------------------------------------
# a leaf's split over 'model' or 'expert'
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """Dim ``dim`` of a leaf cut into ``blocks`` equal blocks, each into
    ``degree`` equal parts over mesh axis ``axis``; the process holds part
    ``coord`` of every block, the blocks in order (``blocks`` is 3 for a
    fused qkv: its heads' q, k and v)."""
    axis: str
    dim: int
    degree: int
    coord: int
    blocks: int = 1

    def spans(self, n: int):
        """[(start in the whole dim, start in the part, length)] of the
        process's blocks along a whole dim of length ``n``."""
        part = n // (self.blocks * self.degree)
        return [(b * (n // self.blocks) + self.coord * part, b * part, part)
                for b in range(self.blocks)]

    def take(self, whole):
        """The process's part of the whole leaf (a tensor or an array)."""
        pieces = []
        for start, _, length in self.spans(whole.shape[self.dim]):
            idx = [slice(None)] * whole.ndim
            idx[self.dim] = slice(start, start + length)
            pieces.append(whole[tuple(idx)])
        if len(pieces) == 1:
            return pieces[0]
        if isinstance(whole, torch.Tensor):
            return torch.cat(pieces, dim=self.dim)
        return np.concatenate(pieces, axis=self.dim)

    def join(self, parts):
        """The inverse of take: every coordinate's part, in coord order."""
        cat = (torch.cat if isinstance(parts[0], torch.Tensor)
               else lambda xs, dim: np.concatenate(xs, axis=dim))
        if self.blocks == 1:
            return cat(list(parts), dim=self.dim)
        per = parts[0].shape[self.dim] // self.blocks
        blocks = []
        for b in range(self.blocks):
            for part in parts:
                idx = [slice(None)] * part.ndim
                idx[self.dim] = slice(b * per, (b + 1) * per)
                blocks.append(part[tuple(idx)])
        return cat(blocks, dim=self.dim)


def leaf_split(name: str, spec, grid) -> Optional[Split]:
    """The Split of leaf ``name`` under ``spec`` on ``grid`` (a
    distributed.Grid), or None where no axis of degree > 1 cuts it."""
    for d, axis in enumerate(spec):
        if axis in ("model", "expert") and grid.degree(axis) > 1:
            blocks = 3 if re.search(r"(^|\.)qkv\.(ws\.\d+|b)$", name) else 1
            return Split(axis, d, grid.degree(axis), grid.coord(axis),
                         blocks)
    return None


# ---------------------------------------------------------------------------
# ZeRO's slices over 'data'
# ---------------------------------------------------------------------------

def shard_dim(shape, world: int, taken: Optional[int] = None
              ) -> Optional[int]:
    """The dim of a leaf of ``shape`` split over ``world`` data-parallel
    processes: the first divisible by ``world`` that the dim ``taken`` (a
    model or expert split) is not; None (whole) for a scalar, a leaf with
    no such dim, or a world of one."""
    if world <= 1:
        return None
    for d, n in enumerate(shape):
        if d != taken and int(n) % world == 0:
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
    """One process's place in the partition table.

    ``splits`` ({name: Split}) cuts whole leaves of shape ``wholes`` into
    the process's model/expert parts, whose shapes are ``shapes``; ZeRO's
    table ``dims`` ({name: dim or None}) cuts those parts further over the
    data degree ``world``, at this process's data coordinate ``rank``.
    ``coords`` ({axis: coordinate}) says which rectangles of the whole
    leaves this process writes to a sharded checkpoint."""
    dims: Dict[str, Optional[int]]
    shapes: Dict[str, Tuple[int, ...]]
    world: int
    rank: int
    splits: Dict[str, Split] = field(default_factory=dict)
    wholes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    coords: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def plan(cls, named, grid, zero: bool) -> "Layout":
        """The layout of ``named`` (whole leaves) on ``grid``: the model
        and expert splits of param_specs, then, with ``zero``, ZeRO's
        slices over the data degree."""
        wholes = {n: tuple(int(d) for d in t.shape) for n, t in named}
        specs = param_specs(wholes, grid.degree("model"),
                            grid.degree("expert"))
        splits = {}
        for name, spec in specs.items():
            split = leaf_split(name, spec, grid)
            if split is not None:
                splits[name] = split
        shapes = {}
        for name, whole in wholes.items():
            shape = list(whole)
            if name in splits:
                shape[splits[name].dim] //= splits[name].degree
            shapes[name] = tuple(shape)
        world = grid.degree("data") if zero else 1
        dims = {name: shard_dim(shape, world,
                                splits[name].dim if name in splits else None)
                for name, shape in shapes.items()}
        return cls(dims, shapes, world, grid.coord("data"), splits, wholes,
                   dict(grid.coords))

    def dim(self, name: str) -> Optional[int]:
        return self.dims.get(name)

    def split(self, name: str) -> Optional[Split]:
        return self.splits.get(name)

    def is_shard(self, name: Optional[str], t) -> bool:
        """Whether ``t`` is a ZeRO shard of leaf ``name`` (not its
        model/expert part whole)."""
        return (name in self.dims and self.dims[name] is not None
                and tuple(t.shape) != self.shapes[name])

    def part(self, name: str, whole):
        """The model/expert part of the whole leaf ``whole``."""
        split = self.splits.get(name)
        return whole if split is None else split.take(whole)

    def local(self, name: str, full):
        """This process's ZeRO shard of ``full`` (its model/expert part)."""
        return shard_of(full, self.dims[name], self.rank, self.world)

    def held(self, name: str, whole):
        """What this process holds of the whole leaf as a ZeRO shard:
        local(part(...))."""
        return self.local(name, self.part(name, whole))

    def writes(self, name: str, sharded: bool) -> bool:
        """Whether this process writes leaf ``name`` to a sharded
        checkpoint: it is the coordinate-0 process of every axis that does
        not cut the leaf (the data axis cuts it where ``sharded``: held as
        a ZeRO shard)."""
        split = self.splits.get(name)
        for axis, coord in self.coords.items():
            cut = (sharded if axis == "data"
                   else split is not None and split.axis == axis)
            if coord and not cut:
                return False
        return True

    def pieces(self, name: str, t, sharded: bool):
        """[(index key of a rectangle of the whole leaf, the view of ``t``
        that holds it)] of a leaf held as ``t`` (a ZeRO shard where
        ``sharded``, else the model/expert part)."""
        whole = self.wholes.get(name, self.shapes[name])
        spans = [[(0, 0, int(n))] for n in whole]
        split = self.splits.get(name)
        if split is not None:
            spans[split.dim] = split.spans(whole[split.dim])
        d = self.dims.get(name) if sharded else None
        if d is not None:
            (start, local, length), = spans[d]
            step = length // self.world
            spans[d] = [(start + self.rank * step, 0, step)]
        out = []
        for combo in _product(spans):
            gidx = tuple(slice(s, s + n) for s, _, n in combo)
            lidx = tuple(slice(l, l + n) for _, l, n in combo)
            out.append((index_key(gidx), t[lidx]))
        return out


def _product(spans):
    """Every combination of one span per dim."""
    if not spans:
        return [()]
    return [(s,) + rest for s in spans[0] for rest in _product(spans[1:])]


def per_rank_bytes(tree) -> int:
    """Bytes this process holds of a state tree, each leaf counted as held
    (its own part): a module, a {name: tensor} dict, the Adam state
    {'count', 'mu', 'nu'}, or None. The counterpart of
    ``per_device_bytes``."""
    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(per_rank_bytes(v) for v in tree.values())


def whole_size(layout: Optional["Layout"], module) -> int:
    """The number of whole parameters of ``module`` (held as parts under
    ``layout``)."""
    if layout is None:
        return sum(p.numel() for p in module.parameters())
    return sum(math.prod(s) for s in layout.wholes.values())
