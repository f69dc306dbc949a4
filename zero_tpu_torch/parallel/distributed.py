"""Data, tensor and expert parallelism across processes, one device a
process.

Counterpart of ``zero_tpu/parallel/distributed.py``. The JAX package joins
its processes with ``jax.distributed.initialize``, shards the global batch
over a mesh and lets GSPMD insert the collectives. Here each process
drives one device (``cuda:<rank % device_count>``, or the CPU) and holds
the whole model, its moments and its EMA; the collectives are explicit:

  * the training step sums the gradients over the processes once a step
    (``all_reduce_sum_``, a few flat fp32 buckets), and every batch
    statistic of the loss is made global (``global_sum``): each process's
    loss is then the global batch's, and the sum of their gradients its
    gradient;
  * under ZeRO (``zero_stage`` 1-3, parallel/mesh.py's layout) the
    moments, the EMA and at stage 3 the parameters are held as shards:
    ``reduce_scatter_sum`` sums gradients into them, ``all_gather_shards``
    makes leaves whole again (the updated weights, the stage-3 forward,
    ``host_fetchable``), in the same flat fp32 buckets;
  * the processes form ``make_mesh``'s grid ``data x model x seq x
    expert`` (``Grid``): the collectives above run over the data group
    (the gradients over the data and seq groups); sequence parallelism
    ('seq', ring attention) passes K/V blocks round its line
    (``ring_shift``), gathers the encoder output (``gather_seq``) and
    sums the per-sentence loss terms over it (``global_sum``); tensor
    parallelism ('model', Megatron) and expert parallelism ('expert')
    enter and leave their split regions through ``copy_in`` (identity
    forward, all-reduce backward) and ``reduce_out`` (all-reduce
    forward, identity backward) over the model or expert group, and a
    column part that an elementwise op reads is made whole by
    ``gather_cols`` (all-gather forward, its own columns backward);
  * ``any_flag`` agrees on a host flag (the preemption signal);
  * eval batches, identical on every process, are split by rows
    (``put_eval_batch``) and their decodes gathered
    (``fetch_decode_output``).

Config knobs: dist_coordinator ("host:port", empty = one process),
dist_num_processes, dist_process_id. A caller that has set up the default
process group itself (two ranks sharing one card over gloo, say) keeps it:
``maybe_initialize`` then does nothing.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from zero_tpu_torch.parallel import tensor

log = logging.getLogger("zero_tpu_torch.distributed")

# the gradient all-reduce's flat fp32 buckets hold at most this many bytes
BUCKET_BYTES = 64 << 20

# each collective's calls, bytes (of the whole tensors it reduces or
# gathers) and time since the last take_stats(): CUDA event pairs on a
# card, host seconds on the CPU
_KINDS = ("all_reduce", "reduce_scatter", "all_gather", "model_reduce",
          "expert_reduce", "model_gather", "seq_ring", "seq_gather")
_stats = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0, "events": []}
          for kind in _KINDS}


def active() -> bool:
    """Whether a default process group exists (a world of one included)."""
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if active() else 1


def process_index() -> int:
    return tdist.get_rank() if active() else 0


def is_primary() -> bool:
    return process_index() == 0


def local_device(params) -> torch.device:
    """This process's device: ``params.device``, and on a card
    ``cuda:<rank % device_count>`` (the rank of the group, or
    dist_process_id before one exists)."""
    device = torch.device(params.device)
    if device.type != "cuda" or device.index is not None \
            or not torch.cuda.is_available():
        return device
    rank = process_index() if active() else int(params.dist_process_id)
    return torch.device("cuda", rank % torch.cuda.device_count())


def maybe_initialize(params) -> bool:
    """Join the training job: NCCL on a CUDA device, gloo on the CPU. A
    no-op without ``dist_coordinator`` and when a default group exists.
    Returns whether it made the group (its maker destroys it)."""
    if active():
        log.info("distributed: keeping the existing %s group, process "
                 "%d/%d", tdist.get_backend(), process_index(),
                 process_count())
        return False
    coordinator = getattr(params, "dist_coordinator", "")
    if not coordinator:
        return False
    device = local_device(params)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(backend, init_method="tcp://" + coordinator,
                             world_size=int(params.dist_num_processes),
                             rank=int(params.dist_process_id))
    log.info("distributed: process %d/%d over %s on %s", process_index(),
             process_count(), backend, device)
    return True


def destroy() -> None:
    """Leave the job (at exit of the CLI, which made the group)."""
    _GRIDS.clear()
    _current["grid"] = None
    if active():
        tdist.destroy_process_group()


AXES = ("data", "model", "seq", "expert")


class Grid:
    """The processes as ``make_mesh``'s device grid: axes data, model, seq
    and expert (``zero_tpu/parallel/mesh.py:56-64``), process r at the
    row-major coordinates of r. ``group(axis)`` is the process group of
    this process's line along ``axis``: None for the default group (the
    axis spans every process), ALONE where the axis has one process and
    another axis has more (no collective runs)."""

    def __init__(self, degrees, rank: int):
        self.degrees = {a: int(degrees.get(a, 1)) for a in AXES}
        coords, rest = {}, int(rank)
        for axis in reversed(AXES):
            coords[axis] = rest % self.degrees[axis]
            rest //= self.degrees[axis]
        self.coords = {a: coords[a] for a in AXES}
        self.groups = {}

    def degree(self, axis: str) -> int:
        return self.degrees.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def size(self) -> int:
        return math.prod(self.degrees.values())

    def group(self, axis: str):
        return self.groups.get(axis)

    def ranks(self, axis: str):
        """The ranks of the line along ``axis`` through this process, in
        coordinate order."""
        coords = dict(self.coords)
        out = []
        for c in range(self.degree(axis)):
            coords[axis] = c
            r = 0
            for a in AXES:
                r = r * self.degree(a) + coords[a]
            out.append(r)
        return out


# Grid.group of an axis along which a process is alone
ALONE = "alone"
_GRIDS = {}
_current = {"grid": None}


def mesh_degrees(params, world: Optional[int] = None) -> dict:
    """{axis: degree} of ``params``' mesh over ``world`` processes (the
    group's by default): ``mesh_data`` -1 or 0 means every process the
    model, seq and expert degrees leave; their product must be the world
    size, else make_mesh's ValueError."""
    world = process_count() if world is None else int(world)
    model = max(int(getattr(params, "mesh_model", 1) or 1), 1)
    seq = max(int(getattr(params, "mesh_seq", 1) or 1), 1)
    expert = max(int(getattr(params, "mesh_expert", 1) or 1), 1)
    data = int(getattr(params, "mesh_data", -1))
    if data <= 0:
        data = world // (model * seq * expert)
    if data <= 0 or data * model * seq * expert != world:
        raise ValueError(mesh_message(data, model, seq, expert, world,
                                      params.device))
    return {"data": data, "model": model, "seq": seq, "expert": expert}


def make_grid(params) -> Grid:
    """The grid of ``params``' mesh over the process group, made current
    (the collectives' groups). COLLECTIVE the first time a mesh shape is
    asked for: every process makes every line's group, in one order."""
    degrees = mesh_degrees(params)
    world, rank = process_count(), process_index()
    key = (world, tuple(degrees[a] for a in AXES))
    grid = _GRIDS.get(key)
    if grid is None:
        grid = Grid(degrees, rank)
        for axis in AXES:
            if grid.degree(axis) == world:
                continue                  # the default group
            if grid.degree(axis) == 1:
                grid.groups[axis] = ALONE
                continue
            # every line along the axis, made by every process in order
            for start in range(world):
                line = Grid(degrees, start)
                if line.coord(axis):
                    continue
                ranks = line.ranks(axis)
                group = tdist.new_group(ranks)
                if rank in ranks:
                    grid.groups[axis] = group
        _GRIDS[key] = grid
    _current["grid"] = grid
    return grid


def grid() -> Grid:
    """The current grid: the last make_grid's, else data parallelism over
    every process."""
    if _current["grid"] is not None and _current["grid"].size() == \
            process_count():
        return _current["grid"]
    return Grid({"data": process_count()}, process_index())


def mesh_message(data: int, model: int, seq: int, expert: int, world: int,
                 platform) -> str:
    """make_mesh's error, for a mesh whose degrees do not multiply to the
    number of devices (one a process)."""
    return ("make_mesh needs data*model*seq*pipe*expert = %s*%s*%s*1*%s = %s "
            "devices but %d are available on platform %r (one device a "
            "process: mesh_data must be -1, 0 or the number of processes "
            "over mesh_model * mesh_seq * mesh_expert). Set mesh_data/"
            "mesh_model/mesh_seq/mesh_pipe/mesh_expert to fit the hardware."
            % (data, model, seq, expert, max(data, 0) * model * seq * expert,
               world, str(platform)))


def _axis_group(axis: str):
    """(the process group, its size) of this process's line along
    ``axis``; the group is ALONE where no collective runs."""
    g = grid()
    return g.group(axis), g.degree(axis)


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective runs: the tensor's device under NCCL, the CPU
    under gloo."""
    if tdist.get_backend() == "nccl":
        return t.device
    return torch.device("cpu")


def _all_reduce(t: torch.Tensor, op, group=None) -> None:
    """All-reduce ``t`` in place over ``group`` (the default group when
    None); under gloo a card's tensor goes through the host."""
    dev = _comm_device(t)
    if dev == t.device:
        tdist.all_reduce(t, op=op, group=group)
        return
    host = t.to(dev)
    tdist.all_reduce(host, op=op, group=group)
    t.copy_(host)


def _buckets(tensors):
    """Index lists of ``tensors`` in order, each list at most BUCKET_BYTES
    of fp32 (a larger tensor alone)."""
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * 4
        if bucket and size + nbytes > BUCKET_BYTES:
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        yield bucket


@contextlib.contextmanager
def _timed(kind: str, nbytes: int, cuda: bool):
    """Count one call of collective ``kind`` over ``nbytes`` and time it."""
    entry = _stats[kind]
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        begin = time.perf_counter()
    yield
    if cuda:
        end.record()
        entry["events"].append((start, end))
    else:
        entry["seconds"] += time.perf_counter() - begin
    entry["calls"] += 1
    entry["bytes"] += nbytes


def all_reduce_sum_(tensors, axis: str = "data") -> None:
    """Sum fp32 tensors in place over this process's line along mesh
    ``axis`` (the data group: the gradients' sum), packed into flat
    buckets of at most BUCKET_BYTES, one call a bucket; nothing where the
    line is this process alone. COLLECTIVE: every process of the line
    calls it with tensors of the same shapes, in the same order."""
    group, _ = _axis_group(axis)
    if group == ALONE:
        return
    tensors = list(tensors)
    for bucket in _buckets(tensors):
        _reduce_bucket([tensors[i] for i in bucket], group)


def _reduce_bucket(bucket, group) -> None:
    flat = torch.cat([t.reshape(-1).float() for t in bucket])
    with _timed("all_reduce", flat.numel() * 4, flat.is_cuda):
        _all_reduce(flat, tdist.ReduceOp.SUM, group)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _front_shape(shape, dim: int, world: int):
    """The shape of a shard with its split dim moved to the front."""
    rest = [int(n) for i, n in enumerate(shape) if i != dim]
    return [int(shape[dim]) // world] + rest


def _scatter_or_gather(kind: str, src: torch.Tensor,
                       out: torch.Tensor, group=None) -> None:
    """reduce_scatter_tensor (a sum) or all_gather_into_tensor of flat
    ``src`` into flat ``out``; under gloo a card's tensors go through the
    host."""
    dev = _comm_device(src)
    host_src = src if src.device == dev else src.to(dev)
    host_out = out if out.device == dev else torch.empty(
        out.shape, dtype=out.dtype, device=dev)
    with warnings.catch_warnings():
        # all_gather_into_tensor is one call on gloo and NCCL alike
        warnings.simplefilter("ignore", FutureWarning)
        if kind == "reduce_scatter":
            tdist.reduce_scatter_tensor(host_out, host_src, group=group)
        else:
            tdist.all_gather_into_tensor(host_out, host_src, group=group)
    if host_out is not out:
        out.copy_(host_out)


def reduce_scatter_sum(tensors, dims):
    """Whole tensors -> this process's shard (parallel/mesh.py:shard_of)
    of their sum over the data group, fp32, each split along its ``dims``
    entry (not None). A shard along a dim d > 0 is not contiguous: dim d
    moves to the front, each process's block is one row of a [W, n]
    matrix, and the buckets' rows are reduce-scattered flat. Over a split
    sequence every tensor (a gradient) is partial on each process of the
    seq line: it is summed over that line first. COLLECTIVE."""
    group, world = _axis_group("data")
    tensors = list(tensors)
    if grid().degree("seq") > 1:
        tensors = [t.float().clone() for t in tensors]
        all_reduce_sum_(tensors, "seq")
    out = [None] * len(tensors)
    for bucket in _buckets(tensors):
        rows = [tensors[i].float().movedim(dims[i], 0).reshape(world, -1)
                for i in bucket]
        flat = torch.cat(rows, dim=1)
        local = flat.new_empty(flat.shape[1])
        with _timed("reduce_scatter", flat.numel() * 4, flat.is_cuda):
            _scatter_or_gather("reduce_scatter", flat.reshape(-1), local,
                               group)
        offset = 0
        for i, row in zip(bucket, rows):
            n = row.shape[1]
            front = local[offset:offset + n].view(
                _front_shape(tensors[i].shape, dims[i], world))
            out[i] = front.movedim(0, dims[i]).contiguous()
            offset += n
    return out


def all_gather_shards(shards, dims):
    """This process's shards -> the whole tensors (every data-group
    process's shard joined along its ``dims`` entry, in rank order), in
    the shards' dtypes. COLLECTIVE."""
    group, world = _axis_group("data")
    shards = list(shards)
    out = [None] * len(shards)
    for bucket in _buckets(shards):
        cols = [shards[i].float().movedim(dims[i], 0).reshape(-1)
                for i in bucket]
        flat = torch.cat(cols)
        whole = flat.new_empty(world * flat.numel())
        with _timed("all_gather", whole.numel() * 4, flat.is_cuda):
            _scatter_or_gather("all_gather", flat, whole, group)
        whole = whole.view(world, -1)
        offset = 0
        for i, col in zip(bucket, cols):
            n = col.numel()
            shape = _front_shape(shards[i].shape, dims[i], 1)
            front = whole[:, offset:offset + n].reshape(
                [world * shape[0]] + shape[1:])
            # contiguous, as the whole tensor is held: a transposed
            # layout would take other GEMM kernels (another rounding)
            out[i] = front.movedim(0, dims[i]).to(
                shards[i].dtype).contiguous()
            offset += n
    return out


def take_stats() -> dict:
    """The gradient all-reduce's {'calls', 'bytes', 'ms'} since the last
    call, with the same for 'reduce_scatter' and 'all_gather' under
    ZeRO, for the split regions' all-reduces, 'model_reduce' and
    'expert_reduce', for tensor parallelism's column gathers,
    'model_gather', and for sequence parallelism's ring steps and
    gathers, 'seq_ring' and 'seq_gather' (waits for the card's events),
    and resets them."""
    out = {}
    for kind in _KINDS:
        entry = _stats[kind]
        seconds = entry["seconds"]
        for start, end in entry["events"]:
            end.synchronize()
            seconds += start.elapsed_time(end) / 1000.0
        out[kind] = {"calls": entry["calls"], "bytes": entry["bytes"],
                     "ms": seconds * 1000.0}
        entry.update(calls=0, bytes=0, seconds=0.0, events=[])
    reduce = out.pop("all_reduce")
    return dict(reduce, **out)


def global_sum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the data group (or this process's line along
    mesh ``axis``: 'seq' sums a per-sentence term over the blocks of a
    sequence) as its value, ``x``'s own gradient: "global value, local
    gradient". A loss built of such sums has the global batch's value on
    every process, and the sum of the processes' gradients is the global
    loss's gradient (for ratios of sums and non-linear terms alike).
    COLLECTIVE."""
    group, _ = _axis_group(axis)
    if group == ALONE:
        return x
    total = x.detach().clone()
    _all_reduce(total, tdist.ReduceOp.SUM, group)
    return total + (x - x.detach())


# ---------------------------------------------------------------------------
# the split regions of tensor ('model') and expert ('expert') parallelism
# ---------------------------------------------------------------------------

def _region_sum(x: torch.Tensor, axis: str,
                op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over this process's line along
    ``axis``, counted as one ``<axis>_reduce`` call."""
    group, _ = _axis_group(axis)
    out = x.detach().contiguous().clone()
    with _timed(axis + "_reduce", out.numel() * out.element_size(),
                out.is_cuda):
        _all_reduce(out, op, group)
    return out


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the line."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _region_sum(g, ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: partial sums summed over the line, identity
    backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _region_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(_CopyIn):
    """A statistic over a split axis whose users are split too (ReLA's
    mean square): summed over the line both ways."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _region_sum(x, axis)


def copy_in(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A replicated activation entering a region split over ``axis``: the
    same value, its gradient summed over the line (each process's holds
    the part its split computed). COLLECTIVE in the backward."""
    return _CopyIn.apply(x, axis) if grid().degree(axis) > 1 else x


def reduce_out(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A region's partial sums leaving it: their sum over the line, the
    replicated gradient passed through. COLLECTIVE."""
    return _ReduceOut.apply(x, axis) if grid().degree(axis) > 1 else x


def sum_both(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum over the line of a statistic that split users read, its
    gradient summed too. COLLECTIVE both ways."""
    return _SumBoth.apply(x, axis) if grid().degree(axis) > 1 else x


def max_over(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The element-wise maximum over the line, no gradient. COLLECTIVE."""
    if grid().degree(axis) == 1:
        return x
    return _region_sum(x, axis, tdist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# sequence parallelism ('seq'): the ring's shifts and the gathered blocks
# ---------------------------------------------------------------------------

def ring_shift(tensors):
    """Send ``tensors`` to the next process of this process's seq line
    ((coord + 1) % n) and return those of the previous one ((coord - 1) %
    n), of the same shapes and dtypes: one flat buffer each way for each
    dtype among them (bf16 K/V travel as bf16 beside fp32 gradients), in
    one ``batch_isend_irecv``. COLLECTIVE over the line, in one order."""
    g = grid()
    n = g.degree("seq")
    tensors = list(tensors)
    if n == 1:
        return tensors
    ranks = g.ranks("seq")
    me = g.coord("seq")
    group = g.group("seq")
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    flats = [torch.cat([tensors[i].reshape(-1) for i in idx])
             for idx in by_dtype.values()]
    dev = _comm_device(flats[0])
    sends = [f.to(dev) for f in flats]
    recvs = [torch.empty_like(f) for f in sends]
    with _timed("seq_ring", sum(f.numel() * f.element_size() for f in sends),
                flats[0].is_cuda):
        ops = []
        for tag, (send, recv) in enumerate(zip(sends, recvs)):
            ops += [tdist.P2POp(tdist.isend, send, ranks[(me + 1) % n],
                                group, tag),
                    tdist.P2POp(tdist.irecv, recv, ranks[(me - 1) % n],
                                group, tag)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        recvs = [r.to(f.device) for r, f in zip(recvs, flats)]
    out = [None] * len(tensors)
    for idx, recv in zip(by_dtype.values(), recvs):
        offset = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = recv[offset:offset + k].view(tensors[i].shape)
            offset += k
    return out


def _gather_dim(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Every ``axis``-line process's ``x`` joined along ``dim`` in
    coordinate order, counted as one ``<axis>_gather`` call."""
    group, n = _axis_group(axis)
    front = x.detach().movedim(dim, 0).contiguous()
    whole = front.new_empty((n,) + tuple(front.shape))
    with _timed(axis + "_gather", whole.numel() * whole.element_size(),
                x.is_cuda):
        _scatter_or_gather("all_gather", front.reshape(-1),
                           whole.reshape(-1), group)
    return whole.reshape((n * front.shape[0],) + tuple(front.shape[1:])) \
        .movedim(0, dim).contiguous()


class _GatherSeq(torch.autograd.Function):
    """The blocks gathered along dim 1; the backward sums the whole
    gradient over the line and keeps this process's block of it."""

    @staticmethod
    def forward(ctx, x):
        return _gather_dim(x, 1, "seq")

    @staticmethod
    def backward(ctx, g):
        group, n = _axis_group("seq")
        gf = g.float()
        front = gf.reshape((g.shape[0], n, g.shape[1] // n)
                           + tuple(g.shape[2:])).movedim(1, 0).contiguous()
        local = front.new_empty(front.shape[1:])
        with _timed("seq_gather", front.numel() * 4, g.is_cuda):
            _scatter_or_gather("reduce_scatter", front.reshape(-1),
                               local.reshape(-1), group)
        return local.to(g.dtype)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """This process's [B, L/n, ...] block -> the whole [B, L, ...] on every
    process of the seq line; differentiable (the backward takes the
    summed gradient's block). COLLECTIVE."""
    return _GatherSeq.apply(x) if grid().degree("seq") > 1 else x


class _GatherCols(torch.autograd.Function):
    """The column parts gathered along the last dim; the backward keeps
    this process's columns of the gradient, which the replicated compute
    downstream made whole and the same on every process of the line."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_dim(x, x.dim() - 1, axis)

    @staticmethod
    def backward(ctx, g):
        width = g.shape[-1] // grid().degree(ctx.axis)
        lo = grid().coord(ctx.axis) * width
        return g[..., lo:lo + width].contiguous(), None


def gather_cols(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A column-parallel region's [..., n/W] part -> the whole [..., n] on
    every process of the ``axis`` line (the parts in coordinate order),
    where an elementwise op, not a row-parallel map, reads the columns;
    differentiable (the backward takes this process's columns, no sum).
    COLLECTIVE."""
    return _GatherCols.apply(x, axis) if grid().degree(axis) > 1 else x


def barrier() -> None:
    """Wait for every process (no-op without a group). COLLECTIVE."""
    if active():
        tdist.barrier()


def any_flag(flag: bool) -> bool:
    """Whether ``flag`` is set on any process (a MAX all-reduce).
    COLLECTIVE."""
    if not active():
        return bool(flag)
    return bool(_max_ints([int(bool(flag))])[0])


def host_fetchable(tree, layout=None):
    """Make every tensor of ``tree`` ({prefix: a module, a {name: tensor}
    dict or the Adam state, or None}) whole on this process. Without a
    ``layout`` (parallel/mesh.py) each process holds the whole state and
    the tree comes back as it is; with one, every ZeRO shard is
    all-gathered over the data group and every model or expert part over
    its line, into a copy of its tree (a module's copy loses its split
    tags: it runs whole). COLLECTIVE by contract, as in the JAX package:
    every process calls it at the same point, even where only the primary
    consumes the result (a checkpoint write)."""
    if layout is None or process_count() == 1:
        return tree
    jobs, out, modules = [], {}, []

    def whole_dict(tensors):
        copied = dict(tensors)
        for name, t in tensors.items():
            jobs.append((name, t, lambda w, n=name: copied.__setitem__(n,
                                                                       w)))
        return copied

    for prefix, sub in tree.items():
        if isinstance(sub, torch.nn.Module):
            if any(layout.is_shard(n, p) or layout.split(n) is not None
                   for n, p in sub.named_parameters()):
                sub = copy.deepcopy(sub)
                modules.append(sub)
                for name, p in sub.named_parameters():
                    jobs.append((name, p, lambda w, q=p: setattr(q, "data",
                                                                 w)))
        elif isinstance(sub, dict) and "mu" in sub:
            sub = dict(sub, mu=whole_dict(sub["mu"]),
                       nu=whole_dict(sub["nu"]))
        elif isinstance(sub, dict):
            sub = whole_dict(sub)
        out[prefix] = sub
    held = [t.detach() for _, t, _ in jobs]
    values = list(held)
    shards = [i for i, (n, t, _) in enumerate(jobs) if layout.is_shard(n, t)]
    if shards:
        wholes = all_gather_shards([values[i] for i in shards],
                                   [layout.dim(jobs[i][0]) for i in shards])
        for i, w in zip(shards, wholes):
            values[i] = w.contiguous()
    for axis in ("model", "expert"):
        parts = [i for i, (n, _, _) in enumerate(jobs)
                 if layout.split(n) is not None
                 and layout.split(n).axis == axis]
        if parts:
            gathered = _all_gather_parts([values[i] for i in parts], axis)
            for i, every in zip(parts, gathered):
                values[i] = layout.split(jobs[i][0]).join(every) \
                    .contiguous()
    for (_, _, assign), h, v in zip(jobs, held, values):
        if v is not h:
            assign(v)
    for module in modules:
        tensor.clear_tags(module)
    return out


def whole_parts(module, layout) -> dict:
    """{name: whole tensor} of ``module``'s leaves that ``layout`` splits
    over a model or expert axis, gathered over their lines, without
    gradient. COLLECTIVE."""
    named = [(n, p.detach()) for n, p in module.named_parameters()
             if layout.split(n) is not None]
    out = {}
    for axis in ("model", "expert"):
        mine = [(n, p) for n, p in named if layout.split(n).axis == axis]
        if mine:
            gathered = _all_gather_parts([p for _, p in mine], axis)
            for (n, _), every in zip(mine, gathered):
                out[n] = layout.split(n).join(every).contiguous()
    return out


def _all_gather_parts(parts, axis: str):
    """Each tensor's part on every process of this process's line along
    ``axis``, in coordinate order: [[part of coord 0, 1, ...] per
    tensor], in flat fp32 buckets. COLLECTIVE."""
    group, world = _axis_group(axis)
    out = [None] * len(parts)
    for bucket in _buckets(parts):
        flat = torch.cat([parts[i].float().reshape(-1) for i in bucket])
        whole = flat.new_empty(world * flat.numel())
        with _timed("all_gather", whole.numel() * 4, flat.is_cuda):
            _scatter_or_gather("all_gather", flat, whole, group)
        whole = whole.view(world, -1)
        offset = 0
        for i in bucket:
            n = parts[i].numel()
            out[i] = [whole[w, offset:offset + n].view(parts[i].shape)
                      .to(parts[i].dtype) for w in range(world)]
            offset += n
    return out


def put_global_batch(batch, device):
    """This process's stacked feature dict -> its tensors on ``device``.
    The global batch is the concatenation over the data group, in data
    coordinate order, of their batches (each padded to the group's shape,
    so they agree; the processes of one model or expert line hold the
    same rows); no process builds it. Its rows before this process's are
    ``grid().coord("data") * rows`` (``train_step``)."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def put_eval_batch(source, rows: int):
    """This process's rows of an eval batch: every process builds the same
    dev/test stream, pads each batch to a multiple of the process count
    (``rows`` of them) and decodes its contiguous slice of rows.
    COLLECTIVE under several processes: all must call it and the
    consuming decode at the same point (``fetch_decode_output``)."""
    n = process_count()
    per = rows // n
    lo = process_index() * per

    def take(x):
        return x[lo:lo + per]
    if isinstance(source, dict):
        return {k: take(v) for k, v in source.items()}
    return take(source)


def fetch_decode_output(out: dict) -> dict:
    """Decode outputs of this process's rows -> those of every row, on
    every process: each array is padded to the largest shape over the
    processes and gathered along its rows, in process order; an int (the
    search's step count) takes the largest. COLLECTIVE."""
    if process_count() == 1:
        return out
    gathered = {}
    for key, value in out.items():
        if isinstance(value, (int, np.integer)):
            gathered[key] = int(_max_ints([int(value)])[0])
            continue
        arr = np.asarray(value)
        shape = _max_ints(list(arr.shape))
        pad = [(0, s - d) for s, d in zip(shape, arr.shape)]
        local = torch.from_numpy(np.ascontiguousarray(np.pad(arr, pad)))
        local = local.to(_host_comm_device())
        parts = [torch.empty_like(local) for _ in range(process_count())]
        tdist.all_gather(parts, local)
        gathered[key] = torch.cat(parts).cpu().numpy()
    return gathered


def _host_comm_device() -> torch.device:
    """Where a collective over host values runs: the current card under
    NCCL, the CPU under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _max_ints(values):
    """The element-wise maximum over the processes of a list of ints."""
    t = torch.tensor(values, dtype=torch.int64, device=_host_comm_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return t.cpu().tolist()


def lcm(a: int, b: int) -> int:
    return a * b // math.gcd(max(a, 1), max(b, 1))
