"""The training step: grads, accumulation, the data-parallel gradient sum,
clipping, Adam, EMA; and the scoring step.

Counterpart of ``zero_tpu/parallel/train_step.py`` on one device a process:
  * gradient accumulation over the ``update_cycle`` stacked microbatches
    (the final grad and loss are means over the cycles)
  * data parallelism across processes (parallel/distributed.py): each
    microbatch is this process's slice of a global batch
    (ops/common.py:global_batch), whose loss every process computes
    through global sums; the accumulated gradients are summed over the
    processes once a step, so every process applies the global batch's
    update. No DistributedDataParallel: the loss runs through
    ``functional_call``, not the module's forward, and DDP's mean of the
    processes' means is not the global batch's mean once their valid rows
    differ (all-pad rows, token buckets)
  * ZeRO (``zero_stage``, parallel/mesh.py's layout) under data
    parallelism: stage 1 holds Adam's moments and the EMA as this
    process's shards, runs Adam on its slices and all-gathers the updated
    weights; stage 2 also reduce-scatters each microbatch's gradient into
    a shard accumulator, so no whole gradient outlives a microbatch;
    stage 3 also holds the parameters as shards and gathers the whole
    fp32 weights once a microbatch through a differentiable all-gather
    (``_GatherShards``: its backward reduce-scatters the gradient). A
    stage changes the layout only, never a value the host can observe;
    with a data degree of one every stage runs as stage 0, as in the JAX
    package
  * sequence parallelism (``mesh_seq``; parallel/ring.py): each
    process of a seq line runs its block of every sequence of the same
    rows, and every gradient is partial there: the gradients are summed
    over the seq line, then over the data group (ZeRO keeps its shards
    over 'data' only)
  * tensor and expert parallelism (``mesh_model``, ``mesh_expert``;
    parallel/mesh.py's table, parallel/tensor.py's regions): each process
    holds its part of every split leaf, and ZeRO cuts that part further;
    the gradients are summed over the data group only (a replicated leaf
    gets the same gradient on every process of a model or expert line,
    which no collective averages), and the norms count each part once
    over its line and each replicated leaf once
  * clipping by global norm (``clip_grad_norm``)
  * Adam as ``optax.scale_by_adam(b1, b2, eps)`` followed by
    ``p - lr * u``, with the learning rate passed from the host each step
  * optional EMA of the weights (``ema_decay > 0``)
  * ``safe_nan``: the update is skipped on the device (no host sync) when
    the loss or gnorm is not finite or gnorm >= ``gnorm_upper_bound``
  * ``robt``: each microbatch also trains on its back-translated pair
    (robt.py), and its loss is (loss + robt_weight * bt_loss) /
    (1 + robt_weight)

The state is updated in place (torch tensors are mutable; the JAX step
returns a new state). Parameters and optimizer moments stay fp32; the loss
casts the parameters to the compute dtype itself (models/common.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import contextlib
import functools

import numpy as np
import torch

from zero_tpu_torch import robt as robt_lib
from zero_tpu_torch.ops import common as ops_common
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel import tensor as tp
from zero_tpu_torch.parallel.mesh import Layout, warn_unsharded


@dataclass
class TrainState:
    params: torch.nn.Module      # fp32 master parameters (stage 3: shards)
    opt: dict                    # {'count': int32 [], 'mu': {name: t}, 'nu': {name: t}}
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    # ZeRO's layout of this process (None: every tensor whole) and the
    # stage that runs
    layout: Optional[Layout] = None
    zero_stage: int = 0


def _names_params(module):
    return list(module.named_parameters())


def zero_stage(cfg) -> int:
    """The ZeRO stage that runs: ``zero_stage`` under a 'data' degree
    above 1, else 0."""
    return int(getattr(cfg, "zero_stage", 0)) \
        if dist.grid().degree("data") > 1 else 0


def init_train_state(model, cfg, gen: torch.Generator, device) -> TrainState:
    """The whole state from ``gen`` (the same on every process), then each
    process keeps its model/expert part of every split leaf and, under
    ZeRO, its shards of the moments and the EMA and, at stage 3, of the
    parameters. Makes the mesh grid current (COLLECTIVE: its groups)."""
    grid = dist.make_grid(cfg) if dist.active() else dist.grid()
    params = model.init_fn(gen, cfg).to(device)
    named = _names_params(params)
    stage = zero_stage(cfg)
    split = grid.degree("model") > 1 or grid.degree("expert") > 1
    layout = (Layout.plan(named, grid, zero=stage > 0)
              if stage or split else None)
    if layout is not None and split:
        if dist.is_primary():
            warn_unsharded(layout.wholes, grid.degree("model"))
        for name, p in named:
            p.data = layout.part(name, p.detach()).contiguous()
        tp.tag_module(params, layout)

    def local(name, p):
        return layout.local(name, p.detach()) if layout else p.detach()

    opt = {"count": torch.zeros((), dtype=torch.int32, device=device),
           "mu": {n: torch.zeros_like(local(n, p)) for n, p in named},
           "nu": {n: torch.zeros_like(local(n, p)) for n, p in named}}
    ema = ({n: local(n, p).clone() for n, p in named}
           if cfg.ema_decay > 0 else None)
    if stage >= 3:
        for n, p in named:
            if layout.dim(n) is not None:
                p.data = local(n, p).clone()
    return TrainState(params=params, opt=opt, ema=ema, step=0,
                      layout=layout, zero_stage=stage)


def stack_microbatches(batches):
    """Stack update_cycle host feature dicts into [C, B, ...] arrays,
    padding each to the common per-dimension max."""
    out = {}
    for k in batches[0]:
        arrs = [np.asarray(b[k]) for b in batches]
        ndim = arrs[0].ndim
        maxes = [max(a.shape[d] for a in arrs) for d in range(ndim)]
        padded = [np.pad(a, [(0, maxes[d] - a.shape[d]) for d in range(ndim)])
                  for a in arrs]
        out[k] = np.stack(padded, axis=0)
    return out


def sharded_norm(shards, wholes, lines=None) -> torch.Tensor:
    """The global norm of a tree held partly as this process's shards
    (their partial sums of squares all-reduced over the data group) and
    partly whole on every process (counted once). ``lines`` ({tensor
    index: mesh axes}) names the model or expert axes that cut a tensor
    (indices into shards + wholes): its partial sum is completed over
    those lines too. COLLECTIVE."""
    tensors = shards + wholes
    lines = lines or {}
    keys = sorted({(i < len(shards),) + tuple(lines.get(i, ()))
                   for i in range(len(tensors))}, reverse=True)
    parts = {k: torch.zeros(1, dtype=torch.float32,
                            device=tensors[0].device) for k in keys}
    for i, t in enumerate(tensors):
        key = (i < len(shards),) + tuple(lines.get(i, ()))
        parts[key] = parts[key] + torch.sum(t.float() * t.float())
    total = None
    for key in keys:
        if key[0]:
            dist.all_reduce_sum_([parts[key]])
        for axis in key[1:]:
            dist.all_reduce_sum_([parts[key]], axis)
        total = parts[key][0] if total is None else total + parts[key][0]
    return torch.sqrt(total)


class _GatherShards(torch.autograd.Function):
    """ZeRO-3's weights: the forward all-gathers the fp32 shards into the
    whole tensors, the backward reduce-scatters their gradients into the
    shards' (each shard's .grad accumulates over the microbatches)."""

    @staticmethod
    def forward(ctx, dims, *shards):
        ctx.dims = dims
        return tuple(dist.all_gather_shards(shards, dims))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(dist.reduce_scatter_sum(grads, ctx.dims))


class _Whole(torch.nn.Module):
    """A parameter module run through functional_call on whole tensors."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, fn):
        return fn(self.inner)


def gathered_call(params, named, sharded, dims, fn):
    """fn(params) with each sharded leaf (indices ``sharded`` of
    ``named``) replaced by its whole fp32 tensor from one differentiable
    all-gather; the cast to the compute dtype comes after, inside the
    loss, so the backward reduce-scatters fp32 gradients. COLLECTIVE."""
    wholes = _GatherShards.apply(tuple(dims[i] for i in sharded),
                                 *[named[i][1] for i in sharded])
    tensors = {"inner." + n: p for n, p in named}
    for i, w in zip(sharded, wholes):
        tensors["inner." + named[i][0]] = w
    return torch.func.functional_call(_Whole(params), tensors, (fn,))


def make_micro_backward(model, cfg):
    """(params, feats, gen, step, layout) -> one microbatch's detached
    loss, its grads accumulated into the parameters' .grad. With ``robt``
    the loss is (loss + robt_weight * bt_loss) / (1 + robt_weight), as
    the JAX package's loss_fn: the main pass's backward runs before the
    back-translation, so its activations are freed first, and the z draw
    and the synthetic pass's seeds follow the main pass's on ``gen``;
    the back-translation gathers ``layout``'s split leaves whole."""
    robt_on = bool(getattr(cfg, "robt", False))
    if robt_on:
        augment = robt_lib.make_augment(model, cfg)
        robt_weight = float(getattr(cfg, "robt_weight", 1.0))

    def micro_backward(params, feats, gen, step, layout=None):
        loss = model.train_fn(params, feats, cfg, gen, step=step)["loss"]
        if not robt_on:
            loss.backward()
            return loss.detach()
        (loss / (1.0 + robt_weight)).backward()
        bt_feats = augment(params, feats, gen, layout)
        bt_loss = model.train_fn(params, bt_feats, cfg, gen,
                                 step=step)["loss"]
        (bt_loss * (robt_weight / (1.0 + robt_weight))).backward()
        return (loss.detach() + robt_weight * bt_loss.detach()) \
            / (1.0 + robt_weight)

    return micro_backward


@contextlib.contextmanager
def global_batch(rows: int):
    """The global batch that a microbatch of ``rows`` rows belongs to:
    under a process group, the concatenation of every data-group
    process's slice in data coordinate order (their slices share one
    shape; a model, seq or expert line holds one slice), and under a seq
    degree above 1 this process's block of every sequence
    (ops/common.py:seq_parallel); else none."""
    if not dist.active():
        yield
        return
    grid = dist.grid()
    data, coord = grid.degree("data"), grid.coord("data")
    with ops_common.global_batch(coord * rows, rows, data * rows,
                                 dist.global_sum):
        if grid.degree("seq") > 1:
            with ops_common.seq_parallel(
                    grid.coord("seq"), grid.degree("seq"),
                    functools.partial(dist.global_sum, axis="seq")):
                yield
        else:
            yield


def make_train_step(model, cfg):
    """Build step(state, batch, lr, gen) -> (state, metrics).

    ``batch`` values are [C, B, L] integer arrays (or tensors) with C =
    update_cycle; ``gen`` (a torch.Generator) seeds every dropout site of
    the C microbatches in turn. metrics holds device scalars {'loss',
    'gnorm', 'pnorm'}; reading them is the caller's host sync. Under a
    process group each process passes its slice of the global batch and
    the same ``gen``, and all apply the same update."""
    b1, b2, eps = float(cfg.beta1), float(cfg.beta2), float(cfg.epsilon)
    clip_norm = float(cfg.clip_grad_norm or 0.0)
    ema_decay = float(cfg.ema_decay)
    safe_nan = bool(cfg.safe_nan)
    gnorm_bound = float(cfg.gnorm_upper_bound)
    micro_backward = make_micro_backward(model, cfg)

    def step_fn(state: TrainState, batch, lr: float, gen):
        params = state.params
        named = _names_params(params)
        device = named[0][1].device
        layout, stage = state.layout, state.zero_stage
        dims = [layout.dim(n) if layout else None for n, _ in named]
        # the leaves held as shards (moments and EMA from stage 1, grads
        # from 2, parameters at 3) and those whole on every process
        sharded = [i for i, d in enumerate(dims) if d is not None]
        whole = [i for i, d in enumerate(dims) if d is None]
        # the model or expert axis that cuts each leaf (the norms complete
        # its sums over that line), by the leaf's index in sharded + whole
        # (``lines``) and in named (``named_lines``)
        splits = {n: s.axis for n, s in layout.splits.items()} \
            if layout else {}
        lines = {j: (splits[named[i][0]],)
                 for j, i in enumerate(sharded + whole)
                 if named[i][0] in splits}
        named_lines = {i: (splits[n],) for i, (n, _) in enumerate(named)
                       if n in splits}
        cycles, rows = next(iter(batch.values())).shape[:2]
        for _, p in named:
            p.grad = None
        loss, acc = None, None
        for c in range(int(cycles)):
            feats = {k: torch.as_tensor(v[c], device=device)
                     for k, v in batch.items()}
            with global_batch(int(rows)):
                if stage >= 3:
                    micro = gathered_call(
                        params, named, sharded, dims,
                        lambda m: micro_backward(m, feats, gen, state.step,
                                                 layout))
                else:
                    micro = micro_backward(params, feats, gen, state.step,
                                           layout)
            if stage == 2:
                # this microbatch's gradient into the shard accumulator
                shards = dist.reduce_scatter_sum(
                    [named[i][1].grad if named[i][1].grad is not None
                     else torch.zeros_like(named[i][1]) for i in sharded],
                    [dims[i] for i in sharded])
                acc = shards if acc is None else [
                    a + b for a, b in zip(acc, shards)]
                for i in sharded:
                    named[i][1].grad = None
            loss = micro if loss is None else loss + micro
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
        if stage == 2:
            for i, g in zip(sharded, acc):
                grads[i] = g
        if dist.active():
            # once a step: the global batch's gradient of every leaf not
            # already reduce-scattered into its shard, summed over the seq
            # line first (each process's covers its block of the
            # sequences)
            held = [grads[i] for i in (
                whole if stage >= 2 else range(len(named)))]
            dist.all_reduce_sum_(held, "seq")
            dist.all_reduce_sum_(held)
        if cycles > 1:
            grads = [g / cycles for g in grads]
            loss = loss / cycles

        with torch.no_grad():
            if stage >= 2:
                gnorm = sharded_norm([grads[i] for i in sharded],
                                     [grads[i] for i in whole], lines)
            else:
                gnorm = sharded_norm([], grads, named_lines)
            if clip_norm > 0:
                scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                                    max=1.0)
                grads = [g * scale for g in grads]
            count = state.opt["count"] + 1
            bc1 = 1.0 - torch.pow(b1, count.float())
            bc2 = 1.0 - torch.pow(b2, count.float())
            ok = None
            if safe_nan:
                ok = (torch.isfinite(loss) & torch.isfinite(gnorm)
                      & (gnorm < gnorm_bound))
            updated = []
            for (name, p), g, d in zip(named, grads, dims):
                # stages 1-2: Adam on this process's slice of a whole
                # parameter (stage 1: of its whole gradient too)
                sliced = d is not None and stage < 3
                p_loc = layout.local(name, p) if sliced else p
                if sliced and stage == 1:
                    g = layout.local(name, g)
                mu = (1.0 - b1) * g + b1 * state.opt["mu"][name]
                nu = (1.0 - b2) * (g * g) + b2 * state.opt["nu"][name]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                new_p = p_loc - lr * u.to(p.dtype)
                if ok is not None:
                    new_p = torch.where(ok, new_p, p_loc)
                    mu = torch.where(ok, mu, state.opt["mu"][name])
                    nu = torch.where(ok, nu, state.opt["nu"][name])
                if sliced:
                    updated.append(new_p)
                else:
                    p.copy_(new_p)
                state.opt["mu"][name] = mu
                state.opt["nu"][name] = nu
            if updated:
                # the new weights whole again: one all-gather of the slices
                for i, w in zip(sharded, dist.all_gather_shards(
                        updated, [dims[i] for i in sharded])):
                    named[i][1].copy_(w)
            state.opt["count"] = (torch.where(ok, count, state.opt["count"])
                                  if ok is not None else count)
            if state.ema is not None:
                for (name, p), d in zip(named, dims):
                    p_loc = layout.local(name, p) \
                        if d is not None and stage < 3 else p
                    state.ema[name] = (ema_decay * state.ema[name]
                                       + (1.0 - ema_decay) * p_loc)
            if stage >= 3:
                pnorm = sharded_norm([named[i][1] for i in sharded],
                                     [named[i][1] for i in whole], lines)
            else:
                pnorm = sharded_norm([], [p for _, p in named], named_lines)
            for _, p in named:
                p.grad = None
        state.step += 1
        return state, {"loss": loss, "gnorm": gnorm, "pnorm": pnorm}

    return step_fn


def make_score_step(model, cfg):
    """Teacher-forced scoring: (params, feats) -> [B] per-sentence scores."""
    @torch.no_grad()
    def score(params, feats):
        return model.score_fn(params, feats, cfg)["score"]
    return score
