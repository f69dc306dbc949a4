"""The single-device training step: grads, accumulation, clipping, Adam,
EMA; and the scoring step.

Counterpart of the single-device part of ``zero_tpu/parallel/train_step.py``:
  * gradient accumulation over the ``update_cycle`` stacked microbatches
    (the final grad and loss are means over the cycles)
  * clipping by global norm (``clip_grad_norm``)
  * Adam as ``optax.scale_by_adam(b1, b2, eps)`` followed by
    ``p - lr * u``, with the learning rate passed from the host each step
  * optional EMA of the weights (``ema_decay > 0``)
  * ``safe_nan``: the update is skipped on the device (no host sync) when
    the loss or gnorm is not finite or gnorm >= ``gnorm_upper_bound``

The state is updated in place (torch tensors are mutable; the JAX step
returns a new state). Parameters and optimizer moments stay fp32; the loss
casts the parameters to the compute dtype itself (models/common.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class TrainState:
    params: torch.nn.Module      # fp32 master parameters
    opt: dict                    # {'count': int32 [], 'mu': {name: t}, 'nu': {name: t}}
    ema: Optional[Dict[str, torch.Tensor]]
    step: int


def _names_params(module):
    return list(module.named_parameters())


def init_train_state(model, cfg, gen: torch.Generator, device) -> TrainState:
    params = model.init_fn(gen, cfg).to(device)
    named = _names_params(params)
    opt = {"count": torch.zeros((), dtype=torch.int32, device=device),
           "mu": {n: torch.zeros_like(p) for n, p in named},
           "nu": {n: torch.zeros_like(p) for n, p in named}}
    ema = ({n: p.detach().clone() for n, p in named}
           if cfg.ema_decay > 0 else None)
    return TrainState(params=params, opt=opt, ema=ema, step=0)


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


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_train_step(model, cfg):
    """Build step(state, batch, lr, gen) -> (state, metrics).

    ``batch`` values are [C, B, L] integer arrays with C = update_cycle;
    ``gen`` (a torch.Generator) seeds every dropout site of the C
    microbatches in turn. metrics holds device scalars {'loss', 'gnorm',
    'pnorm'}; reading them is the caller's host sync."""
    b1, b2, eps = float(cfg.beta1), float(cfg.beta2), float(cfg.epsilon)
    clip_norm = float(cfg.clip_grad_norm or 0.0)
    ema_decay = float(cfg.ema_decay)
    safe_nan = bool(cfg.safe_nan)
    gnorm_bound = float(cfg.gnorm_upper_bound)

    def step_fn(state: TrainState, batch, lr: float, gen):
        params = state.params
        named = _names_params(params)
        device = named[0][1].device
        cycles = int(next(iter(batch.values())).shape[0])
        for _, p in named:
            p.grad = None
        loss = None
        for c in range(cycles):
            feats = {k: torch.as_tensor(np.asarray(v[c]), device=device)
                     for k, v in batch.items()}
            micro = model.train_fn(params, feats, cfg, gen,
                                   step=state.step)["loss"]
            micro.backward()
            loss = micro.detach() if loss is None else loss + micro.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
        if cycles > 1:
            grads = [g / cycles for g in grads]
            loss = loss / cycles

        with torch.no_grad():
            gnorm = global_norm(grads)
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
            for (name, p), g in zip(named, grads):
                mu = (1.0 - b1) * g + b1 * state.opt["mu"][name]
                nu = (1.0 - b2) * (g * g) + b2 * state.opt["nu"][name]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                new_p = p - lr * u.to(p.dtype)
                if ok is not None:
                    new_p = torch.where(ok, new_p, p)
                    mu = torch.where(ok, mu, state.opt["mu"][name])
                    nu = torch.where(ok, nu, state.opt["nu"][name])
                p.copy_(new_p)
                state.opt["mu"][name] = mu
                state.opt["nu"][name] = nu
            state.opt["count"] = (torch.where(ok, count, state.opt["count"])
                                  if ok is not None else count)
            if state.ema is not None:
                for name, p in named:
                    state.ema[name] = (ema_decay * state.ema[name]
                                       + (1.0 - ema_decay) * p)
            pnorm = global_norm([p for _, p in named])
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
