"""Model registry and the inference contract.

Counterpart of ``zero_tpu/models/base.py``. A model registers

  init_fn(generator, cfg)                  -> parameter module (random init;
                                              state-dict names follow the
                                              JAX param paths)
  infer_fn(cfg)                            -> Inference with
      encode(params, source)                       -> state (beam-invariant
                                                    + 'mask', 'encodes')
      init_cache(params, state, batch, max_len)    -> cache dict, tensors
                                                    [B, ...] preallocated
      decode_step(params, prev_tok, state, cache, time)
                                                   -> (logits [B, V] fp32,
                                                       cache)
      decode_prefix(params, tgt_prefix, state, time) -> logits [B, V]
          (dev-mode oracle: full recompute over the padded prefix buffer)
      reorder_cache(cache, beam_indices [B, K], batch, beam_size, time,
                    span=1) -> cache

  train_fn(params, features, cfg, gen, step=0) -> {'loss': scalar}
      (features: {'source', 'target'} [B, L] int; gen: a torch.Generator
      seeding the dropout sites, or None for no dropout)
  score_fn(params, features, cfg)          -> {'score': [B]} (no dropout,
                                              no label smoothing)

``time`` is a host int.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class Inference(NamedTuple):
    encode: Callable
    init_cache: Callable
    decode_step: Callable
    decode_prefix: Optional[Callable] = None
    # None: the search permutes every cache tensor with a beam gather
    reorder_cache: Optional[Callable] = None


class ModelSpec(NamedTuple):
    init_fn: Callable
    train_fn: Callable
    score_fn: Callable
    infer_fn: Callable


_REGISTRY = {}


def model_register(name: str, init_fn, train_fn, score_fn, infer_fn) -> None:
    if name in _REGISTRY:
        raise ValueError("Model name %r is already registered" % name)
    _REGISTRY[name] = ModelSpec(init_fn, train_fn, score_fn, infer_fn)


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise ValueError("Unknown model %r; registered: %s"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]
