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

  (transformer_ibdecoder's IBInference has decode_pair, two positions a
  step, in place of decode_step; search.py:ib_beam_search drives it; the
  speech models' encode takes {'audio', 'mask'[, 'context',
  'context_mask']})

  train_fn(params, features, cfg, gen, step=0) -> {'loss': scalar, ...}
      (features: {'source', 'target'} [B, L] int, or for speech 'audio'
      [B, T, mels], 'audio_mask', 'target', 'transcript' and the context;
      gen: a torch.Generator seeding the dropout sites, or None for no
      dropout)
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
    # True: the eval modes cast the weights to the compute dtype once (the
    # skeleton's models, which the JAX package casts on every call). False
    # for models whose JAX counterpart never casts its weights (it computes
    # in fp32 at eval, or casts at each op): their weights stay fp32
    eval_cast: bool = True


_REGISTRY = {}

# the JAX package's registered models (zero_tpu/models): a name here that
# the port has not registered is a later slice of the port
JAX_MODELS = ("deepnmt", "rnnsearch", "rnnsearch_deepatt", "transformer",
              "transformer_aan", "transformer_afs", "transformer_clsr",
              "transformer_fixup", "transformer_fuse",
              "transformer_ibdecoder", "transformer_l0drop",
              "transformer_moe", "transformer_multilingual",
              "transformer_rela", "transformer_rpr")


def model_register(name: str, init_fn, train_fn, score_fn, infer_fn,
                   eval_cast: bool = True) -> None:
    if name in _REGISTRY:
        raise ValueError("Model name %r is already registered" % name)
    _REGISTRY[name] = ModelSpec(init_fn, train_fn, score_fn, infer_fn,
                                eval_cast)


def get_model(name: str) -> ModelSpec:
    """The registered model ``name``. A model of the JAX package that the
    port has not registered yet raises NotImplementedError; any other
    unknown name ValueError."""
    if name not in _REGISTRY and name in JAX_MODELS:
        raise NotImplementedError(
            "model %r is not ported to zero_tpu_torch yet: it comes with a "
            "later slice (ported: %s)" % (name, sorted(_REGISTRY)))
    if name not in _REGISTRY:
        raise ValueError("Unknown model %r; registered: %s"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]
