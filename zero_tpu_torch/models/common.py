"""Shared transformer-family skeleton: embeddings, encoder/decoder stacks,
the loss, and the static-cache inference API.

Counterpart of ``zero_tpu/models/common.py``. Variants supply a
``LayerHooks`` bundle and share one skeleton. Semantics kept:
  * embeddings scaled by sqrt(hidden) plus one bias shared between source
    and target sides
  * decoder-input shift-right after the bias add, so position 0's input is
    the zero vector + timing signal
  * sharing flags: shared_source_target_embedding ties all three tables;
    shared_target_softmax_embedding ties softmax to target
  * logits of the tied softmax in the compute dtype, returned as fp32
  * label-smoothed CE minus normalizer, per-sentence mean then batch mean,
    in fp32, over chunks of ``loss_chunk_tokens`` positions whose logits
    are recomputed in the backward (``chunked_tied_ce``)
  * fp32 master parameters: the loss casts them to the compute dtype with
    a differentiable cast, so the gradients reach the fp32 parameters
  * ``use_remat``: in training each layer runs under a non-reentrant
    activation checkpoint (``remat_policy`` picks what it keeps), with its
    dropout seeds drawn before it and passed in, so the recompute draws
    the forward's masks
  * the variants' extras: ``post_encode`` (L0Drop's gates), the
    post-stack ``enc_post``/``dec_post`` (Fixup's shift and scale),
    ``extra_init``/``extra_loss`` (L0Drop's gate projection and penalty)
    and ``zero_softmax`` (Fixup's zero softmax table)

  * ``scan_layers``: each stack's layers are one module whose tensors
    carry a leading [L] axis (state-dict keys ``encoder.self.qkv.ws.0``
    with no ``encoder.<l>.`` level, the JAX package's stacked paths);
    layer l runs the stack's module through functional_call on the l-th
    slice of each tensor, and in training the dropout seeds of every
    layer are drawn before the stack runs, as the JAX package's scan
    draws them

Data parallelism across processes runs (parallel/distributed.py), and
for every model tensor parallelism (``mesh_model``: vocab-parallel
embeddings and cross entropy here, split attention and FFN in ops/;
parallel/tensor.py), for transformer_moe expert parallelism
(``mesh_expert``, ops/moe.py) and for SP_MODELS sequence parallelism
(``mesh_seq``: every process of a seq line holds the whole batch ids,
embeds its block of the source and of the shifted target positions
(``seq_inputs``), runs the layers on its block with ring self-attention
(parallel/ring.py), gathers the encoder output once for every decoder
layer's cross-attention (``gather_encodes``) and takes the loss of its
target block, the per-sentence sums over the line); the other
parallelism options raise in training (check_ported), the pipeline over
a stack (``mesh_pipe``) among them.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from zero_tpu_torch import dtypes
from zero_tpu_torch.models.base import Inference
from zero_tpu_torch.ops import common as ops_common
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.ops import initializers as inits
from zero_tpu_torch.ops import nn
from zero_tpu_torch.ops.common import RngGen, dropout
from zero_tpu_torch.parallel import tensor as tp


class LayerHooks(NamedTuple):
    """Per-variant layer constructors/applications. Training hooks take a
    dropout-seed source ``rngs`` (RngGen); decode hooks are dropout-free."""
    init_enc_layer: Callable  # (gen, cfg, layer) -> module
    enc_layer: Callable       # (p, x, src_keep, cfg, rngs) -> x
    init_dec_layer: Callable  # (gen, cfg, layer) -> module
    # self_keep: the causal keep-mask, or a callable building it
    dec_layer_train: Callable  # (p, x, state, self_keep, mem_keep, cfg, rngs, tgt_mask) -> x
    dec_layer_precompute: Callable  # (p, encodes, cfg) -> layer_state
    init_dec_layer_cache: Callable  # (p, batch, max_len, cfg, dtype, device) -> cache
    dec_layer_step: Callable  # (p, x_t, layer_state, state, cache, time, cfg) -> (x_t, cache)
    # False for variants whose decode self-attention the pool kernel cannot
    # serve (RPR's relative-position tables): on the card they keep the
    # classic permuted cache instead of the ancestry pools
    pool_kernel: bool = True
    # optional encoder-output postprocessor (L0Drop):
    # (params, state, cfg, rngs, training) -> state
    post_encode: Optional[Callable] = None
    # optional post-stack transforms (Fixup's trailing shift/scale)
    init_enc_post: Optional[Callable] = None  # (gen, cfg) -> module
    enc_post: Optional[Callable] = None       # (p, x) -> x
    init_dec_post: Optional[Callable] = None  # (gen, cfg) -> module
    dec_post: Optional[Callable] = None       # (p, x) -> x


class Layer(torch.nn.Module):
    """A named group of sub-modules (one transformer layer: 'self', 'ln1',
    'cross', 'ffn', ...)."""

    def __init__(self, parts: dict):
        super().__init__()
        for name, part in parts.items():
            self.add_module(name, part)

    def forward(self, fn, *args):
        """fn(self, *args): lets torch.func.functional_call run a layer
        on given tensors (the activation checkpoint's recompute)."""
        return fn(self, *args)


class Seq2Seq(torch.nn.Module):
    """Parameters of a transformer-family model. State-dict keys are the
    JAX param paths with '/' turned into '.': ``embedding``, ``emb_bias``,
    ``encoder.<l>....``, ``decoder.<l>....`` (under scan_layers
    ``encoder....`` and ``decoder....`` with a leading [L] axis), and the
    variants' extra modules under their JAX keys (``source_pruning``,
    ``enc_post``, ``dec_post``). ``encoder``/``decoder``: a list of layer
    modules, or one stacked module (stack_layers)."""

    def __init__(self, tables: dict, encoder, decoder, extra=None):
        super().__init__()
        for name, t in tables.items():
            self.register_parameter(name, torch.nn.Parameter(t))
        self.encoder = (encoder if isinstance(encoder, torch.nn.Module)
                        else torch.nn.ModuleList(encoder))
        self.decoder = (decoder if isinstance(decoder, torch.nn.Module)
                        else torch.nn.ModuleList(decoder))
        for name, module in (extra or {}).items():
            self.add_module(name, module)

    def forward(self, fn):
        """fn(self): lets torch.func.functional_call run a function of the
        module on substituted (compute-dtype) parameters."""
        return fn(self)


def stack_layers(layers) -> torch.nn.Module:
    """One module of the layers' structure whose every tensor is the
    layers' tensors stacked on a new leading [L] axis (the JAX package's
    scan_layers layout; values identical to the unrolled ones)."""
    stacked = copy.deepcopy(layers[0])
    per_layer = [dict(layer.named_parameters()) for layer in layers]
    for name, _ in list(stacked.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = stacked.get_submodule(owner)
        module._parameters[leaf] = torch.nn.Parameter(
            torch.stack([p[name].detach() for p in per_layer]))
    return stacked


def _sliced(stack, tensors, l, fn, *args):
    """fn(layer l, *args): the stacked module run on the l-th slice of
    each of its ``tensors`` (tp.stack_tensors; slicing inside autograd,
    so the layer's grads land in row l of the stacked grads)."""
    return torch.func.functional_call(
        stack, {n: t[l] for n, t in tensors.items()}, (fn,) + args)


def stack_depth(stack) -> int:
    """The number of layers of a stacked module (the longest leading dim:
    tensor parallelism may hold a leaf's part of the layers)."""
    return max(t.shape[0] for t in stack.parameters())


def layer_calls(layers) -> list:
    """Per-layer appliers ``call(fn, *args) -> fn(layer, *args)`` over a
    list of layer modules or a stacked module (scan_layers)."""
    if isinstance(layers, torch.nn.ModuleList):
        return [functools.partial(_direct, p) for p in layers]
    tensors = tp.stack_tensors(layers)
    return [functools.partial(_sliced, layers, tensors, l)
            for l in range(stack_depth(layers))]


def _direct(layer, fn, *args):
    return fn(layer, *args)


def config_initializer(cfg):
    return inits.get_initializer(cfg.initializer, cfg.initializer_gain)


def layer_initializer(cfg, layer: int):
    """Depth-scaled per-layer initializer when deep_transformer_init is
    on, else the config initializer."""
    if cfg.deep_transformer_init:
        return inits.depth_scaled(layer, cfg.initializer_gain)
    return config_initializer(cfg)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embeddings(gen, cfg, zero_softmax: bool = False) -> dict:
    """Embedding tables per the sharing flags + the shared scale bias.

    zero_softmax: Fixup zero-initialises a *separate* softmax table; with
    sharing on, the tied table keeps its init."""
    emb_init = inits.normal(cfg.hidden_size ** -0.5)
    tables = {}
    src_vocab = cfg.src_vocab.size()
    tgt_vocab = cfg.tgt_vocab.size()
    if cfg.shared_source_target_embedding:
        tables["embedding"] = emb_init(gen, (src_vocab, cfg.embed_size))
    else:
        tables["src_embedding"] = emb_init(gen, (src_vocab, cfg.embed_size))
        tables["tgt_embedding"] = emb_init(gen, (tgt_vocab, cfg.embed_size))
        if not cfg.shared_target_softmax_embedding:
            init = inits.zeros() if zero_softmax else emb_init
            tables["softmax_embedding"] = init(gen,
                                               (tgt_vocab, cfg.embed_size))
    tables["emb_bias"] = config_initializer(cfg)(gen, (cfg.embed_size,))
    return tables


def emb_tables(params: Seq2Seq, cfg):
    """Resolve (src, tgt, softmax) tables under the sharing flags; a table
    split over the vocabulary (tensor parallelism) as its
    parallel/tensor.py:VocabPart."""
    if cfg.shared_source_target_embedding:
        e = tp.table(params, "embedding", params.embedding)
        return e, e, e
    src = tp.table(params, "src_embedding", params.src_embedding)
    tgt = tp.table(params, "tgt_embedding", params.tgt_embedding)
    soft = (tgt if cfg.shared_target_softmax_embedding
            else tp.table(params, "softmax_embedding",
                          params.softmax_embedding))
    return src, tgt, soft


def lookup(table, ids, dtype=None):
    """The rows of ``table`` at ``ids`` (in ``dtype`` when given). A
    VocabPart looks up the ids in its rows, zero elsewhere, summed over
    its line."""
    if not isinstance(table, tp.VocabPart):
        x = torch.nn.functional.embedding(ids.long(), table)
        return x if dtype is None else x.to(dtype)
    local = ids.long() - table.offset
    inside = (local >= 0) & (local < table.table.shape[0])
    x = torch.nn.functional.embedding(
        torch.where(inside, local, torch.zeros_like(local)), table.table)
    if dtype is not None:
        x = x.to(dtype)
    return dist.reduce_out(torch.where(inside[..., None], x,
                                       torch.zeros_like(x)), table.axis)


def embed_scaled(table, ids, bias, cfg, dtype):
    """gather(emb) * sqrt(hidden) + bias (``lookup``: a VocabPart's rows
    summed over its line)."""
    x = lookup(table, ids, dtype) * (cfg.hidden_size ** 0.5)
    return x + bias.to(dtype)


def shift_right(x):
    """Prepend a zero vector and drop the last position (applied post-bias,
    so the zero survives)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]


# ---------------------------------------------------------------------------
# sequence parallelism: this process's block of every sequence
# ---------------------------------------------------------------------------

def seq_span(length: int):
    """[lo, hi) of this process's block of a length-``length`` sequence
    axis under a split sequence (ops/common.py:seq_parallel); the whole
    axis otherwise."""
    n = ops_common.seq_degree()
    if n <= 1:
        return 0, int(length)
    if length % n:
        raise ValueError("a sequence of %d positions does not split into "
                         "mesh_seq=%d blocks (seq_padded pads it)"
                         % (length, n))
    part = length // n
    lo = ops_common.seq_coord() * part
    return lo, lo + part


def seq_block(x, dim: int = 1):
    """This process's block of ``x`` along ``dim`` (x itself without a
    split sequence)."""
    lo, hi = seq_span(x.shape[dim])
    return x.narrow(dim, lo, hi - lo) if (lo, hi) != (0, x.shape[dim]) \
        else x


def seq_padded(features: dict) -> dict:
    """The source and target ids padded with 0 (pad) to a multiple of the
    seq degree: the padding is masked (keys, loss), and trails every
    valid position. The one place a training length meets the 'seq'
    degree (the JAX package runs a length it does not divide dense)."""
    n = ops_common.seq_degree()
    if n <= 1:
        return features
    out = dict(features)
    for key in ("source", "target"):
        t = out[key]
        pad = (-t.shape[1]) % n
        if pad:
            out[key] = torch.nn.functional.pad(t, (0, pad))
    return out


def seq_inputs(x, rng, rate):
    """Embedded whole-length inputs x [B, L, d] (the target's already
    shifted) -> this process's block plus the timing signal of its global
    positions, then the input dropout, indexed over the whole sequence."""
    lo, _ = seq_span(x.shape[1])
    x = nn.add_timing_signal(seq_block(x), offset=lo)
    return dropout(rng, x, rate,
                   split=ops_common.seq_split(1, x.shape[1]))


def gather_encodes(x):
    """The encoder output's blocks joined whole on every process of the
    seq line, once for every decoder layer's cross-attention
    (distributed.gather_seq); x itself without a split sequence."""
    return dist.gather_seq(x) if ops_common.seq_degree() > 1 else x


# the matmuls each policy keeps: "dots" those without batch dims (the
# projections and the FFN), "dots_all" the batched ones too (attention's
# scores and context)
_SAVED_DOTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_all": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
}


def remat_policy(cfg):
    """cfg.remat_policy as a checkpoint ``context_fn``. "nothing" (the
    default) recomputes the whole layer in the backward; "dots" keeps the
    outputs of the matmuls without batch dims and recomputes the rest;
    "dots_all" keeps the batched matmuls' too (selective activation
    checkpointing)."""
    name = str(getattr(cfg, "remat_policy", "nothing") or "nothing")
    if name == "nothing":
        return noop_context_fn
    if name not in _SAVED_DOTS:
        raise ValueError("unknown remat_policy %r (nothing|dots|dots_all)"
                         % name)
    return functools.partial(create_selective_checkpoint_contexts,
                             list(_SAVED_DOTS[name]))


# dropout seeds drawn per layer under use_remat, as the JAX package's
# _REMAT_KEYS: the upper bound on a layer's dropout sites
REMAT_KEYS = 10


def _draw_keys(rngs):
    return [rngs() for _ in range(REMAT_KEYS)]


def _key_source(keys):
    """An rngs callable over a layer's pre-drawn seeds; a draw past them
    raises instead of wrapping round."""
    it = iter(keys)

    def draw():
        try:
            return next(it)
        except StopIteration:
            raise RuntimeError(
                "a layer asked for more than %d dropout seeds under "
                "use_remat" % REMAT_KEYS) from None
    return draw


def remat_layer(layer, context_fn, fn, *args, tensors=None):
    """``fn(layer, *args)`` under a non-reentrant activation checkpoint.

    The layer's tensors go in as an input and the layer runs on them
    through functional_call: the loss casts the fp32 parameters inside a
    functional_call of its own, which has put the fp32 masters back by the
    time the backward recomputes the layer. ``tensors`` (a stacked layer's
    l-th slices) stand in for the layer's own. Dropout draws from seeds in
    ``args``, never from a torch generator, so the recompute needs no RNG
    state (``preserve_rng_state`` off)."""
    def call(tensors, *inputs):
        return torch.func.functional_call(layer, tensors, (fn,) + inputs)

    if tensors is None:
        tensors = dict(layer.named_parameters())
    return checkpoint(call, tensors, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context_fn)


def compute_call(params, dtype, body):
    """body(params) with every tensor of ``params`` cast to ``dtype``
    differentiably (through functional_call), so the grads reach the fp32
    masters: the JAX package's cast_to_compute inside a loss. ``params``
    is a module whose forward(fn) returns fn(self)."""
    cast = {name: p.to(dtype) for name, p in params.named_parameters()}
    return torch.func.functional_call(params, cast, (body,))


def output_logits(feature, softmax_table):
    """Weight-tied softmax logits: product in the compute dtype, then fp32."""
    logits = torch.matmul(feature, softmax_table.to(feature.dtype).t())
    return logits.float()


def _chunk_ce(xc, lc, table, factor, vocab=None):
    return ops_common.smoothed_centropy_reduced(output_logits(xc, table), lc,
                                                factor, vocab)


def chunked_tied_ce(feature, soft_table, labels, factor, chunk_tokens):
    """Per-position label-smoothed CE without keeping the full logits: the
    [B*L, V] positions run in ``chunk_tokens``-row chunks, and under
    autograd each chunk is checkpointed, so the backward recomputes its
    logits instead of storing them. Per-position math is that of
    smoothed_centropy(output_logits(...)). feature: [B, L, d]; returns
    centropy [B, L] fp32. A VocabPart table gives [B*L, V/W] logits a
    chunk, reduced over its line (smoothed_centropy_reduced's ``vocab``)."""
    vocab = None
    if isinstance(soft_table, tp.VocabPart):
        vocab = (soft_table.offset, soft_table.total, soft_table.axis)
        feature = dist.copy_in(feature, soft_table.axis)
        soft_table = soft_table.table
    b, l, d = feature.shape
    n = b * l
    xf = feature.reshape(n, d)
    lf = labels.reshape(n).long()
    chunk = max(1, min(int(chunk_tokens), n))
    pad = (-n) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
        lf = torch.cat([lf, lf.new_zeros((pad,))])
    grad = torch.is_grad_enabled()
    cents = []
    for c0 in range(0, n + pad, chunk):
        args = (xf[c0:c0 + chunk], lf[c0:c0 + chunk], soft_table, factor,
                vocab)
        cents.append(checkpoint(_chunk_ce, *args, use_reentrant=False)
                     if grad else _chunk_ce(*args))
    return torch.cat(cents)[:n].reshape(b, l)


def ce_from_feature(feature, soft_table, labels, mask, cfg, factor):
    """Tied-softmax label-smoothed CE from decoder features: chunked when
    cfg.loss_chunk_tokens > 0, full logits otherwise. Returns (scalar loss,
    per-sentence [B])."""
    chunk = int(getattr(cfg, "loss_chunk_tokens", 0) or 0)
    if isinstance(soft_table, tp.VocabPart) and chunk <= 0:
        # the vocab-parallel reductions over one chunk of every position
        chunk = labels.numel()
    if chunk > 0:
        return ops_common.sentence_mean_loss(
            chunked_tied_ce(feature, soft_table, labels, factor, chunk),
            mask)
    return ops_common.label_smooth_loss(output_logits(feature, soft_table),
                                        labels, mask, factor)


def parallel_options(cfg) -> list:
    """The parallelism options of ``cfg`` that ask for more than one
    device: a mesh degree above 1 (``mesh_data`` -1 and 0 mean every
    device), ``dist_num_processes`` above 1 or ``zero_stage`` above 0.
    Returns their "name=value" strings (the eval modes' warning:
    train.py:_eval_on_one_device)."""
    asked = ["%s=%s" % (key, getattr(cfg, key))
             for key in ("mesh_data", "mesh_model", "mesh_seq", "mesh_pipe",
                         "mesh_expert", "dist_num_processes")
             if int(getattr(cfg, key, 1)) > 1]
    if int(getattr(cfg, "zero_stage", 0)) > 0:
        asked.append("zero_stage=%s" % cfg.zero_stage)
    return asked


# the models that train under expert parallelism (mesh_expert > 1)
EP_MODELS = ("transformer_moe",)
# the models that train under sequence parallelism (mesh_seq > 1): the
# JAX package's ring-capable models (zero_tpu/tests/test_ring.py)
SP_MODELS = ("transformer", "transformer_rpr", "transformer_rela",
             "transformer_multilingual", "transformer_clsr",
             "transformer_l0drop")


def check_ported(cfg, training: bool = True,
                 world: Optional[int] = None):
    """Raise on options of a later slice instead of ignoring them: in
    training ``mesh_pipe`` above 1 (and with it the pipeline over a
    scan_layers stack), ``mesh_seq`` above 1 for a model not in SP_MODELS
    and ``mesh_expert`` above 1 for one not in EP_MODELS, each naming the
    model, and ``mesh_seq`` with ``mesh_expert`` or ROBT. Data
    parallelism across ``world`` processes (by default the process
    group's, or ``dist_num_processes`` before one exists) runs, with ZeRO
    (``zero_stage``), the sharded checkpoint and every model, and so do
    tensor parallelism for every model, and sequence and expert
    parallelism (under ``scan_layers`` too) for their models; mesh
    degrees whose product is not the world size raise make_mesh's
    ValueError, and a head count the model degree does not divide a
    ValueError. Evaluation decodes on one device with a warning instead
    (train.py:_eval_on_one_device), as the JAX package's _eval_mesh does
    when the devices are too few."""
    if not training:
        return
    asked = ["%s=%s" % (key, getattr(cfg, key))
             for key in ("mesh_pipe",)
             if int(getattr(cfg, key, 1)) > 1]
    if not asked:
        if world is None:
            world = dist.process_count() if dist.active() \
                else int(cfg.dist_num_processes)
        dist.mesh_degrees(cfg, world)
    name = getattr(cfg, "model_name", "")
    for key, models in (("mesh_seq", SP_MODELS), ("mesh_expert", EP_MODELS)):
        if int(getattr(cfg, key, 1)) > 1 and name not in models:
            asked.append("%s=%s for %s" % (key, getattr(cfg, key), name))
    if int(getattr(cfg, "mesh_seq", 1)) > 1:
        # ROBT's in-step greedy decode of the batch is not split
        for key in ("mesh_expert", "robt"):
            value = getattr(cfg, key, 0)
            if (int(value) > 1 if key == "mesh_expert" else bool(value)):
                asked.append("mesh_seq=%s with %s=%s"
                             % (cfg.mesh_seq, key, value))
    if asked:
        raise NotImplementedError(
            "%s: not ported to zero_tpu_torch yet: it comes with a later "
            "slice" % ", ".join(asked))
    model = int(getattr(cfg, "mesh_model", 1))
    if model > 1 and int(cfg.num_heads) % model:
        raise ValueError("num_heads %d is not divisible by mesh_model %d: "
                         "tensor parallelism splits attention by heads"
                         % (int(cfg.num_heads), model))


# ---------------------------------------------------------------------------
# skeleton model
# ---------------------------------------------------------------------------

def make_transformer(hooks: LayerHooks, zero_softmax: bool = False,
                     extra_init: Optional[Callable] = None,
                     extra_loss: Optional[Callable] = None):
    """Build (init_fn, train_fn, score_fn, infer_fn) from layer hooks.

    extra_init(gen, cfg) -> {name: module} registered beside the layers
    (L0Drop's ``source_pruning``). extra_loss(params, state, cfg, step) ->
    scalar added to the training loss (L0Drop's ramped penalty); ``state``
    is what post_encode returned."""

    def init_fn(gen, cfg) -> Seq2Seq:
        tables = init_embeddings(gen, cfg, zero_softmax)
        encoder = [hooks.init_enc_layer(gen, cfg, l)
                   for l in range(cfg.num_encoder_layer)]
        decoder = [hooks.init_dec_layer(gen, cfg, l)
                   for l in range(cfg.num_decoder_layer)]
        if _scan_layers(cfg):
            encoder, decoder = stack_layers(encoder), stack_layers(decoder)
        extra = {}
        if hooks.init_enc_post is not None:
            extra["enc_post"] = hooks.init_enc_post(gen, cfg)
        if hooks.init_dec_post is not None:
            extra["dec_post"] = hooks.init_dec_post(gen, cfg)
        if extra_init is not None:
            extra.update(extra_init(gen, cfg))
        return Seq2Seq(tables, encoder, decoder, extra)

    def _use_remat(cfg, training):
        return bool(getattr(cfg, "use_remat", False)) and training

    def _scan_layers(cfg):
        return bool(getattr(cfg, "scan_layers", False))

    def _stacked_keys(rngs, num_layers):
        """Every layer's REMAT_KEYS seed pairs, drawn before the stack
        runs (the JAX package's _stacked_keys, with or without remat), or
        None when dropout is off. As there, the first draw only tests
        whether the source is live, and is dropped."""
        if rngs() is None:
            return None
        return [_draw_keys(rngs) for _ in range(num_layers)]

    def _scan_stack(stack, layer_fn, x, args, keys, remat):
        """The JAX package's _scan_stack as a loop: layer_fn(p, x, *args,
        keys_l) on each layer's slices of the stacked tensors, under the
        activation checkpoint when ``remat`` (a context_fn) is given.
        keys None: dropout off."""
        tensors = tp.stack_tensors(stack)
        for l in range(stack_depth(stack)):
            keys_l = [None] * REMAT_KEYS if keys is None else keys[l]
            if remat is not None:
                x = remat_layer(stack, remat, layer_fn, x, *args, keys_l,
                                tensors={n: t[l] for n, t in tensors.items()})
            else:
                x = _sliced(stack, tensors, l, layer_fn, x, *args, keys_l)
        return x

    def _enc_layer_keys(p, x, src_keep, cfg, keys):
        return hooks.enc_layer(p, x, src_keep, cfg, _key_source(keys))

    def _dec_layer_keys(p, x, state, self_keep, mem_keep, tgt_mask, cfg,
                        keys):
        return hooks.dec_layer_train(p, x, state, self_keep, mem_keep, cfg,
                                     _key_source(keys), tgt_mask)

    def _encode(params, source, cfg, rngs, dtype, training):
        mask = (source != 0).to(dtype)
        src_table, _, _ = emb_tables(params, cfg)
        x = embed_scaled(src_table, source, params.emb_bias, cfg, dtype)
        x = seq_inputs(x, rngs(), cfg.dropout if training else None)
        src_keep = nn.masking_mask(mask)
        remat = remat_policy(cfg) if _use_remat(cfg, training) else None
        if _scan_layers(cfg):
            keys = (_stacked_keys(rngs, cfg.num_encoder_layer) if training
                    else None)
            x = _scan_stack(params.encoder, _enc_layer_keys, x,
                            (src_keep, cfg), keys, remat)
        else:
            for p in params.encoder:
                if remat is not None:
                    # the seeds are drawn here, outside the checkpoint, so
                    # the recompute reads the forward's
                    x = remat_layer(p, remat, _enc_layer_keys, x, src_keep,
                                    cfg, _draw_keys(rngs))
                else:
                    x = hooks.enc_layer(p, x, src_keep, cfg, rngs)
        if hooks.enc_post is not None:
            x = hooks.enc_post(params.enc_post, x)
        state = {"encodes": gather_encodes(x), "mask": mask}
        if hooks.post_encode is not None:
            state = hooks.post_encode(params, state, cfg, rngs, training)
        return state

    def _decode_train(params, target, state, cfg, rngs, dtype, training):
        mask = seq_block((target != 0).to(dtype))
        _, tgt_table, soft_table = emb_tables(params, cfg)
        x = embed_scaled(tgt_table, target, params.emb_bias, cfg, dtype)
        x = seq_inputs(shift_right(x), rngs(),
                       cfg.dropout if training else None)
        # built on first use, by a layer on the composite path: a layer
        # whose self-attention takes a kernel needs only the causal flag,
        # and an [L, L] fp32 mask is 1 GiB at L = 16384
        self_keep = functools.cache(functools.partial(
            nn.causal_mask, target.shape[1], device=target.device))
        mem_keep = nn.masking_mask(state["mask"])
        remat = remat_policy(cfg) if _use_remat(cfg, training) else None
        if _scan_layers(cfg):
            keys = (_stacked_keys(rngs, cfg.num_decoder_layer) if training
                    else None)
            x = _scan_stack(params.decoder, _dec_layer_keys, x,
                            (state, self_keep, mem_keep, mask, cfg), keys,
                            remat)
        else:
            for p in params.decoder:
                if remat is not None:
                    x = remat_layer(p, remat, _dec_layer_keys, x, state,
                                    self_keep, mem_keep, mask, cfg,
                                    _draw_keys(rngs))
                else:
                    x = hooks.dec_layer_train(p, x, state, self_keep,
                                              mem_keep, cfg, rngs, mask)
        if hooks.dec_post is not None:
            x = hooks.dec_post(params.dec_post, x)
        return x, soft_table, mask

    def _loss(params, features, cfg, gen, step, training, label_smooth):
        """Cast the fp32 parameters to the compute dtype (differentiably),
        encode, decode, CE (plus extra_loss in training). Returns (scalar
        loss, per-sentence [B])."""
        check_ported(cfg, training)
        dtype = dtypes.compute_dtype(cfg)
        features = seq_padded(features)

        def body(cparams):
            rngs = RngGen(gen if training else None)
            state = _encode(cparams, features["source"], cfg, rngs, dtype,
                            training)
            feature, soft_table, mask = _decode_train(
                cparams, features["target"], state, cfg, rngs, dtype,
                training)
            loss, per_sample = ce_from_feature(
                feature, soft_table, seq_block(features["target"]), mask,
                cfg, label_smooth)
            if extra_loss is not None and training:
                loss = loss + extra_loss(cparams, state, cfg, step)
            return loss, per_sample

        return compute_call(params, dtype, body)

    def train_fn(params, features, cfg, gen, step=0):
        loss, _ = _loss(params, features, cfg, gen, step, True,
                        cfg.label_smooth)
        return {"loss": loss}

    def score_fn(params, features, cfg):
        # dropout off, label smoothing off
        _, per_sample = _loss(params, features, cfg, None, 0, False, 0.0)
        return {"score": per_sample}

    def infer_fn(cfg):
        dtype = dtypes.compute_dtype(cfg)

        def encode(params, source):
            state = _encode(params, source, cfg, RngGen(None), dtype, False)
            # per-layer beam-invariant decode state (cross mk/mv)
            state["layers"] = [
                call(hooks.dec_layer_precompute, state["encodes"], cfg)
                for call in layer_calls(params.decoder)]
            return state

        def _use_ancestry(beams, device):
            """Ancestry-indexed pools for beam decode. On the card they pay
            off only where the pool kernel runs (hooks.pool_kernel and
            use_flash_decode); elsewhere the classic permuted cache runs.
            The CPU takes them for every beam > 1, as the JAX package does
            off the TPU, so the tests exercise them; decode_ancestry on/off
            overrides for A/B measurement."""
            if beams <= 1:
                return False
            mode = str(getattr(cfg, "decode_ancestry", "auto"))
            if mode in ("on", "off"):
                return mode == "on"
            if device.type != "cuda":
                return True
            return bool(hooks.pool_kernel and cfg.use_flash_decode)

        def init_cache(params, state, batch, max_len):
            # ancestry[b, i, t] = pool row whose position-t KV belongs to
            # live beam i; beam count inferred from the beam-invariant
            # encoder state (batch = B * K). All-zeros start: every beam
            # descends from slot 0, matching the init_log_probs tie-break.
            device = state["mask"].device
            beams = max(batch // state["mask"].shape[0], 1)
            cache = {"layers": [
                call(hooks.init_dec_layer_cache, batch, max_len, cfg, dtype,
                     device)
                for call in layer_calls(params.decoder)]}
            if _use_ancestry(beams, device):
                cache["ancestry"] = torch.zeros(
                    (batch // beams, beams, max_len), dtype=torch.int32,
                    device=device)
            return cache

        def _embed_step(params, prev_tok, time):
            _, tgt_table, _ = emb_tables(params, cfg)
            x = embed_scaled(tgt_table, prev_tok, params.emb_bias, cfg, dtype)
            if time == 0:
                # position 0's input is the zero vector (shift-right)
                x = torch.zeros_like(x)
            return nn.add_timing_signal(x, time=time)

        def decode_step(params, prev_tok, state, cache, time):
            _, _, soft_table = emb_tables(params, cfg)
            x = _embed_step(params, prev_tok, time)
            anc = cache.get("ancestry")
            new_layer_caches = []
            for call, lstate, lcache in zip(layer_calls(params.decoder),
                                            state["layers"],
                                            cache["layers"]):
                if anc is not None:
                    lcache = dict(lcache, ancestry=anc)
                x, new_c = call(hooks.dec_layer_step, x, lstate, state,
                                lcache, time, cfg)
                new_c.pop("ancestry", None)
                new_layer_caches.append(new_c)
            if hooks.dec_post is not None:
                x = hooks.dec_post(params.dec_post, x)
            logits = output_logits(x[:, 0], soft_table)
            out_cache = {"layers": new_layer_caches}
            if anc is not None:
                out_cache["ancestry"] = anc
            return logits, out_cache

        def reorder_cache(cache, beam_indices, batch, beam_size, time,
                          span=1):
            """Beam-reorder the cache WITHOUT copying the KV pools.

            The just-written positions [time, time+span) sit in each
            beam's own row: record that as identity ancestry, then permute
            the [B, K, T] index by the surviving-beam indices. Every other
            tensor gets the plain beam gather."""
            if "ancestry" not in cache:
                # classic mode: permute every tensor, pools included
                return {"layers": [
                    {k: ops_common.gather_beams(v, beam_indices, batch,
                                                beam_size)
                     for k, v in lc.items()} for lc in cache["layers"]]}
            anc = cache["ancestry"]
            anc[:, :, time:time + span] = torch.arange(
                beam_size, dtype=anc.dtype, device=anc.device)[None, :, None]
            anc = torch.take_along_dim(anc, beam_indices[:, :, None].long(),
                                       dim=1)
            new_layers = [
                {k: (v if k.startswith("pool_")
                     else ops_common.gather_beams(v, beam_indices, batch,
                                                  beam_size))
                 for k, v in lc.items()} for lc in cache["layers"]]
            return {"layers": new_layers, "ancestry": anc}

        def decode_prefix(params, tgt_buffer, state, time):
            """Dev-mode oracle: full causal recompute over the [B, T_max]
            buffer; positions > time are garbage but causally invisible."""
            _, tgt_table, soft_table = emb_tables(params, cfg)
            x = embed_scaled(tgt_table, tgt_buffer, params.emb_bias, cfg,
                             dtype)
            x = shift_right(x)
            x = nn.add_timing_signal(x)
            self_keep = nn.causal_mask(tgt_buffer.shape[1],
                                       device=tgt_buffer.device)
            mem_keep = nn.masking_mask(state["mask"])
            mask = torch.ones_like(tgt_buffer).to(dtype)
            for call in layer_calls(params.decoder):
                x = call(hooks.dec_layer_train, x, state, self_keep,
                         mem_keep, cfg, RngGen(None), mask)
            if hooks.dec_post is not None:
                x = hooks.dec_post(params.dec_post, x)
            return output_logits(x[:, time], soft_table)

        return Inference(encode=encode, init_cache=init_cache,
                         decode_step=decode_step, decode_prefix=decode_prefix,
                         reorder_cache=reorder_cache)

    return init_fn, train_fn, score_fn, infer_fn
