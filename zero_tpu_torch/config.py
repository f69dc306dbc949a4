"""Configuration system: flat hyper-parameter namespace with layered merging.

A copy of ``zero_tpu/config.py`` (the port imports nothing of the JAX
package): the same keys and defaults, so a ``param.json`` written by either
package merges into the other, plus ``device``. 3-level merge priority --
command line > saved param.json > config file > defaults -- with safe
config parsing (JSON or python-literal via ast.literal_eval).

Keys that only the JAX package reads (mesh axes, XLA cache, PRNG
implementation, ...) are kept for param.json compatibility and ignored here.
"""

from __future__ import annotations

import ast
import json
import logging
import os
from typing import Any, Dict


class Config:
    """A flat, attribute-accessible hyperparameter namespace.

    Mirrors the small slice of tf.contrib HParams the reference relies on:
    attribute access, ``parse("k=v,k2=v2")`` command-line overrides with
    type coercion against the default, ``override_from_dict``, and JSON
    (de)serialisation of ``param.json`` (reference run.py:262-272, 333-340).
    """

    def __init__(self, **kwargs: Any):
        self._values: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self._values[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError("Unknown hyperparameter: %s" % name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._values[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def values(self) -> Dict[str, Any]:
        return dict(self._values)

    def add_param(self, name: str, value: Any) -> None:
        self._values[name] = value

    # -- merging ----------------------------------------------------------
    def parse(self, spec: str) -> "Config":
        """Parse ``k=v,k2=v2`` command-line overrides with type coercion.

        Values are coerced to the type of the existing default; list-valued
        params accept python-literal syntax (``gpus=[0,1]``).
        """
        if not spec:
            return self
        # split on commas not inside brackets/quotes
        items, depth, cur = [], 0, []
        for ch in spec:
            if ch in "[({":
                depth += 1
            elif ch in "])}":
                depth -= 1
            if ch == "," and depth == 0:
                items.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur:
            items.append("".join(cur))

        for item in items:
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError("Malformed parameter assignment: %r" % item)
            k, v = item.split("=", 1)
            k = k.strip()
            if k not in self._values:
                # typo'd knobs silently doing nothing waste entire runs;
                # unknown keys are still SET (forward/experimental compat,
                # and the reference accepts injected keys) but flagged
                logging.getLogger("zero_tpu_torch").warning(
                    "Unknown parameter %r (not a declared default) -- "
                    "check for a typo", k)
            self._values[k] = _coerce(v.strip(), self._values.get(k))
        return self

    def override_from_dict(self, d: Dict[str, Any]) -> "Config":
        for k, v in d.items():
            self._values[k] = v
        return self

    # -- persistence --------------------------------------------------------
    def parse_json(self, s: str) -> "Config":
        return self.override_from_dict(json.loads(s))

    def to_json(self) -> str:
        return json.dumps(
            {k: v for k, v in self._values.items() if _is_jsonable(v)},
            indent=2, sort_keys=True)


def _is_jsonable(v: Any) -> bool:
    return isinstance(v, (int, float, str, bool, type(None), list, tuple, dict))


def _coerce(raw: str, default: Any) -> Any:
    """Coerce a raw string to the type of ``default``."""
    if isinstance(default, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError("Cannot parse bool from %r" % raw)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, (list, tuple)):
        return ast.literal_eval(raw)
    if default is None or isinstance(default, str):
        # unknown param: best-effort literal parse, else string
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return raw
    return raw


def default_config() -> Config:
    """All hyperparameters with defaults.

    Same inventory as the reference's global_params (run.py:24-239), minus
    TF-specific knobs (swap_memory, nthreads) and plus TPU-native ones
    (mesh axes, bucketing, microbatching).
    """
    return Config(
        # -- embeddings / sharing (run.py:26-28)
        shared_source_target_embedding=False,
        shared_target_softmax_embedding=True,

        # -- decoding (run.py:30-44)
        decode_length=50,
        beam_size=4,
        decode_alpha=0.6,
        enable_noise_beam_search=False,
        beam_search_temperature=1.0,
        top_beams=1,
        search_mode="cache",       # cache or dev (dev = re-run full decoder)
        decode_max_len=256,        # static upper bound on decode steps (TPU)

        # -- relative position encoding (run.py:47)
        max_relative_position=16,

        # -- learning rate decay (run.py:49-66)
        nstable=4,
        lrdecay_start=600000,
        lrdecay_end=1200000,
        warmup_steps=400,
        lrate_strategy="gnmt+",    # noam, gnmt+, epoch, score, vanilla, cosine
        lrate_decay=0.5,
        lrate_patience=1,
        cosine_period=5000,
        cosine_factor=1,

        # -- early stopping (run.py:69)
        estop_patience=100,

        # -- initialization (run.py:71-75)
        initializer="uniform",
        initializer_gain=0.08,

        # -- model size (run.py:77-113)
        hidden_size=1000,
        embed_size=620,
        dropout=0.1,
        relu_dropout=0.1,
        residual_dropout=0.1,
        label_smooth=0.1,
        model_name="rnnsearch",
        scope_name="rnnsearch",
        cell="atr",
        caencoder=True,
        layer_norm=False,
        use_deep_att=False,
        filter_size=2048,
        attention_dropout=0.1,
        num_encoder_layer=6,
        num_decoder_layer=6,
        num_heads=8,

        # -- average attention network (run.py:115-119)
        aan_mask=True,
        use_ffn=False,
        strategies=["aan"],

        # -- batching (run.py:121-133)
        max_len=100,
        eval_max_len=1000000,
        batch_size=80,
        token_size=3000,
        batch_or_token="token",
        eval_batch_size=32,
        shuffle_batch=True,
        # TPU shape-bucket discipline: pad sequence lengths up to a multiple
        # of this to bound the number of compiled shapes
        pad_seq_multiple=16,
        # pad batch dim up to a multiple of this (padded rows fully masked)
        pad_batch_multiple=8,

        # -- host pipeline (run.py:138-144)
        process_num=0,
        buffer_size=1000,
        input_queue_size=100,
        output_queue_size=100,
        # the JAX package's C++ corpus tokeniser; the port has not brought
        # it over yet and always tokenises in python (data.py)
        native_tokenizer=True,

        # -- files (run.py:146-167)
        src_vocab_file="",
        tgt_vocab_file="",
        src_train_file="",
        tgt_train_file="",
        src_dev_file="",
        tgt_dev_file="",
        src_test_file="",
        tgt_test_file="",
        output_dir="",
        test_output="",
        pretrained_model="",

        # -- optimizer (run.py:169-182)
        beta1=0.9,
        beta2=0.999,
        epsilon=1e-9,
        clip_grad_norm=5.0,
        gnorm_upper_bound=1e20,
        lrate=1e-5,
        min_lrate=0.0,
        max_lrate=1.0,

        # -- training budget (run.py:184-190)
        epoches=10,
        update_cycle=1,
        gpus=[0],                  # kept for config compat; TPU uses mesh
        # TPU mesh: number of data-parallel and model(tensor)-parallel ways;
        # -1 for data = use all remaining devices
        mesh_data=-1,
        mesh_model=1,
        # sequence-parallel ways (ring attention over a 'seq' mesh axis);
        # 1 = off. An extension the reference lacks (SURVEY §5 names SP as
        # the explicit TPU extension point for speech-length inputs).
        mesh_seq=1,
        # pipeline-parallel ways over a 'pipe' mesh axis (GPipe schedule
        # on scan_layers stacks; parallel/pipe.py); 1 = off. Requires
        # scan_layers=True and layer counts divisible by mesh_pipe.
        mesh_pipe=1,
        # microbatches per pipeline round-trip; 0 = mesh_pipe (minimum).
        # More microbatches shrink the (P-1)/(M+P-1) bubble.
        pp_microbatches=0,
        # expert-parallel ways over an 'expert' mesh axis (shards the
        # transformer_moe expert weights; ops/moe.py); 1 = off
        mesh_expert=1,
        # ZeRO optimizer-state/param sharding stage: 0 = off; 1 shards
        # the Adam moments + EMA over the 'data' axis (1/data_par per
        # chip instead of replicated; mesh.py:zero1_sharding); 2 also
        # pins the GRADIENT tree (including the gradient-accumulation
        # scan carry) to that layout, so the DP reduction lowers to a
        # reduce-scatter and no replicated grad tree persists; 3 also
        # shards the PARAMS over 'data' (FSDP: per-use weight
        # all-gathers, params 1/data_par per chip). Update math is
        # unchanged -- GSPMD derives the reduce/gather schedule from
        # the layout.
        zero_stage=0,
        # sharded checkpoints (saver.py sharded-v1): each host writes only
        # its own shards of cross-host-sharded state instead of
        # all-gathering the full tree to every host per save. "auto" =
        # on iff multi-host AND zero_stage>0; explicit true/false forces.
        sharded_checkpoint="auto",
        # transformer_moe (Switch/GShard extension): expert count,
        # routed experts per token (1=Switch, 2=GShard), train-time
        # capacity factor, load-balance aux-loss weight
        moe_num_experts=8,
        moe_top_k=1,
        moe_capacity_factor=1.25,
        moe_aux_weight=0.01,
        # MoE token dispatch backend (ops/moe.py): "scatter" (per-row
        # scatter-add/gather, no [B,S,E,C] one-hots -- the single-chip/
        # data-parallel optimum), "einsum" (dense one-hot form GSPMD
        # turns into all-to-alls under an 'expert' mesh axis), or
        # "auto" = einsum iff mesh_expert > 1
        moe_dispatch="auto",
        # gradient-checkpoint policy when use_remat: "nothing" = full
        # per-layer recompute (min memory), "dots" = keep layer matmul
        # outputs resident and recompute only elementwise + attention
        # scores (models/common.py:remat_policy; docs/mfu.md), or
        # "dots_all" (also keep batched score/context dots)
        remat_policy="nothing",
        # multi-host preemption-flag sync cadence (steps): SIGTERM may
        # reach hosts at different times, so the local flags are
        # all-reduced every N steps and every host checkpoints+exits at
        # the same step (the checkpoint path is collective)
        preempt_sync_freq=10,
        # data parallelism across processes (parallel/distributed.py:
        # torch.distributed, NCCL on cards, gloo on the CPU; one device a
        # process): coordinator "host:port"; empty = single process. The
        # reference has no multi-node support.
        dist_coordinator="",
        dist_num_processes=1,
        dist_process_id=0,

        safe_nan=False,
        dl4mt_redict=True,
        ema_decay=-1.0,
        data_leak_ratio=0.5,
        deep_transformer_init=False,

        # write checkpoints on a background thread over an on-device
        # snapshot (the train loop never blocks on the device->host fetch)
        async_checkpoint=True,

        # persistent XLA compilation cache: recompiles across processes
        # become disk hits (empty string disables)
        compilation_cache_dir="~/.cache/zero_tpu_xla",
        # PRNG implementation: auto = hardware rbg on TPU (threefry bit
        # generation measured at 48% of a dropout-regularised step),
        # threefry elsewhere; or an explicit jax impl name
        prng_impl="auto",

        # stack per-layer params and lax.scan the transformer stacks during
        # training: one layer body is traced/compiled instead of N (first
        # compiles of 20-30L models drop from minutes to layer-count-free);
        # decode stays unrolled (per-layer slices). Homogeneous-layer
        # transformer-family models only. Changes the checkpoint layout.
        scan_layers=False,

        # rematerialisation: recompute transformer layers in the backward
        # pass (jax.checkpoint) to fit deep/large models in HBM
        use_remat=False,

        # compute the tied-softmax CE loss in N-token chunks under
        # jax.checkpoint so the [tokens, vocab] fp32 logits (multi-GB at
        # WMT step sizes) never persist for the backward; 0 = off.
        # Numerically identical to the unchunked loss
        # (models/common.py:chunked_tied_ce, tests/test_chunked_loss.py).
        # Default 2048: measured 201k tok/s / 38.7% MFU at B=256 L=128 on
        # v5e -- within noise of the unchunked rate -- while freeing the
        # ~8 GB the persisted logits+grad cost (the unchunked step OOMs at
        # that shape on a 16 GB chip)
        loss_chunk_tokens=2048,

        # -- observability (rebuild extension; SURVEY §5: the reference
        # has no tracing -- only wall-clock step logs)
        profiler_dir="",          # write a torch.profiler trace here
        profiler_start_step=10,   # trace window [start, stop)
        profiler_stop_step=15,

        # -- train loop frequencies (run.py:207-219)
        disp_freq=100,
        eval_freq=10000,
        save_freq=5000,
        sample_freq=1000,
        checkpoints=5,
        best_checkpoints=1,
        max_training_steps=1000,

        random_seed=1234,
        train_continue=True,

        # -- dtype policy (run.py:228-232)
        default_dtype="float32",   # compute dtype: float32 | bfloat16
        dtype_epsilon=1e-8,
        dtype_inf=1e8,
        loss_scale=1.0,            # unused on TPU bf16; kept for compat

        # static-k compacted decode for L0Drop/AFS eval: gather the top
        # ceil(ratio*S) surviving positions into a shorter memory with a
        # count-carrying zero pad slot (the reference's extract_encodes,
        # transformer_l0drop.py:103-135, with a static k). 0 disables
        # (full-length zero-vector equivalence).
        l0_compact_ratio=0.0,

        # -- l0drop (run.py:234-238)
        l0_norm_reg_scalar=1.0,
        l0_norm_start_reg_ramp_up=0,
        l0_norm_end_reg_ramp_up=10000,
        l0_norm_warm_up=True,

        # -- speech translation (AFS / CTC; specs from reference docs/)
        audio_num_mel_bins=80,
        audio_frame_stride=1,
        asr_pretrain="",
        afs_l0_scalar=0.5,
        afs_mode="tf",             # 't' temporal only | 'tf' temporal+feature
        num_st_encoder_layer=6,
        # context-aware ST (docs/context_aware_st: simple concatenation of
        # the previous segment's AFS-reduced features)
        st_context=False,
        context_max_frame_len=1024,
        # multilingual LaLN/LaLT (docs/multilingual_laln_lalt): language
        # tags occupy vocab ids [lang_id_offset, lang_id_offset+num_languages)
        num_languages=2,
        lang_id_offset=3,
        # random online backtranslation (robt.py): in-graph greedy
        # back-translation through a uniformly random intermediate language
        robt=False,
        robt_weight=1.0,
        # CLSR (docs/conditional_language_specific_routing): budget p of
        # language-specific capacity + budget-loss weight
        clsr_budget=0.5,
        clsr_alpha=1.0,
        ctc_alpha=0.3,
        ctc_repeated=False,
        ctc_enable=False,
        coarse_label_base=-1,      # CoLaCTC label base; -1 disables
        sinusoid_posenc=True,
        max_frame_len=2048,
        # training and scoring attention through the CUDA kernels of
        # ops/kernels/fused_attention.py (their plain PyTorch version for
        # CPU tensors); off by default, as in the JAX package, until the
        # kernels win on the card (PERF.md)
        use_flash_attention=False,
        flash_block_size=256,
        # training and scoring FFNs through the CUDA kernels of
        # ops/kernels/fused_ffn.py: the [tokens, filter] hidden tile stays
        # on chip in the forward and the dropout mask regenerates in the
        # backward; off by default until it wins on the card (PERF.md)
        use_fused_ffn=False,
        # decode self-attention through the CUDA kernels of
        # ops/kernels/decode_attention.py (their plain PyTorch versions
        # for CPU tensors); False keeps the plain attention code of
        # ops/attention.py on every device
        use_flash_decode=True,
        # ancestry-indexed beam KV pools (models/common.py reorder_cache):
        # the per-step beam reorder updates a [B, K, T] int index instead
        # of permuting every layer's KV cache. "auto" = on for beams > 1;
        # "on"/"off" force it for A/B measurement
        decode_ancestry="auto",

        # torch device of the port's entry points: "cuda" (default) or
        # "cpu"; "cuda" without a GPU raises instead of moving to the CPU
        device="cuda",
    )


def save_parameters(params: Config, output_dir: str) -> None:
    """Persist params to ``output_dir/param.json``."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "param.json"), "w") as w:
        w.write(params.to_json())


def load_parameters(params: Config, output_dir: str) -> Config:
    """Merge saved param.json into params if present (reference run.py:262-272)."""
    path = os.path.join(output_dir, "param.json")
    if os.path.exists(path):
        with open(path) as r:
            params.parse_json(r.read())
    return params


def load_config_file(path: str) -> Dict[str, Any]:
    """Safely parse a config file: JSON first, then python-literal dict.

    The reference ``eval``s the file (run.py:335); we restrict to literals.
    """
    with open(path) as r:
        text = r.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        value = ast.literal_eval(text)
        if not isinstance(value, dict):
            raise ValueError("Config file must contain a dict literal")
        return value


def merge_params(params: Config, config_file: str = "", parameters: str = "",
                 output_dir: str | None = None) -> Config:
    """3-level merge: cmdline > saved param.json > config file > defaults.

    Applied twice around the saved-param load, exactly like reference
    run.py:367-376.
    """
    params.parse(parameters)
    if config_file and os.path.exists(config_file):
        params.override_from_dict(load_config_file(config_file))
    params = load_parameters(params, output_dir or params.output_dir)
    if config_file and os.path.exists(config_file):
        params.override_from_dict(load_config_file(config_file))
    params.parse(parameters)
    return params
