"""Training, evaluation and scoring loops: one device a process, data,
tensor, sequence and expert parallelism across processes.

Counterpart of ``zero_tpu/train.py`` without pipelines or rings: the
epoch/step loop with update_cycle grouping, NaN abort (or the safe_nan
skip), periodic display/save/sample/eval, mid-epoch
resume from ``record.json`` by skipping consumed batches, dev-BLEU-driven
best checkpointing and early stop, the EMA weight swap for eval, a SIGTERM
checkpoint-and-exit, a profiler window, and the final save and dev eval;
plus the ``--mode test`` (``evaluate``), ``--mode score`` (``scorer``) and
``--mode ensemble`` (``ensemble``) entry points, which decode on one
device. Under several processes (parallel/distributed.py) each takes the
slot of its data coordinate in every group of host batches (the
processes of a model, seq or expert line take the same, and each
process of a seq line runs its block of every sequence), the primary saves
and samples, and the dev eval decodes each process's rows of every batch
with the whole weights and gathers them; under ZeRO (``zero_stage``) or
tensor and expert parallelism (``mesh_model``, ``mesh_expert``) the
state is gathered whole where a save or a decode needs it, or each
process writes its own parts (``sharded_checkpoint``).
``data_kind=speech`` reads TSV manifests (audio.py:SpeechDataset) in
every mode and feeds the models the frames, their mask, the transcript
and the context as the JAX package does.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import signal
import time

import numpy as np
import torch

from zero_tpu_torch import dtypes, evalu, lrs
from zero_tpu_torch.audio import SpeechDataset
from zero_tpu_torch.data import Dataset
from zero_tpu_torch.models.base import Inference, get_model
from zero_tpu_torch.models.common import check_ported, parallel_options
from zero_tpu_torch.models.transformer_ibdecoder import unfold
from zero_tpu_torch.parallel import distributed as dist
from zero_tpu_torch.parallel.mesh import per_rank_bytes, whole_size
from zero_tpu_torch.parallel import tensor as tp
from zero_tpu_torch.pipeline import Prefetcher
from zero_tpu_torch.saver import Saver
from zero_tpu_torch.search import beam_search, gather_cache, ib_beam_search
from zero_tpu_torch.train_step import (init_train_state, make_score_step,
                                       make_train_step, stack_microbatches)

log = logging.getLogger("zero_tpu_torch.train")


def device_of(params) -> torch.device:
    """The configured torch device, on a card this process's
    (``cuda:<rank % device_count>``); "cuda" without a GPU raises (no
    silent move to the CPU)."""
    device = torch.device(params.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=%s but torch sees no CUDA device; pass "
            "--parameters device=cpu to run on the CPU" % params.device)
    return dist.local_device(params)


def _is_speech(params) -> bool:
    return getattr(params, "data_kind", "text") == "speech"


def _make_dataset(params, src, tgt, train=False, data_par: int = 1):
    """Training batches by the configured batch or token budget, their
    rows padded to a multiple of lcm(pad_batch_multiple, data_par); eval
    batches padded to lcm(eval_batch_size, data_par) rows, so the 'data'
    degree divides them. Lengths snap to pad_seq_multiple, as the JAX
    package pads them (under mesh_seq the model pads a training length
    further, to a multiple of the 'seq' degree: models/common.py:
    seq_padded). Speech: ``src`` is the TSV manifest (features,
    transcript, translation), ``tgt`` still names the reference
    translations for BLEU, and the token budget counts frames."""
    bmult = dist.lcm(params.pad_batch_multiple, data_par) if train else 1
    eval_rows = dist.lcm(params.eval_batch_size, data_par)
    if _is_speech(params):
        return SpeechDataset(
            src, params.src_vocab, params.tgt_vocab,
            max_len=params.max_len if train else params.eval_max_len,
            max_frame_len=params.max_frame_len,
            batch_or_token=params.batch_or_token if train else "batch",
            data_leak_ratio=params.data_leak_ratio,
            num_mels=params.audio_num_mel_bins,
            pad_seq_multiple=params.pad_seq_multiple,
            pad_batch_multiple=bmult,
            pad_batch_to=0 if train else eval_rows,
            coarse_label_base=params.coarse_label_base,
            context=params.st_context,
            context_max_frame_len=params.context_max_frame_len)
    return Dataset(src, tgt, params.src_vocab, params.tgt_vocab,
                   max_len=params.max_len if train else params.eval_max_len,
                   batch_or_token=params.batch_or_token if train else "batch",
                   data_leak_ratio=params.data_leak_ratio,
                   pad_seq_multiple=params.pad_seq_multiple,
                   pad_batch_multiple=bmult,
                   pad_batch_to=0 if train else eval_rows,
                   # process_num forked tokeniser workers for the first pass
                   # over the training corpus; the C++ tokeniser (native/)
                   # where native_tokenizer is on and the library builds
                   num_workers=params.process_num if train else 0,
                   vocab_files=(params.src_vocab_file,
                                params.tgt_vocab_file),
                   use_native=params.native_tokenizer)


def _batch_source(batch, device):
    """Dataset batch dict -> the model's encode input: the token matrix,
    or the speech dict {'audio', 'mask'[, 'context', 'context_mask']}."""
    if "src_mask" in batch:
        source = {"audio": batch["src"], "mask": batch["src_mask"]}
        if "context" in batch:
            source["context"] = batch["context"]
            source["context_mask"] = batch["context_mask"]
        return {k: torch.as_tensor(v, device=device)
                for k, v in source.items()}
    return torch.as_tensor(batch["src"], device=device).long()


def _batch_features(params, batch):
    """Dataset batch dict -> training/scoring feature dict (speech: the
    frames, their mask, the target, the transcript and the context)."""
    if "src_mask" in batch:
        feats = {"audio": batch["src"], "audio_mask": batch["src_mask"],
                 "target": batch["tgt"]}
        for key in ("transcript", "context", "context_mask"):
            if key in batch:
                feats[key] = batch[key]
        return feats
    return {"source": batch["src"], "target": batch["tgt"]}


def _pad_rows(source, mult: int):
    """Pad the rows (axis 0) of a source tensor, or of each tensor of a
    speech source dict, with zeros up to a multiple of ``mult``; all-pad
    rows are legal everywhere. Returns (padded source, original rows)."""
    first = next(iter(source.values())) if isinstance(source, dict) \
        else source
    rows = int(first.shape[0])
    extra = -rows % mult

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
    if not extra:
        return source, rows
    if isinstance(source, dict):
        return {k: pad(v) for k, v in source.items()}, rows
    return pad(source), rows


def make_decode_fn(params, model=None, inference=None, sharded=False):
    """Beam-search callable over dataset batch dicts; returns numpy
    'seq' [B, K, T] and 'score' [B, K], and the int 'steps'.
    transformer_ibdecoder runs the pair search and unfolds each
    hypothesis on the host ('steps' counts pair steps). ``sharded``: the
    data-sharded decode of ``zero_tpu/train.py:_mesh_decode`` -- each
    process decodes its rows of the batch (padded to a multiple of the
    process count) and every process gets every row's output.
    COLLECTIVE under several processes."""
    model = model or get_model(params.model_name)
    inference = inference or model.infer_fn(params)
    device = device_of(params)
    pairs = params.model_name == "transformer_ibdecoder"

    @torch.inference_mode()
    def decode(weights, batch):
        source = _batch_source(batch, device)
        if not sharded or dist.process_count() == 1:
            return run(weights, source)
        source, rows = _pad_rows(source, dist.process_count())
        padded = rows + -rows % dist.process_count()
        out = dist.fetch_decode_output(
            run(weights, dist.put_eval_batch(source, padded)))
        return {k: (v[:rows] if getattr(v, "ndim", 0) > 0 else v)
                for k, v in out.items()}

    def run(weights, source):
        if not pairs:
            out = beam_search(weights, source, inference, params)
            return {"seq": out["seq"].cpu().numpy(),
                    "score": out["score"].cpu().numpy(),
                    "steps": out["steps"]}
        out = ib_beam_search(weights, source, inference, params)
        z = out["seq"].cpu().numpy()
        y = np.zeros(z.shape, np.int64)
        eos = params.tgt_vocab.eos()
        for bi in range(z.shape[0]):
            for ki in range(z.shape[1]):
                toks = unfold(z[bi, ki], eos)
                y[bi, ki, :len(toks)] = toks
        return {"seq": y, "score": out["score"].cpu().numpy(),
                "steps": out["steps"]}
    return decode


def _dev_eval(params, decode, weights, dev_dataset, out_prefix: str):
    translations, _, indices = evalu.decoding(
        lambda batch: decode(weights, batch), dev_dataset, params)
    bleu = evalu.eval_metric(translations, params.tgt_dev_file, indices)
    if out_prefix:
        evalu.dump_translation(translations, out_prefix, indices)
    return bleu


def train(params) -> dict:
    """Train per ``params``; returns the run's summary (see _train). A
    SIGTERM checkpoints at the end of the current step and exits the loop,
    so ``--mode train`` on the same output_dir resumes mid-epoch."""
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:           # not the main thread (library use)
        prev_sigterm = None
    try:
        return _train(params, preempted)
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def _step_generator(params, step: int) -> torch.Generator:
    """The dropout seeds of one step: a host generator keyed by the run's
    seed and the step, so a resumed run draws what it would have drawn."""
    return torch.Generator().manual_seed(
        (int(params.random_seed) + 7) * 1000003 + int(step))


def _pad_group_batch(batch, host_group):
    """Pad a host batch to the shape of its group of process batches
    (``zero_tpu/train.py:_pad_group_batch``): every array of two or more
    axes to the group's largest rows (axis 0) and length (axis 1), so the
    processes' slices of the global batch share one shape. Zero rows and
    columns are ordinary padding (all-pad rows are legal)."""
    out = dict(batch)

    def pad_to(x, length, axis):
        width = [(0, 0)] * x.ndim
        width[axis] = (0, length - x.shape[axis])
        return np.pad(x, width) if length > x.shape[axis] else x

    for key, val in batch.items():
        if not (hasattr(val, "shape") and getattr(val, "ndim", 0) >= 2):
            continue
        rows = max(b[key].shape[0] for b in host_group)
        length = max(b[key].shape[1] for b in host_group)
        out[key] = pad_to(pad_to(val, length, 1), rows, 0)
    return out


def sharded_checkpoint(params, nproc: int) -> bool:
    """``sharded_checkpoint``: "auto" is on iff there are several processes
    and ``zero_stage`` > 0 (``zero_tpu/train.py:338-345``); true or false
    force it."""
    pref = getattr(params, "sharded_checkpoint", "auto")
    if str(pref).lower() == "auto":
        return nproc > 1 and int(getattr(params, "zero_stage", 0)) > 0
    return pref is True or str(pref).lower() in ("true", "1", "yes")


class _ProfileWindow:
    """A torch.profiler trace of steps [profiler_start_step,
    profiler_stop_step) into ``profiler_dir`` as Chrome JSON
    (``zero_tpu/train.py:475-487``); ``profiler_dir=""`` keeps it off. The
    device is synchronised at the stop step. Each step in the window is
    one ``zero_tpu_torch.train_step`` range. Under data parallelism only
    the primary traces, as the JAX trace is one host's."""

    def __init__(self, params, device):
        self.dir = params.profiler_dir if dist.is_primary() else ""
        self.start = int(params.profiler_start_step)
        self.stop = int(params.profiler_stop_step)
        self.device = device
        self.prof = None

    def before(self, step: int) -> None:
        if self.dir and step == self.start and self.prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            log.info("profiler trace started -> %s", self.dir)

    def step(self):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("zero_tpu_torch.train_step")

    def after(self, step: int) -> None:
        if self.prof is not None and step >= self.stop:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace_steps%d-%d.json"
                            % (self.start, self.stop))
        self.prof.export_chrome_trace(path)
        self.prof = None
        log.info("profiler trace stopped -> %s", path)


def _train(params, preempted) -> dict:
    """Returns {'steps', 'seconds', 'step_end_times', 'losses', 'gnorms',
    'target_tokens', 'shapes', 'bleu', 'allreduce'}: per-step host-clock
    end times (device-synchronised when the step displays), losses,
    gnorms, this process's target tokens and the [C] (src, tgt) batch
    shapes of every step, the final dev BLEU (None without a dev set or
    after a preemption) and the gradient all-reduce's {'calls', 'bytes',
    'ms'} over the run (zeros without a process group), with ZeRO's
    'reduce_scatter' and 'all_gather' the same."""
    model = get_model(params.model_name)
    device = device_of(params)
    nproc, pid = dist.process_count(), dist.process_index()
    check_ported(params, world=nproc)
    # the mesh grid over the processes, one device a process
    # (parallel/distributed.py): 'data' x 'model' x 'seq' x 'expert'
    grid = dist.make_grid(params) if dist.active() else dist.grid()
    data_par, slot = grid.degree("data"), grid.coord("data")
    if nproc > 1:
        log.info("process %d of %d on %s: mesh %s at %s", pid, nproc,
                 device, grid.degrees, grid.coords)
    if nproc > 1 and grid.degree("model") > 1 and params.sample_freq > 0:
        # zero_tpu/train.py:295-302
        log.warning("multi-host with tensor parallelism: in-training "
                    "sampling disabled (sample batches are host-local); "
                    "dev eval itself stays on via the collective mesh "
                    "decode")
        params.sample_freq = 0
    # every process builds the same batch stream (the seeds of run.py),
    # takes the slot of its data coordinate in each group of data_par
    # host batches and pads it to the group's shape: the global batch
    # needs no communication, and a model, seq or expert line holds one
    # slot (R3)
    train_dataset = _make_dataset(params, params.src_train_file,
                                  params.tgt_train_file, train=True,
                                  data_par=max(data_par // nproc, 1))
    if isinstance(train_dataset, Dataset):
        # the first pass runs here, in the main thread, before any device
        # state or prefetch thread exists: process_num's forked workers run
        # pure python and touch neither torch nor the card
        train_dataset.tokenize()
    dev_dataset = _make_dataset(params, params.src_dev_file,
                                params.tgt_dev_file, data_par=data_par)

    gen = torch.Generator().manual_seed(int(params.random_seed))
    state = init_train_state(model, params, gen, device)
    num_params = whole_size(state.layout, state.params)
    log.info("Total trainable variables size: %d", num_params)
    mb = 1024.0 * 1024.0
    # each process's own bytes: its shards under ZeRO
    log.info("Per-chip state: params %.1f MB, optimizer %.1f MB, "
             "EMA %.1f MB (zero_stage=%d)",
             per_rank_bytes(state.params) / mb,
             per_rank_bytes(state.opt) / mb, per_rank_bytes(state.ema) / mb,
             int(getattr(params, "zero_stage", 0)))

    step_fn = make_train_step(model, params)
    # the dev eval decodes each process's rows of every batch; sampling
    # decodes the primary's own last batch on its own
    decode = make_decode_fn(params, model, sharded=True)
    decode_local = make_decode_fn(params, model)
    # the sharded format: each process writes its own shards, no process
    # gathers the whole state (saver.py)
    saver = Saver(checkpoints=params.checkpoints,
                  output_dir=params.output_dir,
                  best_checkpoints=params.best_checkpoints,
                  async_save=bool(params.async_checkpoint),
                  sharded=sharded_checkpoint(params, nproc),
                  layout=state.layout)
    recorder = params.recorder

    def _save_all(step, bleu=None):
        """Checkpoint and recorder. COLLECTIVE: every process writes its
        shards (sharded), or all gather the whole state (host_fetchable)
        and the primary writes it."""
        trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
        if saver.sharded:
            saver.save(trees, step, bleu)
        else:
            trees = dist.host_fetchable(trees, state.layout)
            if dist.is_primary():
                saver.save(trees, step, bleu)
        if dist.is_primary():
            recorder.save_to_json(
                os.path.join(params.output_dir, "record.json"))

    trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    if params.pretrained_model:
        saver.restore(trees, params.pretrained_model)
    saver.restore(trees)

    adapt_lr = lrs.get_lr(params)
    adapt_lr.lrate = recorder.lrate
    step = int(recorder.step)
    state.step = step
    cycle = max(int(params.update_cycle), 1)
    should_stop = False
    summary = {"step_end_times": [], "losses": [], "gnorms": [],
               "target_tokens": [], "shapes": [], "bleu": None}
    profile = _ProfileWindow(params, device)
    dist.take_stats()
    begin = time.time()

    for epoch in range(recorder.epoch, params.epoches + 1):
        log.info("Training at Epoch %d", epoch)
        adapt_lr.before_epoch(eidx=epoch)
        resume_epoch, resume_lidx = recorder.epoch, recorder.lidx

        host_queue = Prefetcher(
            lambda: train_dataset.batcher(
                params.batch_size if params.batch_or_token == "batch"
                else params.token_size,
                buffer_size=params.buffer_size,
                shuffle=params.shuffle_batch, train=True),
            maxsize=params.output_queue_size)

        def grouped_batches():
            """Process grouping, update_cycle grouping, stacking and the
            copy to the device, on the feed thread (no collective runs
            here); skips the groups a resumed run has consumed."""
            group, host_group = [], []
            for lidx, batch in enumerate(host_queue):
                host_group.append(batch)
                if len(host_group) < data_par:
                    continue
                mine = host_group[slot]
                if data_par > 1:
                    mine = _pad_group_batch(mine, host_group)
                host_group = []
                if epoch == resume_epoch and lidx <= resume_lidx:
                    continue
                group.append(mine)
                if len(group) < cycle:
                    continue
                stacked = dist.put_global_batch(stack_microbatches(
                    [_batch_features(params, b) for b in group]), device)
                tokens = int(sum((b["tgt"] > 0).sum() for b in group))
                shapes = [(tuple(b["src"].shape), tuple(b["tgt"].shape))
                          for b in group]
                yield stacked, tokens, shapes, lidx, group[-1]
                group = []

        feed = Prefetcher(grouped_batches, maxsize=2)
        window_tokens = 0
        window_start = time.time()

        for stacked, token_count, shapes, lidx, batch in feed:
            adapt_lr.step(step)
            lr = adapt_lr.get_lr()
            profile.before(step)
            with profile.step():
                _, metrics = step_fn(state, stacked, lr,
                                     _step_generator(params, step))
            step += 1
            profile.after(step)
            window_tokens += token_count
            summary["losses"].append(metrics["loss"])
            summary["gnorms"].append(metrics["gnorm"])
            summary["target_tokens"].append(token_count)
            summary["shapes"].append(shapes)

            if step % params.disp_freq == 0:
                loss = float(metrics["loss"])   # waits for the device
                gnorm = float(metrics["gnorm"])
                pnorm = float(metrics["pnorm"])
                now = time.time()
                duration = now - window_start
                rate = window_tokens / max(duration, 1e-6)
                window_start = now
                window_tokens = 0
                # the loss is the global batch's: every process stops
                if not params.safe_nan and not np.isfinite(loss):
                    log.error("Nan or Inf raised at step %d; abort training",
                              step)
                    recorder.estop = True
                    summary["step_end_times"].append(time.time())
                    break
                log.info("%d/%d, loss %.3f, gnorm %.2f, pnorm %.2f, "
                         "lr %.6f, batch %s, tokens %d, UD %.3f s, "
                         "%.0f tokens/s", epoch, step, loss, gnorm, pnorm,
                         lr, [s for s, _ in shapes], token_count, duration,
                         rate)
            summary["step_end_times"].append(time.time())

            recorder.step = step
            recorder.lidx = lidx
            recorder.lrate = float(lr)
            recorder.epoch = epoch

            # SIGTERM may reach the processes at different steps, or only
            # some, and _save_all is collective: the flags are agreed on
            # every preempt_sync_freq steps, so all take the
            # checkpoint-and-exit branch at the same step
            preempt_now = preempted["flag"] if nproc == 1 else False
            if nproc > 1 and step % max(
                    int(getattr(params, "preempt_sync_freq", 10)), 1) == 0:
                preempt_now = dist.any_flag(preempted["flag"])
            if preempt_now:
                preempted["flag"] = True
                log.warning("SIGTERM received: checkpointing at step %d "
                            "and exiting for preemption", step)
                _save_all(step)
                should_stop = True
                break

            if params.save_freq > 0 and step % params.save_freq == 0:
                _save_all(step)

            if params.sample_freq > 0 and step % params.sample_freq == 0:
                # under ZeRO every process gathers the weights (collective),
                # the primary decodes its own batch
                weights = (_eval_weights(params, model, state)
                           if dist.is_primary() or state.layout else None)
                if dist.is_primary():
                    _sample_decode(params, decode_local, weights, batch)
                del weights
                window_start = time.time()
                window_tokens = 0

            if params.eval_freq > 0 and step % params.eval_freq == 0:
                # every process decodes its rows and gathers the rest, so
                # all compute one BLEU: the lr schedule and early stop
                # agree with no broadcast
                bleu = _dev_eval(params, decode,
                                 _eval_weights(params, model, state),
                                 dev_dataset,
                                 os.path.join(params.output_dir, "trans.txt")
                                 if dist.is_primary() else "")
                log.info("Step %d, BLEU %.4f, Best BLEU %.4f", step, bleu,
                         max(saver.best_score, bleu))
                stop_now = record_eval_score(recorder, step, float(bleu),
                                             params.estop_patience)
                _save_all(step, bleu)
                adapt_lr.after_eval(float(bleu))
                if stop_now:
                    log.info("Early stopped at step %d", step)
                    break
                window_start = time.time()
                window_tokens = 0

            if step >= params.max_training_steps:
                should_stop = True
                break

        feed.close()
        host_queue.close()
        if recorder.estop or should_stop:
            break
        recorder.lidx = -1
        adapt_lr.after_epoch(eidx=epoch)
        recorder.epoch = epoch + 1

    profile.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary["seconds"] = time.time() - begin
    summary["steps"] = len(summary["losses"])
    summary["losses"] = [float(x) for x in summary["losses"]]
    summary["gnorms"] = [float(x) for x in summary["gnorms"]]
    summary["allreduce"] = dist.take_stats()
    # a SIGTERM after the last agreement must not let one process skip
    # the collective final eval that the others enter
    if nproc > 1:
        preempted["flag"] = dist.any_flag(preempted["flag"])
    _save_all(step)
    if not preempted["flag"] and params.src_dev_file:
        bleu = _dev_eval(params, decode,
                         _eval_weights(params, model, state), dev_dataset,
                         os.path.join(params.output_dir, "trans.txt")
                         if dist.is_primary() else "")
        log.info("Final BLEU %.4f at step %d", bleu, step)
        _save_all(step, bleu)
        summary["bleu"] = bleu
    saver.wait()
    log.info("Training finished at step %d", step)
    return summary


def record_eval_score(recorder, step, bleu, estop_patience):
    """Append an eval score and update the early-stop patience counter:
    every eval that does not STRICTLY improve on the best so far counts.
    Returns True when patience is exhausted and training should stop."""
    prior_scores = [v[1] for v in recorder.valid_script_scores]
    recorder.history_scores.append([step, bleu])
    recorder.valid_script_scores.append([step, bleu])
    if not prior_scores or bleu > max(prior_scores):
        recorder.bad_counter = 0
        return False
    recorder.bad_counter += 1
    if recorder.bad_counter > estop_patience:
        recorder.estop = True
        return True
    return False


def _eval_weights(params, model, state):
    """A copy of the weights to decode with, in the compute dtype where the
    model casts them (ModelSpec.eval_cast): the EMA weights when
    ema_decay > 0, else the parameters; under ZeRO or tensor and expert
    parallelism gathered whole on every process (COLLECTIVE:
    host_fetchable), so the decode runs as on one device."""
    if params.ema_decay > 0 and state.ema is not None:
        # only the EMA is gathered; the module is a skeleton for it
        ema = dist.host_fetchable({"ema": state.ema}, state.layout)["ema"]
        weights = copy.deepcopy(state.params)
        tp.clear_tags(weights)
        for name, p in weights.named_parameters():
            p.data = ema[name].detach().to(p.dtype, copy=True)
    else:
        weights = dist.host_fetchable({"params": state.params},
                                      state.layout)["params"]
        if weights is state.params:
            weights = copy.deepcopy(weights)
    if model.eval_cast:
        weights = dtypes.cast_to_compute(weights, params)
    return weights.eval()


def _sample_decode(params, decode, weights, batch) -> None:
    """Decode a handful of training sentences for human inspection. The
    source rows go through decode_target_token as in the JAX package,
    which a speech batch's frames do not pass (a ValueError there too)."""
    n = min(5, len(batch["raw"]))
    small = {k: (v[:n] if hasattr(v, "__getitem__")
                 and not isinstance(v, dict) else v)
             for k, v in batch.items()}
    out = decode(weights, small)
    seqs = np.asarray(out["seq"])
    for i in range(n):
        src_toks = evalu.decode_target_token(batch["src"][i],
                                             params.src_vocab)
        ref_toks = evalu.decode_target_token(batch["tgt"][i],
                                             params.tgt_vocab)
        hyp_toks = evalu.decode_target_token(seqs[i][0], params.tgt_vocab)
        log.info("sample %d", i)
        log.info("source:      %s", " ".join(src_toks))
        log.info("reference:   %s", " ".join(ref_toks))
        log.info("translation: %s", " ".join(hyp_toks))


def _restore_eval_params(params, model, device):
    """Random init from ``random_seed``, then the latest checkpoint (EMA
    weights when ema_decay > 0), cast once to the compute dtype where the
    model casts (ModelSpec.eval_cast) and moved to ``device``."""
    weights = model.init_fn(torch.Generator().manual_seed(params.random_seed),
                            params)
    saver = Saver(checkpoints=params.checkpoints,
                  output_dir=params.output_dir)
    saver.restore({"ema" if params.ema_decay > 0 else "params": weights})
    if model.eval_cast:
        weights = dtypes.cast_to_compute(weights, params)
    return weights.to(device).eval()


def _eval_on_one_device(params) -> None:
    """The eval modes run on the one device. A config that asks for more
    (a mesh, several processes) gets the JAX package's warning from
    _eval_mesh, as there when the devices are too few, and decodes here."""
    asked = parallel_options(params)
    if asked:
        log.warning("eval mesh unavailable (%s asks for more devices than "
                    "the 1 zero_tpu_torch uses); decoding on one device",
                    ", ".join(asked))


def _decode_test_set(params, weights, decode, label) -> dict:
    """Decode the test set, log BLEU, write the translations. Returns
    {'bleu', 'sentences', 'target_tokens', 'steps', 'seconds'}: the
    decode loop's sentence and top-beam token counts (EOS excluded), the
    summed beam-search steps and its wall time (host clock; every batch
    ends in a device-to-host copy of its results)."""
    test_dataset = _make_dataset(params, params.src_test_file,
                                 params.tgt_test_file)
    steps = []

    def decode_batch(batch):
        out = decode(weights, batch)
        steps.append(out["steps"])
        return out

    begin = time.time()
    translations, scores, indices = evalu.decoding(decode_batch,
                                                   test_dataset, params)
    seconds = time.time() - begin
    bleu = evalu.eval_metric(translations, params.tgt_test_file, indices)
    log.info("%s Performance, BLEU Score: %.4f, using %.3f s", label, bleu,
             seconds)
    out = params.test_output or os.path.join(params.output_dir, "trans.txt")
    evalu.dump_translation(translations, out, indices)
    return {"bleu": bleu, "sentences": len(translations),
            "target_tokens": sum(len(t) for t in translations),
            "steps": sum(steps), "seconds": seconds}


def evaluate(params) -> dict:
    """Decode the test set with the latest checkpoint; returns
    _decode_test_set's summary."""
    device = device_of(params)
    _eval_on_one_device(params)
    model = get_model(params.model_name)
    weights = _restore_eval_params(params, model, device)
    decode = make_decode_fn(params, model)
    return _decode_test_set(params, weights, decode, "Translation")


def scorer(params):
    """Teacher-forced scores of the test set (dropout and label smoothing
    off); writes one per-sentence score per line. Returns (scores, ppl)."""
    device = device_of(params)
    _eval_on_one_device(params)
    model = get_model(params.model_name)
    weights = _restore_eval_params(params, model, device)
    score_step = make_score_step(model, params)

    def score_fn(batch):
        feats = {k: torch.as_tensor(v, device=device)
                 for k, v in _batch_features(params, batch).items()}
        return score_step(weights, feats).cpu().numpy()

    test_dataset = _make_dataset(params, params.src_test_file,
                                 params.tgt_test_file)
    scores, ppl = evalu.scoring(score_fn, test_dataset, params)
    log.info("Average per-sentence score: %.4f, corpus ppl: %.4f",
             float(np.mean(scores)), ppl)
    out = params.test_output or os.path.join(params.output_dir, "scores.txt")
    evalu.dump_translation(scores, out)
    return scores, ppl


def make_ensemble_inference(inferences) -> Inference:
    """Compose N models' inferences into one: at each step the fp32 mean
    of the models' softmaxes, then log(p + 1e-20). Parameters, states and
    caches are per-model lists; each model reorders its own cache (its own
    cache mode: ancestry pools or the permuted cache), or, for a model
    without a reorder_cache, the beam gather permutes every cache tensor
    (the language ids of the multilingual models included)."""

    def _log_mean_prob(logits):
        probs = sum(torch.softmax(x.float(), dim=-1) for x in logits)
        return torch.log(probs / len(logits) + 1e-20)

    def encode(all_params, source):
        return [inf.encode(p, source)
                for inf, p in zip(inferences, all_params)]

    def init_cache(all_params, states, batch, max_len):
        return [inf.init_cache(p, s, batch, max_len)
                for inf, p, s in zip(inferences, all_params, states)]

    def decode_step(all_params, prev_tok, states, caches, time):
        steps = [inf.decode_step(p, prev_tok, s, c, time)
                 for inf, p, s, c in zip(inferences, all_params, states,
                                         caches)]
        return (_log_mean_prob([logits for logits, _ in steps]),
                [c for _, c in steps])

    def decode_prefix(all_params, buffer, states, time):
        return _log_mean_prob([
            inf.decode_prefix(p, buffer, s, time)
            for inf, p, s in zip(inferences, all_params, states)])

    def reorder_cache(caches, beam_indices, batch, beam_size, time, span=1):
        return [inf.reorder_cache(c, beam_indices, batch, beam_size, time,
                                  span=span)
                if inf.reorder_cache is not None
                else gather_cache(c, beam_indices, batch, beam_size)
                for inf, c in zip(inferences, caches)]

    return Inference(encode=encode, init_cache=init_cache,
                     decode_step=decode_step, decode_prefix=decode_prefix,
                     reorder_cache=reorder_cache)


def ensemble(all_params) -> dict:
    """Decode the test set with an ensemble of separately trained models,
    one config each (their names may differ); the first config's files,
    beam and decode settings drive the search. Returns _decode_test_set's
    summary."""
    default = all_params[0]
    for p in all_params:
        if p.model_name == "transformer_ibdecoder":
            # the pair search has no ensemble form (the JAX package fails
            # there too: its ensemble inference has no decode_pair)
            raise ValueError("--mode ensemble cannot decode %s (%s): its "
                             "pair search has no ensemble form"
                             % (p.model_name, p.output_dir))
    device = device_of(default)
    _eval_on_one_device(default)
    models = [get_model(p.model_name) for p in all_params]
    weights = [_restore_eval_params(p, m, device)
               for p, m in zip(all_params, models)]
    inference = make_ensemble_inference(
        [m.infer_fn(p) for m, p in zip(models, all_params)])
    decode = make_decode_fn(default, models[0], inference=inference)
    return _decode_test_set(default, weights, decode, "Ensemble Translation")
