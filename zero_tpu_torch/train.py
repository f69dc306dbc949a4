"""Training, evaluation and scoring loops on one device.

Counterpart of ``zero_tpu/train.py`` without meshes, multiple hosts, ZeRO,
pipelines or rings: the epoch/step loop with update_cycle grouping, NaN
abort (or the safe_nan skip), periodic display/save/sample/eval, mid-epoch
resume from ``record.json`` by skipping consumed batches, dev-BLEU-driven
best checkpointing and early stop, the EMA weight swap for eval, a SIGTERM
checkpoint-and-exit, and the final save and dev eval; plus the ``--mode
test`` (``evaluate``) and ``--mode score`` (``scorer``) entry points.
"""

from __future__ import annotations

import copy
import logging
import os
import signal
import time

import numpy as np
import torch

from zero_tpu_torch import dtypes, evalu, lrs
from zero_tpu_torch.data import Dataset
from zero_tpu_torch.models.base import get_model
from zero_tpu_torch.pipeline import Prefetcher
from zero_tpu_torch.saver import Saver
from zero_tpu_torch.search import beam_search
from zero_tpu_torch.train_step import (init_train_state, make_score_step,
                                       make_train_step, stack_microbatches)

log = logging.getLogger("zero_tpu_torch.train")


def device_of(params) -> torch.device:
    """The configured torch device; "cuda" without a GPU raises (no silent
    move to the CPU)."""
    device = torch.device(params.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=%s but torch sees no CUDA device; pass "
            "--parameters device=cpu to run on the CPU" % params.device)
    return device


def _make_dataset(params, src, tgt, train=False):
    """Training batches by the configured batch or token budget; eval
    batches padded to eval_batch_size rows. Lengths snap to
    pad_seq_multiple, as the JAX package pads them."""
    return Dataset(src, tgt, params.src_vocab, params.tgt_vocab,
                   max_len=params.max_len if train else params.eval_max_len,
                   batch_or_token=params.batch_or_token if train else "batch",
                   data_leak_ratio=params.data_leak_ratio,
                   pad_seq_multiple=params.pad_seq_multiple,
                   pad_batch_multiple=params.pad_batch_multiple if train
                   else 1,
                   pad_batch_to=0 if train else params.eval_batch_size)


def _batch_features(params, batch):
    """Dataset batch dict -> training/scoring feature dict."""
    return {"source": batch["src"], "target": batch["tgt"]}


def make_decode_fn(params, model=None, inference=None):
    """Beam-search callable over dataset batch dicts; returns numpy
    'seq' [B, K, T] and 'score' [B, K], and the int 'steps'."""
    model = model or get_model(params.model_name)
    inference = inference or model.infer_fn(params)
    device = device_of(params)

    @torch.inference_mode()
    def decode(weights, batch):
        source = torch.as_tensor(batch["src"], device=device).long()
        out = beam_search(weights, source, inference, params)
        return {"seq": out["seq"].cpu().numpy(),
                "score": out["score"].cpu().numpy(),
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


def _train(params, preempted) -> dict:
    """Returns {'steps', 'seconds', 'step_end_times', 'losses', 'gnorms',
    'target_tokens', 'shapes', 'bleu'}: per-step host-clock end times
    (device-synchronised when the step displays), losses, gnorms, target
    tokens and the [C] (src, tgt) batch shapes of every step, and the final
    dev BLEU (None without a dev set or after a preemption)."""
    model = get_model(params.model_name)
    device = device_of(params)
    train_dataset = _make_dataset(params, params.src_train_file,
                                  params.tgt_train_file, train=True)
    dev_dataset = _make_dataset(params, params.src_dev_file,
                                params.tgt_dev_file)

    gen = torch.Generator().manual_seed(int(params.random_seed))
    state = init_train_state(model, params, gen, device)
    num_params = sum(p.numel() for p in state.params.parameters())
    log.info("Total trainable variables size: %d", num_params)

    step_fn = make_train_step(model, params)
    decode = make_decode_fn(params, model)
    saver = Saver(checkpoints=params.checkpoints,
                  output_dir=params.output_dir,
                  best_checkpoints=params.best_checkpoints)
    recorder = params.recorder

    def _save_all(step, bleu=None):
        saver.save({"params": state.params, "opt": state.opt,
                    "ema": state.ema}, step, bleu)
        recorder.save_to_json(os.path.join(params.output_dir, "record.json"))

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
            """update_cycle grouping and stacking, on the feed thread;
            skips the batches a resumed run has consumed."""
            group = []
            for lidx, batch in enumerate(host_queue):
                if epoch == resume_epoch and lidx <= resume_lidx:
                    continue
                group.append(batch)
                if len(group) < cycle:
                    continue
                stacked = stack_microbatches(
                    [_batch_features(params, b) for b in group])
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
            _, metrics = step_fn(state, stacked, lr,
                                 _step_generator(params, step))
            step += 1
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

            if preempted["flag"]:
                log.warning("SIGTERM received: checkpointing at step %d "
                            "and exiting for preemption", step)
                _save_all(step)
                should_stop = True
                break

            if params.save_freq > 0 and step % params.save_freq == 0:
                _save_all(step)

            if params.sample_freq > 0 and step % params.sample_freq == 0:
                _sample_decode(params, decode, _eval_weights(params, state),
                               batch)
                window_start = time.time()
                window_tokens = 0

            if params.eval_freq > 0 and step % params.eval_freq == 0:
                bleu = _dev_eval(params, decode, _eval_weights(params, state),
                                 dev_dataset,
                                 os.path.join(params.output_dir, "trans.txt"))
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

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary["seconds"] = time.time() - begin
    summary["steps"] = len(summary["losses"])
    summary["losses"] = [float(x) for x in summary["losses"]]
    summary["gnorms"] = [float(x) for x in summary["gnorms"]]
    _save_all(step)
    if not preempted["flag"] and params.src_dev_file:
        bleu = _dev_eval(params, decode, _eval_weights(params, state),
                         dev_dataset,
                         os.path.join(params.output_dir, "trans.txt"))
        log.info("Final BLEU %.4f at step %d", bleu, step)
        _save_all(step, bleu)
        summary["bleu"] = bleu
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


def _eval_weights(params, state):
    """A compute-dtype copy of the weights to decode with: the EMA weights
    when ema_decay > 0, else the parameters."""
    weights = copy.deepcopy(state.params)
    if params.ema_decay > 0 and state.ema is not None:
        with torch.no_grad():
            for name, p in weights.named_parameters():
                p.copy_(state.ema[name])
    return dtypes.cast_to_compute(weights, params).eval()


def _sample_decode(params, decode, weights, batch) -> None:
    """Decode a handful of training sentences for human inspection."""
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
    weights when ema_decay > 0), cast once to the compute dtype and moved
    to ``device``."""
    weights = model.init_fn(torch.Generator().manual_seed(params.random_seed),
                            params)
    saver = Saver(checkpoints=params.checkpoints,
                  output_dir=params.output_dir)
    saver.restore({"ema" if params.ema_decay > 0 else "params": weights})
    return dtypes.cast_to_compute(weights, params).to(device).eval()


def evaluate(params) -> dict:
    """Decode the test set, log BLEU, write the translations. Returns
    {'bleu', 'sentences', 'target_tokens', 'steps', 'seconds'}: the
    decode loop's sentence and top-beam token counts (EOS excluded), the
    summed beam-search steps and its wall time (host clock; every batch
    ends in a device-to-host copy of its results)."""
    device = device_of(params)
    model = get_model(params.model_name)
    weights = _restore_eval_params(params, model, device)
    decode = make_decode_fn(params, model)
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
    log.info("Translation Performance, BLEU Score: %.4f, using %.3f s",
             bleu, seconds)
    out = params.test_output or os.path.join(params.output_dir, "trans.txt")
    evalu.dump_translation(translations, out, indices)
    return {"bleu": bleu, "sentences": len(translations),
            "target_tokens": sum(len(t) for t in translations),
            "steps": sum(steps), "seconds": seconds}


def scorer(params):
    """Teacher-forced scores of the test set (dropout and label smoothing
    off); writes one per-sentence score per line. Returns (scores, ppl)."""
    device = device_of(params)
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
