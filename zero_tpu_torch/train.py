"""Evaluation driver: restore weights, beam-decode a test set, BLEU.

Counterpart of the eval half of ``zero_tpu/train.py`` (``_make_dataset``,
``make_decode_fn``, ``_restore_eval_params``, ``evaluate``) on one device.
The training loop, scoring and ensembling come with later slices.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from zero_tpu_torch import dtypes, evalu
from zero_tpu_torch.data import Dataset
from zero_tpu_torch.models.base import get_model
from zero_tpu_torch.saver import Saver
from zero_tpu_torch.search import beam_search

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


def _make_dataset(params, src, tgt):
    """Eval dataset: every batch padded to eval_batch_size rows, lengths
    snapped to pad_seq_multiple, as the JAX package pads them."""
    return Dataset(src, tgt, params.src_vocab, params.tgt_vocab,
                   max_len=params.eval_max_len,
                   batch_or_token="batch",
                   data_leak_ratio=params.data_leak_ratio,
                   pad_seq_multiple=params.pad_seq_multiple,
                   pad_batch_multiple=1,
                   pad_batch_to=params.eval_batch_size)


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
