"""Host-side decode loop and metric glue.

A copy of the decoding and scoring parts of ``zero_tpu/evalu.py`` (the port imports
nothing of the JAX package): batch iteration with prefetching, top-1-of-beam
extraction, id->token detok stopping at eos/pad, multi-reference file
discovery ``path.ref0..N``, the index-ordered translation dump, and
teacher-forced scoring (per-sentence scores, corpus perplexity).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np

from zero_tpu_torch import metric
from zero_tpu_torch.pipeline import Prefetcher

log = logging.getLogger("zero_tpu_torch.evalu")


def decode_target_token(id_seq, vocab) -> List[str]:
    """ids -> tokens, stopping at the first eos/pad."""
    valid = []
    for tok_id in id_seq:
        if tok_id == vocab.eos() or tok_id == vocab.pad():
            break
        valid.append(int(tok_id))
    return vocab.to_tokens(valid)


def decode_hypothesis(seqs, scores, params):
    """Top-1-of-beam hypotheses for a [B, K, T] batch."""
    hypos, marks = [], []
    for seq, score in zip(seqs, scores):
        hypos.append(decode_target_token(seq[0], params.tgt_vocab))
        marks.append(float(score[0]))
    return hypos, marks


def decoding(decode_fn, dataset, params):
    """Decode a dataset; returns (translations, scores, indices).

    decode_fn(batch_dict) -> {'seq': [B, K, T], 'score': [B, K]} numpy
    arrays; padded batch rows beyond len(raw) are dropped.
    """
    translations, scores, indices = [], [], []
    queue = Prefetcher(
        lambda: dataset.batcher(params.eval_batch_size,
                                buffer_size=params.buffer_size,
                                shuffle=False, train=False),
        maxsize=params.output_queue_size)

    very_begin = time.time()
    for bidx, data in enumerate(queue):
        if bidx == 0:
            very_begin = time.time()
        start = time.time()
        out = decode_fn(data)
        n_valid = len(data["raw"])
        seqs = np.asarray(out["seq"])[:n_valid]
        marks = np.asarray(out["score"])[:n_valid]
        hypos, hscores = decode_hypothesis(seqs, marks, params)
        translations.extend(hypos)
        scores.extend(hscores)
        indices.extend(data["index"])
        log.info("Decoding Batch %d using %.3f s, translating %d "
                 "sentences using %.3f s in total", bidx,
                 time.time() - start, len(translations),
                 time.time() - very_begin)
    return translations, scores, indices


def scoring(score_fn, dataset, params):
    """Teacher-forced scoring; returns (index-ordered scores, corpus ppl).

    score_fn(batch_dict) -> [B] per-sentence mean losses."""
    scores, indices = [], []
    total_entropy = 0.0
    total_tokens = 0.0
    queue = Prefetcher(
        lambda: dataset.batcher(params.eval_batch_size,
                                buffer_size=params.buffer_size,
                                shuffle=False, train=False),
        maxsize=params.output_queue_size)

    for bidx, data in enumerate(queue):
        start = time.time()
        out = np.asarray(score_fn(data))
        n_valid = len(data["raw"])
        out = out[:n_valid]
        tgt = data["tgt"][:n_valid]
        total_entropy += sum(
            s * float((d > 0).sum()) for d, s in zip(tgt, out.tolist()))
        total_tokens += float((tgt > 0).sum())
        scores.extend(out.tolist())
        indices.extend(data["index"])
        log.info("Scoring Batch %d using %.3f s, %d sentences", bidx,
                 time.time() - start, len(scores))

    scores = [s for _, s in sorted(zip(indices, scores), key=lambda x: x[0])]
    ppl = float(np.exp(total_entropy / max(total_tokens, 1.0)))
    return scores, ppl


def fetch_valid_ref_files(path: str) -> Optional[List[str]]:
    """Reference files by MT convention: `path` or `path.ref0..N`."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        return [path]
    if not os.path.exists(path + ".ref0"):
        log.warning("Invalid reference format %s", path)
        return None
    files = []
    num = 0
    while os.path.exists(path + ".ref%d" % num):
        files.append(path + ".ref%d" % num)
        num += 1
    return files


def eval_metric(trans, target_file, indices=None) -> float:
    """Corpus BLEU of translations against (multi-)reference files."""
    ref_files = fetch_valid_ref_files(target_file)
    if ref_files is None:
        return 0.0
    if indices is not None:
        trans = [t for _, t in sorted(zip(indices, trans), key=lambda x: x[0])]
    references = []
    for ref_file in ref_files:
        with open(ref_file) as r:
            references.append([line.strip().split() for line in r])
    references = list(zip(*references))
    return metric.bleu(trans, references)


def dump_translation(trans, output: str, indices=None) -> None:
    if indices is not None:
        trans = [t for _, t in sorted(zip(indices, trans), key=lambda x: x[0])]
    with open(output, "w") as w:
        for hypo in trans:
            if isinstance(hypo, list):
                w.write(" ".join(hypo) + "\n")
            else:
                w.write(str(hypo) + "\n")
    log.info("Saving translations into %s", output)
