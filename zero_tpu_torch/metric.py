"""Corpus BLEU-4, the metric of ``--mode test``.

A copy of the BLEU part of ``zero_tpu/metric.py`` (the port imports nothing
of the JAX package): multi-reference aware, closest-reference brevity
penalty, optional +1 smoothing. OTEM/UTEM/chrF and detokenized BLEU come
with the scripts of a later slice.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], max_n: int = 4) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[" ".join(tokens[i:i + n])] += 1
    return counts


def _closest_ref_length(ref_lens: Sequence[int], cand_len: int,
                        strategy: str = "best_match") -> int:
    """Closest reference length; ties go to the shorter reference."""
    if strategy == "min":
        return min(ref_lens)
    best, best_diff = None, None
    for r in ref_lens:
        d = abs(r - cand_len)
        if best is None or d < best_diff or (d == best_diff and r < best):
            best, best_diff = r, d
    return best


def _safe_log(x: float) -> float:
    if x <= 0:
        return -9999999999.0
    return math.log(x)


def bleu(cand: List[List[str]], refs: List[Sequence[List[str]]],
         bp: str = "closest", smooth: bool = False, n: int = 4,
         weights=None) -> float:
    """Corpus BLEU-n with closest-ref brevity penalty; larger is better."""
    len_c = 0
    len_r = 0
    total = defaultdict(int)    # candidate ngram totals by order
    matched = defaultdict(int)  # clipped matches by order

    for candidate, references in zip(cand, refs):
        len_c += len(candidate)
        len_r += _closest_ref_length(
            [len(r) for r in references], len(candidate),
            "best_match" if bp == "closest" else "min")

        cn = _ngrams(candidate, n)
        clipped: Dict[str, int] = defaultdict(int)
        for reference in references:
            rn = _ngrams(reference, n)
            for g, c in cn.items():
                if g in rn:
                    clipped[g] = max(clipped[g], min(rn[g], c))
        for g, c in cn.items():
            order = g.count(" ") + 1
            total[order] += c
            matched[order] += clipped[g]

    if len_r == 0:
        return 0.0

    precisions = defaultdict(float)
    for i in range(1, n + 1):
        if i in total:
            m, t = matched[i], total[i]
            if smooth and i > 1:
                m += 1
                t += 1
            precisions[i] = m * 1.0 / t if t > 0 else 0.0

    lp = 1.0
    if len_c <= len_r:
        lp = math.exp(1.0 - len_r * 1.0 / len_c) if len_c > 0 else 0.0

    weights = weights or [1.0 / n] * n
    score = lp * math.exp(
        sum(_safe_log(precisions[i + 1]) * weights[i] for i in range(n)))
    return score
