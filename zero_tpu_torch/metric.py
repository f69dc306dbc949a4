"""Corpus evaluation metrics: BLEU-4 (tokenized, and detokenized with
the mteval-v13a tokenization), OTEM, UTEM and chrF, and their CLI.

A copy of ``zero_tpu/metric.py`` (the port imports nothing of the JAX
package): multi-reference aware, the closest-reference brevity penalty and
optional +1 smoothing; OTEM/UTEM as in the Otem-Utem formulation; chrF3
(character n-grams up to 6); detokenized BLEU as multi-bleu-detok.perl.

  python -m zero_tpu_torch.metric [-lc] [-bp closest|shortest] [--detok] \
      candidate reference
"""

from __future__ import annotations

import math
import re
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
    """Closest reference length; ties go to the shorter reference
    (reference metric._get_length_reference)."""
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


def otem(cand: List[List[str]], refs: List[Sequence[List[str]]],
         bp: str = "closest", smooth: bool = False, n: int = 2,
         weights=None) -> float:
    """Over-translation metric; lower is better."""
    len_c = 0
    len_r = 0
    total = defaultdict(int)
    over = defaultdict(int)

    for candidate, references in zip(cand, refs):
        len_c += len(candidate)
        len_r += _closest_ref_length(
            [len(r) for r in references], len(candidate),
            "best_match" if bp == "closest" else "min")

        cn = _ngrams(candidate, n)
        over_sample: Dict[str, int] = defaultdict(int)
        for reference in references:
            rn = _ngrams(reference, n)
            for g, c in cn.items():
                # over-count: occurrences beyond the reference's (or beyond
                # one, if absent from the reference entirely)
                if g not in rn:
                    o = c - 1 if c > 1 else 0
                else:
                    o = max(c - rn[g], 0)
                if o > 0:
                    if over_sample[g] == 0:
                        over_sample[g] = o
                    else:
                        over_sample[g] = min(over_sample[g], o)
        for g, c in cn.items():
            order = g.count(" ") + 1
            total[order] += c
            over[order] += over_sample[g]

    if len_r == 0:
        return 0.0

    ratios = defaultdict(float)
    for i in range(1, n + 1):
        if i in total:
            o, t = over[i], total[i]
            if smooth and i > 1:
                o += 1
                t += 1
            ratios[i] = o * 1.0 / t if t else 0.0

    lp = 1.0
    if len_c >= len_r:  # over-translation penalises long candidates
        lp = math.exp(1.0 - len_r * 1.0 / len_c)

    weights = weights or [1.0 / n] * n
    return lp * math.exp(
        sum(_safe_log(ratios[i + 1]) * weights[i] for i in range(n)))


def utem(cand: List[List[str]], refs: List[Sequence[List[str]]],
         bp: str = "closest", smooth: bool = False, n: int = 4,
         weights=None) -> float:
    """Under-translation metric; lower is better."""
    len_c = 0
    len_r = 0
    total = defaultdict(int)
    missed = defaultdict(int)

    for candidate, references in zip(cand, refs):
        len_c += len(candidate)
        len_r += _closest_ref_length(
            [len(r) for r in references], len(candidate),
            "best_match" if bp == "closest" else "min")

        cn = _ngrams(candidate, n)
        per_ref_total = defaultdict(list)
        per_ref_missed = defaultdict(list)
        for reference in references:
            rn = _ngrams(reference, n)
            t_ref = defaultdict(int)
            m_ref = defaultdict(int)
            for g, rc in rn.items():
                order = g.count(" ") + 1
                t_ref[order] += rc
                if g not in cn:
                    m_ref[order] += rc
                elif rc > cn[g]:
                    m_ref[order] += rc - cn[g]
            for order in t_ref:
                per_ref_total[order].append(t_ref[order])
                per_ref_missed[order].append(m_ref[order])
        for order in per_ref_total:
            missed[order] += min(per_ref_missed[order])
            total[order] += max(per_ref_total[order])

    if len_r == 0:
        return 0.0

    ratios = defaultdict(float)
    for i in range(1, n + 1):
        if i in total:
            m, t = missed[i], total[i]
            if smooth and i > 1:
                m += 1
                t += 1
            ratios[i] = m * 1.0 / t if t else 0.0

    lp = 1.0
    if len_c <= len_r:  # under-translation penalises short candidates
        lp = math.exp(1.0 - len_c * 1.0 / len_r)

    weights = weights or [1.0 / n] * n
    return lp * math.exp(
        sum(_safe_log(ratios[i + 1]) * weights[i] for i in range(n)))


# ---------------------------------------------------------------------------
# Detokenized BLEU: mteval-v13a internal tokenization
# (multi-bleu-detok.perl:192-214; identical to sacrebleu's "13a" tokenizer)
# ---------------------------------------------------------------------------

# the perl char class ([\{-\~\[-\` -\&\(-\+\:-\@\/]): ASCII punctuation
# ranges {-~, [-`, space-&, (-+, :-@, and / -- periods/commas/digit-dashes
# are handled by the context-sensitive rules below
_V13A_SUBS = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def v13a_tokenize(line: str) -> List[str]:
    """International (mteval-v13a) tokenization of a detokenized line.

    Same normalization order as multi-bleu-detok.perl:192-214: strip
    <skipped> tags, join hyphenated line breaks, unescape the four SGML
    entities, then split punctuation with the v13a context rules.
    """
    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "")
    line = line.replace("\n", " ")
    line = line.replace("&quot;", '"')
    line = line.replace("&amp;", "&")
    line = line.replace("&lt;", "<")
    line = line.replace("&gt;", ">")
    line = " " + line + " "
    for pat, rep in _V13A_SUBS:
        line = pat.sub(rep, line)
    return line.split()


def detok_bleu(cand_lines: List[str], ref_lines: List[Sequence[str]],
               lowercase: bool = False, n: int = 4) -> float:
    """Corpus BLEU over detokenized text, v13a-tokenized internally.

    Equivalent to multi-bleu-detok.perl (and to sacrebleu's BLEU with the
    13a tokenizer, modulo its effective-order smoothing of empty orders):
    scores are unaffected by how the system output was tokenized.
    """
    if lowercase:
        cand_lines = [c.lower() for c in cand_lines]
        ref_lines = [[r.lower() for r in rs] for rs in ref_lines]
    cand = [v13a_tokenize(c) for c in cand_lines]
    refs = [[v13a_tokenize(r) for r in rs] for rs in ref_lines]
    return bleu(cand, refs, bp="closest", n=n)


# ---------------------------------------------------------------------------
# chrF (Popovic 2015, chrF3 like reference scripts/chrF.py)
# ---------------------------------------------------------------------------

def _char_ngrams(text: str, max_n: int = 6) -> Dict[str, int]:
    s = "".join(text.split())
    counts: Dict[str, int] = defaultdict(int)
    for n in range(1, max_n + 1):
        for i in range(len(s) - n + 1):
            counts[s[i:i + n]] += 1
    return counts


def chrf(cand_lines: List[str], ref_lines: List[str], beta: float = 3.0,
         max_n: int = 6) -> float:
    """Corpus chrF-beta over character n-grams up to max_n."""
    precisions = [0.0] * max_n
    recalls = [0.0] * max_n
    p_totals = [0] * max_n
    r_totals = [0] * max_n
    for c_line, r_line in zip(cand_lines, ref_lines):
        cn = _char_ngrams(c_line, max_n)
        rn = _char_ngrams(r_line, max_n)
        for g, cc in cn.items():
            order = len(g) - 1
            p_totals[order] += cc
            if g in rn:
                precisions[order] += min(cc, rn[g])
        for g, rc in rn.items():
            order = len(g) - 1
            r_totals[order] += rc
            if g in cn:
                recalls[order] += min(rc, cn[g])

    avg_p = sum((precisions[i] / p_totals[i]) if p_totals[i] else 0.0
                for i in range(max_n)) / max_n
    avg_r = sum((recalls[i] / r_totals[i]) if r_totals[i] else 0.0
                for i in range(max_n)) / max_n
    if avg_p + avg_r == 0:
        return 0.0
    b2 = beta * beta
    return (1 + b2) * avg_p * avg_r / (b2 * avg_p + avg_r)


def main():
    import argparse
    import os
    import sys

    parser = argparse.ArgumentParser(
        description="OTEM/UTEM/BLEU on multiple references")
    parser.add_argument("-lc", action="store_true", help="lowercase")
    parser.add_argument("-bp", default="closest",
                        choices=["shortest", "closest"])
    parser.add_argument("--detok", action="store_true",
                        help="detokenized BLEU: apply mteval-v13a "
                             "tokenization internally "
                             "(multi-bleu-detok.perl equivalent)")
    parser.add_argument("candidate")
    parser.add_argument("reference")
    args = parser.parse_args()

    def read_lines(f):
        with open(f) as r:
            return [line.strip().lower() if args.lc else line.strip()
                    for line in r]

    ref_files = []
    if os.path.exists(args.reference):
        ref_files = [args.reference]
    else:
        i = 0
        while os.path.exists(args.reference + str(i)):
            ref_files.append(args.reference + str(i))
            i += 1
        if not ref_files:
            print("no reference found:", args.reference, file=sys.stderr)
            sys.exit(1)

    cand_lines = read_lines(args.candidate)
    ref_lines = list(zip(*[read_lines(f) for f in ref_files]))
    if args.detok:
        print("detok BLEU-4 (v13a): {}".format(
            detok_bleu(cand_lines, ref_lines)))
        return
    cand = [c.split() for c in cand_lines]
    refs = [[r.split() for r in rs] for rs in ref_lines]
    print("OTEM-2/UTEM-4/BLEU-4: {}/{}/{}".format(
        otem(cand, refs, bp=args.bp, n=2),
        utem(cand, refs, bp=args.bp, n=4),
        bleu(cand, refs, bp=args.bp, n=4)))


if __name__ == "__main__":
    main()
