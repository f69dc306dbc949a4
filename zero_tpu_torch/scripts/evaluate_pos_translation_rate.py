"""Precision/recall/F1 of the translation of POS-tagged tokens, as
``zero_tpu/scripts/evaluate_pos_translation_rate.py``: corpora are
word_POS tokenised; for each POS set and n-gram order, words carrying the
POS are kept (others become <NaN> holes), n-grams with holes are dropped,
and the clipped-match P/R/F1 is averaged over the references.

  python -m zero_tpu_torch.scripts.evaluate_pos_translation_rate \
      --trans hyp --refs ref0 [ref1 ...]
"""

from __future__ import annotations

import argparse
from collections import Counter


def prepare_ngram(text: str, pos, ngram: int, splitter: str = "_") -> Counter:
    tokens = text.strip().split()
    pos_list = pos if isinstance(pos, list) else [pos]
    words = []
    for token in tokens:
        if any(p in token for p in pos_list):
            segs = token.strip().split(splitter)
            words.append(splitter.join(segs[:-1]))
        else:
            words.append("<NaN>")
    grams = [" ".join(words[i - ngram:i]) for i in range(ngram, len(words))]
    return Counter(g for g in grams if "<NaN>" not in g)


def score(trans_counters, refs_counters):
    def prf(_trans, _ref):
        t_c = t_r = matched = 0.0
        for cn, rn in zip(_trans, _ref):
            t_c += sum(cn.values())
            t_r += sum(rn.values())
            for g in cn:
                if g in rn:
                    matched += min(cn[g], rn[g])
        p = matched / t_c if t_c > 0 else 0.0
        r = matched / t_r if t_r > 0 else 0.0
        f = 2 * p * r / (p + r + 1e-8)
        return p, r, f

    evals = [prf(trans_counters, ref) for ref in refs_counters]
    evals = list(zip(*evals))
    return [sum(v) / len(v) for v in evals]


def evaluate(refs, trans, pos, ngram, splitter="_"):
    ref_counters = [[prepare_ngram(line, pos, ngram, splitter) for line in r]
                    for r in refs]
    trans_counters = [prepare_ngram(line, pos, ngram, splitter)
                      for line in trans]
    return score(trans_counters, ref_counters)


def main():
    parser = argparse.ArgumentParser(
        description="Evaluate P/R/F score for POS-tagged tokens")
    parser.add_argument("--trans", type=str, required=True)
    parser.add_argument("--refs", type=str, required=True, nargs="+")
    parser.add_argument("--ngram", type=int, default=4)
    parser.add_argument("--noun", type=str, default="NN")
    parser.add_argument("--verb", type=str, default="VB")
    parser.add_argument("--adj", type=str, default="JJ")
    parser.add_argument("--adv", type=str, default="RB")
    parser.add_argument("--spliter", type=str, default="_")
    args = parser.parse_args()

    refs = []
    for path in args.refs:
        with open(path) as r:
            refs.append(r.readlines())
    with open(args.trans) as r:
        trans = r.readlines()

    poses = [args.noun, args.verb, args.adj, args.adv,
             [args.noun, args.verb], [args.noun, args.verb, args.adj]]
    for pos in poses:
        for ngram in range(args.ngram):
            evals = evaluate(refs, trans, pos, ngram + 1, args.spliter)
            print("Pos: %s, Ngram: %s, Score %s" % (pos, ngram + 1,
                                                    str(evals)))


if __name__ == "__main__":
    main()
