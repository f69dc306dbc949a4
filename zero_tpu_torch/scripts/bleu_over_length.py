"""BLEU bucketed by source sentence length, as
``zero_tpu/scripts/bleu_over_length.py``: sort by source length, split
into -g groups, report each group's mean source length and corpus BLEU
(metric.py).

  python -m zero_tpu_torch.scripts.bleu_over_length -source src \
      -candidate hyp -reference ref [ref ...] -g 4
"""

from __future__ import annotations

import argparse

from zero_tpu_torch.metric import bleu


def read(path, lc=False):
    with open(path) as r:
        return [(line.strip().lower() if lc else line.strip()).split()
                for line in r]


def bleu_over_length(src, cand, refs, groups=1, bp="closest", n=4):
    order = sorted(range(len(src)), key=lambda i: len(src[i]))
    per_group = len(order) // groups
    results = []
    for gidx in range(groups):
        idx = order[gidx * per_group:(gidx + 1) * per_group]
        g_src = [src[i] for i in idx]
        g_cand = [cand[i] for i in idx]
        g_refs = [refs[i] for i in idx]
        avg_len = sum(len(s) for s in g_src) / float(len(g_src))
        score = bleu(g_cand, g_refs, bp=bp, n=n)
        results.append((avg_len, score))
    return results


def main():
    parser = argparse.ArgumentParser(
        description="BLEU score over source sentence length")
    parser.add_argument("-lc", action="store_true")
    parser.add_argument("-bp", default="closest",
                        choices=["shortest", "closest"])
    parser.add_argument("-n", type=int, default=4)
    parser.add_argument("-g", type=int, default=1)
    parser.add_argument("-source", type=str, required=True)
    parser.add_argument("-candidate", type=str, required=True)
    parser.add_argument("-reference", type=str, nargs="+", required=True)
    args = parser.parse_args()

    src = read(args.source, args.lc)
    cand = read(args.candidate, args.lc)
    refs = list(zip(*[read(r, args.lc) for r in args.reference]))
    assert len(cand) == len(refs), \
        "candidate and reference must be the same length"

    results = bleu_over_length(src, cand, refs, args.g, args.bp, args.n)
    for gidx, (avg_len, score) in enumerate(results):
        print("Group Idx {} Avg Source Length {} BLEU Score {}".format(
            gidx, avg_len, score))
    print("AvgLength: [{}]".format(",".join(str(r[0]) for r in results)))
    print("BLEU Score: [{}]".format(",".join(str(r[1]) for r in results)))


if __name__ == "__main__":
    main()
