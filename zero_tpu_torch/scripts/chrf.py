"""chrF scorer CLI: character n-grams up to 6, beta 3 (chrF3), as
``zero_tpu/scripts/chrf.py``.

  python -m zero_tpu_torch.scripts.chrf -H hypotheses -R references
"""

from __future__ import annotations

import argparse

from zero_tpu_torch.metric import chrf


def main():
    parser = argparse.ArgumentParser(description="chrF scorer")
    parser.add_argument("--hypothesis", "-H", required=True)
    parser.add_argument("--reference", "-R", required=True)
    parser.add_argument("--beta", "-b", type=float, default=3.0)
    parser.add_argument("--ngram", "-n", type=int, default=6)
    args = parser.parse_args()

    with open(args.hypothesis) as r:
        hyps = [line.strip() for line in r]
    with open(args.reference) as r:
        refs = [line.strip() for line in r]
    print("chrF%g: %.6f" % (args.beta, chrf(hyps, refs, beta=args.beta,
                                            max_n=args.ngram)))


if __name__ == "__main__":
    main()
