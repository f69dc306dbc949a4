"""Jointly shuffle parallel corpora, as
``zero_tpu/scripts/shuffle_corpus.py``: one permutation (numpy's, from
--seed) applied to every file, truncated to the shortest; writes
``<file>.<suffix>``.

  python -m zero_tpu_torch.scripts.shuffle_corpus --corpus a.src a.tgt \
      --seed 1
"""

from __future__ import annotations

import argparse

import numpy as np


def shuffle_corpus(files, suffix: str = "shuf", seed=None):
    data = []
    for path in files:
        with open(path) as r:
            data.append(r.readlines())
    minlen = min(len(lines) for lines in data)

    if seed is not None:
        np.random.seed(seed)
    indices = np.arange(minlen)
    np.random.shuffle(indices)

    outputs = []
    for path, lines in zip(files, data):
        out = path + "." + suffix
        with open(out, "w") as w:
            for idx in indices.tolist():
                w.write(lines[idx])
        outputs.append(out)
    return outputs


def main():
    parser = argparse.ArgumentParser(description="Shuffle corpus")
    parser.add_argument("--corpus", nargs="+", required=True)
    parser.add_argument("--suffix", type=str, default="shuf")
    parser.add_argument("--seed", type=int)
    args = parser.parse_args()
    shuffle_corpus(args.corpus, args.suffix, args.seed)


if __name__ == "__main__":
    main()
