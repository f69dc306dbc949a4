"""Synthetic MT task generator ("synth-MT"), as
``zero_tpu/scripts/make_synth_mt.py``.

A deterministic translation task that is scored exactly and, unlike a copy
task, needs:

  * lexical mapping through a Zipfian vocabulary (sparse-word memorisation),
  * fertility: ~25% of source words translate to two target tokens,
  * many-to-one phrases: frequent source bigrams fuse into one target token
    (segmentation must be learned, phrases beat word-by-word decoding),
  * local reordering: a class-A word swaps with the following word,
  * a global agreement token: the target ends with a marker determined by
    the source length mod 3 (a whole-sequence dependency).

A model that merely copies or word-substitutes cannot exceed ~BLEU 0.5;
the exact transduction has BLEU 1.0. Writes {train,dev,test}.{src,tgt}
and vocab.{src,tgt} into out_dir:

  python -m zero_tpu_torch.scripts.make_synth_mt out_dir --train 200000
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _zipf_probs(n: int, a: float = 1.3) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


class SynthMT:
    def __init__(self, vocab_size: int = 4000, n_phrases: int = 150,
                 seed: int = 7):
        rs = np.random.RandomState(seed)
        self.n = vocab_size
        self.src_words = ["s%d" % i for i in range(vocab_size)]
        self.probs = _zipf_probs(vocab_size)
        # word class: A words swap with their successor (30%)
        self.is_a = rs.rand(vocab_size) < 0.3
        # lexicon: 25% of words have fertility 2
        self.fertility2 = rs.rand(vocab_size) < 0.25
        # fused-phrase table over frequent bigrams
        top = np.arange(120)
        self.phrases = {}
        while len(self.phrases) < n_phrases:
            a, b = rs.choice(top), rs.choice(top)
            self.phrases.setdefault((int(a), int(b)),
                                    "P%d" % len(self.phrases))
        self.agree = ["<m0>", "<m1>", "<m2>"]

    def translate(self, ids) -> list:
        # 1) segment greedily into phrase/word units
        units = []
        i = 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) in self.phrases:
                units.append(("P", self.phrases[(ids[i], ids[i + 1])]))
                i += 2
            else:
                units.append(("W", ids[i]))
                i += 1
        # 2) class-A reordering on the unit sequence
        out_units = list(units)
        j = 0
        while j + 1 < len(out_units):
            kind, val = out_units[j]
            if kind == "W" and self.is_a[val]:
                out_units[j], out_units[j + 1] = out_units[j + 1], \
                    out_units[j]
                j += 2
            else:
                j += 1
        # 3) lexical mapping with fertility
        toks = []
        for kind, val in out_units:
            if kind == "P":
                toks.append(val)
            elif self.fertility2[val]:
                toks.extend(["t%da" % val, "t%db" % val])
            else:
                toks.append("t%d" % val)
        # 4) global agreement marker
        toks.append(self.agree[len(ids) % 3])
        return toks

    def sample_source(self, rs: np.random.RandomState) -> list:
        length = rs.randint(5, 31)
        return rs.choice(self.n, size=length, p=self.probs).tolist()

    def tgt_vocab_tokens(self) -> list:
        toks = []
        for i in range(self.n):
            if self.fertility2[i]:
                toks += ["t%da" % i, "t%db" % i]
            else:
                toks.append("t%d" % i)
        toks += sorted(set(self.phrases.values()))
        toks += self.agree
        return toks


def generate(out_dir: str, n_train: int, n_dev: int, n_test: int,
             vocab_size: int, seed: int) -> None:
    os.makedirs(out_dir, exist_ok=True)
    task = SynthMT(vocab_size=vocab_size, seed=seed)
    rs = np.random.RandomState(seed + 1)
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        with open(os.path.join(out_dir, split + ".src"), "w") as fs, \
                open(os.path.join(out_dir, split + ".tgt"), "w") as ft:
            for _ in range(n):
                ids = task.sample_source(rs)
                fs.write(" ".join(task.src_words[i] for i in ids) + "\n")
                ft.write(" ".join(task.translate(ids)) + "\n")
    specials = ["<pad>", "<unk>", "<eos>"]
    with open(os.path.join(out_dir, "vocab.src"), "w") as f:
        f.write("\n".join(specials + task.src_words) + "\n")
    with open(os.path.join(out_dir, "vocab.tgt"), "w") as f:
        f.write("\n".join(specials + task.tgt_vocab_tokens()) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--train", type=int, default=200000)
    ap.add_argument("--dev", type=int, default=1000)
    ap.add_argument("--test", type=int, default=1000)
    ap.add_argument("--vocab", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    generate(args.out_dir, args.train, args.dev, args.test, args.vocab,
             args.seed)


if __name__ == "__main__":
    main()
