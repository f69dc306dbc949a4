"""Vocabulary: word<->id maps with reserved <pad>=0, <unk>=1, <eos>=2.

A copy of ``zero_tpu/vocab.py`` (the port imports nothing of the JAX
package).

Behavioral parity with reference vocab.py:10-102 (same reserved symbols and
ids, eos appended on encode, frequency-sorted build CLI).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


class Vocab:
    PAD = "<pad>"
    UNK = "<unk>"
    EOS = "<eos>"

    def __init__(self, vocab_file: Optional[str] = None):
        self.word2id: Dict[str, int] = {}
        self.id2word: Dict[int, str] = {}
        self.word2count: Dict[str, int] = {}

        for sym in (self.PAD, self.UNK, self.EOS):
            self.insert(sym)

        if vocab_file is not None:
            self.load_vocab(vocab_file)

    def insert(self, token: str) -> None:
        if token not in self.word2id:
            idx = len(self.word2id)
            self.word2id[token] = idx
            self.id2word[idx] = token
            self.word2count[token] = 0
        self.word2count[token] += 1

    def size(self) -> int:
        return len(self.word2id)

    def load_vocab(self, vocab_file: str) -> None:
        with open(vocab_file) as reader:
            for token in reader:
                self.insert(token.strip())

    def get_token(self, idx: int) -> str:
        return self.id2word.get(idx, self.UNK)

    def get_id(self, token: str) -> int:
        return self.word2id.get(token, self.word2id[self.UNK])

    def sort_vocab(self) -> None:
        sorted_counts = sorted(self.word2count.items(), key=lambda x: -x[1])
        self.word2id, self.id2word = {}, {}
        for sym in (self.PAD, self.UNK, self.EOS):
            self.insert(sym)
        for word, _ in sorted_counts:
            self.insert(word)

    def save_vocab(self, vocab_file: str, size: int = 1_000_000) -> None:
        with open(vocab_file, "w") as writer:
            for idx in range(min(self.size(), int(size))):
                writer.write(self.id2word[idx] + "\n")

    def to_id(self, tokens: List[str], append_eos: bool = True) -> List[int]:
        ids = [self.get_id(t) for t in tokens]
        if append_eos:
            ids.append(self.eos())
        return ids

    def to_tokens(self, ids: List[int]) -> List[str]:
        return [self.get_token(i) for i in ids]

    def eos(self) -> int:
        return self.get_id(self.EOS)

    def pad(self) -> int:
        return self.get_id(self.PAD)


def main() -> None:
    parser = argparse.ArgumentParser("Vocabulary preparation")
    parser.add_argument("--size", type=int, default=1_000_000,
                        help="maximum vocabulary size")
    parser.add_argument("input", type=str)
    parser.add_argument("output", type=str)
    args = parser.parse_args()

    vocab = Vocab()
    with open(args.input) as reader:
        for line in reader:
            for token in line.strip().split():
                vocab.insert(token)
    vocab.sort_vocab()
    vocab.save_vocab(args.output, args.size)
    print("Loaded {} tokens from {}".format(vocab.size(), args.input))


if __name__ == "__main__":
    main()
