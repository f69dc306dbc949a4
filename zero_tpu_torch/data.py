"""Host-side dataset: streaming, bucket-sorting, batching, shape discipline.

A copy of the python tokeniser path of ``zero_tpu/data.py`` (the port
imports nothing of the JAX package; the C++ tokeniser and the forked
tokeniser workers come with a later slice). Reference pipeline semantics:
buffer-sort by max(src,tgt) length, batch- or token-count bucketing,
shuffled bucket order, per-batch max padding into int32 matrices, and the
leak buffer deferring undersized tail batches.

``pad_seq_multiple``/``pad_batch_multiple``/``pad_batch_to`` keep exactly
the JAX package's padded shapes: beam search derives its step budget from
the padded source length (search.py), so a different padding would decode
a different number of steps. One exception, for long sequences: the JAX
package snaps a token batch's rows up a ladder that starts at 16 rows
(``snap_rows_ladder``, bounding its jit shapes), so one 16k-token pair under
``token_size=16384`` trains as 16 rows, 15 of them empty. Here a token
batch whose longest padded side leaves the budget room for fewer than 16
rows keeps its own row count; below that length (every length up to 256
at ``token_size=4096``) the shapes are the JAX package's. All-pad rows
change no loss (``sentence_mean_loss`` leaves them out), only the work.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def batch_indexer(datasize: int, batch_size: int) -> List[List[int]]:
    """Split range(datasize) into consecutive fixed-size index groups
    (keeps the tail as a smaller group)."""
    index = list(range(datasize))
    groups = [index[i * batch_size:(i + 1) * batch_size]
              for i in range(datasize // batch_size)]
    if datasize % batch_size > 0:
        groups.append(index[-(datasize % batch_size):])
    return groups


def token_indexer(lengths: Sequence[Sequence[int]],
                  token_size: int) -> List[List[int]]:
    """Token-budget batching: cost of a batch = count x running-max-length
    per field; oversize singletons become 1-element batches."""
    index = list(range(len(lengths)))
    groups: List[List[int]] = []

    running_max = [0.0] * len(lengths[0])
    count = 0
    i = 0
    while i < len(lengths):
        running_max = [max(m, l) for m, l in zip(running_max, lengths[i])]
        count += 1
        for m in running_max:
            if count * m >= token_size:
                if count > 1:
                    groups.append(index[i - count + 1:i])
                    i -= 1
                else:
                    groups.append(index[i:i + 1])
                count = 0
                running_max = [0.0] * len(lengths[0])
                break
        i += 1

    consumed = sum(len(g) for g in groups)
    if consumed != len(lengths):
        groups.append(index[consumed:])
    return groups


def round_up(x: int, multiple: int) -> int:
    if multiple <= 1:
        return x
    return ((x + multiple - 1) // multiple) * multiple


LADDER_FIRST_RUNG = 16


def snap_rows_ladder(n: int, multiple: int) -> int:
    """Snap a row count UP to a geometric ladder (1.25x steps on top of
    ``multiple``), bounding the number of distinct batch shapes to
    O(log rows) instead of one per row count."""
    if multiple <= 1:
        return n
    step = max(multiple, LADDER_FIRST_RUNG)
    v = step
    while v < n:
        v = round_up(max(v + 1, int(v * 1.25)), step)
    return v


class Dataset:
    """Parallel-text dataset with sort-bucket batching and a leak buffer.

    Yields dict batches: 'src'/'tgt' int32 [B, L] zero-padded, 'index' the
    original sentence indices, 'raw' the (index, src_ids, tgt_ids) triples.
    """

    def __init__(self, src_file: str, tgt_file: str, src_vocab, tgt_vocab,
                 max_len: int = 100, batch_or_token: str = "batch",
                 data_leak_ratio: float = 0.5,
                 pad_seq_multiple: int = 1,
                 pad_batch_multiple: int = 1,
                 pad_batch_to: int = 0):
        self.source = src_file
        self.target = tgt_file
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.max_len = max_len
        self.batch_or_token = batch_or_token
        self.data_leak_ratio = data_leak_ratio
        self.pad_seq_multiple = pad_seq_multiple
        self.pad_batch_multiple = pad_batch_multiple
        # pad every batch up to this many rows (eval: one batch shape per
        # sequence bucket instead of one per tail-batch size)
        self.pad_batch_to = pad_batch_to
        self._id_cache = None
        self.leak_buffer: List[Tuple[int, List[int], List[int]]] = []

    def load_data(self) -> Iterator[Tuple[List[int], List[int]]]:
        """Stream sentence pairs; truncate source/target at max_len tokens
        (pre-eos), skip blank lines, stop at first exhausted file. Later
        passes replay the tokenised corpus instead of re-reading the text."""
        if self._id_cache is not None:
            yield from self._id_cache
            return
        collected = []
        for src_line, tgt_line in self._raw_pairs():
            pair = (self.src_vocab.to_id(src_line.split()[:self.max_len]),
                    self.tgt_vocab.to_id(tgt_line.split()[:self.max_len]))
            collected.append(pair)
            yield pair
        self._id_cache = collected

    def _raw_pairs(self) -> Iterator[Tuple[str, str]]:
        """Stream stripped non-blank (src_line, tgt_line) string pairs."""
        with open(self.source) as src_reader, open(self.target) as tgt_reader:
            while True:
                src_line = src_reader.readline()
                tgt_line = tgt_reader.readline()
                if src_line == "" or tgt_line == "":
                    break
                src_line = src_line.strip()
                tgt_line = tgt_line.strip()
                if src_line == "" or tgt_line == "":
                    continue
                yield (src_line, tgt_line)

    def to_matrix(self, batch, token_size: int = 0):
        """Pad a list of (idx, src_ids, tgt_ids) into int32 matrices.

        Sequence dims are capped at max_len then snapped up to
        pad_seq_multiple; the batch dim is snapped up to pad_batch_multiple
        with all-pad rows (fully masked downstream -- models treat all-zero
        rows as empty sentences). A token batch (``token_size`` its budget)
        whose longest side leaves room for fewer than LADDER_FIRST_RUNG rows
        keeps its own row count (the module docstring says why).
        """
        batch_size = len(batch)
        src_len = min(self.max_len, max(len(s[1]) for s in batch))
        tgt_len = min(self.max_len, max(len(s[2]) for s in batch))

        src_len = round_up(src_len, self.pad_seq_multiple)
        tgt_len = round_up(tgt_len, self.pad_seq_multiple)
        if self.batch_or_token == "token":
            padded_bs = snap_rows_ladder(batch_size, self.pad_batch_multiple)
            if max(src_len, tgt_len) * LADDER_FIRST_RUNG > token_size > 0:
                padded_bs = batch_size
        else:
            padded_bs = round_up(batch_size, self.pad_batch_multiple)
        padded_bs = max(padded_bs, self.pad_batch_to)

        s = np.zeros([padded_bs, src_len], dtype=np.int32)
        t = np.zeros([padded_bs, tgt_len], dtype=np.int32)
        x = []
        for eidx, sample in enumerate(batch):
            x.append(sample[0])
            src_ids, tgt_ids = sample[1], sample[2]
            s[eidx, :min(src_len, len(src_ids))] = src_ids[:src_len]
            t[eidx, :min(tgt_len, len(tgt_ids))] = tgt_ids[:tgt_len]
        return x, s, t

    def batcher(self, size: int, buffer_size: int = 1000, shuffle: bool = True,
                train: bool = True) -> Iterator[dict]:
        """Sort a buffer by max length, bucket it, shuffle bucket order,
        yield padded batches; undersized batches (< size*leak_ratio) are
        deferred into the leak buffer and re-batched with later data."""

        def _handle_buffer(buf):
            sorted_buf = sorted(buf, key=lambda xx: max(len(xx[1]), len(xx[2])))
            if self.batch_or_token == "batch":
                buffer_index = batch_indexer(len(sorted_buf), size)
            else:
                buffer_index = token_indexer(
                    [[len(s[1]), len(s[2])] for s in sorted_buf], size)

            order = list(range(len(buffer_index)))
            if shuffle:
                np.random.shuffle(order)

            for oidx in order:
                batch = [sorted_buf[ii] for ii in buffer_index[oidx]]
                x, s, t = self.to_matrix(
                    batch, size if self.batch_or_token == "token" else 0)
                yield {"src": s, "tgt": t, "index": x, "raw": batch}

        def _size(data):
            if self.batch_or_token == "batch":
                return len(data["raw"])
            return max(int(np.sum(data["tgt"] > 0)),
                       int(np.sum(data["src"] > 0)))

        buf = self.leak_buffer
        self.leak_buffer = []
        for i, (src_ids, tgt_ids) in enumerate(self.load_data()):
            buf.append((i, src_ids, tgt_ids))
            if len(buf) >= buffer_size:
                for data in _handle_buffer(buf):
                    if _size(data) < size * self.data_leak_ratio:
                        self.leak_buffer += data["raw"]
                    else:
                        yield data
                buf = self.leak_buffer
                self.leak_buffer = []

        if len(buf) > 0:
            for data in _handle_buffer(buf):
                if train and _size(data) < size * self.data_leak_ratio:
                    self.leak_buffer += data["raw"]
                else:
                    yield data
