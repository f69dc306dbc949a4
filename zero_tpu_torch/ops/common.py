"""Shared functional utilities of ``zero_tpu/ops/common.py``: dropout-seed
threading, counter-hash dropout, label-smoothed losses, log-probs, gumbel
noise and the beam gather.

Dropout seeds. The JAX package threads PRNG keys; a dropout site hashes
each element's linear index with the key's two raw u32 words
(``_hash_bits``). The port threads those two words directly, as a tuple
``(s0, s1)`` of host ints: ``RngGen`` draws a fresh pair per site from a
host ``torch.Generator``, and the kernels take the pair by value, so a
train step needs no device-to-host copy for seeds. Given the same words,
``_hash_bits`` and ``dropout`` are bit-identical to the JAX package's.

The global batch. Under data parallelism (parallel/distributed.py) each
process holds rows [offset, offset + rows) of a global batch of ``total``
rows, as the JAX package's GSPMD step holds one global array.
``global_batch`` says so for a microbatch; within it every draw indexed by
batch row takes the global row (``index_base``, or ``global_index`` where
the batch is not the leading axis: the JAX iota is global),
and ``global_sum`` makes a batch statistic of the loss global.

A split axis. Under tensor parallelism a process draws over its heads
([B, H/W, Lq, Lk] attention weights) or its slice of the FFN hidden
width ([B, L, F/W]); under expert parallelism over its experts ([E/W,
B*C, d]). GSPMD hashes the global linear index, so such a draw names the
axis, its offset and its whole length (``split``): the element's index is
its place in the tensor with both the batch and the split axis whole
(``global_index``), which no one offset gives (``index_base`` refuses).

A split sequence. Under sequence parallelism (``mesh_seq``,
parallel/ring.py) each process of a seq line holds block ``coord`` of
every sequence, all blocks of one length (``seq_parallel``): a draw over
a [B, L/n, ...] activation names its L axis (``seq_split``), so that it
takes the whole sequence's index, and the per-sentence sums of the loss
are summed over the line (``seq_sum``). Ring attention folds its blocks'
owners into the seed words (``fold_in``, JAX's threefry ``fold_in``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch

Words = Tuple[int, int]
_U32 = 0xFFFFFFFF


class RngGen:
    """Per-site dropout seeds: each call returns a fresh ``(s0, s1)`` pair
    of u32 words from ``gen``, or None when ``gen`` is None (dropout off:
    eval and scoring)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self._gen = gen

    def __call__(self) -> Optional[Words]:
        if self._gen is None:
            return None
        s0, s1 = torch.randint(0, 2 ** 32, (2,), generator=self._gen,
                               dtype=torch.int64).tolist()
        return int(s0), int(s1)


# the microbatch's place in the global batch (global_batch)
_BATCH = {"offset": 0, "rows": 0, "total": 0, "reduce": None}


@contextlib.contextmanager
def global_batch(offset: int, rows: int, total: int,
                 reduce: Optional[Callable] = None):
    """Within: this process's microbatch is rows [offset, offset + rows) of
    a global batch of ``total`` rows; ``reduce(x)`` (the processes' sum,
    distributed.global_sum) makes a batch statistic global."""
    saved = dict(_BATCH)
    _BATCH.update(offset=int(offset), rows=int(rows), total=int(total),
                  reduce=reduce)
    try:
        yield
    finally:
        _BATCH.update(saved)


@contextlib.contextmanager
def replicated_draws():
    """Within a global batch: draws over a tensor that no batch row
    indexes (a parameter's gates) are the same on every process, as a
    replicated JAX array's; global_sum still reduces."""
    with global_batch(0, 0, 0, _BATCH["reduce"]):
        yield


def global_rows() -> Tuple[int, int, int]:
    """(offset, rows, total) of the microbatch in its global batch; (0, 0,
    0) outside global_batch."""
    return _BATCH["offset"], _BATCH["rows"], _BATCH["total"]


def index_base(shape, batch_axis: int = 0) -> int:
    """The global linear index (mod 2^32) of the first element of a draw
    over a tensor of ``shape`` whose batch axis is ``batch_axis``: the
    elements of the rows before this process's. 0 outside global_batch.
    Only a batch-major draw (batch axis 0, its leading axis a multiple of
    the rows) has one contiguous offset; any other raises, and takes its
    index from global_index instead."""
    offset, rows, _ = global_rows()
    if not rows:
        return 0
    shape = tuple(int(d) for d in shape)
    if batch_axis != 0:
        raise ValueError("a draw over %s whose batch axis is %d under a "
                         "global batch: its rows are not one contiguous "
                         "block of the global index (global_index)"
                         % (shape, batch_axis))
    if not shape or shape[0] % rows:
        raise ValueError("a draw over %s under a global batch of %d-row "
                         "slices: its leading axis is not the batch"
                         % (shape, rows))
    return (offset * (math.prod(shape) // rows)) & _U32


Split = Tuple[int, int, int]     # (axis, offset, whole length)


def _splits(split) -> list:
    """A Split, a sequence of Splits or None -> a list of Splits."""
    if not split:
        return []
    if isinstance(split[0], int):
        return [tuple(split)]
    return [tuple(s) for s in split if s is not None]


def global_index(shape, batch_axis: int = 0, device=None,
                 split: Optional[Split] = None) -> torch.Tensor:
    """The global linear index (mod 2^32, int64) of every element of a
    draw over ``shape`` whose axis ``batch_axis`` holds this process's
    rows, each ``shape[batch_axis] // rows`` long, and whose axis
    ``split[0]`` (if given) is the part [offset, offset + n) of a whole
    ``split[2]`` long: the element's index in the global tensor. An
    expert-major [E, B*C, d] tensor (ops/moe.py) is E strided blocks of
    that index space, not one offset. ``split`` may be a list of such
    splits on different axes (heads and a sequence block)."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    offset, rows, total = global_rows()
    splits = _splits(split)
    if not splits and (not rows or batch_axis == 0):
        return ((torch.arange(max(n, 1), dtype=torch.int64, device=device)
                 + index_base(shape, batch_axis)) & _U32)[:n].reshape(shape)
    # each axis as (offset, whole length)
    spans = [(0, d) for d in shape]
    if rows:
        width = shape[batch_axis]
        if width % rows:
            raise ValueError("a draw over %s: axis %d is not %d rows long"
                             % (shape, batch_axis, rows))
        per = width // rows
        spans[batch_axis] = (offset * per, total * per)
    for axis, start, whole in splits:
        spans[axis % len(shape)] = (int(start), int(whole))
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        start, whole = spans[axis]
        view = [1] * len(shape)
        view[axis] = shape[axis]
        idx = idx + (torch.arange(start, start + shape[axis],
                                  dtype=torch.int64, device=device)
                     * stride).reshape(view)
        stride *= whole
    return (idx.expand(shape) & _U32).reshape(shape)


# the process's block of every sequence (seq_parallel)
_SEQ = {"coord": 0, "degree": 1, "reduce": None}


@contextlib.contextmanager
def seq_parallel(coord: int, degree: int, reduce: Optional[Callable] = None):
    """Within: this process holds block ``coord`` of ``degree`` equal
    blocks of every sequence of the microbatch; ``reduce(x)``
    (distributed.global_sum over 'seq') sums a per-sentence statistic
    over the line."""
    saved = dict(_SEQ)
    _SEQ.update(coord=int(coord), degree=int(degree), reduce=reduce)
    try:
        yield
    finally:
        _SEQ.update(saved)


def seq_degree() -> int:
    """The number of blocks a sequence is split into (1: no split)."""
    return _SEQ["degree"]


def seq_coord() -> int:
    return _SEQ["coord"]


def seq_split(axis: int, length: int) -> Optional[Split]:
    """The Split of a draw whose axis ``axis`` is this process's block of
    ``length`` positions: (axis, coord * length, degree * length); None
    without a split sequence."""
    n = _SEQ["degree"]
    if n <= 1:
        return None
    return (axis, _SEQ["coord"] * int(length), n * int(length))


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over this process's block of positions -> the whole
    sequence's: the line's sum as the value, its own gradient."""
    reduce = _SEQ["reduce"]
    return x if reduce is None or _SEQ["degree"] <= 1 else reduce(x)


def seq_shared(x: torch.Tensor) -> torch.Tensor:
    """A loss term that every process of a seq line computes whole (from
    the gathered encoder output): its value as it is and 1/n of its
    gradient on each of the n processes, so that their sum is its
    gradient."""
    n = _SEQ["degree"]
    return x if n <= 1 else x.detach() + (x - x.detach()) / n


def seq_count(n: float) -> float:
    """A count over this process's block of positions -> the whole
    sequence's."""
    return n * _SEQ["degree"]


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> Words:
    """Threefry-2x32 with 20 rounds on host ints (jax.random's
    threefry_2x32 on one pair of counters)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _U32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def fold_in(words: Words, data: int) -> Words:
    """``jax.random.fold_in`` of a threefry key whose two words are
    ``words``: threefry_2x32 of the key over the counters (0, data)."""
    return _threefry2x32(int(words[0]) & _U32, int(words[-1]) & _U32, 0,
                         int(data) & _U32)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A batch statistic made global: its sum over the processes as the
    value, its own gradient (``x`` itself outside global_batch or in one
    process without a group)."""
    reduce = _BATCH["reduce"]
    return x if reduce is None else reduce(x)


def _mul32(x: torch.Tensor, mult: int) -> torch.Tensor:
    """(x * mult) mod 2^32 for int64 x in [0, 2^32), without int64
    overflow: the multiplier is split into 16-bit halves."""
    lo = x * (mult & 0xFFFF)
    hi = ((x * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor, mult: int) -> torch.Tensor:
    x = x ^ (x >> 16)
    return _mul32(x, mult)


def _hash_bits(words: Words, shape, device=None,
               batch_axis: int = 0,
               split: Optional[Split] = None) -> torch.Tensor:
    """Uniform u32 draws (held in int64) from the murmur3 fmix32 finalizer
    over each element's linear index, seeded by the two key words:
    ``zero_tpu/ops/common.py:_hash_bits``, bit for bit. Within a global
    batch the index is the element's in the global tensor, whose batch
    axis is ``batch_axis``, with a ``split`` axis whole (global_index)."""
    s0, s1 = int(words[0]) & _U32, int(words[-1]) & _U32
    x = global_index(shape, batch_axis, device, split)
    x = _mix32(x ^ s0, 0x85EBCA6B)
    x = _mix32(x, 0xC2B2AE35)
    return x ^ (x >> 16) ^ s1


def keep_threshold(rate: Optional[float]) -> int:
    """t of the 8-bit threshold dropout (keep = low8(bits) < t, scale
    256/t); 256 means dropout is off."""
    if rate is None or not (0.0 < rate < 1.0):
        return 256
    return min(int(round((1.0 - rate) * 256.0)), 256)


def dropout(rng: Optional[Words], x: torch.Tensor,
            rate: Optional[float], batch_axis: int = 0,
            split: Optional[Split] = None) -> torch.Tensor:
    """Inverted dropout with 8-bit threshold masks from the counter hash;
    a no-op when ``rng`` is None or the rate is falsy/invalid.
    ``batch_axis``: the axis of ``x`` that holds the batch rows;
    ``split``: (axis, offset, whole length) of an axis ``x`` holds a part
    of (_hash_bits)."""
    if rng is None:
        return x
    t = keep_threshold(rate)
    if t >= 256:
        return x
    if t <= 0:
        return torch.zeros_like(x)
    keep = (_hash_bits(rng, x.shape, x.device, batch_axis, split)
            & 255) < t
    return torch.where(keep, x * keep_scale(t, x.dtype), torch.zeros_like(x))


def keep_scale(t: int, dtype) -> float:
    """256/t rounded to ``dtype``, as a host float: multiplying a tensor of
    that dtype by it rounds like the JAX graph's product of two
    ``dtype`` values, and needs no host-to-device copy."""
    return float(torch.tensor(256.0 / t, dtype=dtype))


def log_prob_from_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def _smoothing(vocab_size: int, factor: float):
    """(p, q, normalizer) of label smoothing; the normalizer is computed
    in fp32 like the JAX graph, on the host."""
    n = float(vocab_size - 1)
    p = 1.0 - factor
    q = factor / n
    f32 = torch.float32
    normalizer = -(torch.tensor(p, dtype=f32)
                   * torch.log(torch.tensor(p, dtype=f32))
                   + torch.tensor(n * q, dtype=f32)
                   * torch.log(torch.tensor(q + 1e-20, dtype=f32)))
    return p, q, normalizer.item()


def smoothed_centropy(logits: torch.Tensor, labels: torch.Tensor,
                      factor: float) -> torch.Tensor:
    """Per-position label-smoothed CE minus the smoothing normalizer,
    fp32. Shape = labels'."""
    logits = logits.float()
    vocab_size = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    gold_logp = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if 0.0 < factor < 1.0:
        p, q, normalizer = _smoothing(vocab_size, factor)
        sum_logp = logp.sum(dim=-1)
        centropy = -(p * gold_logp + q * (sum_logp - gold_logp))
        return centropy - normalizer
    return -gold_logp


def smoothed_centropy_reduced(logits: torch.Tensor, labels: torch.Tensor,
                              factor: float, vocab=None) -> torch.Tensor:
    """smoothed_centropy as per-token reductions over the vocabulary (max,
    log-sum-exp, centred logit sum, gold logit): no [N, V] log-prob tensor
    is kept. The max is detached, the standard stable-lse step.

    ``vocab`` = (offset, whole size, mesh axis): the logits are a
    process's columns [offset, offset + V/W) of the vocabulary (tensor
    parallelism); each of the four reductions is completed over the line
    (Megatron's vocab-parallel cross entropy), and the result is the
    whole vocabulary's on every process."""
    from zero_tpu_torch.parallel import distributed as dist
    logits = logits.float()
    vocab_size = logits.shape[-1]
    labels = labels.long()
    total = (lambda x: x) if vocab is None else (
        lambda x: dist.reduce_out(x, vocab[2]))
    m = logits.max(dim=-1).values.detach()
    if vocab is not None:
        m = dist.max_over(m, vocab[2])
        offset, vocab_size = vocab[0], vocab[1]
        local = labels - offset
        inside = (local >= 0) & (local < logits.shape[-1])
        labels = torch.where(inside, local, torch.zeros_like(local))
    centered = logits - m[..., None]
    sum_exp = total(torch.exp(centered).sum(dim=-1))
    lse = m + torch.log(sum_exp)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    if vocab is not None:
        gold = total(torch.where(inside, gold, torch.zeros_like(gold)))
    gold_logp = gold - lse
    if 0.0 < factor < 1.0:
        p, q, normalizer = _smoothing(vocab_size, factor)
        csum = total(centered.sum(dim=-1))
        sum_logp = csum - float(vocab_size) * torch.log(sum_exp)
        centropy = -(p * gold_logp + q * (sum_logp - gold_logp))
        return centropy - normalizer
    return -gold_logp


def sentence_mean_loss(centropy: torch.Tensor, mask: torch.Tensor):
    """Per-sentence mean, then batch mean over the sentences that have a
    token (all-pad rows contribute 0 and are left out). Returns (scalar
    loss, per-sentence loss [B]). Within a global batch both sums are the
    global batch's (global_sum); over a split sequence the per-sentence
    sums are the whole sentence's (seq_sum)."""
    mask = mask.float()
    msum = seq_sum(mask.sum(dim=-1))
    per_sample = seq_sum((centropy * mask).sum(dim=-1)) / torch.clamp(
        msum, min=1.0)
    valid = (msum > 0).float()
    return masked_mean(per_sample, valid), per_sample


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sum(values * valid) / max(sum(valid), 1), both sums over the global
    batch (global_sum): the mean over the valid rows."""
    return global_sum((values * valid).sum()) / torch.clamp(
        global_sum(valid.sum()), min=1.0)


def shared_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term no batch row enters (a penalty on a parameter): its
    value as it is and, within a global batch, 1/W of its gradient on each
    of the W processes, so that their sum is its gradient."""
    offset, rows, total = global_rows()
    if _BATCH["reduce"] is None or not rows:
        return x
    return x.detach() + (x - x.detach()) * (rows / total)


def global_count(n: float) -> float:
    """A count of elements of this process's microbatch -> the global
    batch's (the processes' slices have one shape)."""
    _, rows, total = global_rows()
    if _BATCH["reduce"] is None or not rows:
        return n
    return n * total / rows


def label_smooth_loss(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, factor: float = 0.1):
    return sentence_mean_loss(smoothed_centropy(logits, labels, factor), mask)


def gumbel_noise(gen: torch.Generator, shape, device,
                 eps: float = 1e-8) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u + eps) + eps)


def gather_beams(x: torch.Tensor, beam_indices: torch.Tensor, batch: int,
                 beam_size: int) -> torch.Tensor:
    """Reorder the beam axis of a [B*K, ...] tensor by [B, K] indices."""
    y = x.reshape((batch, beam_size) + x.shape[1:])
    idx = beam_indices.reshape((batch, beam_size) + (1,) * (y.dim() - 2))
    y = torch.take_along_dim(y, idx.long(), dim=1)
    return y.reshape((batch * beam_size,) + x.shape[1:])
