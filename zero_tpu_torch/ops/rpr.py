"""Shaw-style relative position representations (RPR).

Counterpart of ``zero_tpu/ops/rpr.py``: clipped-distance embedding tables
for keys and values, and the add-on to attention logits and outputs.
Decode takes a single distance row for the current step.

Two forms of the same math:
  * one-hot (the full-sequence path): with M = 2*max+1 buckets,
        rel_logits[b,h,q,k] = (q @ table^T)[b,h,q, ids[q,k]]
        rpr_out[b,h,q,:]    = (sum_k w[q,k] * OH[q,k,m]) @ table
    where OH = one_hot(ids) is a small [Lq, Lk, M] constant;
  * gathered: the [Lq, Lk, depth] table rows contracted per query
    position (decode steps, non-standard distance matrices, and shapes whose
    one-hot constant would be oversized).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RprTables(torch.nn.Module):
    """The two [2*max+1, depth] tables of one attention block: parameters
    ``keys`` and ``values`` (the JAX param names)."""

    def __init__(self, keys: torch.Tensor, values: torch.Tensor):
        super().__init__()
        self.keys = torch.nn.Parameter(keys)
        self.values = torch.nn.Parameter(values)


class TableView(NamedTuple):
    """RprTables' two tensors as they enter a computation (tensor
    parallelism: through copy_in)."""
    keys: torch.Tensor
    values: torch.Tensor


def init_rpr(gen, max_relative_position: int, depth: int,
             weight_init) -> RprTables:
    """Two embedding tables [2*max+1, depth]: one for keys, one for values."""
    vocab = 2 * max_relative_position + 1
    return RprTables(weight_init(gen, (vocab, depth)),
                     weight_init(gen, (vocab, depth)))


def relative_positions_matrix(length_q: int, length_k: int,
                              max_relative_position: int,
                              device=None, q_offset: int = 0) -> torch.Tensor:
    """[Lq, Lk] clipped relative-distance ids in [0, 2*max]; query i is at
    position q_offset + i (a sequence block's queries against a whole
    memory)."""
    rq = torch.arange(q_offset, q_offset + length_q, device=device)[:, None]
    rk = torch.arange(length_k, device=device)[None, :]
    dist = torch.clamp(rq - rk, -max_relative_position, max_relative_position)
    return dist + max_relative_position


def relative_positions_row(time: int, length_k: int,
                           max_relative_position: int,
                           device=None) -> torch.Tensor:
    """[1, Lk] distance ids for a single decode step at position ``time``."""
    rk = torch.arange(length_k, device=device)[None, :]
    dist = torch.clamp(time - rk, -max_relative_position,
                       max_relative_position)
    return dist + max_relative_position


def gather_embeddings(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[Lq, Lk, depth] (or [1, Lk, depth]) relative-position embeddings."""
    return table[ids]


# beyond this many [Lq, Lk, M] one-hot elements, the gathered form runs
# rather than materializing a huge constant
_ONEHOT_MAX_ELEMS = 1 << 28


def onehot_supported(length_q: int, length_k: int,
                     max_relative_position: int) -> bool:
    return (length_q * length_k * (2 * max_relative_position + 1)
            <= _ONEHOT_MAX_ELEMS)


def _dist_onehot(length_q: int, length_k: int, max_relative_position: int,
                 dtype, device=None, q_offset: int = 0) -> torch.Tensor:
    ids = relative_positions_matrix(length_q, length_k,
                                    max_relative_position, device, q_offset)
    return torch.nn.functional.one_hot(
        ids, 2 * max_relative_position + 1).to(dtype)


def logits_with_rpr_onehot(qh, kh, table, max_relative_position: int,
                           q_offset: int = 0):
    """q @ k^T + (q @ table^T) expanded through the distance one-hot."""
    lq, lk = qh.shape[2], kh.shape[2]
    oh = _dist_onehot(lq, lk, max_relative_position, qh.dtype, qh.device,
                      q_offset)
    qr = torch.einsum("bhqd,md->bhqm", qh, table.to(qh.dtype))
    logits = torch.matmul(qh, kh.transpose(-1, -2))
    return logits + torch.einsum("bhqm,qkm->bhqk", qr, oh)


def output_with_rpr_onehot(w, v, table, max_relative_position: int,
                           q_offset: int = 0):
    """w @ v + bucket-summed weights @ table."""
    lq, lk = w.shape[2], w.shape[3]
    oh = _dist_onehot(lq, lk, max_relative_position, w.dtype, w.device,
                      q_offset)
    wb = torch.einsum("bhqk,qkm->bhqm", w, oh)
    o = torch.matmul(w, v)
    return o + torch.einsum("bhqm,md->bhqd", wb, table.to(w.dtype))


def logits_with_rpr(q, k, r):
    """q @ k^T + q @ r^T with q, k: [B, H, L, Dh], r: [Lq, Lk, Dh]: the
    r-term contracts per query position."""
    logits = torch.matmul(q, k.transpose(-1, -2))
    return logits + torch.einsum("bhqd,qkd->bhqk", q, r.to(q.dtype))


def output_with_rpr(w, v, r):
    """w @ v + w @ r with w: [B, H, Lq, Lk], v: [B, H, Lk, Dh],
    r: [Lq, Lk, Dh]."""
    o = torch.matmul(w, v)
    return o + torch.einsum("bhqk,qkd->bhqd", w, r.to(w.dtype))
