"""Single-query decode attention: CUDA kernels for Hopper and their plain
PyTorch versions.

Replaces the Pallas TPU kernels of ``zero_tpu/ops/kernels/decode_attention.py``:

* ``decode_attention`` -- ``decode_attention`` (``pallas_call`` at :366,
  ``_kernel`` :79): one query per row, masked softmax over the positions
  <= ``time`` of a static [B, T, hidden] cache. Single-beam decode.
* ``decode_pool_attention`` -- ``decode_pool_attention`` (``pallas_call``
  at :288, ``_pool_kernel`` :176): one query per beam over UNPERMUTED beam
  KV pools [B, K, T, hidden]; position t of beam i reads pool row
  ``ancestry[b, i, t]``. Softmax, or ReLA's unnormalised relu weights.
  Beam decode.
* ``decode_cross_attention`` -- ``decode_cross_attention`` (``pallas_call``
  at :329, ``_cross_kernel`` :113): beam-folded one-step cross attention,
  [B, beams, hidden] queries over precomputed memory projections
  [B, S, hidden] under a [B, S] pad mask. The JAX package leaves it out of
  ``cross_attn_step`` (speed-neutral at MT lengths), and so does the port:
  ``chip_smoke.py`` launches it at long-memory and MT shapes.

All three run one CUDA kernel in ``csrc/decode_attention.cu`` (its header
explains the design); where the
blocks of one (row, head) each would leave SMs idle (a long cache at small
batch), both split their positions into chunks (``decode_splits``,
``cross_splits``) and a second kernel folds the chunks. Bound on the card:
device-memory bytes -- the K and V head slices of the selected rows of
positions <= ``time``, plus the query, the ancestry entries and the
output, over the card's bandwidth (3.35 TB/s on an H100 SXM). The
operations (4 per K/V element pair) are ~2 per byte read, far below the
~295 flops/byte where the tensor cores would bound it. The single-query
kernel reads each selected element once, in 16-byte loads, in one pass (an
online softmax per group of lanes), and gathers pool rows by the ancestry
index directly, where the TPU kernel made K masked passes over every pool
row. The cross kernel reads each memory element once per batch row, for
up to CROSS_BEAMS_PER_BLOCK beams, in the same 16-byte loads: each lane
group takes the dots of all the block's beams from one K load.

Dispatch: a CUDA tensor launches the kernel, or raises when the kernel
does not take the input; a CPU tensor goes to the plain version
(``decode_attention_ref``/``decode_pool_attention_ref``/
``decode_cross_attention_ref``), which the CPU tests compare with the JAX
package. Nothing on the main path calls a
plain version on the card.

The kernels build with ``nvcc`` on first use, from this package's sources,
into ``zero_tpu_torch/_build/`` (git-ignored), and load through ctypes.
``launches`` counts kernel launches and plain-version calls by name.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from zero_tpu_torch.ops.kernels import cuda_build

NEG_INF = -1e9   # the masked-logit value of zero_tpu/ops/attention.py
CROSS_NEG_INF = -1e30   # the masked-logit value of _cross_kernel

# the JAX package's limits on the single-query kernels (head depth, cache
# length); the wrappers raise outside them. The cross kernel streams the
# memory in tiles: S has no bound.
MAX_HEAD_DIM = 256
MAX_POSITIONS = 10240
DECODE_BLOCKS_PER_SM = 4     # the single-query kernel's split target
DECODE_MIN_CHUNK = 256       # its least positions per split
CROSS_BEAMS_PER_BLOCK = 4    # the cross kernel's beams per block
CROSS_BLOCKS_PER_SM = 2      # its split target
CROSS_MIN_CHUNK = 256        # its least memory positions per split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches ("decode_attention", "decode_pool_attention" and, in
# ReLA's relu mode, "decode_pool_attention_relu", "decode_cross_attention")
# and calls of the plain versions (the same names with "_ref")
launches: collections.Counter = collections.Counter()
# the splits over positions (memory positions for the cross kernel) of each
# kernel's last launch
taken: dict = {}


def build() -> str:
    """Compile ``csrc/decode_attention.cu`` for sm_90a unless its library
    is built already (``cuda_build``); returns the library path."""
    return cuda_build.build("decode_attention")["decode_attention"]


@functools.lru_cache(maxsize=None)
def _library():
    fn = cuda_build.load("decode_attention").zt_single_query_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _cross_library():
    fn = cuda_build.load("decode_attention").zt_cross_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, time, num_heads, name):
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError("%s: q/k/v must share one dtype of %s, got %s/%s/%s"
                         % (name, list(_DTYPES), q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("%s: q/k/v on different devices" % name)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("%s: q/k/v must be contiguous" % name)
    hidden = q.shape[-1]
    if hidden % num_heads or hidden // num_heads > MAX_HEAD_DIM:
        raise ValueError("%s: hidden %d / heads %d must split evenly into "
                         "heads of depth <= %d" % (name, hidden, num_heads,
                                                   MAX_HEAD_DIM))
    t_max = k.shape[-2]
    if not 0 <= int(time) < t_max or t_max > MAX_POSITIONS:
        raise ValueError("%s: need 0 <= time (%d) < T (%d) <= %d"
                         % (name, time, t_max, MAX_POSITIONS))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(blocks: int, n: int, sms: int, per_sm: int, min_chunk: int,
            tile: int):
    """(splits, chunk) of ``n`` positions over ``blocks`` blocks each: split
    until about ``per_sm`` blocks per SM are in flight, each split at least
    ``min_chunk`` positions, chunks a multiple of ``tile``."""
    splits = max(1, min(-(-per_sm * sms // blocks), n // min_chunk))
    chunk = -(-n // splits)
    chunk = -(-chunk // tile) * tile
    return -(-n // chunk), chunk


def decode_splits(blocks: int, n: int, sms: int):
    """(splits, chunk) of the single-query kernel: ``blocks`` (rows x heads)
    over ``n`` positions; chunks a multiple of 64 (a block's positions per
    iteration at Dh 64 in bf16). ``scripts/decode_split_sweep.py`` times
    the kernel against DECODE_BLOCKS_PER_SM."""
    return _splits(blocks, n, sms, DECODE_BLOCKS_PER_SM, DECODE_MIN_CHUNK, 64)


def _launch(name, q, k, v, ancestry, rows, beams, num_heads, time, relu):
    out = torch.empty_like(q)
    hidden = q.shape[-1]
    dh = hidden // num_heads
    splits, chunk = decode_splits(rows * num_heads, int(time) + 1,
                                  _sms(q.device))
    part_o = part_ml = None
    if splits > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_o = torch.empty((rows // beams, num_heads, splits, beams, dh),
                             **f32)
        part_ml = torch.empty((rows // beams, num_heads, splits, beams, 2),
                              **f32)
    taken[name] = splits
    with torch.cuda.device(q.device):
        err = _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if ancestry is None else ancestry.data_ptr(),
            out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            _DTYPES[q.dtype], rows, beams, k.shape[-2], hidden, num_heads,
            int(time), int(relu), float(dh) ** -0.5, splits, chunk,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("decode-attention kernel launch failed: CUDA "
                           "error %d" % err)
    return out


# ---------------------------------------------------------------------------
# plain versions (written from zero_tpu/ops/attention.py:_attn_core and
# _ancestry_attn)
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k, v, time: int, num_heads: int):
    """Plain PyTorch ``decode_attention``."""
    launches["decode_attention_ref"] += 1
    b, lq, hidden = q.shape
    t_max = k.shape[1]
    dh = hidden // num_heads
    qh = q.reshape(b, lq, num_heads, dh).transpose(1, 2) * (dh ** -0.5)
    kh = k.reshape(b, t_max, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, t_max, num_heads, dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()
    keep = torch.arange(t_max, device=q.device) <= time
    logits = torch.where(keep, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.matmul(weights, vh)                        # [B, H, 1, dh]
    return o.transpose(1, 2).reshape(b, lq, hidden)


def decode_pool_attention_ref(q, k, v, ancestry, time: int, num_heads: int,
                              relu: bool = False):
    """Plain PyTorch ``decode_pool_attention``: gather each beam's history
    by ``ancestry``, then single-query attention over positions <= time."""
    launches["decode_pool_attention%s_ref" % _mode(relu)] += 1
    b, beams, hidden = q.shape
    t_max = k.shape[2]
    dh = hidden // num_heads
    idx = ancestry.long()[..., None]                     # [B, K, T, 1]
    kg = torch.take_along_dim(k, idx, dim=1).reshape(b, beams, t_max,
                                                     num_heads, dh)
    vg = torch.take_along_dim(v, idx, dim=1).reshape(b, beams, t_max,
                                                     num_heads, dh)
    qh = q.reshape(b, beams, num_heads, dh) * (dh ** -0.5)
    logits = torch.einsum("bihd,bithd->biht", qh, kg).float()
    keep = torch.arange(t_max, device=q.device) <= time
    if relu:
        weights = torch.relu(logits * keep.float())
    else:
        weights = torch.softmax(torch.where(keep, logits, NEG_INF), dim=-1)
    o = torch.einsum("biht,bithd->bihd", weights.to(q.dtype), vg)
    return o.reshape(b, beams, hidden)


def decode_cross_attention_ref(q, mk, mv, mask, num_heads: int):
    """Plain PyTorch ``decode_cross_attention``: each beam's query
    attends over its batch row's memory under the pad mask."""
    launches["decode_cross_attention_ref"] += 1
    b, beams, hidden = q.shape
    s_len = mk.shape[1]
    dh = hidden // num_heads
    qh = q.reshape(b, beams, num_heads, dh) * (dh ** -0.5)
    kh = mk.reshape(b, s_len, num_heads, dh)
    vh = mv.reshape(b, s_len, num_heads, dh)
    logits = torch.einsum("bihd,bshd->bhis", qh, kh).float()
    logits = torch.where(mask[:, None, None, :] > 0, logits, CROSS_NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhis,bshd->bihd", weights, vh)
    return o.reshape(b, beams, hidden)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, time: int, num_heads: int):
    """Single-step masked attention over the static decode cache.

    q: [B, 1, hidden]; k, v: [B, T, hidden] caches already holding this
    step's entries at position ``time``; attends over positions <= time.
    Returns [B, 1, hidden] in the query dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, time, num_heads)
    if not q.is_cuda:
        raise ValueError("decode_attention: unsupported device %s" % q.device)
    _check(q, k, v, time, num_heads, "decode_attention")
    b, hidden = q.shape[0], q.shape[2]
    if q.shape[1] != 1 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != b or k.shape[2] != hidden:
        raise ValueError("decode_attention: need q [B, 1, hidden] and k, v "
                         "[B, T, hidden]; got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    out = _launch("decode_attention", q, k, v, None, b, 1, num_heads, time,
                  False)
    launches["decode_attention"] += 1
    return out


def decode_pool_attention(q, k, v, ancestry, time: int, num_heads: int,
                          relu: bool = False):
    """Ancestry-selected single-step attention over unpermuted beam pools.

    q: [B, K, hidden] beam queries; k, v: [B, K, T, hidden] pools already
    holding this step's entries at ``time``; ancestry: [B, K, T] int32
    pool-row indices in [0, K) with column ``time`` set to identity.
    Attends over positions <= time. relu=True switches the softmax for
    ReLA's unnormalised relu weights. Returns [B, K, hidden].
    """
    if q.device.type == "cpu":
        return decode_pool_attention_ref(q, k, v, ancestry, time, num_heads,
                                         relu=relu)
    if not q.is_cuda:
        raise ValueError("decode_pool_attention: unsupported device %s"
                         % q.device)
    _check(q, k, v, time, num_heads, "decode_pool_attention")
    b, beams, hidden = q.shape
    if k.shape != v.shape or k.dim() != 4 \
            or (k.shape[0], k.shape[1], k.shape[3]) != (b, beams, hidden) \
            or tuple(ancestry.shape) != (b, beams, k.shape[2]):
        raise ValueError("decode_pool_attention: need q [B, K, hidden], k, v "
                         "[B, K, T, hidden], ancestry [B, K, T]; got %s, %s, "
                         "%s, %s" % (tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape), tuple(ancestry.shape)))
    if ancestry.dtype != torch.int32 or not ancestry.is_contiguous() \
            or ancestry.device != q.device:
        raise ValueError("decode_pool_attention: ancestry must be a "
                         "contiguous int32 tensor on %s" % q.device)
    out = _launch("decode_pool_attention", q, k, v, ancestry, b * beams,
                  beams, num_heads, time, relu)
    launches["decode_pool_attention%s" % _mode(relu)] += 1
    return out


def _mode(relu: bool) -> str:
    """The pool kernel's counter suffix: "_relu" in ReLA's relu mode."""
    return "_relu" if relu else ""


def cross_splits(blocks: int, s_len: int, sms: int):
    """(splits, chunk) of the cross kernel's memory axis: ``blocks`` (B x
    heads x beam groups) over ``s_len`` positions, about
    CROSS_BLOCKS_PER_SM blocks per SM, chunks a multiple of 32.
    ``scripts/decode_split_sweep.py --kernel cross`` times the kernel
    against the target."""
    return _splits(blocks, s_len, sms, CROSS_BLOCKS_PER_SM, CROSS_MIN_CHUNK,
                   32)


def decode_cross_attention(q, mk, mv, mask, num_heads: int):
    """Beam-folded one-step cross attention over precomputed memory
    projections.

    q: [B, beams, hidden] (beam queries folded per batch row, the layout of
    ops/attention.py:cross_attn_step); mk, mv: [B, S, hidden]; mask: [B, S]
    1/0 pad mask. Returns [B, beams, hidden] in the query dtype.
    """
    if q.device.type == "cpu":
        return decode_cross_attention_ref(q, mk, mv, mask, num_heads)
    if not q.is_cuda:
        raise ValueError("decode_cross_attention: unsupported device %s"
                         % q.device)
    if not (q.dtype == mk.dtype == mv.dtype and q.dtype in _DTYPES):
        raise ValueError("decode_cross_attention: q/mk/mv must share one "
                         "dtype of %s, got %s/%s/%s" % (
                             list(_DTYPES), q.dtype, mk.dtype, mv.dtype))
    if not (q.device == mk.device == mv.device == mask.device):
        raise ValueError("decode_cross_attention: inputs on different "
                         "devices")
    b, beams, hidden = q.shape
    if q.dim() != 3 or mk.shape != mv.shape or mk.dim() != 3 \
            or (mk.shape[0], mk.shape[2]) != (b, hidden) \
            or tuple(mask.shape) != tuple(mk.shape[:2]):
        raise ValueError("decode_cross_attention: need q [B, beams, hidden], "
                         "mk, mv [B, S, hidden], mask [B, S]; got %s, %s, %s,"
                         " %s" % (tuple(q.shape), tuple(mk.shape),
                                  tuple(mv.shape), tuple(mask.shape)))
    if hidden % num_heads or hidden // num_heads > MAX_HEAD_DIM \
            or mk.shape[1] < 1 or b > 2 ** 31 - 1 or num_heads > 65535:
        raise ValueError("decode_cross_attention: hidden %d / heads %d must "
                         "split evenly into heads of depth <= %d, over S >= 1"
                         % (hidden, num_heads, MAX_HEAD_DIM))
    q, mk, mv = q.contiguous(), mk.contiguous(), mv.contiguous()
    pad = mask.float().contiguous()
    out = torch.empty_like(q)
    s_len, dh = mk.shape[1], hidden // num_heads
    splits, chunk = cross_splits(
        b * num_heads * -(-beams // CROSS_BEAMS_PER_BLOCK), s_len,
        _sms(q.device))
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b, num_heads, splits, beams, dh),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, num_heads, splits, beams, 2),
                              dtype=torch.float32, device=q.device)
    taken["decode_cross_attention"] = splits
    with torch.cuda.device(q.device):
        err = _cross_library()(
            q.data_ptr(), mk.data_ptr(), mv.data_ptr(), pad.data_ptr(),
            out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            _DTYPES[q.dtype], b, beams, s_len, hidden, num_heads,
            float(dh) ** -0.5, splits, chunk,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("decode cross-attention kernel launch failed: "
                           "CUDA error %d" % err)
    launches["decode_cross_attention"] += 1
    return out
