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

Both run one CUDA kernel (``csrc/decode_attention.cu``; its header explains
the design). Bound on the card: device-memory bytes -- the K and V head
slices of the selected rows of positions <= ``time``, plus the query, the
ancestry entries and the output, over the card's bandwidth (3.35 TB/s on
an H100 SXM). The operations (4 per K/V element pair) are ~2 per byte
read, far below the ~295 flops/byte where the tensor cores would bound it.
The kernel reads each selected element once and gathers pool rows by the
ancestry index directly, where the TPU kernel made K masked passes over
every pool row.

Dispatch: a CUDA tensor launches the kernel, or raises when the kernel
does not take the input; a CPU tensor goes to the plain version
(``decode_attention_ref``/``decode_pool_attention_ref``), which the CPU
tests compare with the JAX package. Nothing on the main path calls a
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

# the kernel keeps one head slice per lane group (<= 256 elements) and the
# (time+1) fp32 weights in shared memory (<= 40 KB of the 48 KB static
# limit); the wrappers raise outside these bounds
MAX_HEAD_DIM = 256
MAX_POSITIONS = 10240
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches ("decode_attention", "decode_pool_attention") and calls
# of the plain versions ("decode_attention_ref", "decode_pool_attention_ref")
launches: collections.Counter = collections.Counter()


def build() -> str:
    """Compile ``csrc/decode_attention.cu`` for sm_90a unless its library
    is built already (``cuda_build``); returns the library path."""
    return cuda_build.build("decode_attention")["decode_attention"]


@functools.lru_cache(maxsize=None)
def _library():
    fn = cuda_build.load("decode_attention").zt_single_query_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
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


def _launch(q, k, v, ancestry, rows, beams, num_heads, time, relu):
    out = torch.empty_like(q)
    hidden = q.shape[-1]
    with torch.cuda.device(q.device):
        err = _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if ancestry is None else ancestry.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], rows, beams, k.shape[-2],
            hidden, num_heads, int(time), int(relu),
            float(hidden // num_heads) ** -0.5,
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
    launches["decode_pool_attention_ref"] += 1
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
    out = _launch(q, k, v, None, b, 1, num_heads, time, False)
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
    out = _launch(q, k, v, ancestry, b * beams, beams, num_heads, time, relu)
    launches["decode_pool_attention"] += 1
    return out
