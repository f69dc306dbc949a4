"""zero_tpu_torch cross-attention decode (#9): the plain version
``decode_cross_attention_ref`` against the JAX package's Pallas kernel
(interpret mode) in bf16, the dtype the kernel serves in, and in fp32 with
a batch row whose memory is fully masked (it averages all S positions). The
CUDA kernel is held to the plain version on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import decode_attention as jda  # noqa: E402
from zero_tpu_torch.ops.kernels import decode_attention as da  # noqa: E402

# 5 beams (more than the kernel's 4 beams a block), 4 heads of 16, S 40
B, BEAMS, H, S, D = 3, 5, 4, 40, 16
HIDDEN = H * D
# bf16 on both sides: both round the weights to bf16 before the product
# with V, in other orders; within 1e-2 + 1e-2 * max as the other bf16
# checks against the Pallas kernels. fp32: only the summation order
# differs.
BF16_TOL = 1e-2
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, masked_row):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, BEAMS, HIDDEN).astype(np.float32)
    mk = rs.randn(B, S, HIDDEN).astype(np.float32)
    mv = rs.randn(B, S, HIDDEN).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[0, 29:] = 0
    if masked_row:
        mask[2] = 0
    return q, mk, mv, mask


def test_bf16_ref_matches_jax_kernel():
    q, mk, mv, mask = _inputs(3, masked_row=False)
    want = jda.decode_cross_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, mk, mv)),
        jnp.asarray(mask), H, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = da.decode_cross_attention_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, mk, mv)),
        torch.from_numpy(mask), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL + BF16_TOL * np.abs(want).max())


def test_fully_masked_row_averages_every_position():
    """_cross_kernel's masked logit is -1e30, not -inf: a batch row whose
    memory is all padding gets uniform weights 1/S, so each beam's output
    is the mean of that row's values; the plain version keeps that rule."""
    q, mk, mv, mask = _inputs(4, masked_row=True)
    want = np.asarray(jda.decode_cross_attention(
        *map(jnp.asarray, (q, mk, mv, mask)), H, interpret=True))
    got = da.decode_cross_attention_ref(*map(torch.from_numpy,
                                             (q, mk, mv, mask)), H).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    np.testing.assert_allclose(got[2], np.broadcast_to(
        mv[2].mean(axis=0), (BEAMS, HIDDEN)), **FP32_TOL)
