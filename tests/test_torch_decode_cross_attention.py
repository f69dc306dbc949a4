"""zero_tpu_torch beam-folded cross-attention decode kernel (#9): the plain
version against the JAX package's Pallas kernel (interpret mode), and the
wrapper's dispatch. Neither package wires it into cross_attn_step; the
CUDA kernel is held to the plain version on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import decode_attention as jda  # noqa: E402
from zero_tpu_torch.ops import attention as attention_mod  # noqa: E402
from zero_tpu_torch.ops.kernels import decode_attention as da  # noqa: E402

# both sides are fp32 on the CPU; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py's shapes: B 3, beams 4, 4 heads of 16, S 24
B, BEAMS, H, S, D = 3, 4, 4, 24, 16
HIDDEN = H * D


def _inputs(seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, BEAMS, HIDDEN).astype(np.float32)
    mk = rs.randn(B, S, HIDDEN).astype(np.float32)
    mv = rs.randn(B, S, HIDDEN).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[0, 17:] = 0
    mask[2, 5:] = 0
    return q, mk, mv, mask


def test_decode_cross_attention_ref_matches_jax_kernel():
    q, mk, mv, mask = _inputs(1)
    want = jda.decode_cross_attention(jnp.asarray(q), jnp.asarray(mk),
                                      jnp.asarray(mv), jnp.asarray(mask), H,
                                      interpret=True)
    got = da.decode_cross_attention_ref(*map(torch.from_numpy,
                                             (q, mk, mv, mask)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_dispatches_cpu_tensors_and_matches_cross_attn_step_math():
    """On the CPU the wrapper is the plain version (one plain call, no
    launch), which equals the composite _attn_core that cross_attn_step
    runs over the same beam-folded queries."""
    q, mk, mv, mask = map(torch.from_numpy, _inputs(2))
    da.launches.clear()
    got = da.decode_cross_attention(q, mk, mv, mask, H)
    assert dict(da.launches) == {"decode_cross_attention_ref": 1}
    want, _ = attention_mod._attn_core(q, mk, mv, mask[:, None, None, :], H)
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_cross_attention(q.to("meta"), mk.to("meta"), mv.to("meta"),
                                  mask.to("meta"), H)


@pytest.mark.parametrize("blocks,s_len,want_splits", [
    (32 * 8, 64, 1),        # MT decode: B*heads blocks fill the card
    (4 * 8, 16384, 9),      # long memory at B 4: about 2 blocks per SM
    (8, 300, 1),            # each split holds at least 256 positions
    (8, 600, 2),
])
def test_cross_splits_cover_the_memory_in_tiles(blocks, s_len, want_splits):
    splits, chunk = da.cross_splits(blocks, s_len, 132)
    assert splits == want_splits
    assert chunk % 32 == 0 and (splits - 1) * chunk < s_len <= splits * chunk
    assert splits == 1 or chunk >= da.CROSS_MIN_CHUNK
