"""zero_tpu_torch attention dropout: one row-seeded mask family for every
attention route (kernels #1-#7 and their plain versions). Element (row
r = (b*H + h)*Lq + i, key j) keeps iff hash(j, hash(r, s0, s1), s1) is
below the 32-bit threshold, so no index over B*H*Lq*Lk wraps at 2^32. The
tests compute only the rows they look at: none allocates 2^32 elements."""

import pytest

torch = pytest.importorskip("torch")

from zero_tpu_torch.ops import common  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import streaming_attention as sa  # noqa: E402

WORDS = (0x243F6A88, 0x85A308D3)
RATE = 0.1


def test_fused_mask_is_the_streaming_rows_mask():
    shape = (2, 3, 5, 7)
    b, h, lq, lk = shape
    want = sa.keep_mask(WORDS, b * h, lq, range(lq), lk, RATE)
    assert torch.equal(fa.keep_mask(WORDS, shape, RATE),
                       want.reshape(shape))


def _linear_index_mask(bh: int, rows, lq: int, lk: int) -> torch.Tensor:
    """The rule #1-#4 once used: the u32 linear index ((bh*Lq + i)*Lk + j)
    through ``_hash_bits``' finalizer, for the given rows of slab bh."""
    s0, s1 = WORDS
    idx = ((bh * lq + torch.tensor(list(rows), dtype=torch.int64))[:, None]
           * lk + torch.arange(lk, dtype=torch.int64)[None]) & 0xFFFFFFFF
    x = common._mix32(idx ^ s0, 0x85EBCA6B)
    x = common._mix32(x, 0xC2B2AE35)
    return (x ^ (x >> 16) ^ s1) < sa.dropout_threshold(RATE)


def test_head_slabs_two_to_the_32_elements_apart_draw_their_own_masks():
    """At Lq = Lk = 8192, head slab 64 starts 64 * 8192 * 8192 = 2^32
    elements after slab 0, so the linear index gave both one mask (the
    fault this rule closes). The row-seeded rule gives them their own; two
    rows of each are drawn."""
    lq = lk = 8192
    rows = range(0, 2)
    old0 = _linear_index_mask(0, rows, lq, lk)
    old64 = _linear_index_mask(64, rows, lq, lk)
    assert torch.equal(old0, old64)
    new = sa.keep_mask(WORDS, 65, lq, rows, lk, RATE)
    assert not torch.equal(new[0], new[64])
    for slab in (new[0], new[64]):
        assert abs(slab.float().mean().item() - (1 - RATE)) < 0.01


def test_fused_and_streaming_plain_versions_drop_the_same_weights():
    """The same inputs and seed words through the fused route's plain
    version and the streaming route's: one mask family, so one output."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 9, 8, generator=gen) for _ in range(3))
    pad = torch.ones(2, 9)
    pad[1, 6:] = 0
    for causal in (False, True):
        fused = fa.fused_attention_ref(q, k, v, pad, causal, RATE, WORDS)
        stream = sa.streaming_attention_ref(q, k, v, pad, causal, RATE,
                                            WORDS)
        torch.testing.assert_close(fused, stream, rtol=1e-6, atol=1e-6)
