"""zero_tpu_torch RPR fused attention (kernels #3/#4): the plain version
``fused_attention_rpr_ref`` against the JAX package's Pallas RPR kernel in
interpret mode, output and the five gradients (dq, dk, dv, dTk, dTv); the
dropout mask it shares with the CUDA kernels, whose bucket sums run over the
dropped weights; and the wrapper's limits. The CUDA kernels are held to the
plain version on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu_torch.ops import rpr  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402

# fp32 on both sides; only the summation order differs. Grads relative to
# their largest element.
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
B, H, D = 2, 2, 8

# (Lq, Lk, m, causal, all-pad row, MAX_BLOCK_SCORE_ELEMS of the JAX kernel)
CASES = {"pad_L16": (16, 16, 4, False, False, None),
         "causal": (16, 16, 3, True, False, None),
         "all_pad_row": (16, 16, 4, True, True, None),
         "multi_qblock": (32, 32, 5, True, False, 8 * 32),
         "cross_8x32": (8, 32, 3, False, False, None),
         "wide_band_m7": (16, 16, 7, False, False, None)}


def _inputs(lq, lk, m, pad_row, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k = rs.randn(B, H, lk, D).astype(np.float32)
    v = rs.randn(B, H, lk, D).astype(np.float32)
    tk = rs.randn(2 * m + 1, D).astype(np.float32)
    tv = rs.randn(2 * m + 1, D).astype(np.float32)
    do = rs.randn(B, H, lq, D).astype(np.float32)
    pad = np.ones((B, lk), np.float32)
    pad[0, lk - 3:] = 0
    if pad_row:
        pad[1] = 0          # an all-pad batch row
    return (q, k, v, tk, tv), pad, do


def _port(args, pad, do, m, causal, rate=0.0, words=None):
    q, k, v, tk, tv = (torch.from_numpy(x).requires_grad_() for x in args)
    tables = rpr.RprTables(tk, tv)
    out = fa.fused_attention(q, k, v, torch.from_numpy(pad), causal=causal,
                             dropout_rate=rate, rng=words,
                             rpr_tables=tables, max_relative_position=m)
    grads = torch.autograd.grad(out, (q, k, v, tables.keys, tables.values),
                                torch.from_numpy(do))
    return [x.detach().numpy() for x in (out,) + grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_pallas_rpr_kernel_in_interpret_mode(case, monkeypatch):
    lq, lk, m, causal, pad_row, block = CASES[case]
    args, pad, do = _inputs(lq, lk, m, pad_row)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    if block:
        monkeypatch.setattr(jfa, "MAX_BLOCK_SCORE_ELEMS", block)
        assert jfa._pick_block(lq, lk) < lq    # more than one q-block

    def fn(q, k, v, tk, tv):
        return jfa.fused_attention(q, k, v, jnp.asarray(pad), causal=causal,
                                   rpr_tables={"keys": tk, "values": tv},
                                   max_relative_position=m)

    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    want = [np.asarray(x) for x in (out,) + vjp(jnp.asarray(do))]
    got = _port(args, pad, do, m, causal)
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dTk", "dTv"), got[1:],
                          want[1:]):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_all_pad_row_feeds_dtv_but_not_dq_dk_dtk():
    """A row with no valid key gets uniform weights 1/Lk: its output is the
    mean of V plus the mean of its Tv rows, dTv gets its share, and ds is
    zero there, so dq, dk and dTk get nothing from it."""
    lq = lk = 12
    m = 2
    args, pad, do = _inputs(lq, lk, m, True, seed=1)
    pad[0] = 0               # both rows all-pad
    q, k, v, tk, tv = args
    out, dq, dk, dv, dtk, dtv = _port(args, pad, do, m, False)
    ids = rpr.relative_positions_matrix(lq, lk, m).numpy()
    mean_tv = tv[ids].mean(axis=1)                       # [Lq, D]
    np.testing.assert_allclose(out, v.mean(axis=2, keepdims=True) + mean_tv,
                               **OUT_TOL)
    assert not dq.any() and not dk.any() and not dtk.any()
    # dTv[c] = sum over rows of (bucket share of the row) * do_i
    share = np.stack([(ids == c).sum(axis=1) for c in range(2 * m + 1)]) / lk
    want = np.einsum("ci,bhid->cd", share, do)
    np.testing.assert_allclose(dtv, want, **OUT_TOL)


WORDS = (0x243F6A88, 0x85A308D3)


def test_dropout_mask_is_shared_and_bucket_sums_are_dropped():
    """Identity probe: with q = k = Tk = 0 every valid weight is 1/Lk. With
    one-hot values and Tv = 0 the output shows the forward's mask; with
    one-hot output grads dv shows the backward's; both equal keep_mask. dTv
    then equals the bucket sums of the DROPPED weights against do."""
    lq = lk = dh = 16
    m, rate = 3, 0.25
    q = torch.zeros(2, 2, lq, dh, requires_grad=True)
    k = torch.zeros(2, 2, lk, dh, requires_grad=True)
    v = torch.eye(lk, dh).expand(2, 2, lk, dh).clone().requires_grad_()
    tables = rpr.RprTables(torch.zeros(2 * m + 1, dh),
                           torch.zeros(2 * m + 1, dh))
    out = fa.fused_attention(q, k, v, torch.ones(2, lk), dropout_rate=rate,
                             rng=WORDS, rpr_tables=tables,
                             max_relative_position=m)
    do = torch.eye(lq, dh).expand(2, 2, lq, dh)
    dv, dtv = torch.autograd.grad(out, (v, tables.values), do)
    keep = fa.keep_mask(WORDS, (2, 2, lq, lk), rate)
    scale = 1.0 / (1.0 - rate) / lk
    assert torch.equal(out.detach() > 0, keep)
    assert torch.equal(dv.transpose(-1, -2) > 0, keep)
    torch.testing.assert_close(out.detach(), keep.float() * scale)
    onehot = torch.nn.functional.one_hot(
        rpr.relative_positions_matrix(lq, lk, m), 2 * m + 1).float()
    wb = torch.einsum("bhik,ikc->bhic", keep.float() * scale, onehot)
    torch.testing.assert_close(dtv, torch.einsum("bhic,bhid->cd", wb, do))


def test_rpr_needs_max_relative_position():
    x = torch.zeros(1, 1, 4, 8)
    tables = rpr.RprTables(torch.zeros(3, 8), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="max_relative_position"):
        fa.fused_attention(x, x, x, rpr_tables=tables)


@pytest.mark.parametrize("m,shape,ok", [(64, (129, 8), True),
                                        (65, (131, 8), False),
                                        (3, (7, 16), False),
                                        (3, (5, 8), False)])
def test_kernel_limits_on_relative_position_and_tables(m, shape, ok):
    """The CUDA wrapper's checks: m <= 64 (R <= 129 buckets in shared
    memory), tables [2m+1, Dh]."""
    q = torch.zeros(1, 1, 4, 8)
    table = torch.zeros(shape)
    if ok:
        fa._check_rpr(q, table, table, m)
    else:
        with pytest.raises(ValueError):
            fa._check_rpr(q, table, table, m)


@pytest.mark.parametrize("lq,lk,m,want", [(8, 7, 3, True), (8, 6, 3, False),
                                          (256, 8192, 16, True),
                                          (4, 8193, 16, False)])
def test_rpr_supported_is_the_jax_rule(lq, lk, m, want):
    assert fa.rpr_supported(lq, lk, m) == want
    assert jfa.rpr_supported(lq, lk, m) == want
