"""zero_tpu_torch streaming attention (kernels #5-#7): the plain version
against the JAX package's Pallas kernels (interpret mode), forward and
gradients; rows whose keys are all padded, where the port follows softmax
and the TPU kernel does not; the dropout mask the plain version shares with
the CUDA kernels; the route of ``attn_train`` past ``fa.MAX_LK``; and the
rule that picks the kernels (tensor cores, CUDA cores or the plain
version). The CUDA kernels are held to the plain version on the card by
chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu.ops.kernels import streaming_attention as jsa  # noqa: E402
from zero_tpu_torch.ops import attention as attention_mod  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import streaming_attention as sa  # noqa: E402

# fp32 on both sides, only the summation order differs: outputs within 1e-5,
# grads within 1e-4 of their max
OUT_TOL = 1e-5
GRAD_TOL = 1e-4

# (B, H, Lq, Lk, causal): the JAX kernel tiles 384 x 384 as a 3 x 3 grid of
# 128-blocks (above-diagonal blocks skipped), 16 x 384 as 1 x 3
CASES = {"causal_384": (1, 1, 384, 384, True),
         "cross_16x384": (2, 2, 16, 384, False)}


# bf16 on both sides: the Pallas kernel rounds its weights and products to
# bf16 where the plain version keeps fp32 until the output (8 mantissa bits),
# so outputs and grads agree within 1e-2 + 1e-2 * max, as the fused FFN's
# bf16 parity test allows
BF16_TOL = 1e-2


def _inputs(b, h, lq, lk, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, lq, 8).astype(np.float32)
    k = rs.randn(b, h, lk, 8).astype(np.float32)
    v = rs.randn(b, h, lk, 8).astype(np.float32)
    do = rs.randn(b, h, lq, 8).astype(np.float32)
    pad = np.ones((b, lk), np.float32)
    pad[0, 300:] = 0
    return q, k, v, pad, do


def _jax_out_and_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out,) + vjp(jnp.asarray(do))]


def _port_out_and_grads(q, k, v, pad, do, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = sa.streaming_attention(qt, kt, vt, torch.from_numpy(pad),
                                 causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (out,) + grads]


def _close(name, got, want, tol):
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (name, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_pallas_kernel_in_interpret_mode(case, monkeypatch):
    """The cross case pads batch row 1 entirely; its upstream gradient is
    zero there, as in the model (padded keys reach nothing), since the TPU
    kernel's backward differs from softmax on such a row (next test)."""
    b, h, lq, lk, causal = CASES[case]
    q, k, v, pad, do = _inputs(b, h, lq, lk, seed=0)
    if not causal:
        pad[1] = 0
        do[1] = 0
    assert jsa.supported(lq, lk)
    bq, bk = jsa._blocks(lq, lk)
    assert lk // bk > 1          # more than one key block streams
    monkeypatch.setattr(jsa, "INTERPRET", True)
    want = _jax_out_and_grads(
        lambda q, k, v: jsa.streaming_attention(q, k, v, jnp.asarray(pad),
                                                causal=causal), q, k, v, do)
    got = _port_out_and_grads(q, k, v, pad, do, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(name, g, w, OUT_TOL if name == "out" else GRAD_TOL)


def test_bf16_ref_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """The bf16 inputs the tensor-core backward takes: the cross case (its
    batch row 1 all padding, with a zero upstream gradient there, as
    above) through the Pallas kernel in bf16 and through the plain version
    (fp32 inside, bf16 out), outputs and grads within 1e-2 + 1e-2 * max."""
    b, h, lq, lk, causal = CASES["cross_16x384"]
    q, k, v, pad, do = _inputs(b, h, lq, lk, seed=4)
    pad[1] = 0
    do[1] = 0
    monkeypatch.setattr(jsa, "INTERPRET", True)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, vjp = jax.vjp(
        lambda q, k, v: jsa.streaming_attention(q, k, v, jnp.asarray(pad),
                                                causal=causal), *bf[:3])
    want = [np.asarray(x.astype(jnp.float32))
            for x in (out,) + vjp(bf[3])]
    got = _port_out_and_grads(q, k, v, pad, do, causal, torch.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= BF16_TOL + BF16_TOL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("device,dtype,dh,route", [
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 64, "plain"),
    ("cuda", torch.bfloat16, 64, "tensor_cores"),
    ("cuda", torch.bfloat16, 16, "tensor_cores"),
    ("cuda", torch.bfloat16, 128, "tensor_cores"),
    ("cuda", torch.bfloat16, 40, "cuda_cores"),
    ("cuda", torch.bfloat16, 256, "cuda_cores"),
    ("cuda", torch.float32, 64, "cuda_cores")])
def test_backward_route(device, dtype, dh, route):
    """``route`` picks the forward and the backward together: bf16 at a
    head depth the tensor-core kernels take (a multiple of 16 up to 128)
    runs them; fp32, which must stay exact, and other depths keep the
    CUDA-core kernels; the CPU takes the plain version."""
    assert sa.route(device, dtype, dh) == route


def test_fully_masked_row_follows_softmax_not_the_tpu_kernel(monkeypatch):
    """B = 2, Lk = 128, row 1 all padding, a random dO. The JAX kernel
    rebuilds the backward weights from lse = m + log l, which rounds to
    -1e30 there: weight 1 instead of 1/Lk, so its dq, dk and dv of that row
    are far off. The port keeps m and l apart and gives what softmax (the
    JAX package's _xla_equivalent) gives: zero dq and dk, dv = 1/Lk of dO's
    row sum."""
    lk = 128
    q, k, v, pad, do = _inputs(2, 1, lk, lk, seed=3)
    pad[0] = 1
    pad[1] = 0
    pad_j = jnp.asarray(pad)
    xla = _jax_out_and_grads(
        lambda q, k, v: jfa._xla_equivalent(q, k, v, pad_j, False, 0.0,
                                            None), q, k, v, do)
    monkeypatch.setattr(jsa, "INTERPRET", True)
    kern = _jax_out_and_grads(
        lambda q, k, v: jsa.streaming_attention(q, k, v, pad_j), q, k, v, do)
    port = _port_out_and_grads(q, k, v, pad, do, False)
    for name, p, x in zip(("out", "dq", "dk", "dv"), port, xla):
        _close(name, p, x, GRAD_TOL)
    out, dq, dk, dv = port
    assert not dq[1].any() and not dk[1].any()
    np.testing.assert_allclose(dv[1], np.broadcast_to(
        do[1].sum(axis=1, keepdims=True) / lk, dv[1].shape), rtol=1e-5,
        atol=1e-6)
    # the interpreted TPU kernel: row 0 agrees, row 1 does not
    for name, kk, x in zip(("out", "dq", "dk", "dv"), kern, xla):
        _close(name + "[row 0]", kk[0], x[0], GRAD_TOL)
    assert np.abs(kern[1][1]).max() > 1.0          # dq where softmax has 0
    assert np.abs(kern[2][1]).max() > 1.0          # dk
    assert np.abs(kern[3][1] - xla[3][1]).max() > 1.0   # dv ~Lk too large


WORDS = (0x243F6A88, 0x85A308D3)


def test_dropout_keep_rate_and_row_seeded_bits():
    rate = 0.1
    keep = sa.keep_mask(WORDS, 4, 64, range(0, 64), 256, rate)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.01
    # rows of one call agree with the same rows drawn in another chunking
    part = sa.keep_mask(WORDS, 4, 64, range(17, 40), 256, rate)
    assert torch.equal(part, keep[:, 17:40])
    # 64-bit safe: at L = 16384 head 16's element (i, j) has the linear
    # index of head 0's modulo 2^32; it still draws its own bits
    wide = sa.keep_mask(WORDS, 17, 16384, range(0, 2), 16384, rate)
    assert not torch.equal(wide[16], wide[0])


def test_dropout_forward_and_backward_share_the_mask():
    """Identity probe: with q = k = 0 every weight is 1/Lk, so one-hot
    values reveal the forward's mask in the output and one-hot output
    gradients the backward's in dv; both equal keep_mask. Chunks of 5 rows
    draw the same bits as one pass."""
    lq = lk = dh = 16
    rate = 0.25
    q = torch.zeros(2, 2, lq, dh, requires_grad=True)
    k = torch.zeros(2, 2, lk, dh, requires_grad=True)
    v = torch.eye(lk, dh).expand(2, 2, lk, dh).clone().requires_grad_()
    pad = torch.ones(2, lk)
    out = sa.streaming_attention_ref(q, k, v, pad, False, rate, WORDS,
                                     chunk=5)
    do = torch.eye(lq, dh).expand(2, 2, lq, dh)
    (dv,) = torch.autograd.grad(out, (v,), do)
    keep = sa.keep_mask(WORDS, 4, lq, range(lq), lk, rate).reshape(
        2, 2, lq, lk)
    assert torch.equal(out.detach() > 0, keep)
    assert torch.equal(dv.transpose(-1, -2) > 0, keep)
    torch.testing.assert_close(out.detach(),
                               keep.float() / (1.0 - rate) / lk)
    torch.testing.assert_close(
        sa.streaming_attention(q, k, v, pad, dropout_rate=rate, rng=WORDS),
        out)


def test_long_keys_route_to_streaming_and_rpr_to_the_composite(monkeypatch):
    """With fa.MAX_LK lowered to 16, attn_train sends 24 keys to the
    streaming kernels (one plain call on the CPU) and 16 to the fused
    ones; RPR past the limit takes the composite _attn_core, as in JAX."""
    monkeypatch.setattr(fa, "MAX_LK", 16)
    gen = torch.Generator().manual_seed(0)
    lin = attention_mod.init_attention(gen, 8, 8, self_attention=False)
    x = torch.randn(2, 3, 8, generator=gen)
    tables = attention_mod.init_rpr_tables(gen, 8, 2, 2)
    for lk, kernel in ((24, "streaming_attention_ref"),
                       (16, "fused_attention_ref")):
        mem = torch.randn(2, lk, 8, generator=gen)
        sa.launches.clear()
        fa.launches.clear()
        got = attention_mod.attn_train(lin, x, mem, None, 2, use_flash=True,
                                       pad_mask=torch.ones(2, lk))["output"]
        counts = {**sa.launches, **fa.launches}
        assert {n: c for n, c in counts.items() if c} == {kernel: 1}
        keep = torch.ones(2, 1, 1, lk)
        want = attention_mod.attn_train(lin, x, mem, keep, 2)["output"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        # RPR: the fused RPR kernel up to the limit, the composite past it
        fa.launches.clear()
        sa.launches.clear()
        attention_mod.attn_train(lin, x, mem, keep, 2, use_flash=True,
                                 pad_mask=torch.ones(2, lk),
                                 rpr_tables=tables, max_relative_position=2)
        counts = {n: c for n, c in {**sa.launches, **fa.launches}.items()
                  if c}
        assert counts == ({} if lk > 16 else {"fused_attention_rpr_ref": 1})
