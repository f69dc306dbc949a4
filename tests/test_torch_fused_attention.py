"""zero_tpu_torch fused attention (kernels #1/#2): the plain version
against the JAX package's Pallas kernel (interpret mode) and its XLA
equivalent, forward and gradients, the dropout mask it shares with the
CUDA kernels, the rule that picks the backward kernel, the causal mask
rule it keeps where the streaming route differs, and the route of keys past
its limit. The CUDA kernels are held to the plain version on the card by
chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu_torch.ops import attention as attention_mod  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import streaming_attention as sa  # noqa: E402

# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 3, 2, 16

# (Lq, Lk, causal, pad rows): causal self-attention; self-attention under a
# pad mask with an all-pad row; cross attention with Lq != Lk
CASES = {"causal": (8, 8, True, False),
         "pad_all_pad_row": (8, 8, False, True),
         "cross": (6, 10, False, True)}


def _inputs(lq, lk, padded, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k = rs.randn(B, H, lk, D).astype(np.float32)
    v = rs.randn(B, H, lk, D).astype(np.float32)
    do = rs.randn(B, H, lq, D).astype(np.float32)
    pad = np.ones((B, lk), np.float32)
    if padded:
        pad[0, lk - 3:] = 0
        pad[1] = 0          # an all-pad batch row
    return q, k, v, pad, do


def _jax_out_and_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out,) + vjp(jnp.asarray(do))]


def _port_out_and_grads(q, k, v, pad, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.fused_attention(qt, kt, vt, torch.from_numpy(pad),
                             causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    return [x.detach().numpy() for x in (out,) + grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_pallas_kernel_in_interpret_mode(case, monkeypatch):
    lq, lk, causal, padded = CASES[case]
    q, k, v, pad, do = _inputs(lq, lk, padded)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    want = _jax_out_and_grads(
        lambda q, k, v: jfa.fused_attention(q, k, v, jnp.asarray(pad),
                                            causal=causal), q, k, v, do)
    got = _port_out_and_grads(q, k, v, pad, do, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_xla_equivalent(case):
    lq, lk, causal, padded = CASES[case]
    q, k, v, pad, do = _inputs(lq, lk, padded, seed=1)
    want = _jax_out_and_grads(
        lambda q, k, v: jfa._xla_equivalent(q, k, v, jnp.asarray(pad),
                                            causal, 0.0, None), q, k, v, do)
    got = _port_out_and_grads(q, k, v, pad, do, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_all_pad_row_gets_uniform_weights_and_no_dq_dk():
    """A row with no valid key: output = mean of V, dv its uniform share,
    dq and dk zero (the TPU kernel's fully-masked-row semantics)."""
    q, k, v, pad, do = _inputs(8, 8, True, seed=2)
    out, dq, dk, dv = _port_out_and_grads(q, k, v, pad, do, False)
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), **TOL)
    assert not dq[1].any() and not dk[1].any()
    np.testing.assert_allclose(dv[1], np.broadcast_to(
        do[1].sum(axis=1, keepdims=True) / 8, dv[1].shape), **TOL)


def test_causal_all_pad_row_keeps_the_fused_rule(monkeypatch):
    """Causal, Lq = Lk = 8, batch row 1 all padding. In the fused kernels
    (and the JAX kernel's _scores) keys past a row exist, masked at -1e30,
    so that row's weights are uniform over all 8 keys: its output is the
    mean of V over every key and its dv is dO summed over the rows / 8,
    with zero dq and dk; the plain version matches the Pallas kernel. The
    streaming route drops keys past a row, so there row i averages keys
    0..i instead: the tensor-core backward takes the rule as an argument."""
    q, k, v, pad, do = _inputs(8, 8, True, seed=4)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    want = _jax_out_and_grads(
        lambda q, k, v: jfa.fused_attention(q, k, v, jnp.asarray(pad),
                                            causal=True), q, k, v, do)
    got = _port_out_and_grads(q, k, v, pad, do, True)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    out, dq, dk, dv = got
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), **TOL)
    np.testing.assert_allclose(dv[1], np.broadcast_to(
        do[1].sum(axis=1, keepdims=True) / 8, dv[1].shape), **TOL)
    assert not dq[1].any() and not dk[1].any()
    stream = sa.streaming_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v, pad)), causal=True).numpy()
    np.testing.assert_allclose(stream[1], np.cumsum(v[1], axis=1) / np.arange(
        1, 9)[None, :, None], **TOL)


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 16, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 40, "cuda_cores"),
    (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 64, "cuda_cores")])
def test_backward_route(dtype, dh, route):
    """The streaming route's rule for the backward on the card: bf16 at a
    head depth the tensor-core kernels take (a multiple of 16 up to 128)
    runs them; fp32, which must stay exact, and other depths keep the
    CUDA-core kernel. (The CPU takes the plain version before a route is
    asked.)"""
    assert fa.backward_route(dtype, dh) == route


WORDS = (0x243F6A88, 0x85A308D3)


def test_dropout_keep_rate_within_binomial_bound():
    rate = 0.1
    shape = (4, 4, 64, 64)
    keep = fa.keep_mask(WORDS, shape, rate)
    n = keep.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(keep.sum().item() - n * (1 - rate)) < 5 * sigma
    # another pair of words draws another mask
    other = fa.keep_mask((1, 2), shape, rate)
    assert 0.7 < (keep == other).float().mean().item() < 0.95


def test_dropout_forward_and_backward_share_the_mask():
    """Identity probe: with q = k = 0 every valid weight is 1/Lk, so with
    one-hot values the output reveals the forward's mask, and with one-hot
    output gradients dv reveals the backward's; both equal keep_mask."""
    lq = lk = dh = 16
    rate = 0.25
    q = torch.zeros(2, 2, lq, dh, requires_grad=True)
    k = torch.zeros(2, 2, lk, dh, requires_grad=True)
    v = torch.eye(lk, dh).expand(2, 2, lk, dh).clone().requires_grad_()
    pad = torch.ones(2, lk)
    out = fa.fused_attention(q, k, v, pad, dropout_rate=rate, rng=WORDS)
    do = torch.eye(lq, dh).expand(2, 2, lq, dh)
    (dv,) = torch.autograd.grad(out, (v,), do)
    keep = fa.keep_mask(WORDS, (2, 2, lq, lk), rate)
    scale = 1.0 / (1.0 - rate) / lk
    assert torch.equal(out.detach() > 0, keep)
    assert torch.equal(dv.transpose(-1, -2) > 0, keep)
    torch.testing.assert_close(out.detach(), keep.float() * scale)


def test_dropout_off_without_seed_words():
    q, k, v, pad, _ = _inputs(8, 8, False)
    args = [torch.from_numpy(x) for x in (q, k, v, pad)]
    plain = fa.fused_attention(*args)
    torch.testing.assert_close(
        fa.fused_attention(*args, dropout_rate=0.3, rng=None), plain)


def test_long_keys_raise_naming_the_streaming_kernels():
    """Keys past the fused kernels' MAX_LK go to the streaming kernels
    (#5-#7; their plain version on the CPU), which the port once refused;
    the result equals the composite attention."""
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    gen = torch.Generator().manual_seed(0)
    lin = attention_mod.init_attention(gen, 8, 8, self_attention=False)
    x = torch.randn(1, 2, 8, generator=gen)
    mem = torch.randn(1, fa.MAX_LK + 1, 8, generator=gen)
    pad = torch.ones(1, fa.MAX_LK + 1)
    pad[0, -5:] = 0
    sa.launches.clear()
    fa.launches.clear()
    got = attention_mod.attn_train(lin, x, mem, None, 2, use_flash=True,
                                   pad_mask=pad)["output"]
    assert sa.launches["streaming_attention_ref"] == 1
    assert not any(fa.launches.values())
    want = attention_mod.attn_train(lin, x, mem, pad[:, None, None, :],
                                    2)["output"]
    torch.testing.assert_close(got, want, **TOL)
