"""zero_tpu_torch fused FFN (kernels #11/#12) and the counter-hash dropout:
the plain version against the JAX package's Pallas kernel (interpret mode)
with dropout off, forward and all five gradients; with dropout on, against
the JAX composite ``ffn`` under the same key words (bit-identical masks);
``_hash_bits`` and ``dropout`` bit-exact to ``zero_tpu/ops/common.py``. The
CUDA kernels are held to the plain version on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import nn as jnn  # noqa: E402
from zero_tpu.ops.kernels import fused_ffn as jff  # noqa: E402
from zero_tpu_torch.ops import common  # noqa: E402
from zero_tpu_torch.ops import nn  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_ffn as ff  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _words(key):
    w = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(w[0]), int(w[-1])


def _params(seed, d_in, f, d_out):
    rs = np.random.RandomState(seed)
    return {"enlarge": {"ws": [rs.randn(d_in, f).astype(np.float32) * 0.1],
                        "b": rs.randn(f).astype(np.float32) * 0.1},
            "output": {"ws": [rs.randn(f, d_out).astype(np.float32) * 0.1],
                       "b": rs.randn(d_out).astype(np.float32) * 0.1}}


def _flat(p):
    return [p["enlarge"]["ws"][0], p["enlarge"]["b"], p["output"]["ws"][0],
            p["output"]["b"]]


def test_ref_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """Dropout off: forward and dx, dW1, db1, dW2, db2 (the TPU kernel
    takes N, widths multiples of 128)."""
    n, d_in, f, d_out = 128, 128, 256, 128
    p = _params(0, d_in, f, d_out)
    rs = np.random.RandomState(1)
    x = rs.randn(n, d_in).astype(np.float32)
    dy = rs.randn(n, d_out).astype(np.float32)
    monkeypatch.setattr(jff, "INTERPRET", True)

    def jfn(x, w1, b1, w2, b2):
        params = {"enlarge": {"ws": [w1], "b": b1},
                  "output": {"ws": [w2], "b": b2}}
        y = jff.fused_ffn(params, x)
        assert y is not None
        return y

    args = [jnp.asarray(a) for a in [x] + _flat(p)]
    out, vjp = jax.vjp(jfn, *args)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    targs = [torch.from_numpy(a).requires_grad_() for a in [x] + _flat(p)]
    y = ff.fused_ffn(*targs)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(dy))
    got = [y.detach().numpy()] + [g.numpy() for g in grads]
    for name, g, w in zip(("y", "dx", "dW1", "db1", "dW2", "db2"), got,
                          want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_ref_with_dropout_matches_jax_composite_ffn(rate):
    """Same key words -> the kernel's mask is the composite's, bit for
    bit, and the outputs agree (odd sizes: no tiling assumption)."""
    b, l, d_in, f, d_out = 3, 5, 24, 40, 16
    p = _params(2, d_in, f, d_out)
    x = np.random.RandomState(3).randn(b, l, d_in).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jp = jax.tree.map(jnp.asarray, p)
    want = np.asarray(jnn.ffn(jp, jnp.asarray(x), key, rate))

    words = _words(key)
    got = ff.fused_ffn(torch.from_numpy(x), *map(torch.from_numpy, _flat(p)),
                       words, rate)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    t = common.keep_threshold(rate)
    jkeep = np.asarray((jcommon._hash_bits(key, (b, l, f))
                        & jnp.uint32(255)) < jnp.uint32(t))
    keep = ((common._hash_bits(words, (b * l, f)) & 255) < t).numpy()
    np.testing.assert_array_equal(keep.reshape(b, l, f), jkeep)


def test_port_ffn_routes_agree():
    """ops/nn.py:ffn fused and composite give the same output and draw the
    same mask."""
    gen = torch.Generator().manual_seed(0)
    params = nn.init_ffn(gen, 16, 48, 16)
    with torch.no_grad():
        params.enlarge.b.normal_(generator=gen)
    x = torch.randn(2, 7, 16, generator=gen)
    words = (123, 456)
    torch.testing.assert_close(nn.ffn(params, x, words, 0.2, fused=True),
                               nn.ffn(params, x, words, 0.2), **TOL)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (2, 4, 8, 16)])
def test_hash_bits_bit_exact(shape):
    key = jax.random.PRNGKey(5)
    want = np.asarray(jcommon._hash_bits(key, shape)).astype(np.int64)
    got = common._hash_bits(_words(key), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_bit_exact(dtype, rate):
    key = jax.random.PRNGKey(9)
    x = np.random.RandomState(4).randn(6, 33).astype(np.float32)
    want = np.asarray(jcommon.dropout(key, jnp.asarray(x, dtype), rate)
                      .astype(jnp.float32))
    got = common.dropout(_words(key), torch.from_numpy(x).to(
        getattr(torch, dtype)), rate).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_off_cases():
    x = torch.randn(4, 5)
    assert common.dropout(None, x, 0.1) is x
    assert common.dropout((1, 2), x, 0.0) is x
    assert common.dropout((1, 2), x, None) is x
    assert common.RngGen(None)() is None
    gen = common.RngGen(torch.Generator().manual_seed(0))
    a, b = gen(), gen()
    assert a != b and all(0 <= w < 2 ** 32 for w in a + b)
