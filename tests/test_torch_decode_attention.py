"""zero_tpu_torch decode-attention kernels: the plain versions against the
JAX package's Pallas kernels (interpret mode), and the wrappers' device
dispatch. The CUDA kernels are held to the plain versions on the card by
chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import decode_attention as jda  # noqa: E402
from zero_tpu_torch.ops.kernels import decode_attention as da  # noqa: E402

# both sides are fp32 on the CPU; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
H, D, T, K = 4, 16, 24, 4
HIDDEN = H * D


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _anc_eff(seed, b, time):
    """Random ancestry with the identity column at ``time``, as
    self_attn_step hands it to the kernel."""
    anc = np.random.RandomState(seed).randint(0, K, (b, K, T)).astype(np.int32)
    anc[:, :, time] = np.arange(K, dtype=np.int32)[None, :]
    return anc


@pytest.mark.parametrize("time", [0, 7, T - 1])
def test_decode_attention_ref_matches_jax_kernel(time):
    q, k, v = _inputs(1, (3, 1, HIDDEN), (3, T, HIDDEN), (3, T, HIDDEN))
    want = jda.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), time, H, interpret=True)
    got = da.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), time, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("time", [0, 11, T - 1])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_decode_pool_attention_ref_matches_jax_kernel(b, time, relu):
    """B = 1, 4, 8 take the JAX kernel's three row-grouping paths
    (rows per program 1, 4, 8)."""
    q, k, v = _inputs(2, (b, K, HIDDEN), (b, K, T, HIDDEN),
                      (b, K, T, HIDDEN))
    anc = _anc_eff(3, b, time)
    want = jda.decode_pool_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
        time, H, relu=relu, interpret=True)
    got = da.decode_pool_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(anc), time, H, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_dispatch_cpu_tensors_to_plain_versions():
    q, k, v = _inputs(4, (2, 1, HIDDEN), (2, T, HIDDEN), (2, T, HIDDEN))
    qp, kp, vp = _inputs(5, (2, K, HIDDEN), (2, K, T, HIDDEN),
                         (2, K, T, HIDDEN))
    anc = torch.from_numpy(_anc_eff(6, 2, 5))
    before = dict(da.launches)
    o = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 5, H)
    op = da.decode_pool_attention(torch.from_numpy(qp), torch.from_numpy(kp),
                                  torch.from_numpy(vp), anc, 5, H)
    ref = da.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 5, H)
    ref_p = da.decode_pool_attention_ref(
        torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(vp),
        anc, 5, H)
    assert torch.equal(o, ref) and torch.equal(op, ref_p)
    delta = {n: da.launches[n] - before.get(n, 0) for n in da.launches}
    assert delta.get("decode_attention", 0) == 0
    assert delta.get("decode_pool_attention", 0) == 0
    assert delta["decode_attention_ref"] == 2
    assert delta["decode_pool_attention_ref"] == 2


def test_wrappers_reject_other_devices():
    """A tensor neither on the CPU nor on a CUDA card gets no plain-version
    fallback."""
    q = torch.empty((2, 1, HIDDEN), device="meta")
    k = torch.empty((2, T, HIDDEN), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(q, k, k, 3, H)
    qp = torch.empty((2, K, HIDDEN), device="meta")
    kp = torch.empty((2, K, T, HIDDEN), device="meta")
    anc = torch.zeros((2, K, T), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_pool_attention(qp, kp, kp, anc, 3, H)
