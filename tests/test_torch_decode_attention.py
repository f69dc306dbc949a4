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


@pytest.mark.parametrize("blocks,n,want_splits", [
    (32 * 4 * 8, 114, 1),   # beam-4 MT decode (B 32, 8 heads): one launch
    (32 * 8, 114, 1),       # beam 1
    (2 * 4 * 8, 8192, 9),   # B 2 beam 4 over 8192 positions: ~4 blocks/SM
    (2 * 8, 8192, 32),      # beam 1: each split at least 256 positions
    (8, 300, 1),
    (8, 600, 2),
])
def test_decode_splits_cover_the_positions(blocks, n, want_splits):
    splits, chunk = da.decode_splits(blocks, n, 132)
    assert splits == want_splits
    assert chunk % 64 == 0 and (splits - 1) * chunk < n <= splits * chunk
    assert splits == 1 or chunk >= da.DECODE_MIN_CHUNK


# fp32 sums of up to 700 positions in another order: relative to the
# largest output
SPLIT_TOL = 1e-5


def _chunks(n, chunk):
    return [(t0, min(n, t0 + chunk)) for t0 in range(0, n, chunk)]


def test_split_fold_by_running_maxima_matches_jax_kernel():
    """The split kernel's algebra: each chunk of the planner's split
    attends its own positions (the plain version over the chunk), and the
    chunks fold by their maxima, o = sum_c e^(m_c - M) l_c o_c / sum_c
    e^(m_c - M) l_c; that equals the JAX kernel over all positions."""
    b, t = 2, 700
    time = t - 1
    splits, chunk = da.decode_splits(b * H, time + 1, 132)
    assert splits == 2
    q, k, v = _inputs(7, (b, 1, HIDDEN), (b, t, HIDDEN), (b, t, HIDDEN))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    qh = qt.reshape(b, H, D) * D ** -0.5
    num = den = big = None
    parts = []
    for t0, t1 in _chunks(time + 1, chunk):
        o = da.decode_attention_ref(qt, kt[:, t0:t1], vt[:, t0:t1],
                                    t1 - 1 - t0, H).reshape(b, H, D)
        s = torch.einsum("bhd,bthd->bht", qh,
                         kt[:, t0:t1].reshape(b, t1 - t0, H, D))
        m = s.max(dim=-1).values
        parts.append((o, m, torch.exp(s - m[..., None]).sum(dim=-1)))
    big = torch.stack([m for _, m, _ in parts]).max(dim=0).values
    num = sum(torch.exp(m - big)[..., None] * l[..., None] * o
              for o, m, l in parts)
    den = sum(torch.exp(m - big) * l for _, m, l in parts)
    got = (num / den[..., None]).reshape(b, 1, HIDDEN).numpy()
    want = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), time, H,
                                           interpret=True))
    np.testing.assert_allclose(got, want, rtol=SPLIT_TOL,
                               atol=SPLIT_TOL * np.abs(want).max())


def test_relu_pool_split_folds_by_sum_matches_jax_kernel():
    """ReLA's unnormalised weights: the chunks of the planner's split add
    up (no maxima), each the plain pool version over its positions."""
    b, t, time = 1, 700, 650
    splits, chunk = da.decode_splits(b * K * H, time + 1, 132)
    assert splits == 2
    q, k, v = _inputs(8, (b, K, HIDDEN), (b, K, t, HIDDEN),
                      (b, K, t, HIDDEN))
    anc = np.random.RandomState(9).randint(0, K, (b, K, t)).astype(np.int32)
    anc[:, :, time] = np.arange(K, dtype=np.int32)[None, :]
    qt, kt, vt, at = map(torch.from_numpy, (q, k, v, anc))
    got = sum(da.decode_pool_attention_ref(
        qt, kt[:, :, t0:t1], vt[:, :, t0:t1], at[:, :, t0:t1], t1 - 1 - t0,
        H, relu=True) for t0, t1 in _chunks(time + 1, chunk)).numpy()
    want = np.asarray(jda.decode_pool_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
        time, H, relu=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=SPLIT_TOL,
                               atol=SPLIT_TOL * np.abs(want).max())
