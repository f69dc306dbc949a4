"""zero_tpu_torch RPR forward (#3) on the tensor cores: the route and the
launch counter the forward takes, and the algebra of the kernel's walk
(``zt::tc::forward_tc`` under the ``Rpr`` policy, csrc/zt_attention_tc.cuh)
mirrored in fp32 PyTorch and held to the JAX package's Pallas RPR kernel in
interpret mode and to the plain version ``fused_attention_rpr_ref``. The
CUDA kernel runs only on the card, where chip_smoke.py holds it to the plain
version."""

import contextlib
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu_torch.ops import rpr  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402

# fp32 on every side; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 2, 8
ROWS = KEYS = 64          # the kernel's query block and key tile
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("device,dtype,dh,counter", [
    ("cpu", torch.bfloat16, 64, "fused_attention_rpr_ref"),
    ("cpu", torch.float32, 64, "fused_attention_rpr_ref"),
    ("cuda", torch.bfloat16, 16, "fused_attention_rpr_tc"),
    ("cuda", torch.bfloat16, 64, "fused_attention_rpr_tc"),
    ("cuda", torch.bfloat16, 80, "fused_attention_rpr_tc"),
    ("cuda", torch.bfloat16, 128, "fused_attention_rpr_tc"),
    ("cuda", torch.bfloat16, 40, "fused_attention_rpr"),
    ("cuda", torch.float32, 64, "fused_attention_rpr")])
def test_rpr_forward_route(device, dtype, dh, counter, monkeypatch):
    """The RPR forward takes forward_route's route, as the backward does:
    the plain version on the CPU; on the card the tensor-core #3 (entry
    zt_attention_rpr_forward_tc, counter fused_attention_rpr_tc) in bf16 at
    a head depth that is a multiple of 16 up to 128, the CUDA-core #3 in
    fp32 and at other depths. The card's side runs the autograd function's
    forward against a stand-in library that records which entry it got."""
    m, lq = 2, 8
    q = torch.zeros(1, 1, lq, dh, dtype=dtype)
    tk = torch.zeros(2 * m + 1, dh, dtype=dtype)
    pad = torch.ones(1, lq)
    fa.launches.clear()
    if device == "cpu":
        out = fa.fused_attention(q, q, q, pad,
                                 rpr_tables=rpr.RprTables(tk, tk),
                                 max_relative_position=m)
        assert out.dtype == dtype
    else:
        calls = []

        def entry(i):
            def call(*args):
                calls.append(i)
                return 0
            return call

        monkeypatch.setattr(fa, "_rpr_library",
                            lambda: tuple(entry(i) for i in range(4)))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: types.SimpleNamespace(
                                cuda_stream=0))
        route = fa.forward_route(dtype, dh, device)
        fa._FusedAttentionRpr.apply(q, q, q, pad, tk, tk, m, 0, False, 0.0,
                                    (0, 0), route)
        assert calls == [fa._RPR_FORWARD[route][0]]
        assert calls == [3 if counter.endswith("_tc") else 0]
    assert dict(fa.launches) == {counter: 1}


def _mirror(q, k, v, pad, tk, tv, m, causal, rate=0.0, words=None):
    """The tensor-core #3's walk in fp32: (o, row max, row sum) as the
    kernel writes them. Per (batch, head) and 64-row block: qr = q.Tk^T in
    64-bucket steps; a causal block stops at the diagonal tile unless its
    first row has no valid key; per 64-key tile the scores S + qr, the
    online softmax, O += P_drop.V, the edge buckets' sums of P_drop as row
    sums rescaled by alpha with l, and an interior bucket's one key leaving
    its score in the qr scratch (+inf if masked); after the walk the
    interior buckets exponentiated against the final max and dropped by
    their key's keep bit, O += wb.Tv in 64-bucket steps, o = O / l."""
    lq, lk, r = q.shape[2], k.shape[2], 2 * m + 1
    scale = q.shape[-1] ** -0.5
    sl2 = scale * LOG2E
    masked_log2 = torch.tensor(fa.NEG_INF * LOG2E, dtype=torch.float32)
    keep_all = (fa.keep_mask(words, (B, H, lq, lk), rate) if rate
                else torch.ones(B, H, lq, lk, dtype=torch.bool))
    drop_scale = 1.0 / (1.0 - rate)
    o = torch.zeros_like(q)
    mx = torch.zeros(B, H, lq)
    lx = torch.zeros(B, H, lq)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, lq, ROWS):
                i = torch.arange(q0, min(q0 + ROWS, lq))
                qb = q[b, h, i]
                qr = torch.cat([qb @ tk[c0:c0 + KEYS].T
                                for c0 in range(0, r, KEYS)], 1)
                scratch = qr.clone()
                k_end = min(lk, q0 + ROWS) if causal else lk
                if causal and not (pad[b, :min(q0, lk - 1) + 1] > 0).any():
                    k_end = lk
                tiles = -(-k_end // KEYS)
                mrow = torch.full((len(i),), fa.NEG_INF)
                lrow = torch.zeros(len(i))
                wlo = torch.zeros(len(i))
                whi = torch.zeros(len(i))
                acc = torch.zeros(len(i), q.shape[-1])
                for t in range(tiles):
                    j = torch.arange(t * KEYS, min(t * KEYS + KEYS, lk))
                    c = (i[:, None] - j[None]).clamp(-m, m) + m
                    s = qb @ k[b, h, j].T + qr.gather(1, c)
                    valid = (pad[b, j] > 0)[None].expand(len(i), -1)
                    if causal:
                        valid = valid & (j[None] <= i[:, None])
                    smax = torch.where(valid, s, -math.inf).amax(1)
                    m_new = torch.maximum(mrow, smax * scale)
                    ml_new = m_new * LOG2E
                    alpha = torch.exp2(mrow * LOG2E - ml_new)
                    w = torch.where(valid,
                                    torch.exp2(s * sl2 - ml_new[:, None]),
                                    torch.exp2(masked_log2 - ml_new)[:, None])
                    keep = keep_all[b, h][i][:, j]
                    wd = torch.where(keep, w * drop_scale, 0.0)
                    lrow = lrow * alpha + w.sum(1)
                    wlo = wlo * alpha + torch.where(c == 0, wd, 0.0).sum(1)
                    whi = whi * alpha + torch.where(
                        (c == 2 * m) & (c != 0), wd, 0.0).sum(1)
                    inner = (c > 0) & (c < 2 * m)
                    u = torch.where(valid, s, math.inf)
                    scratch[inner.nonzero(as_tuple=True)[0],
                            c[inner]] = u[inner]
                    acc = acc * alpha[:, None] + wd @ v[b, h, j]
                    mrow = m_new
                ml = mrow * LOG2E
                cs = torch.arange(r)
                jj = i[:, None] - cs[None] + m
                reached = (jj >= 0) & (jj < min(lk, tiles * KEYS))
                kept = keep_all[b, h][i].gather(1, jj.clamp(0, lk - 1))
                e = torch.where(scratch == math.inf,
                                (masked_log2 - ml)[:, None],
                                scratch * sl2 - ml[:, None])
                wb = torch.where(reached & kept,
                                 torch.exp2(e) * drop_scale, 0.0)
                wb[:, 0] = wlo
                if m:
                    wb[:, 2 * m] = whi
                for c0 in range(0, r, KEYS):
                    acc = acc + wb[:, c0:c0 + KEYS] @ tv[c0:c0 + KEYS]
                o[b, h, i] = acc / lrow[:, None]
                mx[b, h, i] = mrow
                lx[b, h, i] = lrow
    return o, mx, lx


def _stats(q, k, pad, tk, m, causal):
    """The row max and sum the backward #4 reads, from the whole score
    matrix: m over the valid keys (-1e30 on a row with none), l the sum of
    exp(s - m) over all Lk keys, masked ones at -1e30."""
    lq, lk = q.shape[2], k.shape[2]
    s = rpr.logits_with_rpr_onehot(q * q.shape[-1] ** -0.5, k, tk, m)
    valid = (pad > 0)[:, None, None, :].expand(-1, -1, lq, -1)
    if causal:
        valid = valid & torch.ones(lq, lk, dtype=torch.bool).tril()
    s = torch.where(valid, s, fa.NEG_INF)
    mx = s.amax(-1)
    return mx, torch.exp(s - mx[..., None]).sum(-1)


# (Lq, Lk, m, causal, all-pad batch row): causal self-attention whose
# batch row 1 is all padding, off the 64-row and 64-key tiles, with tiles
# in the band and on both sides of it; cross attention Lq != Lk; m = 40,
# whose R = 81 buckets take two 64-bucket steps
CASES = {"causal_all_pad_136": (136, 136, 3, True, True),
         "cross_40x150": (40, 150, 4, False, False),
         "wide_band_m40": (96, 96, 40, False, False)}


def _inputs(lq, lk, m, pad_row, seed):
    rs = np.random.RandomState(seed)
    args = [rs.randn(B, H, n, D).astype(np.float32) for n in (lq, lk, lk)]
    args += [rs.randn(2 * m + 1, D).astype(np.float32) for _ in range(2)]
    pad = np.ones((B, lk), np.float32)
    pad[0, lk - 5:] = 0
    if pad_row:
        pad[1] = 0
    return args, pad


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_pallas_rpr_kernel_and_plain_version(case,
                                                           monkeypatch):
    """The walk's fold (edge sums rescaled by alpha, interior buckets from
    stored scores against the final max, wb.Tv after the walk) gives the
    Pallas RPR kernel's output (interpret mode) and the plain version's,
    and the m and l that the backward rebuilds the weights from."""
    lq, lk, m, causal, pad_row = CASES[case]
    assert fa.rpr_supported(lq, lk, m)
    args, pad = _inputs(lq, lk, m, pad_row, seed=21)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    want = np.asarray(jfa.fused_attention(
        *map(jnp.asarray, args[:3]), jnp.asarray(pad), causal=causal,
        rpr_tables={"keys": jnp.asarray(args[3]),
                    "values": jnp.asarray(args[4])},
        max_relative_position=m))
    q, k, v, tk, tv = map(torch.from_numpy, args)
    pad_t = torch.from_numpy(pad)
    got, mx, lx = _mirror(q, k, v, pad_t, tk, tv, m, causal)
    ref = fa.fused_attention_rpr_ref(q, k, v, pad_t, tk, tv, m, causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    m_ref, l_ref = _stats(q, k, pad_t, tk, m, causal)
    np.testing.assert_allclose(mx.numpy(), m_ref.numpy(), **TOL)
    np.testing.assert_allclose(lx.numpy(), l_ref.numpy(), **TOL)
    if pad_row:
        # the all-pad row averages all Lk keys: l = Lk, m = -1e30
        assert (mx[1] == fa.NEG_INF).all() and torch.allclose(
            lx[1], torch.full_like(lx[1], float(lk)))


WORDS = (0x243F6A88, 0x85A308D3)


def test_mirror_with_dropout_matches_plain_version():
    """With dropout on, the mirror draws the kernels' row-seeded mask: the
    edge sums, the interior buckets (dropped keys stored at -inf) and O all
    take the dropped weights, as the plain version does."""
    lq, lk, m, causal, pad_row = CASES["causal_all_pad_136"]
    args, pad = _inputs(lq, lk, m, pad_row, seed=22)
    q, k, v, tk, tv = map(torch.from_numpy, args)
    pad_t = torch.from_numpy(pad)
    got = _mirror(q, k, v, pad_t, tk, tv, m, causal, 0.1, WORDS)[0]
    ref = fa.fused_attention_rpr_ref(q, k, v, pad_t, tk, tv, m, causal, 0.1,
                                     WORDS)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_mirror_at_m0_matches_the_xla_path_and_plain_version(monkeypatch):
    """m = 0: one bucket, which every key falls in, so the score term is a
    per-row constant and the value term is Tv[0]: the output is attention
    without RPR plus Tv[0]. The walk (every key in edge bucket 0) gives it,
    as the JAX package's XLA path and the plain version do. (The Pallas RPR
    kernel's lane-roll skew departs from its own XLA path at m = 0, so it is
    not the reference here.)"""
    lq, lk, m, causal, pad_row = 40, 150, 0, False, False
    args, pad = _inputs(lq, lk, m, pad_row, seed=23)
    monkeypatch.setattr(jfa, "INTERPRET", False)
    want = np.asarray(jfa.fused_attention(
        *map(jnp.asarray, args[:3]), jnp.asarray(pad), causal=causal,
        rpr_tables={"keys": jnp.asarray(args[3]),
                    "values": jnp.asarray(args[4])},
        max_relative_position=m))
    q, k, v, tk, tv = map(torch.from_numpy, args)
    pad_t = torch.from_numpy(pad)
    got = _mirror(q, k, v, pad_t, tk, tv, m, causal)[0]
    ref = fa.fused_attention_rpr_ref(q, k, v, pad_t, tk, tv, m, causal)
    plain = fa.fused_attention_ref(q, k, v, pad_t, causal) + tv[0]
    for other in (want, ref.numpy(), plain.numpy()):
        np.testing.assert_allclose(got.numpy(), other, **TOL)
