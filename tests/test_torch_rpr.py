"""zero_tpu_torch Shaw relative positions (ops/rpr.py and the RPR parts of
ops/attention.py) against zero_tpu's, fp32 on the CPU: distance ids, the
one-hot and gathered forms (forward and grads), ``_attn_core`` in both
forms, the training route of ``attn_train`` and the three decode paths
(plain cache, ancestry pools, cross attention)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import bridge, t  # noqa: E402
from zero_tpu.ops import attention as jattn  # noqa: E402
from zero_tpu.ops import rpr as jrpr  # noqa: E402
from zero_tpu_torch.ops import attention as attn  # noqa: E402
from zero_tpu_torch.ops import rpr  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402

# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 2, 8
HIDDEN = H * D


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("lq,lk,m", [(5, 5, 2), (3, 9, 4), (9, 4, 1)])
def test_distance_ids_match_jax(lq, lk, m):
    np.testing.assert_array_equal(
        rpr.relative_positions_matrix(lq, lk, m).numpy(),
        np.asarray(jrpr.relative_positions_matrix(lq, lk, m)))
    for time in (0, 3, lk + 2):
        np.testing.assert_array_equal(
            rpr.relative_positions_row(time, lk, m).numpy(),
            np.asarray(jrpr.relative_positions_row(time, lk, m)))
    assert rpr.onehot_supported(lq, lk, m) == jrpr.onehot_supported(lq, lk, m)


@pytest.mark.parametrize("form", ["onehot", "gathered"])
def test_rpr_forms_match_jax_with_grads(form):
    """logits_with_rpr* and output_with_rpr* of each form, forward and the
    grads of every input (tables included), against the JAX module."""
    rs = np.random.RandomState(0)
    lq, lk, m = 6, 7, 2
    q, k = _rand(rs, B, H, lq, D), _rand(rs, B, H, lk, D)
    v, w = _rand(rs, B, H, lk, D), _rand(rs, B, H, lq, lk)
    tk, tv = _rand(rs, 2 * m + 1, D), _rand(rs, 2 * m + 1, D)
    ids = np.asarray(jrpr.relative_positions_matrix(lq, lk, m))

    def jfn(q, k, v, w, tk, tv):
        if form == "onehot":
            return (jrpr.logits_with_rpr_onehot(q, k, tk, m),
                    jrpr.output_with_rpr_onehot(w, v, tv, m))
        return (jrpr.logits_with_rpr(q, k, jrpr.gather_embeddings(tk, ids)),
                jrpr.output_with_rpr(w, v, jrpr.gather_embeddings(tv, ids)))

    def pfn(q, k, v, w, tk, tv):
        if form == "onehot":
            return (rpr.logits_with_rpr_onehot(q, k, tk, m),
                    rpr.output_with_rpr_onehot(w, v, tv, m))
        pids = t(ids)
        return (rpr.logits_with_rpr(q, k, rpr.gather_embeddings(tk, pids)),
                rpr.output_with_rpr(w, v, rpr.gather_embeddings(tv, pids)))

    args = (q, k, v, w, tk, tv)
    douts = (_rand(rs, B, H, lq, lk), _rand(rs, B, H, lq, D))
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    jgrads = vjp(tuple(map(jnp.asarray, douts)))
    pargs = [t(x).requires_grad_() for x in args]
    pout = pfn(*pargs)
    pgrads = torch.autograd.grad(pout, pargs, [t(x) for x in douts])
    for name, got, want in zip(("logits", "output"), pout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    for name, got, want in zip(("q", "k", "v", "w", "tk", "tv"), pgrads,
                               jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, rtol=1e-5, atol=1e-4)


def test_onehot_equals_gathered():
    rs = np.random.RandomState(1)
    lq, lk, m = 5, 8, 3
    q, k = t(_rand(rs, B, H, lq, D)), t(_rand(rs, B, H, lk, D))
    v, w = t(_rand(rs, B, H, lk, D)), t(_rand(rs, B, H, lq, lk))
    tk, tv = t(_rand(rs, 2 * m + 1, D)), t(_rand(rs, 2 * m + 1, D))
    ids = rpr.relative_positions_matrix(lq, lk, m)
    torch.testing.assert_close(
        rpr.logits_with_rpr_onehot(q, k, tk, m),
        rpr.logits_with_rpr(q, k, rpr.gather_embeddings(tk, ids)), **TOL)
    torch.testing.assert_close(
        rpr.output_with_rpr_onehot(w, v, tv, m),
        rpr.output_with_rpr(w, v, rpr.gather_embeddings(tv, ids)), **TOL)


def test_rpr_tables_are_named_keys_and_values():
    tables = attn.init_rpr_tables(torch.Generator().manual_seed(0), HIDDEN,
                                  H, 3)
    assert sorted(n for n, _ in tables.named_parameters()) == ["keys",
                                                               "values"]
    assert tables.keys.shape == tables.values.shape == (7, D)


def _tables(rs, m):
    tk, tv = _rand(rs, 2 * m + 1, D), _rand(rs, 2 * m + 1, D)
    return ({"keys": jnp.asarray(tk), "values": jnp.asarray(tv)},
            rpr.RprTables(t(tk), t(tv)))


@pytest.mark.parametrize("form", ["onehot", "gathered"])
def test_attn_core_with_rpr_matches_jax(form):
    """rpr_max selects the one-hot form; rpr_ids alone the gathered one."""
    rs = np.random.RandomState(2)
    lq, lk, m = 6, 9, 2
    q, k, v = (_rand(rs, B, n, HIDDEN) for n in (lq, lk, lk))
    keep = np.ones((B, 1, lq, lk), np.float32)
    keep[0, :, :, 6:] = 0
    keep[1] = 0                 # an all-pad batch row
    jtab, ptab = _tables(rs, m)
    if form == "onehot":
        jkw, pkw = dict(rpr_max=m), dict(rpr_max=m)
    else:
        ids = np.asarray(jrpr.relative_positions_matrix(lq, lk, m))
        jkw, pkw = dict(rpr_ids=jnp.asarray(ids)), dict(rpr_ids=t(ids))
    jo, jw = jattn._attn_core(*map(jnp.asarray, (q, k, v, keep)), H,
                              rpr_tables=jtab, **jkw)
    po, pw = attn._attn_core(*map(t, (q, k, v, keep)), H, rpr_tables=ptab,
                             **pkw)
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(pw.detach().numpy(), np.asarray(jw), **TOL)


def _attention(self_attention, seed=3):
    """A JAX attention block and its port counterpart on the same
    weights."""
    jp = jattn.init_attention(jax.random.PRNGKey(seed), HIDDEN, HIDDEN,
                              self_attention)
    p = attn.init_attention(torch.Generator(), HIDDEN, HIDDEN, self_attention)
    return jp, bridge(jp, p)


@pytest.mark.parametrize("lk,pad,causal,kernel", [
    (7, True, False, True),     # 2m < Lk: the RPR kernel (plain version)
    (4, True, False, False),    # Lk <= 2m: the composite
    (7, False, False, False),   # no causal flag and no pad mask: composite
    (7, False, True, True)])
def test_attn_train_rpr_route_and_jax_parity(lk, pad, causal, kernel):
    """use_flash with RPR takes the kernel exactly where the JAX package
    does (_rpr_flash_ok), and either route equals the JAX composite."""
    rs = np.random.RandomState(4)
    m = 2
    jp, p = _attention(True)
    x = _rand(rs, B, lk, HIDDEN)
    pad_mask = np.ones((B, lk), np.float32)
    pad_mask[0, lk - 1:] = 0
    keep = pad_mask[:, None, None, :] if pad else np.ones((1, 1, 1, lk),
                                                          np.float32)
    if causal:
        keep = keep * np.tril(np.ones((lk, lk), np.float32))[None, None]
    jtab, ptab = _tables(rs, m)
    kw = dict(max_relative_position=m, causal=causal)
    want = jattn.attn_train(jp, jnp.asarray(x), None, jnp.asarray(keep), H,
                            rpr_tables=jtab,
                            pad_mask=jnp.asarray(pad_mask) if pad else None,
                            **kw)["output"]
    fa.launches.clear()
    got = attn.attn_train(p, t(x), None, t(keep), H, rpr_tables=ptab,
                          use_flash=True,
                          pad_mask=t(pad_mask) if pad else None, **kw)
    assert fa.launches["fused_attention_rpr_ref"] == int(kernel)
    assert (got["weights"] is None) == kernel
    np.testing.assert_allclose(got["output"].detach().numpy(),
                               np.asarray(want), **TOL)


def test_self_attn_step_with_rpr_matches_jax():
    """Single-beam decode: the distance row of step ``time`` on the plain
    cache path; use_flash stays off the decode kernel under RPR."""
    rs = np.random.RandomState(5)
    m, t_max = 2, 8
    jp, p = _attention(True)
    jtab, ptab = _tables(rs, m)
    jcache = jattn.init_self_cache(B, t_max, HIDDEN, jnp.float32)
    cache = attn.init_self_cache(B, t_max, HIDDEN, torch.float32, "cpu")
    for time in range(5):
        x = _rand(rs, B, 1, HIDDEN)
        jo, jcache = jattn.self_attn_step(
            jp, jnp.asarray(x), jcache, time, H, rpr_tables=jtab,
            max_relative_position=m)
        o, cache = attn.self_attn_step(p, t(x), cache, time, H,
                                       use_flash=True, rpr_tables=ptab,
                                       max_relative_position=m)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)


def test_ancestry_attn_with_rpr_matches_jax():
    """Beam decode over ancestry pools: the distance row tiled over the K
    pool rows."""
    rs = np.random.RandomState(6)
    m, beams, t_max, time = 2, 3, 7, 4
    q = _rand(rs, B * beams, 1, HIDDEN)
    k, v = (_rand(rs, B * beams, t_max, HIDDEN) for _ in range(2))
    anc = rs.randint(0, beams, (B, beams, t_max)).astype(np.int32)
    jtab, ptab = _tables(rs, m)
    want = jattn._ancestry_attn(*map(jnp.asarray, (q, k, v, anc)), time, H,
                                rpr_tables=jtab, max_relative_position=m)
    got = attn._ancestry_attn(*map(t, (q, k, v, anc)), time, H,
                              rpr_tables=ptab, max_relative_position=m)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_cross_attn_step_with_rpr_matches_jax():
    """Cross attention at decode step ``time``: the distance row tiled over
    the beam-query rows against untiled memory."""
    rs = np.random.RandomState(7)
    m, beams, s_len, time = 2, 3, 6, 3
    jp, p = _attention(False, seed=8)
    mem = _rand(rs, B, s_len, HIDDEN)
    mem_keep = np.ones((B, s_len), np.float32)
    mem_keep[1, 4:] = 0
    x = _rand(rs, B * beams, 1, HIDDEN)
    jtab, ptab = _tables(rs, m)
    jmkv = jattn.cross_attn_precompute(jp, jnp.asarray(mem))
    want, _ = jattn.cross_attn_step(jp, jnp.asarray(x), jmkv,
                                    jnp.asarray(mem_keep), H, time=time,
                                    rpr_tables=jtab, max_relative_position=m)
    mkv = attn.cross_attn_precompute(p, t(mem))
    got = attn.cross_attn_step(p, t(x), mkv, t(mem_keep), H, time=time,
                               rpr_tables=ptab, max_relative_position=m)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
