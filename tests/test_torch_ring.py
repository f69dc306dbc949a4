"""zero_tpu_torch's ring attention (parallel/ring.py) against the JAX
package's ``ring_self_attention`` on its virtual CPU devices, fp32.

No processes: the port's ring runs its n blocks in n threads of this
process, each block's shifts exchanged through a barrier (``ring.simulate``),
so every block runs the code a process of a seq line runs. Covered: the
meshes of tests/test_ring.py, forward and grads, padded with an all-pad
row or causal; ReLA's and RPR's modes (the tables' grads too); dropout on,
its block masks bit-equal to the JAX ring's ``_drop_mask`` under the
folded keys; the port's threefry ``fold_in`` against
``jax.random.fold_in`` over a sweep of keys and data; the merge of the
kernels' (o, m, l) blocks (their plain version on CPU tensors) against
the dense result at dropout 0; and the route rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from zero_tpu.parallel import ring as jring  # noqa: E402
from zero_tpu_torch.ops import common  # noqa: E402
from zero_tpu_torch.parallel import ring  # noqa: E402

B, H, S, D = 4, 4, 16, 8


def _mesh(data, model, seq):
    devs = jax.devices()
    if len(devs) < data * model * seq:
        pytest.skip("needs %d devices" % (data * model * seq))
    return Mesh(np.array(devs[:data * model * seq]).reshape(data, model, seq),
                ("data", "model", "seq"))


def _qkv(seed=0, all_pad=True):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    keep = (rs.rand(B, S) > 0.2).astype(np.float32)
    if all_pad:
        keep[1] = 0.0
    return q, k, v, keep


def _port_ring(n, q, k, v, keep, grads=True, tables=None, **kwargs):
    """The port's ring over n blocks: (output [B, H, S, D], grads of q, k,
    v and the tables of the loss sum(sin(out)))."""
    lb = S // n
    keep_t = None if keep is None else torch.from_numpy(keep)

    def fn(me, shift):
        blocks = [torch.from_numpy(x[:, :, me * lb:(me + 1) * lb].copy())
                  .requires_grad_() for x in (q, k, v)]
        tabs = None
        if tables is not None:
            tabs = [torch.from_numpy(t.copy()).requires_grad_()
                    for t in tables]
        o = ring.ring_attention(*blocks, keep_t, rpr_tables=tabs,
                                line=(me, n, shift), **kwargs)
        if grads:
            torch.sin(o).sum().backward()
        return o.detach(), [b.grad for b in blocks], (
            [t.grad for t in tabs] if tabs else [])

    res = ring.simulate(n, fn)
    out = torch.cat([r[0] for r in res], dim=2).numpy()
    if not grads:
        return out, None
    gs = [torch.cat([r[1][i] for r in res], dim=2).numpy() for i in range(3)]
    if tables is not None:
        # each block's table gradient is partial: the sum over the line
        gs += [sum(r[2][i] for r in res).numpy() for i in range(2)]
    return out, gs


def _jax_ring(mesh, q, k, v, keep, tables=None, **kwargs):
    args = [jnp.asarray(x) for x in (q, k, v)]
    keep_j = None if keep is None else jnp.asarray(keep)

    def f(*a):
        t = None
        if tables is not None:
            t = {"keys": a[3], "values": a[4]}
        return jring.ring_self_attention(a[0], a[1], a[2], keep_j,
                                         rpr_tables=t, mesh=mesh, **kwargs)
    if tables is not None:
        args += [jnp.asarray(t) for t in tables]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                             argnums=tuple(range(len(args)))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 8), (4, 1, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_the_jax_ring(shape, causal):
    """Forward and grads over the seq degree of each mesh, with an all-pad
    row (uniform over all S keys, no NaN)."""
    mesh = _mesh(*shape)
    q, k, v, keep = _qkv()
    out, grads = _port_ring(shape[2], q, k, v, keep, causal=causal)
    want, wgrads = _jax_ring(mesh, q, k, v, keep, causal=causal)
    _close(out, want, 2e-6)
    for g, w in zip(grads, wgrads):
        _close(g, w, 2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_rela_ring_matches_the_jax_ring(causal):
    mesh = _mesh(2, 1, 4)
    q, k, v, keep = _qkv()
    out, grads = _port_ring(4, q, k, v, keep, causal=causal, relu=True)
    want, wgrads = _jax_ring(mesh, q, k, v, keep, causal=causal, relu=True)
    _close(out, want, 2e-5)
    for g, w in zip(grads, wgrads):
        _close(g, w, 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_rpr_ring_matches_the_jax_ring(causal):
    """Distances from the blocks' global positions; the tables' grads are
    the sum of the blocks' (the train step's sum over the seq line)."""
    mesh = _mesh(2, 1, 4)
    q, k, v, keep = _qkv()
    rs = np.random.RandomState(7)
    tables = [rs.randn(9, D).astype(np.float32) for _ in range(2)]
    out, grads = _port_ring(4, q, k, v, keep, causal=causal, tables=tables,
                            max_rel=4)
    want, wgrads = _jax_ring(mesh, q, k, v, keep, causal=causal,
                             tables=tables, max_rel=4)
    _close(out, want, 2e-6)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)


WORDS = (0x12345678, 0x9ABCDEF0)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_ring_matches_the_jax_ring(causal):
    """Dropout 0.1: every block's mask is the JAX ring's, bit for bit, and
    the output and grads follow."""
    mesh = _mesh(1, 1, 8)
    q, k, v, keep = _qkv()
    rng = jnp.asarray(WORDS, jnp.uint32)
    out, grads = _port_ring(8, q, k, v, keep, causal=causal, words=WORDS,
                            drop=0.1)
    want, wgrads = _jax_ring(mesh, q, k, v, keep, causal=causal, rng=rng,
                             drop=0.1)
    _close(out, want, 2e-6)
    for g, w in zip(grads, wgrads):
        _close(g, w, 2e-6)
    lb = S // 8
    ones = torch.ones((B, H, lb, lb))
    opts = ring.Opts(keep=None, causal=False, words=WORDS, drop=0.1,
                     relu=False, max_rel=None, heads=None, family="jax",
                     route="plain", me=0, n=8, shift=None)
    for me, owner in ((0, 0), (3, 5), (7, 2)):
        key = jax.random.fold_in(jax.random.fold_in(rng, me), owner)
        jmask = np.asarray(jring._drop_mask(jnp.ones((B, H, lb, lb)), key,
                                            0.1))
        pmask = ring._dropped(ones, ring.block_words(WORDS, me, owner),
                              opts).numpy()
        np.testing.assert_array_equal(pmask, jmask)


def test_fold_in_matches_jax():
    rs = np.random.RandomState(3)
    keys = [(0, 0), (1, 2), (0xFFFFFFFF, 0xFFFFFFFF)] + [
        tuple(int(w) for w in rs.randint(0, 2 ** 32, 2, dtype=np.uint64))
        for _ in range(8)]
    for key in keys:
        for data in (0, 1, 7, 255, 2 ** 31 + 5, 2 ** 32 - 1):
            want = np.asarray(jax.random.fold_in(
                jnp.asarray(key, jnp.uint32), data))
            assert common.fold_in(key, data) == tuple(int(w) for w in want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_form_blocks_merge_to_the_dense_result(n, causal):
    """use_kernels on CPU tensors: each block's (o, m, l) in the kernels'
    form (masks -1e30, a causal row's later keys absent), merged by m and
    l, forward and grads equal the JAX ring's at dropout 0. A causal ring
    carries no pad mask (the decoder's), where the two forms agree."""
    mesh = _mesh(1, 1, n)
    q, k, v, keep = _qkv()
    keep = None if causal else keep
    before = ring.launches["ring_block_ref"]
    out, grads = _port_ring(n, q, k, v, keep, causal=causal,
                            use_kernels=True)
    blocks = n * (n + 1) // 2 if causal else n * n
    assert ring.launches["ring_block_ref"] - before == blocks
    want, wgrads = _jax_ring(mesh, q, k, v, keep, causal=causal)
    _close(out, want, 2e-6)
    for g, w in zip(grads, wgrads):
        _close(g, w, 2e-6)


def test_route_rules_match_the_jax_ring():
    mesh = _mesh(2, 2, 2)
    degrees = {"data": 2, "model": 2, "seq": 2}
    shapes = [(4, 4, 16, 16), (4, 4, 15, 15), (3, 4, 16, 16),
              (4, 3, 16, 16), (4, 4, 16, 8)]
    jring.set_active_mesh(mesh)
    try:
        want = [jring.ring_route_ok(*s) for s in shapes]
    finally:
        jring.set_active_mesh(None)
    assert want == [True, False, False, False, False]
    assert [ring.ring_route_ok(*s, degrees=degrees) for s in shapes] == want
    assert not ring.ring_route_ok(4, 4, 16, 16, degrees={"seq": 1})
    assert ring.seq_degree() == 1


def test_kernels_plain_versions_draw_the_whole_sequences_masks():
    """The dropout index of a sequence block (the kernels' ``qrows``, as
    a cross-attention's query block runs them, and the FFN's ``tokens``),
    in the plain versions: each half of the queries (rows) at dropout 0.1
    gives the whole launch's slice, bit for bit; without the block's
    offset the second half draws other masks."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(3))
    pad = torch.ones(2, 16)
    pad[1, 11:] = 0
    x = torch.randn(2, 16, 8, generator=g)
    w1, w2 = torch.randn(8, 12, generator=g), torch.randn(12, 8, generator=g)
    b1, b2 = torch.randn(12, generator=g), torch.randn(8, generator=g)
    kw = dict(dropout_rate=0.1, rng=WORDS)
    whole = [fa.fused_attention(q, k, v, pad, **kw),
             sa.streaming_attention(q, k, v, pad, **kw)]
    ffn = ff.fused_ffn(x, w1, b1, w2, b2, WORDS, 0.1)
    for lo in (0, 8):
        qb = q[:, :, lo:lo + 8]
        got = [fa.fused_attention(qb, k, v, pad, qrows=(lo, 16), **kw),
               sa.streaming_attention(qb, k, v, pad, qrows=(lo, 16), **kw)]
        for w, gb in zip(whole, got):
            assert torch.equal(gb, w[:, :, lo:lo + 8])
        yb = ff.fused_ffn(x[:, lo:lo + 8], w1, b1, w2, b2, WORDS, 0.1,
                          tokens=(8, 16, lo))
        assert torch.equal(yb, ffn[:, lo:lo + 8])
    assert not torch.equal(fa.fused_attention(q[:, :, 8:], k, v, pad, **kw),
                           whole[0][:, :, 8:])
    assert not torch.equal(ff.fused_ffn(x[:, 8:], w1, b1, w2, b2, WORDS,
                                        0.1), ffn[:, 8:])


def test_a_self_attention_the_ring_cannot_take_raises():
    """Under a split sequence a self-attention whose mask does not
    decompose into a causal flag and a key pad mask raises: it would
    attend within its block alone."""
    from zero_tpu_torch.ops import attention

    params = attention.init_attention(torch.Generator().manual_seed(0), 8,
                                      8, self_attention=True)
    x = torch.randn(2, 4, 8)
    with common.seq_parallel(0, 2):
        with pytest.raises(ValueError, match="not ring-capable"):
            attention.attn_train(params, x, None, None, 2)


def test_the_route_raises_where_ring_route_ok_refuses(monkeypatch):
    """The route asks ring_route_ok (whole batch, heads and length): a
    shape it refuses raises rather than attend within a block."""
    from zero_tpu_torch.ops import attention

    params = attention.init_attention(torch.Generator().manual_seed(0), 8,
                                      8, self_attention=True)
    x = torch.randn(2, 4, 8)
    asked = []

    def refuse(*args, **kwargs):
        asked.append(args)
        return False

    monkeypatch.setattr(ring, "ring_route_ok", refuse)
    with common.seq_parallel(0, 2):
        with pytest.raises(ValueError, match="does not take the ring"):
            attention.attn_train(params, x, None, None, 2, causal=True)
    assert asked == [(2, 2, 8, 8)]


def test_rpr_plain_version_over_a_query_block_is_the_whole_launchs_slice():
    """#3/#4's plain version over each half of the queries (``qrows``, a
    cross-attention's query block under mesh_seq) gives the whole
    launch's slice: the distances from the block's first query and the
    whole sequence's dropout rows. Without the offset the second half
    indexes other distances; a causal launch over a block is refused."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.rpr import TableView

    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 2, 12, 8, generator=g)
    k, v = (torch.randn(2, 2, 10, 8, generator=g) for _ in range(2))
    pad = torch.ones(2, 10)
    pad[1, 7:] = 0
    m = 2
    tables = TableView(*(torch.randn(2 * m + 1, 8, generator=g)
                         for _ in range(2)))
    for rate in (0.0, 0.1):
        kw = dict(dropout_rate=rate, rng=WORDS, rpr_tables=tables,
                  max_relative_position=m)
        whole = fa.fused_attention(q, k, v, pad, **kw)
        for lo in (0, 6):
            got = fa.fused_attention(q[:, :, lo:lo + 6], k, v, pad,
                                     qrows=(lo, 12), **kw)
            torch.testing.assert_close(got, whole[:, :, lo:lo + 6],
                                       rtol=1e-6, atol=1e-6)
        assert not torch.allclose(
            fa.fused_attention(q[:, :, 6:], k, v, pad, **kw),
            whole[:, :, 6:], atol=1e-3)
    with pytest.raises(ValueError, match="causal RPR launch"):
        fa.fused_attention(q[:, :, 6:, :], q, q, torch.ones(2, 12),
                           causal=True, qrows=(6, 12), rpr_tables=tables,
                           max_relative_position=m)
