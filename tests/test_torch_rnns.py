"""zero_tpu_torch's RNN modules against zero_tpu, fp32 on the CPU, on
weights bridged from the JAX init functions (modules within 1e-5):
``linear`` with the per-input LayerNorm (``ln=True``) and its key set;
``additive_attention`` with beams folded into the query axis and an
all-pad memory row; each of the six cells through ``rnn`` over a padded
batch, forwards and on the flipped sequence of a backward direction, with
and without ``ln``; ``cond_rnn`` in attention and one2one (CAEncoder)
mode; ``cond_rnn_step`` against step t of ``cond_rnn``; and the gradients
of a ``cond_rnn`` loss."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import bridge, t  # noqa: E402
from zero_tpu import rnns as jrnns  # noqa: E402
from zero_tpu.ops import attention as jattn  # noqa: E402
from zero_tpu.ops import initializers as jinits  # noqa: E402
from zero_tpu.ops import nn as jnn  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch import rnns  # noqa: E402
from zero_tpu_torch.ops import attention as attn  # noqa: E402
from zero_tpu_torch.ops import initializers as inits  # noqa: E402
from zero_tpu_torch.ops import nn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CELLS = ["gru", "lstm", "sru", "atr", "lrn", "olrn"]
B, L, S, E, D, DM, HEADS = 3, 6, 5, 4, 8, 6, 2
# a larger uniform init than the models' 0.08, so the gates move (the
# port's draws are replaced by the bridged JAX weights)
WI = jinits.uniform(0.5)
WI_PORT = inits.uniform(0.5)


def _np(x):
    return np.asarray(x, np.float32)


def _inputs():
    rs = np.random.RandomState(0)
    x = rs.randn(B, L, E).astype(np.float32)
    memory = rs.randn(B, S, DM).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, 4:] = 0                  # a padded tail
    mask[2, 1] = 0                   # a pad inside a row
    mem_mask = np.ones((B, S), np.float32)
    mem_mask[1, 3:] = 0
    mem_mask[2] = 0                  # an all-pad memory row
    return x, memory, mask, mem_mask


def _port(jax_params, module):
    return bridge(jax_params, module)


def _same_keys(jax_params, module):
    want = sorted(k[len("p/"):] for k in _flatten(jax_params, "p"))
    got = sorted(n.replace(".", "/") for n, _ in module.named_parameters())
    assert got == want


@pytest.mark.parametrize("ln", [False, True])
def test_linear_with_per_input_layer_norm_matches_jax(ln):
    """Two inputs, a bias; ln=True layer-norms each projection before the
    sum (eps 1e-8); ln=False makes no ``lns`` key."""
    rs = np.random.RandomState(1)
    xs = [rs.randn(3, 5, 4).astype(np.float32),
          rs.randn(3, 5, 7).astype(np.float32)]
    jp = jnn.init_linear(jax.random.PRNGKey(0), [4, 7], 6, ln=ln,
                         weight_init=WI)
    if ln:   # non-trivial LayerNorm parameters
        jp["lns"] = [{"scale": jnp.asarray(rs.rand(6) + 0.5, jnp.float32),
                      "offset": jnp.asarray(rs.randn(6), jnp.float32)}
                     for _ in range(2)]
    p = nn.init_linear(torch.Generator(), [4, 7], 6, ln=ln)
    _same_keys(jp, p)
    assert (p.lns is not None) == ln
    _port(jp, p)
    got = nn.linear(p, [t(x) for x in xs], ln=ln)
    want = jnn.linear(jp, [jnp.asarray(x) for x in xs], ln=ln)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


@pytest.mark.parametrize("beams", [1, 3])
def test_additive_attention_matches_jax(beams):
    """Beams fold into a query axis over the untiled memory; the all-pad
    memory row gets uniform weights and no NaN; the given projected
    memory is used (feed_memory is not read)."""
    _, memory, _, mem_mask = _inputs()
    rs = np.random.RandomState(2)
    query = rs.randn(B * beams, D).astype(np.float32)
    jp = jattn.init_additive_attention(jax.random.PRNGKey(3), D, DM, DM,
                                       num_heads=HEADS, weight_init=WI)
    p = attn.init_additive_attention(torch.Generator(), D, DM, DM,
                                     num_heads=HEADS)
    _same_keys(jp, p)
    _port(jp, p)
    proj = rs.randn(B, S, DM).astype(np.float32)
    want = jattn.additive_attention(jp, jnp.asarray(query),
                                    jnp.asarray(memory),
                                    jnp.asarray(mem_mask), num_heads=HEADS,
                                    proj_memory=jnp.asarray(proj))
    got = attn.additive_attention(p, t(query), t(memory), t(mem_mask),
                                  num_heads=HEADS, proj_memory=t(proj))
    for key in ("output", "weights", "cache_state"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   _np(want[key]), **TOL)
    w = got["weights"].detach().numpy().reshape(B, beams, HEADS, S)
    np.testing.assert_allclose(w[2], np.full((beams, HEADS, S), 1.0 / S),
                               **TOL)
    assert np.isfinite(got["output"].detach().numpy()).all()


def _cell_params(name, ln, d_in=E):
    cell = rnns.get_cell(name)
    jp = jrnns.get_cell(name).init(jax.random.PRNGKey(4), d_in, D, ln, WI)
    p = cell.init(torch.Generator(), d_in, D, ln, WI_PORT)
    _same_keys(jp, p)
    return cell, jp, _port(jp, p)


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rnn_matches_jax_forwards_and_flipped(name, ln):
    """rnn over a padded batch (a padded tail, a pad inside a row): the
    outputs, the last state and their hidden halves; pads carry the state
    (output at a pad == output before it); then the flipped sequence and
    mask, as a backward direction runs, from a given initial state."""
    x, _, mask, _ = _inputs()
    cell, jp, p = _cell_params(name, ln)
    jcell = jrnns.get_cell(name)
    h0 = np.random.RandomState(5).randn(
        B, D * cell.state_mult).astype(np.float32)
    for flip in (False, True):
        xi = x[:, ::-1].copy() if flip else x
        mi = mask[:, ::-1].copy() if flip else mask
        init = h0 if flip else None
        want = jrnns.rnn(
            jcell, jp, jnp.asarray(xi), D, mask=jnp.asarray(mi), ln=ln,
            init_state=None if init is None else jnp.asarray(init))
        got = rnns.rnn(cell, p, t(xi), D, mask=t(mi), ln=ln,
                       init_state=None if init is None else t(init))
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_allclose(g.detach().numpy(), _np(w), **TOL)
        out = got[0][0].detach().numpy()
        pads = np.argwhere(mi == 0)
        for b, s in pads:
            if s > 0:
                np.testing.assert_array_equal(out[b, s], out[b, s - 1])


@pytest.mark.parametrize("name,one2one,ln", [
    ("gru", False, False), ("lstm", False, True), ("atr", True, False),
    ("sru", True, True), ("olrn", False, False), ("lrn", True, False)])
def test_cond_rnn_matches_jax(name, one2one, ln):
    """cond_rnn in attention mode (additive attention over the memory,
    an all-pad memory row) and one2one mode (memory position t feeds step
    t; memory of the sequence's length): outputs, last state, hidden,
    contexts and attention weights."""
    x, memory, mask, mem_mask = _inputs()
    if one2one:
        memory = np.random.RandomState(6).randn(B, L, D).astype(np.float32)
        mem_mask = mask
    d_mem = memory.shape[-1]
    jp = jrnns.init_cond_rnn(jax.random.PRNGKey(7), name, E, d_mem, D, ln=ln,
                             weight_init=WI, one2one=one2one,
                             att_num_heads=HEADS)
    p = rnns.init_cond_rnn(torch.Generator(), name, E, d_mem, D, ln=ln,
                           one2one=one2one, att_num_heads=HEADS)
    _same_keys(jp, p)
    _port(jp, p)
    want = jrnns.cond_rnn(name, jp, jnp.asarray(x), jnp.asarray(memory), D,
                          mask=jnp.asarray(mask),
                          mem_mask=jnp.asarray(mem_mask), ln=ln,
                          one2one=one2one, num_heads=HEADS)
    got = rnns.cond_rnn(name, p, t(x), t(memory), D, mask=t(mask),
                        mem_mask=t(mem_mask), ln=ln, one2one=one2one,
                        num_heads=HEADS)
    flat_got = list(got[0]) + list(got[1]) + [got[2], got[3]]
    flat_want = list(want[0]) + list(want[1]) + [want[2], want[3]]
    for g, w in zip(flat_got, flat_want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), _np(w), **TOL)


@pytest.mark.parametrize("name", ["gru", "lstm"])
def test_cond_rnn_step_equals_step_t_of_cond_rnn(name):
    """Unmasked, the decode step from cond_rnn's state at t-1 gives its
    state, hidden output and context at t (and JAX's cond_rnn_step)."""
    x, memory, _, mem_mask = _inputs()
    jp = jrnns.init_cond_rnn(jax.random.PRNGKey(8), name, E, DM, D,
                             weight_init=WI, att_num_heads=HEADS)
    p = _port(jp, rnns.init_cond_rnn(torch.Generator(), name, E, DM, D,
                                     att_num_heads=HEADS))
    cell = rnns.get_cell(name)
    with torch.no_grad():
        (outs, _), (hid, _), ctx, _ = rnns.cond_rnn(
            name, p, t(x), t(memory), D, mem_mask=t(mem_mask),
            num_heads=HEADS)
        proj = nn.linear(p["context_att"], t(memory))
        h = rnns.zero_state(cell, B, D)
        jh = jnp.zeros((B, D * cell.state_mult))
        for step in range(L):
            h, hidden, c = rnns.cond_rnn_step(
                name, p, h, t(x[:, step]), t(memory), t(mem_mask), proj,
                num_heads=HEADS)
            jh, jhid, jc = jrnns.cond_rnn_step(
                name, jp, jh, jnp.asarray(x[:, step]), jnp.asarray(memory),
                jnp.asarray(mem_mask),
                jnn.linear(jp["context_att"], jnp.asarray(memory)),
                num_heads=HEADS)
            for a, b_ in ((h, outs[:, step]), (hidden, hid[:, step]),
                          (c, ctx[:, step])):
                np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)
            for a, w in ((h, jh), (hidden, jhid), (c, jc)):
                np.testing.assert_allclose(a.numpy(), _np(w), **TOL)


def test_cond_rnn_grads_match_jax():
    """d(sum of cond_rnn's hidden outputs and contexts, weighted) / d every
    parameter and the inputs, against jax.grad: within 1e-5 of the largest
    |grad|; feed_memory, which the projected memory bypasses, gets no grad
    here and JAX's exact zeros."""
    name = "lstm"
    x, memory, mask, mem_mask = _inputs()
    wt = np.random.RandomState(9).randn(B, L, D).astype(np.float32)
    jp = jrnns.init_cond_rnn(jax.random.PRNGKey(10), name, E, DM, D,
                             ln=True, weight_init=WI, att_num_heads=HEADS)

    def jloss(params, xx):
        _, (hid, _), ctx, _ = jrnns.cond_rnn(
            name, params, xx, jnp.asarray(memory), D, mask=jnp.asarray(mask),
            mem_mask=jnp.asarray(mem_mask), ln=True, num_heads=HEADS)
        return jnp.sum(hid * wt) + jnp.sum(ctx ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p = _port(jp, rnns.init_cond_rnn(torch.Generator(), name, E, DM, D,
                                     ln=True, att_num_heads=HEADS))
    xt = t(x).requires_grad_(True)
    _, (hid, _), ctx, _ = rnns.cond_rnn(name, p, xt, t(memory), D,
                                        mask=t(mask), mem_mask=t(mem_mask),
                                        ln=True, num_heads=HEADS)
    loss = (hid * t(wt)).sum() + (ctx ** 2).sum()
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad(loss, list(p.parameters()) + [xt],
                                allow_unused=True)
    want = _flatten(jgp, "p")
    top = max(np.abs(v).max() for v in want.values())
    for n, g in zip(names, grads):
        ref = want["p/" + n.replace(".", "/")]
        if g is None:
            assert n.startswith("attention.feed_memory.")
            assert not np.any(ref)
            continue
        assert np.abs(g.numpy() - ref).max() <= 1e-5 * top, n
    np.testing.assert_allclose(grads[-1].numpy(), _np(jgx), **TOL)
