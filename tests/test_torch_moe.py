"""zero_tpu_torch ops/moe.py and transformer_moe against zero_tpu, fp32 on
the CPU, on weights bridged from the JAX init_fn: moe_ffn's output, aux
loss and grads under both dispatches, top-1 and top-2, at a capacity that
drops tokens and with the router's ties; then the model: train_fn loss,
moe_aux and grads (einsum and scatter), bf16 training's dtypes, score_fn,
beam search at beam 4 and 1, cache decode against dev mode, and a
checkpoint across the two packages."""

from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, bridge, check_beam_search,  # noqa: E402
                          check_checkpoint_round_trip, check_same_decode,
                          check_score_fn, check_train_fn, jax_loss_and_grads,
                          parity_features, port_config, port_params, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import moe as jmoe  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import moe  # noqa: E402

NAME = "transformer_moe"
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1,
            moe_num_experts=4, moe_capacity_factor=0.5, moe_aux_weight=0.3)
D, F, E = 8, 12, 4


@pytest.fixture(scope="module")
def moe_case():
    """JAX expert weights; inputs [3, 7, 8] with a token pattern that
    overflows C = ceil(7 * 0.5 * k / 4); a second router whose logits are
    all equal (ties everywhere)."""
    rs = np.random.RandomState(5)
    jp = jmoe.init_moe_ffn(jax.random.PRNGKey(2), D, F, D, E)
    tied = dict(jp, router={"ws": [jnp.zeros_like(jp["router"]["ws"][0])]})
    x = rs.randn(3, 7, D).astype(np.float32)
    r = rs.randn(3, 7, D).astype(np.float32)
    return dict(jp=jp, tied=tied, x=x, r=r)


def _jax_moe(jp, x, r, top_k, dispatch, training):
    def f(p, xx):
        aux = []
        y = jmoe.moe_ffn(p, xx, num_experts=E, top_k=top_k,
                         capacity_factor=0.5, aux_sums=aux,
                         training=training, dispatch=dispatch)
        return jnp.sum(y * r) + 3.0 * aux[0], (y, aux[0])
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return y, aux, gp, gx


def _port_moe(jp, x, r, top_k, dispatch, training):
    params = bridge(jp, moe.init_moe_ffn(torch.Generator(), D, F, D, E))
    xt = t(x).requires_grad_()
    aux = []
    y = moe.moe_ffn(params, xt, num_experts=E, top_k=top_k,
                    capacity_factor=0.5, aux_sums=aux, training=training,
                    dispatch=dispatch)
    grads = torch.autograd.grad((y * t(r)).sum() + 3.0 * aux[0],
                                [xt] + list(params.parameters()))
    names = [n for n, _ in params.named_parameters()]
    return y, aux[0], dict(zip(["x"] + names, grads))


@pytest.mark.parametrize("router", ["random", "tied"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax_under_both_dispatches(moe_case, top_k, router):
    """Output, aux loss and the grads of the input and every weight,
    within 1e-5 of JAX's; scatter equals einsum. Tokens are dropped at
    this capacity (training) and routed without loss at eval."""
    from zero_tpu.saver import _flatten

    s = moe_case
    jp = s["jp"] if router == "random" else s["tied"]
    y, aux, _, _ = _jax_moe(jp, s["x"], s["r"], top_k, "einsum", True)
    _, _, gp, gx = _jax_moe(jp, s["x"], s["r"], top_k, "scatter", True)
    want = {"x": np.asarray(gx)}
    want.update({k[2:].replace("/", "."): v
                 for k, v in _flatten(gp, "p").items()})
    got = {}
    for dispatch in ("einsum", "scatter"):
        got[dispatch] = _port_moe(jp, s["x"], s["r"], top_k, dispatch, True)
        py, paux, pg = got[dispatch]
        np.testing.assert_allclose(py.detach().numpy(), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(paux.item(), float(aux), rtol=1e-5)
        assert sorted(pg) == sorted(want)
        for k, g in pg.items():
            np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=(dispatch, k))
    for a, b in zip(got["einsum"][2].values(), got["scatter"][2].values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the capacity binds: some (token, slot) is dropped in training
    probs = torch.softmax(torch.matmul(t(s["x"]), t(jp["router"]["ws"][0])),
                          -1)
    _, idx = moe.stable_top_k(probs, top_k)
    _, keep = moe._route(idx, E, moe.capacity(7, E, 0.5, top_k))
    assert not keep.all()
    ey, _, _, _ = _jax_moe(jp, s["x"], s["r"], top_k, "einsum", False)
    py, _, _ = _port_moe(jp, s["x"], s["r"], top_k, "scatter", False)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(ey),
                               rtol=1e-5, atol=1e-5)


def test_unknown_dispatch_raises(moe_case):
    params = moe.init_moe_ffn(torch.Generator(), D, F, D, E)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(params, t(moe_case["x"]), num_experts=E,
                    dispatch="gather")


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = parity_features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    want = jax_loss_and_grads(NAME, cfg, jparams, feats, score=True)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    want["moe_aux"] = float(jax.jit(lambda p: jget_model(NAME).train_fn(
        p, jfeats, cfg, jax.random.PRNGKey(1))["moe_aux"])(jparams))
    return dict(cfg=cfg, feats=feats, jparams=jparams, **want)


@pytest.mark.parametrize("dispatch", ["auto", "scatter"])
def test_train_fn_and_grads_match_jax(setup, dispatch):
    """JAX's "auto" is einsum; scatter gives the same loss and grads. The
    kernel flags are on and no training kernel runs (the JAX layers pass
    none)."""
    s = setup
    launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"], s,
                              moe_dispatch=dispatch,
                              use_flash_attention=True, use_fused_ffn=True)
    assert launches == {}
    pcfg = port_config(s["cfg"], moe_dispatch=dispatch)
    out = get_model(NAME).train_fn(
        port_params(NAME, s["jparams"], pcfg),
        {k: t(v) for k, v in s["feats"].items()}, pcfg, torch.Generator())
    assert abs(out["moe_aux"].item() - s["moe_aux"]) <= 1e-5 * s["moe_aux"]


def test_bf16_training_runs_bf16_activations_and_an_fp32_router(setup):
    s = setup
    pcfg = port_config(s["cfg"], default_dtype="bfloat16")
    params = port_params(NAME, s["jparams"], pcfg)
    seen = {"probs": [], "xin": []}
    real_top_k, real_ffn = moe.stable_top_k, moe._expert_ffn

    def top_k_spy(probs, k):
        seen["probs"].append(probs.dtype)
        return real_top_k(probs, k)

    def ffn_spy(ex, xin, rngs, drop):
        seen["xin"].append(xin.dtype)
        return real_ffn(ex, xin, rngs, drop)

    with mock.patch.object(moe, "stable_top_k", top_k_spy), \
            mock.patch.object(moe, "_expert_ffn", ffn_spy):
        loss = get_model(NAME).train_fn(
            params, {k: t(v) for k, v in s["feats"].items()}, pcfg,
            torch.Generator().manual_seed(0))["loss"]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert seen["probs"] == [torch.float32] * 2
    assert seen["xin"] == [torch.bfloat16] * 2
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    assert abs(loss.item() - s["loss"]) < 0.05 * s["loss"]


def test_score_fn_matches_jax(setup):
    s = setup
    check_score_fn(NAME, s["cfg"], s["jparams"], s["feats"], s["score"])


@pytest.mark.parametrize("beam", [4, 1])
def test_beam_search_matches_jax(setup, beam):
    s = setup
    check_beam_search(NAME, tiny_config(beam_size=beam, **SIZE),
                      s["jparams"], s["feats"]["source"])


def test_cache_decode_equals_dev_mode(setup):
    """Eval routes without loss (C = S), so the one-step decode equals the
    full recompute."""
    s = setup
    check_same_decode(NAME, tiny_config(beam_size=4, **SIZE), s["jparams"],
                      s["feats"]["source"], {"search_mode": "dev"})


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(NAME, s["cfg"], s["jparams"], str(tmp_path))
