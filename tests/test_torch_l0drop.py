"""zero_tpu_torch transformer_l0drop and ops/l0norm.py against zero_tpu,
fp32 on the CPU, on weights bridged from the JAX init_fn: the
hard-concrete transform on noise that JAX drew, the gate mean, the
expected-L0 norm, var_train/var_eval and the penalty's ramp; the port's
own noise; ``compact_encodings`` with ties; then the model: train_fn loss
and grads with the same gate noise injected on both sides (the JAX
sampler's key and the port's noise patched inside the test), with the
kernel flags off, on, and with use_remat; a source row whose gates all
close (finite loss and grads); score_fn and beam search at beam 4 and 1
at l0_compact_ratio 0, 0.6 and 1.0 (1.0 equals full-length decoding);
cache decode against dev-mode decode; a checkpoint across the two
packages."""

import contextlib
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_beam_search,  # noqa: E402
                          check_checkpoint_round_trip, check_same_decode,
                          check_score_fn, check_train_fn, jax_loss_and_grads,
                          parity_features, port_beam, port_config,
                          port_params, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.models import transformer_l0drop as jl0drop  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.models import transformer_l0drop as l0drop  # noqa: E402
from zero_tpu_torch.ops import l0norm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_l0drop"
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1,
            l0_norm_reg_scalar=0.2, l0_norm_end_reg_ramp_up=50)
STEP = 20   # inside the penalty's ramp
NOISE_KEY = jax.random.PRNGKey(7)


def _log_alpha(seed, *shape):
    return (3.0 * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


def test_hard_concrete_transform_matches_jax_on_its_noise():
    la = _log_alpha(0, 4, 9, 1)
    noise = np.asarray(jax.random.uniform(NOISE_KEY, la.shape, jnp.float32))
    want = jl0.hard_concrete_sample(NOISE_KEY, jnp.asarray(la))
    got = l0norm.hard_concrete_from_noise(t(noise), t(la))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ((got == 0).any() and (got == 1).any()
            and ((got > 0) & (got < 1)).any())
    theta = np.random.RandomState(1).randn(*la.shape).astype(np.float32)
    with mock.patch.object(l0norm, "uniform_noise",
                           lambda words, shape, device: t(noise)):
        w, g = l0norm.var_train((1, 2), (t(theta), t(la)))
    jw, jg = jl0.var_train(NOISE_KEY, (jnp.asarray(theta), jnp.asarray(la)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def test_gate_mean_l0_norm_and_var_eval_match_jax():
    la = _log_alpha(2, 3, 11, 1)
    theta = np.random.RandomState(3).randn(*la.shape).astype(np.float32)
    for got, want in (
            (l0norm.hard_concrete_mean(t(la)),
             jl0.hard_concrete_mean(jnp.asarray(la))),
            (l0norm.l0_norm(t(la)), jl0.l0_norm(jnp.asarray(la)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w, g = l0norm.var_eval((t(theta), t(la)))
    jw, jg = jl0.var_eval((jnp.asarray(theta), jnp.asarray(la)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("warm_up", [True, False])
def test_penalty_ramp_matches_jax(warm_up):
    penalty = np.float32(0.73)
    for step in (0, 1, 7, 100, 2499, 2500, 10 ** 6):
        got = l0norm.l0_regularization_loss(
            torch.tensor(penalty), step, reg_scalar=0.2,
            start_reg_ramp_up=100, end_reg_ramp_up=2500, warm_up=warm_up)
        want = jl0.l0_regularization_loss(
            jnp.asarray(penalty), step, reg_scalar=0.2, start_reg_ramp_up=100,
            end_reg_ramp_up=2500, warm_up=warm_up)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0, err_msg=str(step))


def test_port_noise_is_uniform_and_seeded():
    a = l0norm.uniform_noise((5, 9), (64, 64, 1), "cpu")
    b = l0norm.uniform_noise((5, 9), (64, 64, 1), "cpu")
    c = l0norm.uniform_noise((5, 10), (64, 64, 1), "cpu")
    d = l0norm.uniform_noise((6, 9), (64, 64, 1), "cpu")
    assert torch.equal(a, b)
    assert not (a == c).any() and (a == d).float().mean() < 0.01
    assert a.min() >= 0 and a.max() < 1 and abs(a.mean() - 0.5) < 0.02
    with pytest.raises(ValueError, match="generator"):
        l0norm.hard_concrete_sample(None, torch.zeros(2, 3, 1))


def test_compact_encodings_matches_jax_with_ties():
    """Scores full of ties at 0 (dropped and pad positions) and among
    survivors: the same positions, in lax.top_k's order."""
    rs = np.random.RandomState(4)
    b, s, d = 4, 9, 5
    enc = rs.randn(b, s, d).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[0, 6:] = 0
    mask[3] = 0                                  # an all-pad row
    score = rs.choice([0.0, 0.25, 0.5, 1.0], (b, s)).astype(np.float32)
    score[1] = 0.0                               # every gate closed
    for ratio in (0.3, 0.6, 1.0):
        got = l0drop.compact_encodings(t(enc), t(mask), t(score), ratio)
        want = jl0drop.compact_encodings(jnp.asarray(enc), jnp.asarray(mask),
                                         jnp.asarray(score), ratio)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@contextlib.contextmanager
def _noise(noise):
    """The gate noise of both packages: JAX's sampler draws from NOISE_KEY
    (``noise`` is what it draws), the port's from ``noise``."""
    jax_sample = jl0.hard_concrete_sample
    with mock.patch.object(jl0, "hard_concrete_sample",
                           lambda rng, la: jax_sample(NOISE_KEY, la)), \
            mock.patch.object(l0norm, "uniform_noise",
                              lambda words, shape, device: t(noise)):
        yield


def _jax_noise(shape):
    return np.asarray(jax.random.uniform(NOISE_KEY, shape, jnp.float32))


def _trained_params(cfg):
    """JAX weights whose gates drop about half the positions (as
    tests/test_compact_decode.py makes them)."""
    params = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    params["source_pruning"]["ws"][0] = params["source_pruning"]["ws"][0] * 40
    params["source_pruning"]["b"] = params["source_pruning"]["b"] - 2.4
    return params


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = parity_features()
    jparams = _trained_params(cfg)
    noise = _jax_noise(feats["source"].shape + (1,))
    with _noise(noise):
        want = jax_loss_and_grads(NAME, cfg, jparams, feats, step=STEP)
    return dict(cfg=cfg, feats=feats, jparams=jparams, noise=noise, **want)


@pytest.mark.parametrize("flags", [{}, {"kernels": True},
                                   {"kernels": True, "use_remat": True}])
def test_train_fn_and_grads_match_jax(setup, flags):
    """Gates sampled from the injected noise, penalty ramped at STEP.
    Flags on: every attention and FFN takes a kernel (plain versions here);
    under use_remat the layers' forwards run again in the backward."""
    s = setup
    kernels = flags.get("kernels", False)
    with _noise(s["noise"]):
        launches = check_train_fn(
            NAME, s["cfg"], s["jparams"], s["feats"], s, step=STEP,
            use_flash_attention=kernels, use_fused_ffn=kernels,
            use_remat=flags.get("use_remat", False))
    assert "params/source_pruning/ws/0" in s["grads"]
    assert np.abs(s["grads"]["params/source_pruning/ws/0"]).max() > 0
    n = 2 if flags.get("use_remat") else 1
    assert launches == ({"fused_attention_ref": 3 * n, "fused_ffn_ref": 2 * n}
                        if kernels else {})


def test_a_row_whose_gates_all_close_gives_finite_loss_and_grads(setup):
    """Row 0's noise is 0: every gate closes, its memory row is all pad,
    which cross attention takes (kernel flags on) with uniform weights."""
    s = setup
    noise = s["noise"].copy()
    noise[0] = 0.0
    pcfg = port_config(s["cfg"], use_flash_attention=True, use_fused_ffn=True)
    params = port_params(NAME, s["jparams"], pcfg)
    gates = []
    transform = l0norm.hard_concrete_from_noise

    def spy(*args):
        gates.append(transform(*args))
        return gates[-1]

    with _noise(noise), mock.patch.object(l0norm, "hard_concrete_from_noise",
                                          spy):
        loss = get_model(NAME).train_fn(
            params, {k: t(v) for k, v in s["feats"].items()}, pcfg,
            torch.Generator(), step=STEP)["loss"]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert (gates[0][0] == 0).all() and (gates[0][1:] > 0).any()
    assert s["feats"]["source"][0].any()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)


def test_training_without_a_generator_raises(setup):
    s = setup
    pcfg = port_config(s["cfg"])
    with pytest.raises(ValueError, match="generator"):
        get_model(NAME).train_fn(port_params(NAME, s["jparams"], pcfg),
                                 {k: t(v) for k, v in s["feats"].items()},
                                 pcfg, None)


@pytest.fixture(scope="module")
def scores(setup):
    """JAX scores at each ratio (mean gates, no sampling)."""
    s = setup
    jfeats = {k: jnp.asarray(v) for k, v in s["feats"].items()}
    out = {}
    for ratio in (0.0, 0.6, 1.0):
        cfg = tiny_config(l0_compact_ratio=ratio, **SIZE)
        out[ratio] = np.asarray(jax.jit(
            lambda p: jget_model(NAME).score_fn(p, jfeats, cfg)["score"])(
                s["jparams"]))
    return out


@pytest.mark.parametrize("ratio", [0.0, 0.6, 1.0])
def test_score_fn_matches_jax(setup, scores, ratio):
    s = setup
    check_score_fn(NAME, tiny_config(l0_compact_ratio=ratio, **SIZE),
                   s["jparams"], s["feats"], scores[ratio])


@pytest.mark.parametrize("beam", [4, 1])
@pytest.mark.parametrize("ratio", [0.0, 0.6, 1.0])
def test_beam_search_matches_jax(setup, ratio, beam):
    """The compacted memory (ratio > 0) decodes through the count softmax;
    at 1.0 the sequences equal full-length decoding's."""
    s = setup
    cfg = tiny_config(beam_size=beam, l0_compact_ratio=ratio, **SIZE)
    got = check_beam_search(NAME, cfg, s["jparams"], s["feats"]["source"])
    if ratio == 1.0:
        full = port_beam(NAME, cfg, s["jparams"], s["feats"]["source"],
                         l0_compact_ratio=0.0)
        np.testing.assert_array_equal(got["seq"].numpy(),
                                      full["seq"].numpy())


@pytest.mark.parametrize("ratio", [0.0, 0.6])
def test_cache_decode_equals_dev_mode(setup, ratio):
    s = setup
    check_same_decode(NAME, tiny_config(beam_size=4, l0_compact_ratio=ratio,
                                        **SIZE),
                      s["jparams"], s["feats"]["source"],
                      {"search_mode": "dev"})


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(NAME, s["cfg"], s["jparams"], str(tmp_path))
