"""zero_tpu_torch transformer_clsr against zero_tpu, fp32 on the CPU, on
weights bridged from the JAX init_fn: the CLSR unit (hard-concrete gates
on gate noise that JAX drew, injected on both sides by patching inside
the tests; mean gates at eval); then the model: train_fn loss (with the
budget loss) and grads, score_fn, beam search at beam 4 and 1, cache
decode against dev mode, an ensemble with transformer_multilingual, and a
checkpoint across the two packages. And every model of the JAX package
resolves, while a name that stands for a model of a later slice (patched
into JAX_MODELS) raises NotImplementedError."""

import contextlib
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
                          port_config, port_params, t, tagged_features)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.models import transformer_clsr as jclsr  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.ops.common import RngGen as JRngGen  # noqa: E402
from zero_tpu_torch import run, train  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.models import base  # noqa: E402
from zero_tpu_torch.models import transformer_clsr as clsr_mod  # noqa: E402
from zero_tpu_torch.ops import l0norm  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_clsr"
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1,
            num_languages=3, lang_id_offset=3, clsr_budget=0.3,
            clsr_alpha=0.7)
NOISE_KEY = jax.random.PRNGKey(7)


def _jax_noise(shape):
    return np.asarray(jax.random.uniform(NOISE_KEY, shape, jnp.float32))


@contextlib.contextmanager
def _noise():
    """The gate noise of both packages: JAX's sampler draws from NOISE_KEY,
    the port's noise is what that draws at each shape."""
    jax_sample = jl0.hard_concrete_sample
    with mock.patch.object(jl0, "hard_concrete_sample",
                           lambda rng, la: jax_sample(NOISE_KEY, la)), \
            mock.patch.object(l0norm, "uniform_noise",
                              lambda words, shape, device:
                              t(_jax_noise(tuple(shape)))):
        yield


def _perturbed(jparams, seed):
    """Per-language projections away from the identity and gate biases
    that open some gates and close others, so that the routing matters."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == "lang" and hasattr(v, "shape"):
                    v = v + jnp.asarray(0.3 * rs.randn(*v.shape)
                                        .astype(np.float32))
                elif k == "gate":
                    v = dict(v, b=jnp.asarray(
                        3.0 * rs.randn(*v["b"].shape).astype(np.float32)))
                out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(jparams)


@pytest.mark.parametrize("training", [True, False])
def test_clsr_unit_matches_jax(training):
    cfg = tiny_config(**SIZE)
    jp = _perturbed({"u": jclsr.init_clsr(jax.random.PRNGKey(3), cfg)},
                    4)["u"]
    rs = np.random.RandomState(5)
    x = rs.randn(4, 6, 16).astype(np.float32)
    lang = np.array([2, 0, 2, 1], np.int32)
    jsums, psums = [], []
    with _noise():
        want = jclsr.clsr(jp, jnp.asarray(x), jnp.asarray(lang),
                          JRngGen(jax.random.PRNGKey(1)), training, jsums)
        params = bridge(jp, clsr_mod.init_clsr(torch.Generator(),
                                               port_config(cfg)))
        got = clsr_mod.clsr(params, t(x), t(lang),
                            lambda: (1, 2), training, psums)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(psums[0][0].item(), float(jsums[0][0]),
                               **TOL)
    assert psums[0][1] == float(jsums[0][1])


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = tagged_features()
    jparams = _perturbed(jget_model(NAME).init_fn(jax.random.PRNGKey(0),
                                                  cfg), 6)
    with _noise():
        want = jax_loss_and_grads(NAME, cfg, jparams, feats, score=True)
    return dict(cfg=cfg, feats=feats, jparams=jparams, **want)


def test_train_fn_and_grads_match_jax(setup):
    """Gates sampled from the injected noise, the budget loss added. The
    kernel flags are on and no training kernel runs (the JAX layers pass
    none)."""
    s = setup
    with _noise():
        launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"],
                                  s, use_flash_attention=True,
                                  use_fused_ffn=True)
    assert launches == {}


def test_score_fn_matches_jax(setup):
    s = setup
    check_score_fn(NAME, s["cfg"], s["jparams"], s["feats"], s["score"])


@pytest.mark.parametrize("beam", [4, 1])
def test_beam_search_matches_jax(setup, beam):
    s = setup
    check_beam_search(NAME, tiny_config(beam_size=beam, **SIZE),
                      s["jparams"], s["feats"]["source"])


def test_cache_decode_equals_dev_mode(setup):
    s = setup
    check_same_decode(NAME, tiny_config(beam_size=4, **SIZE), s["jparams"],
                      s["feats"]["source"], {"search_mode": "dev"})


def test_ensemble_with_a_multilingual_model(setup):
    """The ensemble permutes each model's whole cache (no reorder_cache),
    the language ids included: CLSR with itself decodes CLSR's beams, and
    CLSR with transformer_multilingual decodes the same in cache and dev
    mode."""
    s = setup
    src = t(s["feats"]["source"]).long()
    names = (NAME, "transformer_multilingual")
    cfgs = [port_config(tiny_config(beam_size=4, **dict(SIZE,
                                                        model_name=n)))
            for n in names]
    params = [port_params(NAME, s["jparams"], cfgs[0]),
              get_model(names[1]).init_fn(torch.Generator().manual_seed(9),
                                          cfgs[1])]
    infs = [get_model(n).infer_fn(c) for n, c in zip(names, cfgs)]
    with torch.inference_mode():
        alone = beam_search(params[0], src, infs[0], cfgs[0])
        twice = beam_search([params[0]] * 2, src,
                            train.make_ensemble_inference([infs[0]] * 2),
                            cfgs[0])
        both = beam_search(params, src, train.make_ensemble_inference(infs),
                           cfgs[0])
        cfgs[0].search_mode = "dev"
        dev = beam_search(params, src, train.make_ensemble_inference(infs),
                          cfgs[0])
    assert torch.equal(twice["seq"], alone["seq"])
    assert torch.equal(dev["seq"], both["seq"])
    assert torch.isfinite(both["score"]).all()


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(NAME, s["cfg"], s["jparams"], str(tmp_path))


@pytest.mark.parametrize("name", ["deepnmt", "rnnsearch"])
def test_a_model_of_a_later_slice_raises(name, monkeypatch):
    """``name`` resolves now, as every model of the JAX package does. A
    model the JAX package has and the port not (``name + "_later"``
    patched into JAX_MODELS) raises NotImplementedError naming it, before
    any work (no files are given); a name neither package has stays a
    ValueError."""
    assert get_model(name).infer_fn is not None
    assert all(get_model(n) is not None for n in base.JAX_MODELS)
    later = name + "_later"
    monkeypatch.setattr(base, "JAX_MODELS", base.JAX_MODELS + (later,))
    with pytest.raises(NotImplementedError, match="%s.*later slice" % later):
        get_model(later)
    with pytest.raises(NotImplementedError, match=later):
        run.main(["--mode", "test", "--parameters",
                  "device=cpu,model_name=" + later])
    with pytest.raises(ValueError, match="Unknown model"):
        get_model(name + "_x")
