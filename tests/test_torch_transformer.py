"""zero_tpu_torch transformer serving path against zero_tpu, on weights
bridged from the JAX init_fn: encode, decode steps, beam search; and the
port's own cache == dev-mode invariant. fp32 on the CPU (in bf16, beam
outputs of different code paths differ by tie-breaking alone)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config, toy_batch  # noqa: E402
from torch_parity import port_config, t  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.saver import flat_from_module, params_from_flat  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(model_name="transformer")
    jparams = jget_model("transformer").init_fn(jax.random.PRNGKey(0), cfg)
    pcfg = port_config(cfg)
    model = get_model("transformer")
    params = model.init_fn(torch.Generator().manual_seed(0), pcfg)
    params.load_state_dict(params_from_flat(_flatten(jparams, "params")))
    src = toy_batch(batch=5)["source"]
    src[2] = 0   # an all-pad row
    return cfg, jparams, pcfg, params, src


def _jax_search(cfg, jparams, src):
    infer = jget_model("transformer").infer_fn(cfg)
    out = jax.jit(lambda p, s: jbeam_search(p, s, infer, cfg))(
        jparams, jnp.asarray(src))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_search(pcfg, params, src):
    with torch.inference_mode():
        out = beam_search(params, t(src).long(),
                          get_model("transformer").infer_fn(pcfg), pcfg)
    return out


def test_state_dict_names_are_the_jax_param_paths(setup):
    _, jparams, _, params, _ = setup
    jflat = _flatten(jparams, "params")
    flat = flat_from_module(params)
    assert sorted(flat) == sorted(jflat)
    for k in jflat:
        np.testing.assert_array_equal(flat[k], jflat[k])


def test_encode_and_decode_steps_match(setup):
    """encode + five decode_step logits on the ancestry-pool path, with a
    beam reorder between steps."""
    cfg, jparams, pcfg, params, src = setup
    b, beams = src.shape[0], cfg.beam_size
    jinf = jget_model("transformer").infer_fn(cfg)
    inf = get_model("transformer").infer_fn(pcfg)
    # jitted once each: JAX's op-by-op dispatch of an unjitted decode step
    # is most of this test's time otherwise
    decode_step = jax.jit(jinf.decode_step)
    reorder_cache = jax.jit(jinf.reorder_cache, static_argnums=(2, 3))
    jstate = jax.jit(jinf.encode)(jparams, jnp.asarray(src))
    jcache = jinf.init_cache(jparams, jstate, b * beams, 12)
    rs = np.random.RandomState(1)
    with torch.inference_mode():
        state = inf.encode(params, t(src).long())
        np.testing.assert_allclose(state["encodes"].numpy(),
                                   np.asarray(jstate["encodes"]), **TOL)
        cache = inf.init_cache(params, state, b * beams, 12)
        assert "ancestry" in cache and "ancestry" in jcache
        for time in range(5):
            tok = rs.randint(3, 20, (b * beams, 1)).astype(np.int32)
            jlogits, jcache = decode_step(jparams, jnp.asarray(tok), jstate,
                                          jcache, jnp.asarray(time))
            logits, cache = inf.decode_step(params, t(tok), state, cache,
                                            time)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            order = rs.randint(0, beams, (b, beams)).astype(np.int32)
            jcache = reorder_cache(jcache, jnp.asarray(order), b, beams,
                                   jnp.asarray(time))
            cache = inf.reorder_cache(cache, t(order), b, beams, time)
            np.testing.assert_array_equal(cache["ancestry"].numpy(),
                                          np.asarray(jcache["ancestry"]))


@pytest.mark.parametrize("beam", [3, 1])
def test_beam_search_matches_jax(setup, beam):
    """Beam 3 runs the ancestry-pool path, beam 1 the plain cache."""
    cfg, jparams, pcfg, params, src = setup
    cfg = tiny_config(model_name="transformer", beam_size=beam)
    pcfg = port_config(cfg)
    want = _jax_search(cfg, jparams, src)
    got = _port_search(pcfg, params, src)
    np.testing.assert_array_equal(got["seq"].numpy(), want["seq"])
    np.testing.assert_allclose(got["score"].numpy(), want["score"], **TOL)
    assert got["steps"] == int(want["steps"])
    assert np.isfinite(got["score"].numpy()).all()


@pytest.mark.parametrize("override", [{"search_mode": "dev"},
                                      {"decode_ancestry": "off"}])
def test_cache_decode_equals_other_decode_paths(setup, override):
    """Cache decode == dev-mode (decode_prefix full recompute) decode, and
    == the classic permuted-cache decode."""
    cfg, _, pcfg, params, src = setup
    base = _port_search(pcfg, params, src)
    other = _port_search(port_config(cfg, **override), params, src)
    np.testing.assert_array_equal(other["seq"].numpy(), base["seq"].numpy())
    np.testing.assert_allclose(other["score"].numpy(), base["score"].numpy(),
                               **TOL)
