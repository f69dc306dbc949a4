"""zero_tpu_torch ops against zero_tpu ops: the same numpy inputs and the
same (bridged) weights through both, fp32 on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import bridge, t  # noqa: E402
from zero_tpu.ops import attention as jatt  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import nn as jnn  # noqa: E402
from zero_tpu_torch.ops import attention as att  # noqa: E402
from zero_tpu_torch.ops import common as common  # noqa: E402
from zero_tpu_torch.ops import nn  # noqa: E402
from zero_tpu_torch.search import F32_MIN, top_k  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
H, HIDDEN = 2, 16
GEN = torch.Generator().manual_seed(0)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_linear_multi_input():
    jp = jnn.init_linear(jax.random.PRNGKey(0), [8, 5], 6)
    jp["b"] = jnp.asarray(_rand(3, 6))   # a nonzero bias
    p = bridge(jp, nn.init_linear(GEN, [8, 5], 6))
    x1, x2 = _rand(1, 3, 4, 8), _rand(2, 3, 4, 5)
    _close(nn.linear(p, [t(x1), t(x2)]),
           jnn.linear(jp, [jnp.asarray(x1), jnp.asarray(x2)]))


def test_layer_norm():
    jp = {"scale": jnp.asarray(_rand(1, HIDDEN)),
          "offset": jnp.asarray(_rand(2, HIDDEN))}
    p = bridge(jp, nn.init_layer_norm(HIDDEN))
    x = _rand(3, 2, 5, HIDDEN) * 3 + 1
    _close(nn.layer_norm(p, t(x)), jnn.layer_norm(jp, jnp.asarray(x)))


def test_ffn():
    jp = jnn.init_ffn(jax.random.PRNGKey(1), HIDDEN, 32, HIDDEN)
    p = bridge(jp, nn.init_ffn(GEN, HIDDEN, 32, HIDDEN))
    x = _rand(4, 2, 5, HIDDEN)
    _close(nn.ffn(p, t(x)), jnn.ffn(jp, jnp.asarray(x)))


@pytest.mark.parametrize("channels", [16, 15])
def test_timing_signal_length_and_position_forms(channels):
    _close(nn.timing_signal(11, channels), jnn.timing_signal(11, channels))
    pos = np.array([0.0, 3.0, 57.0], np.float32)
    _close(nn.timing_signal(t(pos), channels),
           jnn.timing_signal(jnp.asarray(pos), channels))
    x = _rand(5, 2, 1, channels)
    _close(nn.add_timing_signal(t(x), time=9),
           jnn.add_timing_signal(jnp.asarray(x), time=jnp.asarray(9)))


def _pad_keep(b, s, seed=6):
    mask = np.ones((b, s), np.float32)
    lens = np.random.RandomState(seed).randint(1, s + 1, b)
    for i, n in enumerate(lens):
        mask[i, n:] = 0
    mask[-1] = 0   # an all-pad row
    return mask


@pytest.mark.parametrize("kind", ["pad", "causal", "cross"])
def test_attn_train(kind):
    self_attn = kind != "cross"
    jp = jatt.init_attention(jax.random.PRNGKey(2), HIDDEN, HIDDEN,
                             self_attention=self_attn)
    p = bridge(jp, att.init_attention(GEN, HIDDEN, HIDDEN,
                                      self_attention=self_attn))
    x = _rand(7, 3, 6, HIDDEN)
    memory = _rand(8, 3, 5, HIDDEN) if kind == "cross" else None
    if kind == "causal":
        keep = np.asarray(jnn.causal_mask(6))
    else:
        keep = np.asarray(jnn.masking_mask(
            jnp.asarray(_pad_keep(3, 5 if kind == "cross" else 6))))
    want = jatt.attn_train(jp, jnp.asarray(x),
                           None if memory is None else jnp.asarray(memory),
                           jnp.asarray(keep), H)
    got = att.attn_train(p, t(x), None if memory is None else t(memory),
                         t(keep), H)
    _close(got["output"], want["output"])
    _close(got["weights"], want["weights"])


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("mode", ["dense", "ancestry"])
def test_self_attn_step(mode, use_flash):
    """One decode step over a cache with history: the plain path, and the
    kernel route (its plain version on CPU tensors), against the JAX
    package's CPU path (_attn_core / _ancestry_attn)."""
    b, beams, t_max, time = 2, 3, 9, 5
    rows = b * beams
    jp = jatt.init_attention(jax.random.PRNGKey(3), HIDDEN, HIDDEN,
                             self_attention=True)
    p = bridge(jp, att.init_attention(GEN, HIDDEN, HIDDEN,
                                      self_attention=True))
    x = _rand(9, rows, 1, HIDDEN)
    pool_k, pool_v = _rand(10, rows, t_max, HIDDEN), _rand(11, rows, t_max,
                                                             HIDDEN)
    jcache = {"pool_k": jnp.asarray(pool_k), "pool_v": jnp.asarray(pool_v)}
    cache = {"pool_k": t(pool_k), "pool_v": t(pool_v)}
    if mode == "ancestry":
        anc = np.random.RandomState(12).randint(
            0, beams, (b, beams, t_max)).astype(np.int32)
        jcache["ancestry"] = jnp.asarray(anc)
        cache["ancestry"] = t(anc)
    want, jnew = jatt.self_attn_step(jp, jnp.asarray(x), jcache,
                                     jnp.asarray(time), H, use_flash=use_flash)
    got, new = att.self_attn_step(p, t(x), cache, time, H,
                                  use_flash=use_flash)
    _close(got, want)
    _close(new["pool_k"], jnew["pool_k"])
    _close(new["pool_v"], jnew["pool_v"])


def test_cross_attn_step_folds_beams():
    """Per-beam queries [B*K, 1, h] against untiled memory [B, S, h]."""
    b, beams, s = 3, 4, 7
    jp = jatt.init_attention(jax.random.PRNGKey(4), HIDDEN, HIDDEN,
                             self_attention=False)
    p = bridge(jp, att.init_attention(GEN, HIDDEN, HIDDEN,
                                      self_attention=False))
    memory = _rand(13, b, s, HIDDEN)
    mask = _pad_keep(b, s, seed=14)
    x = _rand(15, b * beams, 1, HIDDEN)
    jmkv = jatt.cross_attn_precompute(jp, jnp.asarray(memory))
    mkv = att.cross_attn_precompute(p, t(memory))
    _close(mkv["mk"], jmkv["mk"])
    want, _ = jatt.cross_attn_step(jp, jnp.asarray(x), jmkv,
                                   jnp.asarray(mask), H)
    got = att.cross_attn_step(p, t(x), mkv, t(mask), H)
    _close(got, want)


def test_gather_beams():
    b, beams = 3, 4
    x = _rand(16, b * beams, 2, 5)
    idx = np.random.RandomState(17).randint(0, beams, (b, beams))
    want = jcommon.gather_beams(jnp.asarray(x), jnp.asarray(idx), b, beams)
    got = common.gather_beams(t(x), t(idx), b, beams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_prob_from_logits():
    x = _rand(18, 4, 11)
    _close(common.log_prob_from_logits(t(x)),
           jcommon.log_prob_from_logits(jnp.asarray(x)))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_breaks_ties_like_lax(k):
    """Exact ties -- F32_MIN-initialised beams, F32_MIN + x rounding back to
    F32_MIN, repeated logits -- ordered lower index first, as lax.top_k."""
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0, -2.0],
                  [F32_MIN, 0.0, F32_MIN, F32_MIN, F32_MIN + 5.0, 0.0, 0.0],
                  [2.0] * 7], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = top_k(t(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
