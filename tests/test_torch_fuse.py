"""zero_tpu_torch transformer_fuse (merged attention: cross attention plus
the AAN average of the query side) against zero_tpu, fp32 on the CPU, on
weights bridged from the JAX init_fn: the fuse path of ``attn_train``
(the raw target mask and the averaging matrix), ``cross_attn_step``'s
running sum, the count softmax; then the model at depth-scaled init:
train_fn loss and grads with the kernel flags off and on (the encoder's
fused attention and FFN, their plain versions here; the merged decoder
takes no kernel), score_fn, beam search at beam 4 and 1 over the O(1)
running-sum cache, and cache decode against dev-mode decode."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, bridge, check_beam_search,  # noqa: E402
                          check_same_decode, check_score_fn, check_train_fn,
                          jax_loss_and_grads, parity_features, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import attention as jatt  # noqa: E402
from zero_tpu.ops import nn as jnn  # noqa: E402
from zero_tpu_torch.ops import attention as att  # noqa: E402
from zero_tpu_torch.ops import nn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_fuse"
HIDDEN, H = 16, 2
# one layer a side keeps the JAX compiles short
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1,
            deep_transformer_init=True)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pad_mask(b, s, seed):
    mask = np.ones((b, s), np.float32)
    for i, n in enumerate(np.random.RandomState(seed).randint(1, s + 1, b)):
        mask[i, n:] = 0
    mask[-1] = 0   # an all-pad row
    return mask


def _fuse_params(seed):
    jp = jatt.init_attention(jax.random.PRNGKey(seed), HIDDEN, HIDDEN,
                             self_attention=False, d_memory=HIDDEN,
                             fuse=True)
    p = bridge(jp, att.init_attention(torch.Generator(), HIDDEN, HIDDEN,
                                      self_attention=False, d_memory=HIDDEN,
                                      fuse=True))
    return jp, p


@torch.no_grad()
@pytest.mark.parametrize("form", ["fuse_mask", "fuse_weight"])
def test_fuse_attn_train_matches_jax(form):
    """Cross attention plus the masked cumulative mean of v(query): from
    the raw [B, Lq] mask (O(L) cumsum) and from the [B, Lq, Lq] matrix."""
    jp, p = _fuse_params(1)
    assert sorted(n for n, _ in p.named_parameters()) == [
        "k.b", "k.ws.0", "o.b", "o.ws.0", "q.b", "q.ws.0", "v.b", "v.ws.0"]
    x, memory = _rand(2, 3, 6, HIDDEN), _rand(3, 3, 5, HIDDEN)
    keep = np.asarray(jnn.masking_mask(jnp.asarray(_pad_mask(3, 5, 4))))
    tgt_mask = _pad_mask(3, 6, 5)
    fuse = ({"fuse_mask": tgt_mask} if form == "fuse_mask" else
            {"fuse_weight": np.asarray(jnn.aan_weight(
                jnp.asarray(tgt_mask)))})
    want = jatt.attn_train(jp, jnp.asarray(x), jnp.asarray(memory),
                           jnp.asarray(keep), H,
                           **{k: jnp.asarray(v) for k, v in fuse.items()})
    got = att.attn_train(p, t(x), t(memory), t(keep), H,
                         **{k: t(v) for k, v in fuse.items()})
    np.testing.assert_allclose(got["output"].numpy(),
                               np.asarray(want["output"]), **TOL)


@torch.no_grad()
def test_fuse_cross_attn_step_matches_jax():
    """The decode step: beam-folded cross attention plus (sum + v_q) /
    (time + 1); the new running sum too."""
    jp, p = _fuse_params(6)
    b, beams, s, time = 3, 2, 5, 4
    memory = _rand(7, b, s, HIDDEN)
    mask = _pad_mask(b, s, 8)
    x = _rand(9, b * beams, 1, HIDDEN)
    aan_sum = _rand(10, b * beams, 1, HIDDEN)
    jmkv = jatt.cross_attn_precompute(jp, jnp.asarray(memory))
    want, want_sum = jatt.cross_attn_step(
        jp, jnp.asarray(x), jmkv, jnp.asarray(mask), H,
        aan_sum=jnp.asarray(aan_sum), time=jnp.asarray(time))
    got, got_sum = att.cross_attn_step(
        p, t(x), att.cross_attn_precompute(p, t(memory)), t(mask), H,
        aan_sum=t(aan_sum), time=time)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), **TOL)


@torch.no_grad()
@pytest.mark.parametrize("where", ["attn_train", "cross_attn_step"])
def test_count_softmax_matches_jax(where):
    """exp-logits times the counts, then normalised, over a pad mask with
    an all-pad row (uniform by count, finite); attn_train keeps the
    composite under use_flash."""
    jp = jatt.init_attention(jax.random.PRNGKey(11), HIDDEN, HIDDEN,
                             self_attention=False)
    p = bridge(jp, att.init_attention(torch.Generator(), HIDDEN, HIDDEN,
                                      self_attention=False))
    b, s = 3, 5
    memory = _rand(12, b, s, HIDDEN)
    mask = _pad_mask(b, s, 13)
    count = np.random.RandomState(14).randint(1, 4, (b, s)).astype(np.float32)
    if where == "attn_train":
        x = _rand(15, b, 4, HIDDEN)
        keep = np.asarray(jnn.masking_mask(jnp.asarray(mask)))
        want = jatt.attn_train(jp, jnp.asarray(x), jnp.asarray(memory),
                               jnp.asarray(keep), H,
                               count_weights=jnp.asarray(count))
        got = att.attn_train(p, t(x), t(memory), t(keep), H, use_flash=True,
                             pad_mask=t(mask), count_weights=t(count))
        np.testing.assert_allclose(got["weights"].numpy(),
                                   np.asarray(want["weights"]), **TOL)
        got, want = got["output"], want["output"]
    else:
        x = _rand(16, b * 2, 1, HIDDEN)
        jmkv = jatt.cross_attn_precompute(jp, jnp.asarray(memory))
        want, _ = jatt.cross_attn_step(jp, jnp.asarray(x), jmkv,
                                       jnp.asarray(mask), H,
                                       count_weights=jnp.asarray(count))
        got = att.cross_attn_step(p, t(x), att.cross_attn_precompute(
            p, t(memory)), t(mask), H, count_weights=t(count))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_aan_step_count_rounds_to_the_compute_dtype():
    assert nn.aan_step_count(256, torch.bfloat16) == 256.0
    assert nn.aan_step_count(256, torch.float32) == 257.0


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = parity_features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, feats=feats, jparams=jparams,
                **jax_loss_and_grads(NAME, cfg, jparams, feats, score=True))


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(setup, kernels):
    """Flags on: the encoder layer's attention and FFN take the fused
    kernels (plain versions on the CPU); the merged decoder none."""
    s = setup
    launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"], s,
                              use_flash_attention=kernels,
                              use_fused_ffn=kernels)
    assert "params/decoder/0/fuse/v/ws/0" in s["grads"]
    assert launches == ({"fused_attention_ref": 1, "fused_ffn_ref": 1}
                        if kernels else {})


def test_score_fn_matches_jax(setup):
    s = setup
    score = check_score_fn(NAME, s["cfg"], s["jparams"], s["feats"],
                           s["score"])
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("beam", [4, 1])
def test_beam_search_matches_jax(setup, beam):
    """The running-sum cache, beam-gathered by reorder_cache (beam 4 on the
    CPU keeps the ancestry index beside it); sequences identical."""
    s = setup
    check_beam_search(NAME, tiny_config(beam_size=beam, **SIZE),
                      s["jparams"], s["feats"]["source"])


@pytest.mark.parametrize("override", [{"search_mode": "dev"},
                                      {"decode_ancestry": "off"}])
def test_cache_decode_equals_other_decode_paths(setup, override):
    s = setup
    check_same_decode(NAME, tiny_config(beam_size=4, **SIZE), s["jparams"],
                      s["feats"]["source"], override)
