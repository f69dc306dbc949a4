"""zero_tpu_torch transformer_fixup and ops/fixup.py against zero_tpu, fp32
on the CPU: the port's init (the JAX param paths; zero ``o``, FFN output
and separate softmax table; unit scales, zero shifts, no biases; the
numblocks-scaled input inits); shift, scale, the Fixup FFN and the
biasless attention on bridged weights; then the model on perturbed JAX
weights (so that no weight is zero): train_fn loss and grads (no kernel,
whatever the flags say, as in the JAX package), under use_remat too,
score_fn, beam search at beam 4 and 1, cache decode against dev-mode
decode, and a checkpoint across the two packages, the (1,)-shaped
scalars included."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, bridge, check_beam_search,  # noqa: E402
                          check_checkpoint_round_trip, check_same_decode,
                          check_score_fn, check_train_fn, jax_loss_and_grads,
                          parity_features, port_config, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import attention as jatt  # noqa: E402
from zero_tpu.ops import fixup as jfixup  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import attention as att  # noqa: E402
from zero_tpu_torch.ops import fixup  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_fixup"
SIZE = dict(model_name=NAME, num_encoder_layer=2, num_decoder_layer=1,
            shared_target_softmax_embedding=False)


def _perturb(tree, seed):
    """Every leaf plus N(0, 0.1) noise: no zero weight, no unit scale."""
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(treedef, [
        a + jnp.asarray(0.1 * rs.randn(*a.shape).astype(np.float32))
        for a in leaves])


def test_init_follows_the_jax_layout_and_fixup_rules():
    cfg = tiny_config(**SIZE)
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    module = get_model(NAME).init_fn(torch.Generator().manual_seed(0),
                                     port_config(cfg))
    want = {k: v.shape for k, v in _flatten(jparams, "params").items()}
    got = {"params/" + n.replace(".", "/"): tuple(p.shape)
           for n, p in module.named_parameters()}
    assert got == want
    for n, p in module.named_parameters():
        if n.endswith(("o.ws.0", "ffn.output.ws.0")) or n in (
                "softmax_embedding",) or n.endswith("offset"):
            assert not p.any(), n
        elif n.endswith(".scale") and p.shape == (1,):
            assert p.item() == 1.0, n
    assert not any(n.endswith(".b") for n, _ in module.named_parameters())
    # the numblocks-scaled inits: each weight's largest |value| (near its
    # uniform limit) is the JAX init's
    for path in ("encoder/0/self/qkv/ws/0", "encoder/0/ffn/enlarge/ws/0",
                 "decoder/0/cross/q/ws/0"):
        got = dict(module.named_parameters())[path.replace("/", ".")]
        want = np.abs(_flatten(jparams, "params")["params/" + path]).max()
        assert 0.8 < got.abs().max().item() / want < 1.25, path


@torch.no_grad()
@pytest.mark.parametrize("self_attention", [True, False])
def test_fixup_ops_match_jax(self_attention):
    """shift, scale, the Fixup FFN (dropout off) and the biasless
    attention, on perturbed weights."""
    h = 16
    rs = np.random.RandomState(1)
    x = rs.randn(3, 6, h).astype(np.float32)
    jffn = _perturb(jfixup.init_fixup_ffn(jax.random.PRNGKey(2), h, 32, h,
                                          numblocks=7), 3)
    ffn = bridge(jffn, fixup.init_fixup_ffn(torch.Generator(), h, 32, h,
                                            numblocks=7))
    np.testing.assert_allclose(
        fixup.fixup_ffn(ffn, t(x)).numpy(),
        np.asarray(jfixup.fixup_ffn(jffn, jnp.asarray(x))), **TOL)
    for got, want in (
            (fixup.shift(ffn.shift1, t(x)),
             jfixup.shift(jffn["shift1"], jnp.asarray(x))),
            (fixup.scale(ffn.scale, t(x)),
             jfixup.scale(jffn["scale"], jnp.asarray(x)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jattn = _perturb(jfixup.init_fixup_attention(
        jax.random.PRNGKey(4), h, h, self_attention, numblocks=7,
        d_memory=None if self_attention else h), 5)
    attn = bridge(jattn, fixup.init_fixup_attention(
        torch.Generator(), h, h, self_attention, numblocks=7,
        d_memory=None if self_attention else h))
    memory = None if self_attention else rs.randn(3, 5, h).astype(np.float32)
    keep = np.ones((3, 1, 1, 6 if self_attention else 5), np.float32)
    keep[1, ..., 3:] = 0
    want = jatt.attn_train(jattn, jnp.asarray(x),
                           None if memory is None else jnp.asarray(memory),
                           jnp.asarray(keep), 2)["output"]
    got = att.attn_train(attn, t(x), None if memory is None else t(memory),
                         t(keep), 2)["output"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = parity_features()
    jparams = _perturb(jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg),
                       6)
    return dict(cfg=cfg, feats=feats, jparams=jparams,
                **jax_loss_and_grads(NAME, cfg, jparams, feats, score=True))


@pytest.mark.parametrize("flags", [{}, {"kernels": True},
                                   {"kernels": True, "use_remat": True}])
def test_train_fn_and_grads_match_jax(setup, flags):
    """No kernel runs: Fixup's layers pass no kernel flag."""
    s = setup
    kernels = flags.get("kernels", False)
    launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"], s,
                              use_flash_attention=kernels,
                              use_fused_ffn=kernels,
                              use_remat=flags.get("use_remat", False))
    assert "params/enc_post/scale/scale" in s["grads"]
    assert "params/dec_post/shift/offset" in s["grads"]
    assert launches == {}


def test_score_fn_matches_jax(setup):
    s = setup
    score = check_score_fn(NAME, s["cfg"], s["jparams"], s["feats"],
                           s["score"])
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("beam", [4, 1])
def test_beam_search_matches_jax(setup, beam):
    """Beam 4 on the CPU decodes over the ancestry pools (use_flash_decode
    on: the pool kernel's plain version), beam 1 the plain cache."""
    s = setup
    check_beam_search(NAME, tiny_config(beam_size=beam, **SIZE),
                      s["jparams"], s["feats"]["source"])


@pytest.mark.parametrize("override", [{"search_mode": "dev"},
                                      {"decode_ancestry": "off"}])
def test_cache_decode_equals_other_decode_paths(setup, override):
    s = setup
    check_same_decode(NAME, tiny_config(beam_size=4, **SIZE), s["jparams"],
                      s["feats"]["source"], override)


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(NAME, s["cfg"], s["jparams"], str(tmp_path))
