"""zero_tpu_torch Transformer-AAN (average attention in the decoder) against
zero_tpu, fp32 on the CPU, on weights bridged from the JAX init_fn:
``aan_cummean`` masked and unmasked against the JAX function and against
``einsum(aan_weight, x)``; then the model: train_fn loss and grads with
the kernel flags off and on (the encoder's fused attention and FFN, their
plain versions here; the decoder runs the composite), with ``use_ffn``
too, score_fn, beam search at beam 3 and 1 over the O(1) running-sum
cache, and cache decode against dev-mode decode."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import bridge, port_config, t  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import nn as jnn  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import nn  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_ffn as ff  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_aan"
NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)
# one layer a side keeps the JAX compiles short
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1)


@pytest.mark.parametrize("masked", [True, False])
def test_aan_cummean_matches_jax_and_the_weight_matrix(masked):
    """The O(L) cumsum form against the JAX function everywhere, and
    against einsum(aan_weight(mask), x) at the valid positions (unmasked,
    padded positions also average the pad inputs); aan_weight against
    JAX's, all-pad row included."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 9, 6).astype(np.float32)
    mask = np.ones((4, 9), np.float32)
    mask[0, 5:] = 0
    mask[2] = 0                 # an all-pad row
    got = nn.aan_cummean(t(x), t(mask), masked=masked)
    want = jnn.aan_cummean(jnp.asarray(x), jnp.asarray(mask), masked=masked)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    weight = nn.aan_weight(t(mask))
    np.testing.assert_allclose(weight.numpy(),
                               np.asarray(jnn.aan_weight(jnp.asarray(mask))),
                               **TOL)
    dense = torch.einsum("bqk,bkd->bqd", weight, t(x)).numpy()
    valid = mask > 0
    np.testing.assert_allclose(got.numpy()[valid], dense[valid], **TOL)
    assert np.isfinite(got.numpy()).all()


def _features():
    # 5 x 6 target positions in chunks of 7: a padded tail; row 2 all-pad
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (5, 6)).astype(np.int32)
    src[0, 4:] = 0
    tgt[1, 3:] = 0
    src[2] = 0
    tgt[2] = 0
    return {"source": src, "target": tgt}


def _jax_loss_and_grads(cfg, jparams, feats, score=False):
    jmodel = jget_model(NAME)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_fn(p, jfeats, cfg,
                                  jax.random.PRNGKey(1))["loss"]))(jparams)
    out = dict(loss=float(loss), grads=_flatten(grads, "params"))
    if score:
        out["score"] = np.asarray(jax.jit(
            lambda p: jmodel.score_fn(p, jfeats, cfg)["score"])(jparams))
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = _features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, feats=feats, jparams=jparams,
                **_jax_loss_and_grads(cfg, jparams, feats, score=True))


def _port_params(jparams, pcfg):
    return bridge(jparams, get_model(NAME).init_fn(torch.Generator(), pcfg))


def _check_train_fn(cfg, jparams, feats, want, **flags):
    """train_fn loss within 1e-5 and each grad within 1e-4 of its max |grad|
    (floored at 1e-3 of the model's largest); returns the launch counts."""
    pcfg = port_config(cfg, **flags)
    params = _port_params(jparams, pcfg)
    fa.launches.clear()
    ff.launches.clear()
    loss = get_model(NAME).train_fn(
        params, {k: t(v) for k, v in feats.items()}, pcfg,
        torch.Generator())["loss"]
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert sorted("params/" + n.replace(".", "/") for n in names) \
        == sorted(want["grads"])
    top = max(np.abs(g).max() for g in want["grads"].values())
    for name, g in zip(names, grads):
        ref = want["grads"]["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-3 * top), (name, err)
    return {**+fa.launches, **+ff.launches}


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(setup, kernels):
    """Flags on: the encoder layer's attention and FFN take the fused
    kernels (plain versions on the CPU); the AAN decoder none."""
    s = setup
    launches = _check_train_fn(s["cfg"], s["jparams"], s["feats"], s,
                               use_flash_attention=kernels,
                               use_fused_ffn=kernels)
    assert "params/decoder/0/z_project/ws/0" in s["grads"]
    assert launches == ({"fused_attention_ref": 1, "fused_ffn_ref": 1}
                        if kernels else {})


def test_use_ffn_unmasked_train_fn_and_decode():
    """use_ffn adds the ``aan_ffn`` on the averaged path and aan_mask=false
    the unmasked mean: train_fn matches JAX, and cache decode (the running
    sum through aan_ffn) equals dev-mode decode."""
    cfg = tiny_config(loss_chunk_tokens=7, use_ffn=True, aan_mask=False,
                      **SIZE, **NO_DROPOUT)
    feats = _features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(2), cfg)
    want = _jax_loss_and_grads(cfg, jparams, feats)
    assert "params/decoder/0/aan_ffn/enlarge/ws/0" in want["grads"]
    _check_train_fn(cfg, jparams, feats, want)
    _check_cache_equals_dev(jparams, cfg, feats["source"])


def test_score_fn_matches_jax(setup):
    s = setup
    pcfg = port_config(s["cfg"])
    with torch.no_grad():
        score = get_model(NAME).score_fn(
            _port_params(s["jparams"], pcfg),
            {k: t(v) for k, v in s["feats"].items()}, pcfg)["score"]
    np.testing.assert_allclose(score.numpy(), s["score"], rtol=1e-5,
                               atol=1e-6)
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("beam", [3, 1])
def test_beam_search_matches_jax(setup, beam):
    """The running-sum cache, beam-gathered by reorder_cache (beam 3 on
    the CPU keeps the ancestry index beside it); sequences identical to
    JAX's."""
    s = setup
    cfg = tiny_config(beam_size=beam, **SIZE)
    src = s["feats"]["source"]
    infer = jget_model(NAME).infer_fn(cfg)
    want = jax.jit(lambda p, x: jbeam_search(p, x, infer, cfg))(
        s["jparams"], jnp.asarray(src))
    pcfg = port_config(cfg)
    with torch.inference_mode():
        got = beam_search(_port_params(s["jparams"], pcfg), t(src).long(),
                          get_model(NAME).infer_fn(pcfg), pcfg)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got["score"].numpy()).all()


def _check_cache_equals_dev(jparams, cfg, src,
                            overrides=({"search_mode": "dev"},)):
    """Beam-3 cache decode (ancestry pools beside the running sum on the
    CPU) against each of ``overrides``' decodes: the same sequences."""
    out = []
    for override in ({},) + tuple(overrides):
        pcfg = port_config(cfg, beam_size=3, **override)
        with torch.inference_mode():
            out.append(beam_search(_port_params(jparams, pcfg),
                                   t(src).long(),
                                   get_model(NAME).infer_fn(pcfg), pcfg))
    for other in out[1:]:
        np.testing.assert_array_equal(other["seq"].numpy(),
                                      out[0]["seq"].numpy())
        np.testing.assert_allclose(other["score"].numpy(),
                                   out[0]["score"].numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("override", [{"search_mode": "dev"},
                                      {"decode_ancestry": "off"}])
def test_cache_decode_equals_other_decode_paths(setup, override):
    """Cache decode == dev-mode (decode_prefix full recompute) decode, and
    == the classic permuted-cache decode."""
    s = setup
    _check_cache_equals_dev(s["jparams"], s["cfg"], s["feats"]["source"],
                            (override,))
