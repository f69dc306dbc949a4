"""zero_tpu_torch transformer_multilingual (LaLN, LaLT) and ROBT against
zero_tpu, fp32 on the CPU, on weights bridged from the JAX init_fn:
lang_layer_norm, the LaLT product and its grads, greedy_decode and the
ROBT augmentation (one intermediate language injected on both sides);
then the model: train_fn loss and grads with ROBT off (kernel flags on:
the encoder's kernels) and on, use_remat ignored as in the JAX package,
score_fn, beam search at beam 4 and 1, cache decode against dev mode, and
a checkpoint across the two packages."""

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
                          launch_counters, port_config, port_params, t,
                          tagged_features)
from zero_tpu import robt as jrobt  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.models import transformer_multilingual as jml  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch import robt  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.models import transformer_multilingual as ml  # noqa: E402
from zero_tpu_torch.train_step import make_micro_backward  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "transformer_multilingual"
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1,
            num_languages=3, lang_id_offset=3)
ROBT_WEIGHT = 0.5
Z = np.array([[2], [0], [1], [2], [1]], np.int32)   # injected languages


def test_lang_layer_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5, 6).astype(np.float32)
    lang = np.array([2, 0, 2, 1], np.int32)
    scale = rs.randn(3, 6).astype(np.float32)
    offset = rs.randn(3, 6).astype(np.float32)
    want = jml.lang_layer_norm({"scale": jnp.asarray(scale),
                                "offset": jnp.asarray(offset)},
                               jnp.asarray(x), jnp.asarray(lang))
    p = ml.init_lang_ln(3, 6)
    with torch.no_grad():
        p.scale.copy_(t(scale))
        p.offset.copy_(t(offset))
    got = ml.lang_layer_norm(p, t(x), t(lang))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(4, 5, 6), (4, 1, 6)])
def test_lalt_and_its_grads_match_jax(shape):
    """Rows share languages (2 twice); the weight grads sum per language
    and a language no row uses gets none."""
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    w = rs.randn(4, 6, 6).astype(np.float32)
    lang = np.array([2, 0, 2, 1], np.int32)

    def f(ww, xx):
        return jnp.sum(jml._lalt({"lalt": ww}, xx, jnp.asarray(lang)) * r)

    (want, (gw, gx)) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(x))
    wt, xt = t(w).requires_grad_(), t(x).requires_grad_()
    y = ml.lang_matmul(xt, wt, t(lang))
    got = (y * t(r)).sum()
    dw, dx = torch.autograd.grad(got, [wt, xt])
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **TOL)
    assert (dw[3] == 0).all()


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    feats = tagged_features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    # the decoder's language parameters away from their init, so that
    # each language's rows differ
    rs = np.random.RandomState(2)
    jparams["lalt"] = jparams["lalt"] + jnp.asarray(
        0.3 * rs.randn(*jparams["lalt"].shape).astype(np.float32))
    for ln in ("ln1", "ln2", "ln3"):
        jparams["decoder"][0][ln]["scale"] = jnp.asarray(
            1.0 + 0.3 * rs.randn(3, 16).astype(np.float32))
    want = jax_loss_and_grads(NAME, cfg, jparams, feats, score=True)
    return dict(cfg=cfg, feats=feats, jparams=jparams, **want)


@pytest.fixture(scope="module")
def robt_want(setup):
    """The JAX package's ROBT loss (its train_step loss_fn's formula) and
    grads, the synthetic batch and the greedy decode, with Z injected."""
    s = setup
    cfg = tiny_config(robt=True, robt_weight=ROBT_WEIGHT, loss_chunk_tokens=7,
                      **SIZE, **NO_DROPOUT)
    jmodel = jget_model(NAME)
    jfeats = {k: jnp.asarray(v) for k, v in s["feats"].items()}
    augment = jrobt.make_augment(jmodel, cfg)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        loss = jmodel.train_fn(p, jfeats, cfg, key)["loss"]
        bt = augment(p, jfeats, key)
        bt_loss = jmodel.train_fn(p, bt, cfg, key)["loss"]
        return (loss + ROBT_WEIGHT * bt_loss) / (1.0 + ROBT_WEIGHT), bt

    with mock.patch.object(jax.random, "randint",
                           lambda *a, **k: jnp.asarray(Z)):
        (loss, bt), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(s["jparams"])
    return dict(cfg=cfg, loss=float(loss), grads=_flatten(grads, "params"),
                source=np.asarray(bt["source"]))


def _softmax_table_key(jparams):
    for key in ("embedding", "softmax_embedding", "tgt_embedding"):
        if key in jparams:
            return key


def _port_greedy(jparams, cfg, src, out_len):
    pcfg = port_config(cfg)
    with torch.no_grad():
        return robt.greedy_decode(port_params(NAME, jparams, pcfg), t(src),
                                  get_model(NAME).infer_fn(pcfg), pcfg,
                                  out_len).numpy()


def test_greedy_decode_matches_jax(setup):
    """Rows hold tokens, then eos, then pad; eos never comes first. The
    eos row of the softmax table is made a multiple of the row of the
    token the model repeats most, so that streams end."""
    s = setup
    cfg = tiny_config(**SIZE)
    src = s["feats"]["source"]
    eos = cfg.tgt_vocab.eos()
    first = _port_greedy(s["jparams"], cfg, src, 12)[:, 1:].ravel()
    word = np.bincount(first[first > eos]).argmax()
    jparams = dict(s["jparams"])
    key = _softmax_table_key(jparams)
    jparams[key] = jparams[key].at[eos].set(1.5 * jparams[key][word])
    want = np.asarray(jax.jit(lambda p, x: jrobt.greedy_decode(
        p, x, jget_model(NAME).infer_fn(cfg), cfg, 12))(
            jparams, jnp.asarray(src)))
    got = _port_greedy(jparams, cfg, src, 12)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] != eos).all()
    ended = 0
    for row in got:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            ended += 1
            assert (row[:hits[0]] > eos).all()
            assert (row[hits[0] + 1:] == 0).all()
        else:
            assert (row > eos).all()
    assert ended > 0


def _port_robt(s, cfg, z=Z):
    """The port's microbatch loss and grads through the train step's
    make_micro_backward, Z injected; returns (loss, {name: grad},
    synthetic sources)."""
    pcfg = port_config(cfg)
    params = port_params(NAME, s["jparams"], pcfg)
    sources = []
    real_train_fn = get_model(NAME).train_fn

    class Spy:
        infer_fn = staticmethod(get_model(NAME).infer_fn)

        @staticmethod
        def train_fn(p, feats, c, gen, step=0):
            sources.append(feats["source"])
            return real_train_fn(p, feats, c, gen, step=step)

    with mock.patch.object(robt, "draw_languages",
                           lambda gen, rows, n, device: t(z).long()):
        loss = make_micro_backward(Spy, pcfg)(
            params, {k: t(v) for k, v in s["feats"].items()},
            torch.Generator().manual_seed(0), 0)
    grads = {"params/" + n.replace(".", "/"): p.grad
             for n, p in params.named_parameters()}
    return loss.item(), grads, sources


def test_robt_loss_and_grads_match_jax(setup, robt_want):
    """robt=true back-translates and changes the loss; the weighted loss,
    every grad and the synthetic batch equal JAX's (the original tag in
    front; the all-pad row stays all-pad)."""
    s, w = setup, robt_want
    loss, grads, sources = _port_robt(s, w["cfg"])
    assert abs(loss - w["loss"]) <= 1e-5 * abs(w["loss"])
    # ROBT off gives JAX's plain loss; on, the loss moves by far more
    # than the tolerance
    assert abs(loss - s["loss"]) > 1e-5 * abs(s["loss"])
    top = max(np.abs(g).max() for g in w["grads"].values())
    assert sorted(grads) == sorted(w["grads"])
    for k, g in grads.items():
        ref = w["grads"][k]
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-3 * top), (k, err)
    synth = sources[1].numpy()
    np.testing.assert_array_equal(synth, w["source"])
    np.testing.assert_array_equal(synth[:, 0], s["feats"]["source"][:, 0])
    assert (synth[2] == 0).all()
    assert (synth != s["feats"]["source"]).any()
    off, _, _ = _port_robt(s, s["cfg"])
    assert abs(off - s["loss"]) <= 1e-5 * abs(s["loss"])


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(setup, kernels):
    """Flags on: the encoder's attention and FFN take the kernels (their
    plain versions here); the decoder passes no flag."""
    s = setup
    launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"], s,
                              use_flash_attention=kernels,
                              use_fused_ffn=kernels)
    assert launches == ({"fused_attention_ref": 1, "fused_ffn_ref": 1}
                        if kernels else {})


def test_use_remat_is_ignored_as_in_jax(setup):
    """The model's own train_fn: use_remat gives the same loss and the same
    launches (with dropout on)."""
    s = setup
    out = {}
    for remat in (False, True):
        pcfg = port_config(tiny_config(**SIZE), use_remat=remat,
                           use_flash_attention=True, use_fused_ffn=True)
        for c in launch_counters():
            c.clear()
        loss = get_model(NAME).train_fn(
            port_params(NAME, s["jparams"], pcfg),
            {k: t(v) for k, v in s["feats"].items()}, pcfg,
            torch.Generator().manual_seed(3))["loss"]
        launches = {}
        for c in launch_counters():
            launches.update(+c)
        out[remat] = (loss.item(), launches)
    assert out[True] == out[False]


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


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(NAME, s["cfg"], s["jparams"], str(tmp_path))
