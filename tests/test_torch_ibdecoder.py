"""zero_tpu_torch transformer_ibdecoder and search.ib_beam_search against
zero_tpu, fp32 on the CPU, on weights bridged from the JAX init_fn:
interleave_target, unfold and pair_causal_mask (exact); train_fn loss and
grads and score_fn with the kernel flags off and on (R1: with
use_flash_attention the decoder self-attention takes the token-causal
flag and drops the pair mask, in both packages); the cached pair step and
the dev-mode decode_prefix, each against JAX's, equal to each other only
with the flag off; the pair beam search at beam 4 and 1 over a batch
where a stream ends at pair 0 and a row is all pad; the host-side decode
through train.make_decode_fn; the ensemble refusal; a checkpoint across
the two packages."""

from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_checkpoint_round_trip,  # noqa: E402
                          check_score_fn, check_train_fn, port_config,
                          port_params, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.models import transformer_ibdecoder as jib  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import ib_beam_search as jib_beam_search  # noqa: E402
from zero_tpu_torch import train as port_train  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.models import transformer_ibdecoder as ib  # noqa: E402
from zero_tpu_torch.search import ib_beam_search  # noqa: E402

NAME = "transformer_ibdecoder"
EOS = 2
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=2)
FLAGS = {"off": {}, "on": dict(use_flash_attention=True,
                               use_fused_ffn=True)}


def _targets(m_dim, rs):
    """Rows of every content length 0..m_dim-1 closed by eos, an all-pad
    row and a row without eos (the length counts non-zero tokens)."""
    rows = []
    for n in range(m_dim):
        rows.append(list(rs.randint(3, 20, n)) + [EOS] + [0] * (m_dim - n - 1))
    rows.append([0] * m_dim)
    rows.append(list(rs.randint(3, 20, m_dim)))
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("m_dim", [7, 8])
def test_interleave_target_and_unfold_match_jax(m_dim):
    target = _targets(m_dim, np.random.RandomState(m_dim))
    got = ib.interleave_target(t(target), EOS).numpy()
    want = np.asarray(jib.interleave_target(jnp.asarray(target), EOS))
    np.testing.assert_array_equal(got, want)
    for n in range(m_dim):       # the eos-closed rows come back whole
        y = [int(v) for v in target[n, :n]]
        assert ib.unfold(got[n], EOS) == jib.unfold(want[n], EOS) == y


def test_unfold_matches_jax_on_arbitrary_sequences():
    rs = np.random.RandomState(3)
    for _ in range(60):
        z = rs.choice([0, EOS, 3, 4, 5, 6, 7], rs.randint(1, 12))
        assert ib.unfold(z, EOS) == jib.unfold(z, EOS)


@pytest.mark.parametrize("z_len", [6, 7])
def test_pair_causal_mask_matches_jax(z_len):
    np.testing.assert_array_equal(ib.pair_causal_mask(z_len).numpy(),
                                  np.asarray(jib.pair_causal_mask(z_len)))


def _features():
    """5 sentences: a 5-token target, a one-token target (its r2l stream
    ends at pair 0), an all-pad row, an eos-only target, an even one."""
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    src[0, 5:] = 0
    src[2] = 0
    tgt = np.zeros((5, 7), np.int32)
    for row, n in ((0, 5), (1, 1), (3, 0), (4, 4)):
        tgt[row, :n] = rs.randint(3, 20, n)
        tgt[row, n] = EOS
    return {"source": src, "target": tgt}


@pytest.fixture(scope="module")
def setup():
    """The JAX loss, grads and scores with the flags off and on, in one
    jitted call (on the CPU the JAX package's kernel route is the
    mathematically equal XLA form, under the causal flag)."""
    cfgs = {k: tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT, **f)
            for k, f in FLAGS.items()}
    feats = _features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfgs["off"])
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    model = jget_model(NAME)

    def both(p):
        out = {}
        for k, cfg in cfgs.items():
            loss, grads = jax.value_and_grad(
                lambda q: model.train_fn(q, jfeats, cfg,
                                         jax.random.PRNGKey(1))["loss"])(p)
            out[k] = (loss, grads, model.score_fn(p, jfeats, cfg)["score"])
        return out

    want = {k: dict(loss=float(loss), grads=_flatten(grads, "params"),
                    score=np.asarray(score))
            for k, (loss, grads, score) in jax.jit(both)(jparams).items()}
    return dict(cfgs=cfgs, feats=feats, jparams=jparams, want=want)


@pytest.mark.parametrize("flag", ["off", "on"])
def test_train_fn_and_grads_match_jax(setup, flag):
    """Flag on: the encoder and both decoder attentions take the fused
    kernel (plain version here), the decoder self-attention under the
    token-causal flag (R1), every FFN the fused kernel."""
    s = setup
    launches = check_train_fn(NAME, s["cfgs"][flag], s["jparams"],
                              s["feats"], s["want"][flag])
    assert launches == ({"fused_attention_ref": 5, "fused_ffn_ref": 3}
                        if flag == "on" else {})
    assert np.abs(s["want"][flag]["grads"]["params/dir_embedding"]).max() > 0


def test_the_kernel_flag_changes_the_loss_in_both_packages(setup):
    """R1: the pair mask (flag off) and the token-causal flag (on) give
    losses further apart than train_fn's parity tolerance (1e-5
    relative), so the tests above tell the two routes apart."""
    want = setup["want"]
    gap = abs(want["on"]["loss"] - want["off"]["loss"])
    assert gap > 2e-5 * abs(want["off"]["loss"]), gap


@pytest.mark.parametrize("flag", ["off", "on"])
def test_score_fn_matches_jax(setup, flag):
    """The all-pad row scores too: its interleaved target is one eos per
    stream, in both packages."""
    s = setup
    check_score_fn(NAME, s["cfgs"][flag], s["jparams"], s["feats"],
                   s["want"][flag]["score"])


@pytest.mark.parametrize("flag", ["off", "on"])
def test_pair_step_and_prefix_decode_match_jax(setup, flag):
    """The cached pair step (decode_pair, two positions at time 2i) and
    the dev-mode recompute (decode_prefix) over one interleaved buffer,
    each against JAX's. With the flag off they agree; with it on they do
    not, in either package (R1: decode_prefix runs the training path,
    whose self-attention takes the token-causal flag, while the cached
    step lets both slots of a pair see each other)."""
    s = setup
    cfg = s["cfgs"][flag]
    pcfg = port_config(cfg)
    params = port_params(NAME, s["jparams"], pcfg)
    src = s["feats"]["source"]
    z = np.asarray(jib.interleave_target(jnp.asarray(s["feats"]["target"]),
                                         EOS))
    pairs = z.shape[1] // 2
    jinf, pinf = jget_model(NAME).infer_fn(cfg), get_model(NAME).infer_fn(pcfg)

    jstate = jinf.encode(s["jparams"], jnp.asarray(src))
    jcache = jinf.init_cache(s["jparams"], jstate, src.shape[0], z.shape[1])
    jstep, jprefix = [], []
    for i in range(pairs):
        prev = jnp.asarray(z[:, max(2 * i - 2, 0):max(2 * i - 2, 0) + 2])
        logits, jcache = jinf.decode_pair(s["jparams"], prev, jstate, jcache,
                                          i)
        jstep.append(np.asarray(logits))
        jprefix.append(np.asarray(jinf.decode_prefix(
            s["jparams"], jnp.asarray(z), jstate, i)))

    with torch.inference_mode():
        pstate = pinf.encode(params, t(src).long())
        pcache = pinf.init_cache(params, pstate, src.shape[0], z.shape[1])
        pstep, pprefix = [], []
        for i in range(pairs):
            prev = t(z[:, max(2 * i - 2, 0):max(2 * i - 2, 0) + 2]).long()
            logits, pcache = pinf.decode_pair(params, prev, pstate, pcache, i)
            pstep.append(logits.numpy())
            pprefix.append(pinf.decode_prefix(params, t(z).long(), pstate,
                                              i).numpy())
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.stack(pstep), np.stack(jstep), **tol)
    np.testing.assert_allclose(np.stack(pprefix), np.stack(jprefix), **tol)
    gap = np.abs(np.stack(pstep) - np.stack(pprefix)).max()
    if flag == "off":
        assert gap <= 1e-4, gap
    else:
        assert gap > 1e-3, gap


@pytest.fixture(scope="module")
def eos_params(setup):
    """JAX weights whose last decoder layer's output leans toward eos (its
    ln3 offset along eos's tied embedding), so some streams end at pair 0
    (the r2l stream of a one-token hypothesis)."""
    params = jax.tree.map(lambda x: x, setup["jparams"])
    eos_row = params["tgt_embedding"][EOS]
    params["decoder"][-1]["ln3"]["offset"] = \
        1.5 * eos_row / jnp.linalg.norm(eos_row)
    return params


def _beam_source():
    rs = np.random.RandomState(5)
    src = rs.randint(3, 20, (4, 6)).astype(np.int32)
    src[1, 3:] = 0
    src[3] = 0                       # an all-pad row
    return src


@pytest.mark.parametrize("beam,flag", [(4, "off"), (1, "off"), (4, "on")])
def test_ib_beam_search_matches_jax(setup, eos_params, beam, flag):
    """The same interleaved sequences, scores within 1e-4, pair steps as
    many as JAX's loop ran; the batch holds hypotheses whose r2l stream
    emitted eos at pair 0 and an all-pad row."""
    cfg = tiny_config(beam_size=beam, **SIZE, **NO_DROPOUT, **FLAGS[flag])
    src = _beam_source()
    want = jax.jit(lambda p, x: jib_beam_search(
        p, x, jget_model(NAME).infer_fn(cfg), cfg))(eos_params,
                                                    jnp.asarray(src))
    pcfg = port_config(cfg)
    with torch.inference_mode():
        got = ib_beam_search(port_params(NAME, eos_params, pcfg),
                             t(src).long(), get_model(NAME).infer_fn(pcfg),
                             pcfg)
    seq = got["seq"].numpy()
    np.testing.assert_array_equal(seq, np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got["score"].numpy()).all()
    assert (seq[:, :, 1] == EOS).any()           # r2l done at pair 0
    assert (seq[:, :, 1] != EOS).any()


def test_decode_fn_unfolds_the_pair_search(setup, eos_params):
    """train.make_decode_fn runs ib_beam_search and unfolds each [b, k]
    row on the host into y."""
    cfg = tiny_config(beam_size=4, **SIZE, **NO_DROPOUT)
    pcfg = port_config(cfg)
    params = port_params(NAME, eos_params, pcfg)
    src = _beam_source()
    out = port_train.make_decode_fn(pcfg)(params, {"src": src})
    with torch.inference_mode():
        z = ib_beam_search(params, t(src).long(),
                           get_model(NAME).infer_fn(pcfg), pcfg)["seq"]
    for bi in range(src.shape[0]):
        for ki in range(4):
            toks = jib.unfold(z[bi, ki].numpy(), EOS)
            assert list(out["seq"][bi, ki, :len(toks)]) == toks
            assert not out["seq"][bi, ki, len(toks):].any()
    assert out["steps"] > 0


def test_ensemble_of_an_ibdecoder_raises_before_decoding(tmp_path):
    cfgs = [port_config(tiny_config(**SIZE), output_dir=str(tmp_path / d))
            for d in ("a", "b")]
    cfgs[1].model_name = "transformer"
    with mock.patch.object(port_train, "make_decode_fn") as decode:
        with pytest.raises(ValueError, match="transformer_ibdecoder"):
            port_train.ensemble(cfgs)
        with pytest.raises(ValueError, match="transformer_ibdecoder"):
            port_train.ensemble(cfgs[::-1])
    decode.assert_not_called()


def test_checkpoint_round_trips_between_the_packages(setup, tmp_path):
    check_checkpoint_round_trip(NAME, setup["cfgs"]["off"], setup["jparams"],
                                str(tmp_path))
