"""zero_tpu_torch transformer_rpr (Shaw relative positions) against zero_tpu,
fp32 on the CPU, on weights bridged from the JAX init_fn: train_fn loss and
grads (the RPR tables included) with the kernel flags off and on (on the
CPU the RPR kernels' plain version), score_fn, beam search at beam 3 and 1,
and ``--mode test`` of a checkpoint written by the JAX package's Saver."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import port_config, t  # noqa: E402
from zero_tpu import evalu as jevalu  # noqa: E402
from zero_tpu.config import default_config  # noqa: E402
from zero_tpu.data import Dataset as JDataset  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.saver import params_from_flat  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)
# 2m = 4 < every sequence length below (7 source, 6 target positions), so
# with use_flash_attention all 1 + 1*2 attentions take the RPR kernel route
# (one layer a side keeps the JAX compiles short)
M = 2
NAME = "transformer_rpr"
SIZE = dict(model_name=NAME, max_relative_position=M, num_encoder_layer=1,
            num_decoder_layer=1)


@pytest.fixture(scope="module")
def setup():
    # 5 x 6 target positions in chunks of 7: a padded tail; row 2 all-pad
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (5, 6)).astype(np.int32)
    src[0, 4:] = 0
    tgt[1, 3:] = 0
    src[2] = 0
    tgt[2] = 0
    feats = {"source": src, "target": tgt}
    jmodel = jget_model(NAME)
    jparams = jmodel.init_fn(jax.random.PRNGKey(0), cfg)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_fn(p, jfeats, cfg,
                                  jax.random.PRNGKey(1))["loss"]))(jparams)
    score = jax.jit(lambda p: jmodel.score_fn(p, jfeats, cfg)["score"])(
        jparams)
    return dict(cfg=cfg, feats=feats, jparams=jparams, loss=float(loss),
                grads=_flatten(grads, "params"), score=np.asarray(score))


def _port_params(s, pcfg):
    params = get_model(NAME).init_fn(torch.Generator(), pcfg)
    params.load_state_dict(params_from_flat(_flatten(s["jparams"],
                                                     "params")))
    return params


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(setup, kernels):
    """kernels=True routes the three attentions of every layer through
    fused_attention's RPR variant (its plain version on the CPU)."""
    s = setup
    pcfg = port_config(s["cfg"], use_flash_attention=kernels,
                       use_fused_ffn=kernels)
    params = _port_params(s, pcfg)
    feats = {k: t(v) for k, v in s["feats"].items()}
    fa.launches.clear()
    loss = get_model(NAME).train_fn(params, feats, pcfg,
                                    torch.Generator())["loss"]
    assert fa.launches["fused_attention_rpr_ref"] == (3 if kernels else 0)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(loss.item() - s["loss"]) <= 1e-5 * abs(s["loss"])
    assert sorted("params/" + n.replace(".", "/") for n in names) \
        == sorted(s["grads"])
    assert {"params/encoder/0/self_rpr/keys",
            "params/decoder/0/self_rpr/values",
            "params/decoder/0/cross_rpr/keys"} <= set(s["grads"])
    # each grad within 1e-4 of its max |grad|, floored at 1e-3 of the
    # model's largest (the cross-attention key bias has an exactly zero
    # gradient in exact arithmetic: both sides hold rounding noise)
    top = max(np.abs(g).max() for g in s["grads"].values())
    for name, g in zip(names, grads):
        want = s["grads"]["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-3 * top), (name,
                                                                   err)


def test_score_fn_matches_jax(setup):
    s = setup
    pcfg = port_config(s["cfg"])
    with torch.no_grad():
        score = get_model(NAME).score_fn(
            _port_params(s, pcfg), {k: t(v) for k, v in s["feats"].items()},
            pcfg)["score"]
    np.testing.assert_allclose(score.numpy(), s["score"], rtol=1e-5,
                               atol=1e-6)
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("beam,ancestry", [(3, "auto"), (3, "off"),
                                           (1, "auto")])
def test_beam_search_matches_jax(setup, beam, ancestry):
    """Beam 3 runs the ancestry pools on the CPU ("auto") and the classic
    permuted cache ("off", the path the card takes for RPR: no pool
    kernel); beam 1 the plain cache. Sequences identical to JAX's."""
    s = setup
    cfg = tiny_config(beam_size=beam, **SIZE)
    src = s["feats"]["source"]
    # one JAX search (one compile) per beam size, shared by its cases
    searches = s.setdefault("jax_searches", {})
    if beam not in searches:
        infer = jget_model(NAME).infer_fn(cfg)
        search = jax.jit(lambda p, x: jbeam_search(p, x, infer, cfg))
        searches[beam] = search(s["jparams"], jnp.asarray(src))
    want = searches[beam]
    pcfg = port_config(cfg, decode_ancestry=ancestry)
    with torch.inference_mode():
        got = beam_search(_port_params(s, pcfg), t(src).long(),
                          get_model(NAME).infer_fn(pcfg), pcfg)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got["score"].numpy()).all()


def _jax_translations(d, spec):
    """JAX package: init transformer_rpr params, save them with its Saver,
    beam-search the test batch; the index-ordered top-beam lines."""
    cfg = default_config().parse(spec)
    cfg.src_vocab = cfg.tgt_vocab = JVocab(str(d / "vocab.txt"))
    model = jget_model(NAME)
    params = model.init_fn(jax.random.PRNGKey(7), cfg)
    JSaver(output_dir=cfg.output_dir).save({"params": params}, step=1)
    data = JDataset(cfg.src_test_file, cfg.tgt_test_file, cfg.src_vocab,
                    cfg.tgt_vocab, max_len=cfg.eval_max_len,
                    pad_seq_multiple=cfg.pad_seq_multiple,
                    pad_batch_to=cfg.eval_batch_size, use_native=False)
    (batch,) = list(data.batcher(cfg.eval_batch_size, shuffle=False,
                                 train=False))
    out = jax.jit(lambda p, s: jbeam_search(p, s, model.infer_fn(cfg), cfg))(
        params, jnp.asarray(batch["src"]))
    n = len(batch["raw"])
    hypos, _ = jevalu.decode_hypothesis(np.asarray(out["seq"])[:n],
                                        np.asarray(out["score"])[:n], cfg)
    return [" ".join(hypos[i]) for i in np.argsort(batch["index"])]


def test_mode_test_reads_jax_rpr_checkpoint_and_matches_jax(tmp_path):
    """A JAX-written transformer_rpr checkpoint (tables under
    ``*/self_rpr/keys`` etc.) decodes through the port's CLI into the JAX
    package's translations."""
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(tmp_path / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(2, 9))) for _ in range(6)]
    for name in ("test.src", "test.tgt"):
        with open(tmp_path / name, "w") as w:
            w.write("\n".join(lines) + "\n")
    spec = ("model_name=transformer_rpr,max_relative_position=3,"
            "hidden_size=16,embed_size=16,filter_size=32,num_heads=2,"
            "num_encoder_layer=2,num_decoder_layer=2,beam_size=3,"
            "decode_length=6,decode_max_len=24,eval_batch_size=8,"
            "pad_seq_multiple=4,shared_source_target_embedding=True,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/out".format(tmp_path))
    want = _jax_translations(tmp_path, spec)
    out_file = tmp_path / "trans.txt"
    summary = run.main(["--mode", "test", "--parameters",
                        spec + ",device=cpu,test_output=%s" % out_file])
    with open(out_file) as r:
        assert r.read().splitlines() == want
    assert summary["sentences"] == 6 and summary["steps"] > 0
