"""zero_tpu_torch's long-sequence slice against zero_tpu: transformer-base
with use_flash_attention on sequences past the fused kernel's key limit,
which both packages' ``MAX_LK`` lowers to 64 here (lengths of 128), so
every attention streams: train_fn loss and grads, score_fn, and ``--mode
test`` at beam 4 of a checkpoint written by the JAX package's Saver, fp32
on the CPU (the JAX package off the TPU computes the streamed attention in
its dense XLA form, the port in the streaming kernels' plain version). And
the decoder builds no [L, L] causal mask when every layer takes a kernel;
token batching keeps one long pair per batch."""

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
from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import nn as port_nn  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import streaming_attention as sa  # noqa: E402
from zero_tpu_torch.saver import params_from_flat  # noqa: E402

MAX_LK = 64
L = 128
NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)


@pytest.fixture(scope="module")
def low_max_lk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "MAX_LK", MAX_LK)
        mp.setattr(fa, "MAX_LK", MAX_LK)
        yield


@pytest.fixture(scope="module")
def setup(low_max_lk):
    # 3 rows of 128 positions (loss chunks of 100: a padded tail); row 1
    # shorter, row 2 all-pad; one layer a side
    cfg = tiny_config(model_name="transformer", use_flash_attention=True,
                      loss_chunk_tokens=100, max_len=L, num_encoder_layer=1,
                      num_decoder_layer=1, **NO_DROPOUT)
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (3, L)).astype(np.int32)
    tgt = rs.randint(3, 20, (3, L)).astype(np.int32)
    src[1, 90:] = 0
    tgt[1, 70:] = 0
    src[2] = 0
    tgt[2] = 0
    feats = {"source": src, "target": tgt}
    jmodel = jget_model("transformer")
    jparams = jmodel.init_fn(jax.random.PRNGKey(0), cfg)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_fn(p, jfeats, cfg,
                                  jax.random.PRNGKey(1))["loss"]))(jparams)
    score = jax.jit(lambda p: jmodel.score_fn(p, jfeats, cfg)["score"])(
        jparams)
    pcfg = port_config(cfg)
    params = get_model("transformer").init_fn(torch.Generator(), pcfg)
    params.load_state_dict(params_from_flat(_flatten(jparams, "params")))
    return dict(pcfg=pcfg, params=params,
                feats={k: t(v) for k, v in feats.items()}, loss=float(loss),
                grads=_flatten(grads, "params"), score=np.asarray(score))


def _streamed(fn):
    """fn() with the kernels' launch counters cleared; returns its result
    and the nonzero counts."""
    sa.launches.clear()
    fa.launches.clear()
    out = fn()
    counts = {**sa.launches, **fa.launches}
    return out, {n: c for n, c in counts.items() if c}


def test_train_fn_and_grads_match_jax(setup):
    """All 1 + 1*2 attentions stream (one plain call each); loss within
    1e-5, grads within 1e-4 of their max."""
    s = setup
    model = get_model("transformer")
    loss, counts = _streamed(lambda: model.train_fn(
        s["params"], s["feats"], s["pcfg"], torch.Generator())["loss"])
    assert counts == {"streaming_attention_ref": 3}
    names = [n for n, _ in s["params"].named_parameters()]
    grads = torch.autograd.grad(loss, list(s["params"].parameters()))
    assert abs(loss.item() - s["loss"]) <= 1e-5 * abs(s["loss"])
    top = max(np.abs(g).max() for g in s["grads"].values())
    for name, g in zip(names, grads):
        want = s["grads"]["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-3 * top), (name,
                                                                   err)


def test_score_fn_matches_jax(setup):
    s = setup
    with torch.no_grad():
        score, counts = _streamed(lambda: get_model("transformer").score_fn(
            s["params"], s["feats"], s["pcfg"])["score"])
    assert counts == {"streaming_attention_ref": 3}
    np.testing.assert_allclose(score.numpy(), s["score"], rtol=1e-5,
                               atol=1e-6)
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("flash", [True, False])
def test_decoder_builds_the_causal_mask_only_for_the_composite(
        setup, flash, monkeypatch):
    """Every decoder self-attention streams with use_flash_attention: no
    [L, L] mask is built. Without it, the composite layers share one."""
    s = setup
    built = []
    causal_mask = port_nn.causal_mask

    def counted(*args, **kwargs):
        built.append(args)
        return causal_mask(*args, **kwargs)

    monkeypatch.setattr(port_nn, "causal_mask", counted)
    pcfg = port_config(s["pcfg"], use_flash_attention=flash)
    with torch.no_grad():
        get_model("transformer").train_fn(s["params"], s["feats"], pcfg,
                                          None)
    assert built == ([] if flash else [(L,)])


def _jax_translations(d, spec):
    """JAX package: init transformer params, save them with its Saver,
    beam-search the test batch; the index-ordered top-beam lines."""
    cfg = default_config().parse(spec)
    cfg.src_vocab = cfg.tgt_vocab = JVocab(str(d / "vocab.txt"))
    model = jget_model("transformer")
    params = model.init_fn(jax.random.PRNGKey(7), cfg)
    JSaver(output_dir=cfg.output_dir).save({"params": params}, step=1)
    data = JDataset(cfg.src_test_file, cfg.tgt_test_file, cfg.src_vocab,
                    cfg.tgt_vocab, max_len=cfg.eval_max_len,
                    pad_seq_multiple=cfg.pad_seq_multiple,
                    pad_batch_to=cfg.eval_batch_size, use_native=False)
    (batch,) = list(data.batcher(cfg.eval_batch_size, shuffle=False,
                                 train=False))
    assert batch["src"].shape[1] == L
    out = jax.jit(lambda p, s: jbeam_search(p, s, model.infer_fn(cfg), cfg))(
        params, jnp.asarray(batch["src"]))
    n = len(batch["raw"])
    hypos, _ = jevalu.decode_hypothesis(np.asarray(out["seq"])[:n],
                                        np.asarray(out["score"])[:n], cfg)
    return [" ".join(hypos[i]) for i in np.argsort(batch["index"])]


def test_mode_test_reads_jax_checkpoint_and_matches_jax(low_max_lk,
                                                        tmp_path):
    """Sources of 80-120 tokens padded to 128 (pad_seq_multiple=128): the
    encoder streams in both packages; beam 4 gives JAX's translations."""
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(tmp_path / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(80, 121)))
             for _ in range(4)]
    for name in ("test.src", "test.tgt"):
        with open(tmp_path / name, "w") as w:
            w.write("\n".join(lines) + "\n")
    spec = ("model_name=transformer,hidden_size=16,embed_size=16,"
            "filter_size=32,num_heads=2,num_encoder_layer=2,"
            "num_decoder_layer=2,beam_size=4,decode_length=6,"
            "decode_max_len=8,eval_batch_size=4,pad_seq_multiple=128,"
            "use_flash_attention=True,shared_source_target_embedding=True,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/out".format(tmp_path))
    want = _jax_translations(tmp_path, spec)
    out_file = tmp_path / "trans.txt"
    summary, counts = _streamed(lambda: run.main(
        ["--mode", "test", "--parameters",
         spec + ",device=cpu,test_output=%s" % out_file]))
    with open(out_file) as r:
        assert r.read().splitlines() == want
    assert summary["sentences"] == 4 and summary["steps"] > 0
    assert counts == {"streaming_attention_ref": 2}   # the encoder layers


def test_token_batches_keep_one_long_pair_each(tmp_path):
    """At max_len = token_size = 16384 and pad_seq_multiple 128, every
    training batch holds one pair of 8200-16000 tokens a side, in ONE row
    (the JAX package pads it to its 16-row ladder), at the JAX package's
    padded lengths; an epoch yields every pair once and drops none."""
    from zero_tpu_torch.data import Dataset
    from zero_tpu_torch.vocab import Vocab

    rs = np.random.RandomState(5)
    words = ["w%d" % i for i in range(40)]
    with open(tmp_path / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    for side in ("src", "tgt"):
        with open(tmp_path / ("train." + side), "w") as w:
            for _ in range(6):
                w.write(" ".join(rs.choice(words, rs.randint(8200, 16001)))
                        + "\n")
    kw = dict(max_len=16384, batch_or_token="token", pad_seq_multiple=128,
              pad_batch_multiple=8)
    files = (str(tmp_path / "train.src"), str(tmp_path / "train.tgt"))
    vocab = Vocab(str(tmp_path / "vocab.txt"))
    jvocab = JVocab(str(tmp_path / "vocab.txt"))
    np.random.seed(0)
    got = list(Dataset(*files, vocab, vocab, **kw).batcher(16384))
    np.random.seed(0)
    want = list(JDataset(*files, jvocab, jvocab, use_native=False,
                         **kw).batcher(16384))
    assert sorted(i for b in got for i in b["index"]) == list(range(6))
    assert [b["index"] for b in got] == [b["index"] for b in want]
    for g, w in zip(got, want):
        assert g["src"].shape == (1, w["src"].shape[1])
        assert g["tgt"].shape == (1, w["tgt"].shape[1])
        assert w["src"].shape[0] == 16
        assert min(g["src"].shape[1], g["tgt"].shape[1]) >= 8320
        np.testing.assert_array_equal(g["src"], w["src"][:1])
        np.testing.assert_array_equal(g["tgt"], w["tgt"][:1])
