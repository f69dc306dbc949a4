"""zero_tpu_torch's RNN models against zero_tpu, fp32 on the CPU, on
weights bridged from the JAX init_fn: for each configuration the init key
set and shapes, train_fn loss (1e-5 relative) and grads (1e-4 of their
max), score_fn, beam search at beam 3 and 1 (identical sequences, scores
within 1e-4), cache decode against dev-mode decode, and a checkpoint
across the two packages. This file holds rnnsearch's configurations and
the CLI; test_torch_rnn_models_deep.py runs the same tests over deepnmt's
and rnnsearch_deepatt's.

The configurations are tests/test_rnn_models.py's RNN_CONFIGS plus
rnnsearch with layer_norm on the lrn cell, deepnmt with embed_size !=
hidden_size (x_map) on the sru cell, and rnnsearch_deepatt on the olrn
cell with layer_norm: all six cells, the CAEncoder on and off,
use_deep_att and layer_norm. They run at initializer_gain 0.5: at the
models' 0.08 a 16-wide random model's hypotheses tie within fp32
rounding, so beam order would follow the summation order."""

import copy
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_beam_search,  # noqa: E402
                          check_checkpoint_round_trip, check_same_decode,
                          check_score_fn, check_train_fn, jax_loss_and_grads,
                          parity_features, port_config)
from zero_tpu import evalu as jevalu  # noqa: E402
from zero_tpu.config import default_config  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.saver import Saver as JSaver, _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.config import default_config as port_default  # noqa: E402
from zero_tpu_torch.config import save_parameters  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402

GAIN = 0.5


def config_id(config):
    name, over = config
    return "-".join([name] + ["%s=%s" % kv for kv in sorted(over.items())])


CONFIGS = [
    ("rnnsearch", dict(cell="gru", caencoder=True)),
    ("rnnsearch", dict(cell="lstm", caencoder=False)),
    ("rnnsearch", dict(cell="atr", caencoder=True, layer_norm=True)),
    ("rnnsearch", dict(cell="lrn", caencoder=False, layer_norm=True)),
]


def make_setup(name, over):
    """One configuration's JAX weights, features and JAX loss, grads and
    scores (one jitted step)."""
    cfg = tiny_config(model_name=name, loss_chunk_tokens=7,
                      initializer_gain=GAIN, **over, **NO_DROPOUT)
    feats = parity_features()
    jparams = jget_model(name).init_fn(jax.random.PRNGKey(0), cfg)
    return dict(name=name, cfg=cfg, feats=feats, jparams=jparams,
                **jax_loss_and_grads(name, cfg, jparams, feats, score=True))


@pytest.fixture(scope="module", params=CONFIGS, ids=config_id)
def setup(request):
    return make_setup(*request.param)


def _source(s):
    # the padded rows and a full one (the all-pad row 2 left out)
    return s["feats"]["source"][[0, 1, 3]]


def test_init_key_set_and_shapes_match_jax(setup):
    s = setup
    module = get_model(s["name"]).init_fn(torch.Generator(),
                                          port_config(s["cfg"]))
    want = {k: v.shape for k, v in _flatten(s["jparams"], "params").items()}
    got = {"params/" + n.replace(".", "/"): tuple(p.shape)
           for n, p in module.named_parameters()}
    assert got == want
    assert not any("/lns/" in k for k in got) or s["cfg"].layer_norm


def test_train_fn_matches_jax(setup):
    """No kernel runs (no JAX RNN path reaches a Pallas kernel)."""
    s = setup
    assert check_train_fn(s["name"], s["cfg"], s["jparams"], s["feats"],
                          s) == {}


def test_score_fn_matches_jax(setup):
    s = setup
    check_score_fn(s["name"], s["cfg"], s["jparams"], s["feats"], s["score"])


@pytest.mark.parametrize("beam", [3, 1])
def test_beam_search_matches_jax(setup, beam):
    s = setup
    cfg = copy.deepcopy(s["cfg"])
    cfg.beam_size = beam
    check_beam_search(s["name"], cfg, s["jparams"], _source(s))


def test_cache_decode_equals_dev_decode(setup):
    s = setup
    check_same_decode(s["name"], s["cfg"], s["jparams"], _source(s),
                      dict(search_mode="dev"))


def test_checkpoint_round_trips_across_the_packages(setup, tmp_path):
    s = setup
    check_checkpoint_round_trip(s["name"], s["cfg"], s["jparams"],
                                str(tmp_path))


# ---------------------------------------------------------------------------
# the CLI's four modes
# ---------------------------------------------------------------------------

CLI_SIZES = ("hidden_size=16,embed_size=16,num_heads=2,num_encoder_layer=1,"
             "num_decoder_layer=2,beam_size=3,decode_length=6,"
             "decode_max_len=24,eval_batch_size=8,pad_seq_multiple=4,"
             "initializer_gain=0.5,shared_source_target_embedding=True")
CLI_MODELS = {"rnnsearch": "model_name=rnnsearch,cell=gru",
              "deepnmt": "model_name=deepnmt,cell=lstm,use_deep_att=True"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("rnn_corpus")
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(d / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    for split, n in (("train", 40), ("test", 6)):
        lines = [" ".join(rs.choice(words, rs.randint(2, 9)))
                 for _ in range(n)]
        for side in ("src", "tgt"):
            with open(d / ("%s.%s" % (split, side)), "w") as w:
                w.write("\n".join(lines) + "\n")
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
             "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt"
             .format(d))
    return d, files


def _jax_checkpoint(d, spec, name, out):
    """JAX package: init, save with its Saver (and the port's param.json,
    which --mode ensemble reads); its beam-search translations of the test
    batch (index order) and its scores."""
    save_parameters(port_default().parse(spec + ",output_dir=" + out), out)
    cfg = default_config().parse(spec + ",output_dir=" + out)
    cfg.src_vocab = cfg.tgt_vocab = JVocab(str(d / "vocab.txt"))
    model = jget_model(name)
    params = model.init_fn(jax.random.PRNGKey(7), cfg)
    JSaver(output_dir=out).save({"params": params}, step=1)
    from zero_tpu.data import Dataset as JDataset
    data = JDataset(cfg.src_test_file, cfg.tgt_test_file, cfg.src_vocab,
                    cfg.tgt_vocab, max_len=cfg.eval_max_len,
                    pad_seq_multiple=cfg.pad_seq_multiple,
                    pad_batch_to=cfg.eval_batch_size, use_native=False)
    (batch,) = list(data.batcher(cfg.eval_batch_size, shuffle=False,
                                 train=False))
    out_b = jax.jit(lambda p, x: jbeam_search(p, x, model.infer_fn(cfg),
                                              cfg))(params,
                                                    jnp.asarray(batch["src"]))
    n = len(batch["raw"])
    hypos, _ = jevalu.decode_hypothesis(np.asarray(out_b["seq"])[:n],
                                        np.asarray(out_b["score"])[:n], cfg)
    scores = np.asarray(model.score_fn(
        params, {"source": jnp.asarray(batch["src"]),
                 "target": jnp.asarray(batch["tgt"])}, cfg)["score"])[:n]
    order = np.argsort(batch["index"])
    return [" ".join(hypos[i]) for i in order], scores[order]


def test_cli_serves_scores_trains_and_ensembles(corpus):
    """--mode test and --mode score on checkpoints the JAX package wrote
    give its translations and scores (rnnsearch and deepnmt); --mode train
    runs a few steps and saves; --mode ensemble of a model with itself
    gives its own translations, and of the two models a line a
    sentence."""
    d, files = corpus
    outs = {}
    for name, model in CLI_MODELS.items():
        spec = "%s,%s,%s" % (CLI_SIZES, model, files)
        out = str(d / ("jax_" + name))
        want, want_scores = _jax_checkpoint(d, spec, name, out)
        common = spec + ",device=cpu,output_dir=" + out
        run.main(["--mode", "test", "--parameters",
                  common + ",test_output=%s/trans.txt" % out])
        with open(os.path.join(out, "trans.txt")) as r:
            assert r.read().splitlines() == want
        scores, _ = run.main(["--mode", "score", "--parameters",
                              common + ",test_output=%s/scores.txt" % out])
        np.testing.assert_allclose(np.asarray(scores), want_scores,
                                   rtol=1e-5, atol=1e-5)
        outs[name] = (out, want)

    trained = str(d / "port_train")
    summary = run.main(["--mode", "train", "--parameters",
                        "%s,%s,%s,device=cpu,output_dir=%s,batch_size=8,"
                        "batch_or_token=batch,max_training_steps=3,"
                        "disp_freq=1,eval_freq=0,save_freq=0,sample_freq=0,"
                        "lrate=1e-3"
                        % (CLI_SIZES, CLI_MODELS["rnnsearch"], files,
                           trained)])
    assert summary["steps"] == 3 and all(map(np.isfinite, summary["losses"]))
    assert os.path.exists(os.path.join(trained, "checkpoint"))

    def ensemble(dirs, output):
        run.main(["--mode", "ensemble", "--ensemble_dirs", ";".join(dirs),
                  "--parameters", files + ",device=cpu,test_output=" + output])
        with open(output) as r:
            return r.read().splitlines()

    out, want = outs["rnnsearch"]
    assert ensemble([out, out], str(d / "self.txt")) == want
    both = ensemble([out, outs["deepnmt"][0]], str(d / "both.txt"))
    assert len(both) == 6


# ---------------------------------------------------------------------------
# chip_smoke.py's model FLOPs of the RNN phases
# ---------------------------------------------------------------------------

FLOP_CONFIGS = [
    ("rnnsearch", dict(cell="gru", caencoder=True)),
    ("rnnsearch", dict(cell="lstm", caencoder=False, layer_norm=True)),
    ("deepnmt", dict(cell="gru", caencoder=True)),
    ("deepnmt", dict(cell="lstm", caencoder=False, use_deep_att=True,
                     num_encoder_layer=1)),
    ("deepnmt", dict(cell="sru", caencoder=True, embed_size=12,
                     dl4mt_redict=False)),
    ("rnnsearch_deepatt", dict(cell="olrn", num_decoder_layer=3)),
]


@pytest.mark.parametrize("name,over", FLOP_CONFIGS,
                         ids=[config_id(c) for c in FLOP_CONFIGS])
def test_chip_smoke_rnn_flops_count_the_forward_matmuls(name, over):
    """chip_smoke.py's MFU of the RNN phases rests on rnn_forward_flops:
    it equals FlopCounterMode's count of one forward (every mm, addmm and
    bmm) at a padded shape, the chunked CE's padded rows included."""
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke
    from zero_tpu_torch.config import default_config as port_defaults
    from zero_tpu_torch.vocab import Vocab

    values = dict(dict(model_name=name, hidden_size=16, embed_size=16,
                       num_heads=2, num_encoder_layer=2, num_decoder_layer=2,
                       loss_chunk_tokens=7), **over)
    cfg = port_defaults().override_from_dict(values)
    cfg.src_vocab = cfg.tgt_vocab = Vocab()
    for i in range(37):
        cfg.src_vocab.insert("w%d" % i)
    model = get_model(name)
    params = model.init_fn(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(0)
    feats = {"source": torch.as_tensor(rs.randint(3, 40, (3, 5))),
             "target": torch.as_tensor(rs.randint(3, 40, (3, 4)))}
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.train_fn(params, feats, cfg, torch.Generator().manual_seed(0))
    fwd, recomputed = chip_smoke.rnn_forward_flops((3, 5, 4), values,
                                                   vocab=40)
    assert counter.get_total_flops() == fwd
    # 12 target rows in chunks of 7: 14 rows
    assert recomputed == 2 * 14 * values["embed_size"] * 40
