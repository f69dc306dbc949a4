"""zero_tpu_torch training slice against zero_tpu: train_fn/score_fn and
their gradients on bridged weights; the train step (accumulation,
clipping, Adam, EMA, safe_nan) on identical gradients; training
checkpoints that resume across the two packages; and ``--mode train``,
``--mode test`` and ``--mode score`` of the port's CLI on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import port_config, t  # noqa: E402
from zero_tpu.config import default_config as jdefault_config  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.parallel.train_step import init_train_state as jinit_state  # noqa: E402
from zero_tpu.parallel.train_step import make_train_step as jmake_step  # noqa: E402
from zero_tpu.recorder import Recorder as JRecorder  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.saver import (Saver, flat_from_module,  # noqa: E402
                                  load_checkpoint_file, params_from_flat)
from zero_tpu_torch.train_step import (init_train_state,  # noqa: E402
                                       make_train_step, stack_microbatches)

NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)


# ---------------------------------------------------------------------------
# train_fn / score_fn and grads on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_setup():
    # 5 x 6 target positions in chunks of 7: a padded tail; row 2 all-pad;
    # one layer a side keeps the JAX compile of the grads short
    cfg = tiny_config(model_name="transformer", loss_chunk_tokens=7,
                      num_encoder_layer=1, num_decoder_layer=1, **NO_DROPOUT)
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (5, 6)).astype(np.int32)
    src[0, 4:] = 0
    tgt[1, 3:] = 0
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
    return dict(cfg=cfg, feats=feats, jparams=jparams, loss=float(loss),
                grads=_flatten(grads, "params"), score=np.asarray(score))


def _port_params(setup, pcfg):
    params = get_model("transformer").init_fn(torch.Generator(), pcfg)
    params.load_state_dict(params_from_flat(_flatten(setup["jparams"],
                                                     "params")))
    return params


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(model_setup, kernels):
    """kernels=True routes attention and FFN through the fused wrappers
    (their plain versions on the CPU)."""
    s = model_setup
    pcfg = port_config(s["cfg"], use_flash_attention=kernels,
                       use_fused_ffn=kernels)
    params = _port_params(s, pcfg)
    feats = {k: t(v) for k, v in s["feats"].items()}
    loss = get_model("transformer").train_fn(params, feats, pcfg,
                                             torch.Generator())["loss"]
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(loss.item() - s["loss"]) <= 1e-5 * abs(s["loss"])
    assert sorted("params/" + n.replace(".", "/") for n in names) \
        == sorted(s["grads"])
    # each grad within 1e-4 of its max |grad|, floored at 1e-3 of the
    # model's largest (the cross-attention key bias has an exactly zero
    # gradient in exact arithmetic: both sides hold rounding noise)
    top = max(np.abs(g).max() for g in s["grads"].values())
    for name, g in zip(names, grads):
        want = s["grads"]["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-3 * top), (name,
                                                                   err)


def test_score_fn_matches_jax(model_setup):
    s = model_setup
    pcfg = port_config(s["cfg"])
    params = _port_params(s, pcfg)
    with torch.no_grad():
        score = get_model("transformer").score_fn(
            params, {k: t(v) for k, v in s["feats"].items()}, pcfg)["score"]
    np.testing.assert_allclose(score.numpy(), s["score"], rtol=1e-5,
                               atol=1e-6)
    assert score[2].item() == 0.0   # the all-pad row


def test_remat_and_scan_layers_raise(model_setup):
    """scan_layers is ported, but its pipeline over the stack (mesh_pipe)
    is a later slice; use_remat is ported, and an unknown remat_policy
    raises."""
    s = model_setup
    feats = {k: t(v) for k, v in s["feats"].items()}
    pcfg = port_config(s["cfg"], scan_layers=True, mesh_pipe=2)
    with pytest.raises(NotImplementedError, match="mesh_pipe"):
        get_model("transformer").train_fn(
            _port_params(s, port_config(s["cfg"])), feats, pcfg, None)
    pcfg = port_config(s["cfg"], use_remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="bogus"):
        get_model("transformer").train_fn(
            _port_params(s, port_config(s["cfg"])), feats, pcfg, None)


# ---------------------------------------------------------------------------
# the train step on identical grads
# ---------------------------------------------------------------------------

W0 = np.random.RandomState(5).randn(4, 3).astype(np.float32)
B0 = np.random.RandomState(6).randn(3).astype(np.float32)


class _JaxLinear:
    """A model whose grads are its batch: loss = sum(w * gw) + sum(b * gb)."""

    @staticmethod
    def init_fn(rng, cfg):
        return {"w": jnp.asarray(W0), "b": jnp.asarray(B0)}

    @staticmethod
    def train_fn(params, feats, cfg, rng, step=0):
        return {"loss": jnp.sum(params["w"] * feats["gw"])
                + jnp.sum(params["b"] * feats["gb"])}


class _PortLinear:
    @staticmethod
    def init_fn(gen, cfg):
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.from_numpy(W0.copy()))
        m.b = torch.nn.Parameter(torch.from_numpy(B0.copy()))
        return m

    @staticmethod
    def train_fn(params, feats, cfg, gen, step=0):
        return {"loss": (params.w * feats["gw"]).sum()
                + (params.b * feats["gb"]).sum()}


def test_train_step_matches_jax_on_identical_grads():
    """update_cycle=2 accumulation, clipping, Adam, EMA, and a safe_nan
    skip (gnorm over gnorm_upper_bound) on the third step."""
    cfg = jdefault_config()
    for k, v in dict(clip_grad_norm=1.0, ema_decay=0.9, safe_nan=True,
                     gnorm_upper_bound=1e3, beta1=0.9, beta2=0.98,
                     epsilon=1e-9).items():
        setattr(cfg, k, v)
    pcfg = port_config(cfg)
    rs = np.random.RandomState(7)
    batches = []
    for scale in (1.0, 3.0, 1e6):
        batches.append({"gw": rs.randn(2, 4, 3).astype(np.float32) * scale,
                        "gb": rs.randn(2, 3).astype(np.float32) * scale})
    jstate = jinit_state(_JaxLinear, cfg, jax.random.PRNGKey(0))
    jstep = jmake_step(_JaxLinear, cfg, donate=False)
    state = init_train_state(_PortLinear, pcfg, torch.Generator(), "cpu")
    step = make_train_step(_PortLinear, pcfg)
    tol = dict(rtol=1e-6, atol=1e-6)
    for i, batch in enumerate(batches):
        lr = 1e-2 * (i + 1)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, lr, jax.random.PRNGKey(i))
        state, m = step(state, batch, lr, torch.Generator())
        for key in ("loss", "gnorm", "pnorm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
        for name in ("w", "b"):
            np.testing.assert_allclose(getattr(state.params, name).detach(),
                                       np.asarray(jstate.params[name]), **tol)
            np.testing.assert_allclose(state.opt["mu"][name],
                                       np.asarray(jstate.opt_state.mu[name]),
                                       **tol)
            np.testing.assert_allclose(state.opt["nu"][name],
                                       np.asarray(jstate.opt_state.nu[name]),
                                       **tol)
            np.testing.assert_allclose(state.ema[name],
                                       np.asarray(jstate.ema[name]), **tol)
        assert int(state.opt["count"]) == int(jstate.opt_state.count)
    assert int(state.opt["count"]) == 2   # the third step was skipped


def test_stack_microbatches_pads_to_the_common_shape():
    a = {"source": np.ones((2, 3), np.int32), "target": np.ones((2, 5))}
    b = {"source": np.ones((4, 2), np.int32), "target": np.ones((4, 4))}
    out = stack_microbatches([a, b])
    assert out["source"].shape == (2, 4, 3) and out["target"].shape == (2, 4, 5)
    assert out["source"][0, 2:].sum() == 0 and out["source"][1, :, 2].sum() == 0


# ---------------------------------------------------------------------------
# checkpoints across packages, and the CLI
# ---------------------------------------------------------------------------

SIZES = ("model_name=transformer,hidden_size=16,embed_size=16,filter_size=32,"
         "num_heads=2,num_encoder_layer=1,num_decoder_layer=1,beam_size=2,"
         "decode_length=6,decode_max_len=24,eval_batch_size=8,max_len=12,"
         "pad_seq_multiple=4,pad_batch_multiple=4,batch_or_token=batch,"
         "batch_size=8,ema_decay=0.99,update_cycle=2,lrate=3e-3,"
         "lrate_strategy=vanilla,disp_freq=5,save_freq=10,eval_freq=10,"
         "sample_freq=0,epoches=50,use_flash_attention=True,"
         "use_fused_ffn=True,shared_source_target_embedding=True")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_corpus")
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(10)]
    with open(d / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    for name, n in (("train", 64), ("dev", 6), ("test", 6)):
        lines = [" ".join(rs.choice(words, rs.randint(2, 8)))
                 for _ in range(n)]
        for side in ("src", "tgt"):
            with open(d / ("%s.%s" % (name, side)), "w") as w:
                w.write("\n".join(lines) + "\n")
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
             "src_dev_file={0}/dev.src,tgt_dev_file={0}/dev.tgt,"
             "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
             "output_dir={0}/out,device=cpu".format(d))
    return d, SIZES + "," + files


def _jax_state(d, spec):
    """A JAX-package training state for the corpus model, with non-trivial
    Adam moments, count and EMA."""
    cfg = jdefault_config().parse(spec.replace(",device=cpu", ""))
    cfg.src_vocab = cfg.tgt_vocab = JVocab(str(d / "vocab.txt"))
    # one jitted init: op-by-op dispatch of the initialisers, the Adam
    # state and the EMA copy costs more than one compile
    state = jax.jit(lambda key: jinit_state(jget_model("transformer"), cfg,
                                            key))(jax.random.PRNGKey(3))
    noise = iter(range(10 ** 6))
    rand = (lambda a: jnp.asarray(np.random.RandomState(next(noise))
                                  .rand(*a.shape).astype(np.float32)))
    opt = state.opt_state._replace(count=jnp.asarray(4, jnp.int32),
                                   mu=jax.tree.map(rand, state.opt_state.mu),
                                   nu=jax.tree.map(rand, state.opt_state.nu))
    return state._replace(opt_state=opt, ema=jax.tree.map(rand, state.ema))


def test_jax_checkpoint_resumes_in_port_cli_and_back(corpus):
    """A JAX-written training checkpoint (params/opt/ema + record.json at
    step 4) restores exactly into the port's state; ``--mode train`` resumes
    it to step 12 (a dev eval at 10); the port's checkpoint then restores
    into the JAX package's state templates, key for key; ``--mode test``
    and ``--mode score`` serve it."""
    d, spec = corpus
    out = d / "out"
    jstate = _jax_state(d, spec)
    trees = {"params": jstate.params, "opt": jstate.opt_state,
             "ema": jstate.ema}
    JSaver(output_dir=str(out)).save(trees, step=4)
    rec = JRecorder()
    rec.__dict__.update(bad_counter=0, estop=False, lidx=7, step=4, epoch=1,
                        lrate=3e-3, history_scores=[],
                        valid_script_scores=[])
    rec.save_to_json(str(out / "record.json"))

    # exact restore into the port's training state
    pcfg = port_config(tiny_config())
    pcfg.parse(spec)
    from zero_tpu_torch.vocab import Vocab
    pcfg.src_vocab = pcfg.tgt_vocab = Vocab(str(d / "vocab.txt"))
    state = init_train_state(get_model("transformer"), pcfg,
                             torch.Generator(), "cpu")
    ptrees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    assert Saver(output_dir=str(out)).restore(ptrees)
    want = {}
    for prefix, tree in trees.items():
        want.update(_flatten(tree, prefix))
    got = {}
    for prefix, tree in ptrees.items():
        got.update(flat_from_module(tree, prefix))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    summary = run.main(["--mode", "train", "--parameters",
                        spec + ",max_training_steps=12"])
    assert summary["steps"] == 8
    assert all(np.isfinite(summary["losses"]))
    with open(out / "record.json") as r:
        assert json.load(r)["step"] == 12
    jrec = JRecorder()
    jrec.load_from_json(str(out / "record.json"))
    assert jrec.step == 12

    # the port's checkpoint: JAX keys, JAX restore
    names = json.load(open(out / "checkpoint"))["all"]
    assert names[-1] == "model-12"
    flat = load_checkpoint_file(str(out / "model-12.npz"))
    assert sorted(flat) == sorted(want)
    assert int(flat["opt/.count"]) == 12
    restored = JSaver(output_dir=str(out)).restore(trees)
    for prefix in trees:
        for k, v in _flatten(restored[prefix], prefix).items():
            np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert os.path.exists(out / "best" / "topk_checkpoint")
    assert os.path.exists(out / "best" / "metric.log")

    trans = d / "trans_port.txt"
    assert run.main(["--mode", "test", "--parameters",
                     spec + ",test_output=%s" % trans])["sentences"] == 6
    assert len(open(trans).read().splitlines()) == 6
    scores_file = d / "scores_port.txt"
    scores, ppl = run.main(["--mode", "score", "--parameters",
                            spec + ",test_output=%s" % scores_file])
    assert len(scores) == 6 and np.isfinite(scores).all() and ppl > 1.0
    assert len(open(scores_file).read().splitlines()) == 6


def test_sigterm_checkpoints_and_resume_continues(corpus, monkeypatch):
    """A SIGTERM during step 3 ends the run after that step with a
    checkpoint and record.json at step 3 and no final dev eval; the next
    ``--mode train`` resumes there, mid-epoch."""
    import signal

    from zero_tpu_torch import train as port_train

    d, spec = corpus
    spec = spec.replace("output_dir=%s/out" % d, "output_dir=%s/pre" % d)
    make_gen = port_train._step_generator

    def gen_and_preempt(params, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return make_gen(params, step)

    monkeypatch.setattr(port_train, "_step_generator", gen_and_preempt)
    summary = run.main(["--mode", "train", "--parameters",
                        spec + ",max_training_steps=5,eval_freq=0"])
    assert summary["steps"] == 3 and summary["bleu"] is None
    assert json.load(open(d / "pre" / "record.json"))["step"] == 3
    assert json.load(open(d / "pre" / "checkpoint"))["latest"] == "model-3"
    monkeypatch.setattr(port_train, "_step_generator", make_gen)
    summary = run.main(["--mode", "train", "--parameters",
                        spec + ",max_training_steps=5,eval_freq=0"])
    assert summary["steps"] == 2
    assert int(load_checkpoint_file(str(d / "pre" / "model-5.npz"))
               ["opt/.count"]) == 5


@pytest.mark.parametrize("scores", [[0.1, 0.2, 0.2, 0.1, 0.05],
                                    [0.3, 0.1, 0.4, 0.4, 0.2, 0.1]])
def test_record_eval_score_matches_jax(scores):
    from zero_tpu import train as jtrain
    from zero_tpu_torch import train as port_train
    from zero_tpu_torch.recorder import Recorder

    recs = []
    for rec in (JRecorder(), Recorder()):
        rec.__dict__.update(bad_counter=0, estop=False,
                            history_scores=[], valid_script_scores=[])
        recs.append(rec)
    for step, bleu in enumerate(scores):
        want = jtrain.record_eval_score(recs[0], step, bleu, 1)
        assert port_train.record_eval_score(recs[1], step, bleu, 1) == want
        assert recs[1].__dict__ == recs[0].__dict__


@pytest.mark.parametrize("strategy", ["noam", "gnmt+", "epoch", "score",
                                      "vanilla", "cosine"])
def test_learning_rate_schedules_match_jax(strategy):
    from zero_tpu import lrs as jlrs
    from zero_tpu_torch import lrs

    cfg = jdefault_config()
    cfg.lrate_strategy = strategy
    cfg.lrate, cfg.warmup_steps, cfg.max_lrate = 1.0, 5, 2.0
    pcfg = port_config(cfg)
    a, b = jlrs.get_lr(cfg), lrs.get_lr(pcfg)
    for step in range(12):
        for sched in (a, b):
            sched.before_epoch(eidx=step // 4)
            sched.step(step)
            if step % 3 == 2:
                sched.after_eval(0.1 * (step % 5))
            if step % 4 == 3:
                sched.after_epoch(eidx=step // 4)
        assert b.get_lr() == a.get_lr()
