"""zero_tpu_torch repairs of three faults against zero_tpu: the profiler
window of the training loop (``profiler_dir``, ``profiler_start_step``,
``profiler_stop_step``), the async checkpoint write (``async_checkpoint``)
and the read side of the JAX package's sharded checkpoint format
(sharded-v1), on the CPU."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from torch_parity import port_config  # noqa: E402
from zero_tpu.config import default_config as jdefault_config  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.parallel import make_mesh  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.saver import _flatten, save_checkpoint_sharded  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch import saver as saver_mod  # noqa: E402
from zero_tpu_torch import train as train_mod  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.saver import Saver  # noqa: E402

SIZES = ("model_name=transformer,hidden_size=16,embed_size=16,filter_size=32,"
         "num_heads=2,num_encoder_layer=1,num_decoder_layer=1,beam_size=2,"
         "decode_length=6,decode_max_len=16,eval_batch_size=8,"
         "pad_seq_multiple=4")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(12)]
    with open(d / "vocab.txt", "w") as w:
        w.write("\n".join(["<pad>", "<unk>", "<eos>"] + words) + "\n")
    for name, n in (("train", 64), ("test", 6)):
        lines = [" ".join(rs.choice(words, rs.randint(2, 8)))
                 for _ in range(n)]
        for side in ("src", "tgt"):
            with open(d / ("%s.%s" % (name, side)), "w") as w:
                w.write("\n".join(lines) + "\n")
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
             "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt"
             .format(d))
    return d, SIZES + "," + files + ",device=cpu,native_tokenizer=false"


def _train(spec, out, **extra):
    params = (spec + ",output_dir=%s,batch_or_token=batch,batch_size=8,"
              "max_training_steps=4,save_freq=2,disp_freq=1,eval_freq=0,"
              "sample_freq=0,src_dev_file=,update_cycle=1" % out)
    for k, v in extra.items():
        params += ",%s=%s" % (k, v)
    return run.main(["--mode", "train", "--parameters", params])


# ---------------------------------------------------------------------------
# F7: the profiler window
# ---------------------------------------------------------------------------

def test_profiler_traces_the_steps_of_its_window(corpus, tmp_path):
    d, spec = corpus
    prof = tmp_path / "prof"
    _train(spec, tmp_path / "out", profiler_dir=prof, profiler_start_step=1,
           profiler_stop_step=3)
    (trace,) = os.listdir(prof)
    with open(prof / trace) as r:
        events = json.load(r)["traceEvents"]
    steps = [e for e in events if e.get("name") == "zero_tpu_torch.train_step"]
    assert len(steps) == 3 - 1
    _train(spec, tmp_path / "out_off", profiler_start_step=1,
           profiler_stop_step=3)
    assert os.listdir(prof) == [trace]    # profiler_dir="": no trace


# ---------------------------------------------------------------------------
# F8: the async checkpoint write
# ---------------------------------------------------------------------------

def _state():
    gen = torch.Generator().manual_seed(0)
    module = torch.nn.Linear(5, 3)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = {"count": torch.tensor(4, dtype=torch.int32),
           "mu": {n: torch.randn(p.shape, generator=gen)
                  for n, p in module.named_parameters()},
           "nu": {n: torch.rand(p.shape, generator=gen)
                  for n, p in module.named_parameters()}}
    return {"params": module, "opt": opt, "ema": None}


def test_async_and_sync_saves_write_identical_files(tmp_path):
    trees = _state()
    for mode in (False, True):
        saver = Saver(output_dir=str(tmp_path / str(mode)), async_save=mode)
        saver.save(trees, 3, 0.5)
        if mode:
            # training goes on in place: the snapshot keeps step 3's state
            with torch.no_grad():
                trees["params"].weight.add_(1.0)
        saver.wait()
        if mode:
            with torch.no_grad():
                trees["params"].weight.sub_(1.0)
    for rel in ("model-3.npz", "best/model-3.npz", "checkpoint",
                "best/topk_checkpoint"):
        with open(tmp_path / "False" / rel, "rb") as a, \
                open(tmp_path / "True" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def test_a_failing_async_write_raises_at_wait(tmp_path, monkeypatch):
    def fail(directory, name, flat):
        raise OSError("disk full")

    monkeypatch.setattr(saver_mod, "write_checkpoint_file", fail)
    saver = Saver(output_dir=str(tmp_path), async_save=True)
    saver.save(_state(), 1)
    with pytest.raises(RuntimeError, match="async checkpoint") as err:
        saver.wait()
    assert isinstance(err.value.__cause__, OSError)
    saver.wait()    # the error is raised once


def test_training_passes_async_checkpoint_and_writes_the_same_files(
        corpus, tmp_path, monkeypatch):
    d, spec = corpus
    made = []
    real = train_mod.Saver

    def spy(*args, **kwargs):
        made.append(kwargs.get("async_save"))
        return real(*args, **kwargs)

    monkeypatch.setattr(train_mod, "Saver", spy)
    for mode in ("true", "false"):
        _train(spec, tmp_path / mode, async_checkpoint=mode)
    assert made == [True, False]
    for rel in ("model-2.npz", "model-4.npz"):
        with open(tmp_path / "true" / rel, "rb") as a, \
                open(tmp_path / "false" / rel, "rb") as b:
            assert a.read() == b.read(), rel


# ---------------------------------------------------------------------------
# F9: the read side of sharded-v1
# ---------------------------------------------------------------------------

def test_a_two_host_sharded_checkpoint_restores_on_one_device(tmp_path):
    """The JAX package's hand-made two-host checkpoint
    (tests/test_saver.py): one leaf split by rows across the hosts."""
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    np.savez(tmp_path / "model-5.shard0.npz", **{"params/w@0:4,0:4": full[:4]})
    np.savez(tmp_path / "model-5.shard1.npz", **{"params/w@4:8,0:4": full[4:]})
    with open(tmp_path / "model-5.shardmeta.json", "w") as w:
        json.dump({"format": "sharded-v1", "nproc": 2,
                   "keys": {"params/w": [8, 4]}}, w)
    with open(tmp_path / "checkpoint", "w") as w:
        json.dump({"latest": "model-5", "all": ["model-5"]}, w)
    saver = Saver(output_dir=str(tmp_path))
    tree = {"w": torch.zeros(8, 4)}
    assert saver.restore({"params": tree})
    np.testing.assert_array_equal(tree["w"].numpy(), full)
    # a key the checkpoint lacks, or holds at another shape, keeps the
    # template's value
    tree = {"w": torch.zeros(8, 4), "extra": torch.ones(2)}
    assert saver.restore({"params": tree})
    np.testing.assert_array_equal(tree["extra"].numpy(), np.ones(2))
    tree = {"w": torch.zeros(4, 8)}
    saver.restore({"params": tree})
    assert not tree["w"].any()


def test_a_jax_sharded_checkpoint_restores_and_serves(corpus, tmp_path):
    """save_checkpoint_sharded over leaves placed on two virtual devices,
    and the JAX Saver's sharded mode: Saver.restore gives the JAX weights,
    and --mode test gives the translations of the monolithic checkpoint."""
    d, spec = corpus
    cfg = jdefault_config().parse(spec.replace(",device=cpu", ""))
    cfg.src_vocab = cfg.tgt_vocab = JVocab(str(d / "vocab.txt"))
    jparams = jget_model("transformer").init_fn(jax.random.PRNGKey(5), cfg)
    mesh = make_mesh(None, data=2, model=1)
    placed = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P("data") if x.shape[0] % 2 == 0 else P())), jparams)
    save_checkpoint_sharded(str(tmp_path / "raw"), "model-3",
                            {"params": placed, "opt": None})
    with open(tmp_path / "raw" / "checkpoint", "w") as w:
        json.dump({"latest": "model-3", "all": ["model-3"]}, w)
    model = get_model("transformer").init_fn(torch.Generator(),
                                             port_config(cfg))
    assert Saver(output_dir=str(tmp_path / "raw")).restore(
        {"params": model})
    want = _flatten(jparams, "params")
    got = saver_mod.flat_from_module(model)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)

    outs = {}
    for kind in ("sharded", "mono"):
        out = tmp_path / kind
        JSaver(output_dir=str(out), sharded=kind == "sharded").save(
            {"params": jparams}, step=4)
        outs[kind] = tmp_path / (kind + ".txt")
        run.main(["--mode", "test", "--parameters",
                  spec + ",output_dir=%s,test_output=%s" % (out,
                                                             outs[kind])])
    assert (tmp_path / "sharded" / "model-4.shardmeta.json").exists()
    assert not (tmp_path / "sharded" / "model-4.npz").exists()
    with open(outs["sharded"]) as a, open(outs["mono"]) as b:
        assert a.read() == b.read()
