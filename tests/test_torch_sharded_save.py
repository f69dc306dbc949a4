"""The sharded checkpoint's write side (saver.py, "sharded-v1") against the
JAX package's format, on the CPU.

Two gloo workers (tests/torch_zero_worker.py) hold a stage-3 state (ZeRO
over 2 processes: parameters, moments and EMA as shards; ``filter_size``
33 leaves FFN biases whole) after one step and write it as a sharded
checkpoint. Its members are exactly the keys the JAX package's
``save_checkpoint_sharded`` writes for the layout of ``zero1_sharding``
(``_index_key``'s text), its meta theirs; JAX's
``load_checkpoint_sharded``, given numpy templates, assembles it to the
port's whole state. A restore of the same world reads each rank's own
slices; one process assembles every leaf. Only rank 0 writes the index
and evicts, and an asynchronous save writes the same bytes. The
weights a dev eval decodes with are gathered whole on both ranks.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from test_torch_data_parallel import (_env, _free_port,  # noqa: E402
                                      _port_values)
from zero_tpu import saver as jsaver  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.parallel import make_mesh  # noqa: E402
from zero_tpu.parallel.mesh import (param_sharding,  # noqa: E402
                                    zero1_sharding)
from zero_tpu_torch import saver  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.train_step import init_train_state  # noqa: E402
from torch_parity import port_config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = dict(num_encoder_layer=1, num_decoder_layer=1, mesh_data=2,
           mesh_model=1, ema_decay=0.9, use_flash_attention=False,
           use_fused_ffn=False, model_name="transformer", filter_size=33,
           zero_stage=3)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(the config, the directory, rank 0's npz, rank 1's npz)."""
    d = tmp_path_factory.mktemp("sharded")
    cfg = tiny_config(**CFG)
    case = {"kind": "save", "cfg": _port_values(cfg), "dir": str(d),
            "out": str(d / "rank%d.npz")}
    spec = str(d / "spec.json")
    with open(spec, "w") as w:
        json.dump({"port": _free_port(), "world": 2, "cases": [case]}, w)
    procs = [subprocess.Popen([sys.executable, os.path.join(
        HERE, "torch_zero_worker.py"), spec, str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env()) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    return (cfg, d) + tuple(dict(np.load(case["out"] % r)) for r in range(2))


def _jax_members(cfg):
    """{rank: member keys} and the meta's {key: shape} that the JAX
    package's save_checkpoint_sharded writes, one device a process, for
    the stage-3 layout of zero1_sharding over 2."""
    shapes = jax.eval_shape(
        lambda k: jget_model(cfg.model_name).init_fn(k, cfg),
        jax.random.PRNGKey(0))
    mesh = make_mesh(data=2, model=1)
    specs = zero1_sharding(shapes, mesh, param_sharding(
        shapes, mesh, warn_unsharded=False))
    members, meta = {0: {"opt/.count"}, 1: set()}, {"opt/.count": []}
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    shape_of = jsaver._flatten_raw(shapes, "p")
    for path, spec in leaves:
        sub = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        shape = tuple(shape_of["p/" + sub].shape)
        axes = list(spec.spec) + [None] * (len(shape) - len(spec.spec))
        for key in ("params/", "opt/.mu/", "opt/.nu/", "ema/"):
            meta[key + sub] = list(shape)
            if "data" not in axes:
                members[0].add(key + sub)
                continue
            d = axes.index("data")
            for rank in (0, 1):
                idx = [slice(None)] * len(shape)
                idx[d] = slice(rank * shape[d] // 2,
                               (rank + 1) * shape[d] // 2)
                members[rank].add(key + sub + "@"
                                  + jsaver._index_key(idx, shape))
    return members, meta


def test_members_and_meta_are_the_jax_packages(saved):
    cfg, d, _, _ = saved
    want, shapes = _jax_members(cfg)
    for rank in (0, 1):
        with np.load(d / "sync" / ("model-1.shard%d.npz" % rank)) as z:
            assert set(z.files) == want[rank]
    with open(d / "sync" / "model-1.shardmeta.json") as r:
        assert json.load(r) == {"format": "sharded-v1", "nproc": 2,
                                "keys": shapes}


def test_jax_load_checkpoint_sharded_assembles_the_port_state(saved):
    _, d, rank0, rank1 = saved
    whole = {k[len("whole/"):]: v for k, v in rank0.items()
             if k.startswith("whole/")}
    for k in whole:
        np.testing.assert_array_equal(rank1["whole/" + k], whole[k])
    templates = {}
    for k, v in whole.items():
        *parents, leaf = k.split("/")
        node = templates
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.zeros_like(v)
    got = jsaver.load_checkpoint_sharded(str(d / "sync" / "model-1"),
                                         templates)
    flat = {}
    for prefix, tree in got.items():
        flat.update(jsaver._flatten(tree, prefix))
    assert sorted(flat) == sorted(whole)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, whole[k], err_msg=k)


def test_a_restore_of_the_same_world_reads_the_own_slices(saved):
    _, _, rank0, rank1 = saved
    for rank in (rank0, rank1):
        assert int(rank["own_keys"]) > 0
        held = {k[len("held/"):]: v for k, v in rank.items()
                if k.startswith("held/")}
        assert any(v.shape != rank["whole/" + k].shape
                   for k, v in held.items())
        for k, v in held.items():
            np.testing.assert_array_equal(rank["restored/" + k], v,
                                          err_msg=k)


def test_one_process_restores_the_whole_state(saved):
    cfg, d, rank0, _ = saved
    pcfg = port_config(cfg)
    state = init_train_state(get_model("transformer"), pcfg,
                             torch.Generator().manual_seed(9), "cpu")
    trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    assert saver.Saver(output_dir=str(d / "sync")).restore(trees)
    for k, t in saver.flat_tensors(trees).items():
        np.testing.assert_array_equal(saver._numpy(t), rank0["whole/" + k],
                                      err_msg=k)


def test_bookkeeping_and_eviction_run_on_rank_0_only(saved):
    _, d, rank0, rank1 = saved
    assert int(rank0["calls/index"]) > 0 and int(rank0["calls/remove"]) > 0
    assert int(rank1["calls/index"]) == 0 == int(rank1["calls/remove"])
    for sub in ("keep", os.path.join("keep", "best")):
        names = sorted(f for f in os.listdir(d / sub)
                       if f.startswith("model-"))
        assert names == ["model-2.shard0.npz", "model-2.shard1.npz",
                         "model-2.shardmeta.json"], (sub, names)
    with open(d / "keep" / "checkpoint") as r:
        assert json.load(r)["all"] == ["model-2"]


def test_an_async_sharded_save_writes_the_same_bytes(saved):
    _, d, _, _ = saved
    for name in ("model-1.shard0.npz", "model-1.shard1.npz",
                 "model-1.shardmeta.json"):
        assert (d / "sync" / name).read_bytes() \
            == (d / "async" / name).read_bytes(), name


@pytest.mark.parametrize("tag,source", [("eval_ema/", "ema/"),
                                        ("eval_params/", "params/")])
def test_eval_weights_are_gathered_whole_on_every_rank(saved, tag, source):
    """The dev eval's weights (train.py:_eval_weights) are the whole EMA,
    or with ema_decay 0 the whole stage-3 parameters, on both ranks."""
    _, _, *ranks = saved
    for out in ranks:
        got = {k[len(tag + "params/"):]: v for k, v in out.items()
               if k.startswith(tag)}
        want = {k[len("whole/" + source):]: v for k, v in out.items()
                if k.startswith("whole/" + source)}
        assert got and got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
