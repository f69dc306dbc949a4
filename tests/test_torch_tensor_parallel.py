"""zero_tpu_torch's tensor parallelism (``mesh_model``; parallel/mesh.py,
parallel/tensor.py, the split attention, FFN, embeddings and cross
entropy) against the JAX package's step on the same mesh, fp32 on the
CPU.

Gloo workers (tests/torch_tp_worker.py: torch and the port only), two on
the mesh (data 1, model 2) and four on (data 2, model 2), train the
global batch of test_torch_data_parallel.py (an all-pad row in the second
data slot) from weights bridged from the JAX init_fn, update_cycle 2,
composite dropout on with the seed words injected into both packages,
against JAX's ``make_train_step`` on the same mesh of its virtual
devices: loss, gnorm, pnorm, parameters, moments and EMA to 1e-5 after
each of two steps. transformer at zero_stage 0, 1 and 3 over the odd
vocabulary (23 rows: the embeddings fall back to whole on every rank)
and an even one (24: vocab-parallel embeddings and cross entropy),
transformer_rpr, transformer_moe (experts whole over 'model'),
transformer_rela (its gated RMS norm's mean square summed over the
line), transformer_fixup, transformer_l0drop (its gate noise
injected) and transformer under scan_layers with use_remat at 2+2
layers (the stacked row biases [2, d] split along their layers). Every
leaf that no axis splits is bit-equal on the processes
of a model line; each rank's bytes of parameters, moments and EMA equal
JAX's ``per_device_bytes``. The kernel routes' plain versions, dropout on,
give two ranks the one-process run. A sharded checkpoint of the (data 2,
model 2) mesh at zero_stage 1 (the fused qkv written as three rectangles
a part) reads whole in JAX's ``load_checkpoint_sharded`` and restores
each rank's parts. Then the grouping: the processes of a model line take
one slot of the data groups' batches, where the JAX package's loop
takes the slot of the process index (R3).
"""

import concurrent.futures
import json
import os
import subprocess
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_tp_worker as worker  # noqa: E402
from helpers import tiny_config, tiny_vocab  # noqa: E402
from test_torch_data_parallel import (_assert_state, _env,  # noqa: E402
                                      _free_port, _global_batches,
                                      _jax_split, _jax_words, _port_values)
from test_torch_data_parallel import NOISE_KEY  # noqa: E402
from zero_tpu import saver as jsaver  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel.distributed import put_global_batch  # noqa: E402
from zero_tpu.parallel.mesh import per_device_bytes  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch import train as ptrain  # noqa: E402
from zero_tpu_torch.saver import layout_name  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
STEPS = 2
LRS = [1e-3, 2e-3]
BASE = dict(num_encoder_layer=1, num_decoder_layer=1, update_cycle=2,
            ema_decay=0.9, clip_grad_norm=1.0, use_flash_attention=False,
            use_fused_ffn=False, epsilon=1e-6, model_name="transformer",
            num_heads=4, max_relative_position=2)
EVEN = 21            # words: 24 rows with the three specials
MESH2 = dict(mesh_data=1, mesh_model=2)
MESH4 = dict(mesh_data=2, mesh_model=2)
CASES = {
    "transformer-odd": dict(MESH2),
    "transformer-even": dict(MESH2, _words=EVEN),
    "rpr": dict(MESH2, model_name="transformer_rpr", _words=EVEN),
    "moe": dict(MESH2, model_name="transformer_moe", _words=EVEN,
                filter_size=32, moe_num_experts=4, moe_top_k=2,
                moe_aux_weight=1.0, relu_dropout=0.3),
    "rela": dict(MESH2, model_name="transformer_rela", _words=EVEN),
    "fixup": dict(MESH2, model_name="transformer_fixup", _words=EVEN),
    "l0drop": dict(MESH2, model_name="transformer_l0drop", _words=EVEN,
                   l0_norm_reg_scalar=0.2, l0_norm_warm_up=False),
    "scan-remat": dict(MESH2, _words=EVEN, num_encoder_layer=2,
                       num_decoder_layer=2, scan_layers=True,
                       use_remat=True),
    "stage0-4": dict(MESH4, _words=EVEN),
    "stage1-4": dict(MESH4, _words=EVEN, zero_stage=1),
    "stage3-4": dict(MESH4, zero_stage=3),
}
# the kernel routes (their plain versions here), dropout on: two ranks
# against one process
KERNELS = dict(MESH2, _words=EVEN, use_flash_attention=True,
               use_fused_ffn=True)
SAVE = dict(MESH4, _words=EVEN, zero_stage=1)


def _cfg(over):
    over = dict(over)
    words = over.pop("_words", None)
    cfg = tiny_config(**dict(BASE, **over))
    if words:
        cfg.src_vocab = cfg.tgt_vocab = tiny_vocab(words)
    return cfg


def _world(cfg):
    return int(cfg.mesh_data) * int(cfg.mesh_model) * int(
        getattr(cfg, "mesh_expert", 1))


def _jax_steps(src, tgt, state, step_fn, mesh):
    out = []
    for s in range(STEPS):
        batch = put_global_batch({"source": src[s], "target": tgt[s]},
                                 mesh, batch_axis=1)
        state, m = step_fn(state, batch, LRS[s],
                           jnp.array([s, 0], jnp.uint32))
        flat = _flatten(jax.device_get(state.params), "params")
        flat.update(_flatten(jax.device_get(state.opt_state), "opt"))
        flat.update(_flatten(jax.device_get(state.ema), "ema"))
        out.append(({k: float(m[k]) for k in ("loss", "gnorm", "pnorm")},
                    flat))
    return out


def _launch(d, world, cases, tag):
    spec = str(d / ("spec%s.json" % tag))
    with open(spec, "w") as w:
        json.dump({"port": _free_port(), "world": world, "cases": cases}, w)
    return [subprocess.Popen([sys.executable, os.path.join(
        HERE, "torch_tp_worker.py"), spec, str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env())
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: JAX steps}, {case: JAX per_device_bytes}, {case: the ranks'
    npz}, the one-process kernels npz, (the save case's directory, its
    ranks' npz))."""
    d = tmp_path_factory.mktemp("tp")
    groups = {2: [], 4: []}
    jobs, nbytes, names = {}, {}, {2: [], 4: []}
    for name, over in list(CASES.items()) + [("kernels", KERNELS)]:
        cfg = _cfg(over)
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        src, tgt = _global_batches(False)
        weights, batches = (str(d / (name + "_w.npz")),
                            str(d / (name + "_b.npz")))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, src=src, tgt=tgt)
        case = {"kind": "train", "cfg": _port_values(cfg),
                "weights": weights, "batches": batches, "lrs": LRS,
                "out": str(d / (name + "_%d.npz"))}
        if name == "l0drop":
            case["noise"] = str(d / "l0drop_noise.npz")
            shapes = {(src.shape[2], src.shape[-1], 1),
                      (tgt.shape[2], tgt.shape[-1], 1)}
            np.savez(case["noise"], **{
                "x".join(map(str, s)): np.asarray(jax.random.uniform(
                    NOISE_KEY, s, jnp.float32)) for s in shapes})
        groups[_world(cfg)].append(case)
        names[_world(cfg)].append(name)
        if name != "kernels":
            nbytes[name] = {"params": per_device_bytes(state.params),
                            "opt": per_device_bytes(state.opt_state),
                            "ema": per_device_bytes(state.ema)}
            jobs[name] = (cfg, jmodel, mesh, state, src, tgt)
    save_dir = d / "saved"
    save = {"kind": "save", "cfg": _port_values(_cfg(SAVE)),
            "dir": str(save_dir), "out": str(d / "save_%d.npz")}
    groups[4].append(save)
    procs = (_launch(d, 2, groups[2], "2") + _launch(d, 4, groups[4], "4"))
    sample = jl0.hard_concrete_sample

    def run(job):
        cfg, jmodel, mesh, state, src, tgt = job
        step_fn = make_train_step(jmodel, cfg, mesh, donate=False)
        return _jax_steps(src, tgt, state, step_fn, mesh)

    try:
        with mock.patch.object(jax.random, "split", _jax_split), \
                mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
                mock.patch.object(jl0, "hard_concrete_sample",
                                  lambda rng, la: sample(NOISE_KEY, la)), \
                concurrent.futures.ThreadPoolExecutor(4) as pool:
            want = dict(zip(jobs, pool.map(run, jobs.values())))
        # the one-process run of the kernels case, on the global batch
        kernels = groups[2][names[2].index("kernels")]
        one = dict(kernels, out=str(d / "kernels_one_%d.npz"))
        one["cfg"] = dict(one["cfg"], mesh_model=1, mesh_data=-1)
        worker.run_train(one, 0, 1)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {}
    for world in (2, 4):
        for name, case in zip(names[world], groups[world]):
            got[name] = tuple(dict(np.load(case["out"] % r))
                              for r in range(world))
    saved = tuple(dict(np.load(save["out"] % r)) for r in range(4))
    return (want, nbytes, got, dict(np.load(one["out"] % 0)),
            (save_dir, saved))


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_step_matches_the_jax_step_on_its_mesh(runs, case):
    """Loss, gnorm, pnorm and the whole state after each step, on every
    rank; every rank gathers the same state, bit for bit."""
    want, _, got, _, _ = runs
    ranks = got[case]
    for s, (metrics, flat) in enumerate(want[case]):
        for rank in ranks:
            for key, value in metrics.items():
                np.testing.assert_allclose(rank["%s/%d" % (key, s)], value,
                                           rtol=1e-5, err_msg=key)
        _assert_state(ranks[0], flat, s)
    for rank in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith("held/"):
                np.testing.assert_array_equal(rank[k], ranks[0][k],
                                              err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_are_bit_equal_on_a_model_line(runs, case):
    """A leaf that the model axis does not split (LN, the output map's
    bias, the fallback's whole embedding, the experts) holds the same
    bits on the two processes of a model line after two steps: its
    gradient is the same on both, and nothing averages it."""
    _, _, got, _, _ = runs
    ranks = got[case]
    split = {str(n) for n in ranks[0]["split_names"]}
    held = [k for k in ranks[0] if k.startswith("held/")]
    whole = [k for k in held
             if layout_name(k[len("held/"):]) not in split | {None}]
    assert split and whole
    for line in range(0, len(ranks), 2):
        for k in whole:
            np.testing.assert_array_equal(ranks[line][k],
                                          ranks[line + 1][k], err_msg=k)
    odd = "_words" not in CASES[case]
    assert ("src_embedding" in split) == (not odd), sorted(split)


@pytest.mark.parametrize("case", list(CASES))
def test_per_rank_bytes_equal_jax_per_device_bytes(runs, case):
    _, nbytes, got, _, _ = runs
    for rank in got[case]:
        assert {k: int(rank["bytes/" + k]) for k in nbytes[case]} \
            == nbytes[case]


def test_two_ranks_on_the_kernel_routes_equal_one_process(runs):
    """The plain versions of #1/#2 and #11/#12 over each rank's heads and
    hidden slice, dropout on, draw the whole heads' and hidden width's
    masks: the two-rank step equals the one-process step."""
    _, _, got, one, _ = runs
    for rank in got["kernels"]:
        for k, v in one.items():
            if k.startswith(("held/", "bytes/", "split_names")):
                continue
            np.testing.assert_allclose(rank[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _templates(whole):
    templates = {}
    for k, v in whole.items():
        *parents, leaf = k.split("/")
        node = templates
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.zeros_like(v)
    return templates


def test_jax_load_checkpoint_sharded_assembles_the_tp_checkpoint(runs):
    """Each process wrote its own rectangles (a fused qkv part as three);
    JAX's load_checkpoint_sharded assembles the whole state, and a
    restore on the same mesh gives each rank back what it held."""
    _, _, _, _, (d, ranks) = runs
    whole = {k[len("whole/"):]: v for k, v in ranks[0].items()
             if k.startswith("whole/")}
    got = jsaver.load_checkpoint_sharded(str(d / "model-1"),
                                         _templates(whole))
    flat = {}
    for prefix, tree in got.items():
        flat.update(jsaver._flatten(tree, prefix))
    assert sorted(flat) == sorted(whole)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, whole[k], err_msg=k)
    def members(rank, key):
        with np.load(d / ("model-1.shard%d.npz" % rank)) as z:
            return [m for m in z.files if m.startswith(key + "@")]
    # the parameters are whole over 'data' at stage 1: data coordinate
    # 0 (ranks 0 and 1) writes each model part, as three rectangles
    qkv = "params/encoder/0/self/qkv/ws/0"
    assert [len(members(r, qkv)) for r in range(4)] == [3, 3, 0, 0]
    # the moments are ZeRO shards of the parts: every rank writes
    assert [len(members(r, "opt/.mu/" + qkv[len("params/"):]))
             for r in range(4)] == [3, 3, 3, 3]
    for rank in ranks:
        for k, v in rank.items():
            if k.startswith("held/"):
                np.testing.assert_array_equal(
                    rank["restored/" + k[len("held/"):]], v, err_msg=k)
        assert int(rank["own_keys"]) > 0


def test_a_model_line_takes_one_slot_of_the_data_groups_batches():
    """R3: at mesh (data 1, model 2) over two processes the port's two
    ranks train on the same rows (the slot of their data coordinate in
    each group of data-degree batches). The JAX package's loop takes the
    slot of the process index in each group of nproc batches
    (zero_tpu/train.py:436-442), so its two processes would hand one
    replicated global batch different rows; the reference is not edited,
    and its loop is pinned here as it stands."""
    with open(os.path.join(REPO, "zero_tpu", "train.py")) as r:
        src = r.read()
    assert "if len(host_group) < nproc:" in src
    assert "mine = host_group[pid]" in src
    with open(os.path.join(REPO, "zero_tpu_torch", "train.py")) as r:
        port = r.read()
    assert "if len(host_group) < data_par:" in port
    assert "mine = host_group[slot]" in port
    from zero_tpu_torch.parallel import distributed as dist
    slots = [dist.Grid({"data": 1, "model": 2}, r).coord("data")
             for r in range(2)]
    assert slots == [0, 0]
    slots = [dist.Grid({"data": 2, "model": 2}, r).coord("data")
             for r in range(4)]
    assert slots == [0, 0, 1, 1]
    cfg = _cfg(MESH4)
    assert ptrain.check_ported(cfg, world=4) is None
