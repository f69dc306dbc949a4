"""zero_tpu_torch's sequence parallelism (``mesh_seq``; parallel/ring.py,
the split skeleton of models/common.py) against the JAX package's step on
the same mesh, fp32 on the CPU.

Gloo workers (tests/torch_sp_worker.py: torch and the port only), two on
the mesh (data 1, seq 2) and four on (data 2, seq 2), (data 1, seq 4) or
(model 2, seq 2), train a global batch of 8-token sentences (an all-pad
row in the second data slot) from weights bridged from the JAX init_fn,
update_cycle 2, every dropout rate at 0.1 with the seed words injected into
both packages, against JAX's ``make_train_step`` on the same mesh of its
virtual devices with ``ring.set_active_mesh``: loss, gnorm, pnorm,
parameters, moments and EMA to 1e-5 after each of two steps. Cases:
transformer at zero_stage 0, 1 and 3, transformer_rpr, transformer_rela,
transformer_multilingual, transformer_clsr (its gate noise injected,
sliced to each rank's block of positions) and transformer_l0drop (its
gates drawn over the gathered encoder output, the penalty's gradient
shared over the line), scan_layers with use_remat,
the kernel routes' plain versions (the ring's blocks in the kernels' form,
#1/#2 on a query block, #11/#12 on a block's rows; attention dropout 0,
as the kernels draw their own attention masks), the same under
transformer_rpr (its cross-attention's #3/#4 on a query block, distances
from the block's first query), a source of 7 and a
target of 6 tokens at dropout 0 (the port pads to the seq degree, JAX runs
that length dense) and tensor with sequence parallelism. Each rank's
bytes of parameters, moments and EMA equal JAX's ``per_device_bytes``.
The dev eval's decode under the seq axis (whole weights, the rows over
the processes) equals the plain decode. Then the grouping: the processes
of a seq line take one slot of the data groups' batches (R3).
"""

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

from helpers import tiny_config, tiny_vocab  # noqa: E402
from test_torch_data_parallel import (NOISE_KEY, _assert_state,  # noqa: E402
                                      _env, _free_port, _jax_split,
                                      _jax_words, _port_values)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel import ring as jring  # noqa: E402
from zero_tpu.parallel.distributed import put_global_batch  # noqa: E402
from zero_tpu.parallel.mesh import per_device_bytes  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch import train as ptrain  # noqa: E402
from zero_tpu_torch.parallel import distributed as pdist  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, CYCLES, ROWS = 2, 2, 3
LRS = [1e-3, 2e-3]
BASE = dict(num_encoder_layer=1, num_decoder_layer=1, update_cycle=CYCLES,
            ema_decay=0.9, clip_grad_norm=1.0, use_flash_attention=False,
            use_fused_ffn=False, epsilon=1e-6, model_name="transformer",
            num_heads=4, max_relative_position=2, mesh_model=1)
NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)
S12 = dict(mesh_data=1, mesh_seq=2)
S22 = dict(mesh_data=2, mesh_seq=2)
S14 = dict(mesh_data=1, mesh_seq=4)
CASES = {
    "transformer": dict(S12),
    "seq4": dict(S14),
    "stage0-4": dict(S22),
    "stage1-4": dict(S22, zero_stage=1),
    "stage3-4": dict(S22, zero_stage=3),
    "rpr": dict(S12, model_name="transformer_rpr"),
    "rela": dict(S12, model_name="transformer_rela"),
    "multilingual": dict(S12, model_name="transformer_multilingual",
                         num_languages=3, lang_id_offset=3, _tagged=True),
    "clsr": dict(S12, model_name="transformer_clsr", num_languages=3,
                 lang_id_offset=3, clsr_budget=0.3, clsr_alpha=0.7,
                 _tagged=True),
    "l0drop": dict(S12, model_name="transformer_l0drop",
                   l0_norm_reg_scalar=0.2, l0_norm_warm_up=False),
    "scan-remat": dict(S12, num_encoder_layer=2, num_decoder_layer=2,
                       scan_layers=True, use_remat=True),
    "kernels": dict(S12, _flags=True, attention_dropout=0.0),
    "rpr-kernels": dict(S12, model_name="transformer_rpr", _flags=True,
                        attention_dropout=0.0),
    "odd-length": dict(S12, _lengths=(7, 6), **NO_DROPOUT),
    "model-seq": dict(mesh_data=1, mesh_model=2, mesh_seq=2,
                      _words=21),
}


def _case_cfg(name, port=False):
    """The case's config; ``port``: with the kernel flags of a ``_flags``
    case (the JAX step runs without them: its ring ignores them, and its
    cross-attention and FFN draw the same masks either way)."""
    over = CASES[name]
    cfg = tiny_config(**dict(BASE, **{k: v for k, v in over.items()
                                      if not k.startswith("_")}))
    if over.get("_words"):
        cfg.src_vocab = cfg.tgt_vocab = tiny_vocab(over["_words"])
    if port and over.get("_flags"):
        cfg.use_flash_attention = cfg.use_fused_ffn = True
    return cfg


def _world(cfg):
    return int(cfg.mesh_data) * int(cfg.mesh_model) * int(cfg.mesh_seq)


def _batches(tagged, lengths=(8, 8)):
    """[STEPS, CYCLES, 2 * ROWS, L] src and tgt: padded tails, the second
    data slot holds an all-pad row and, in one microbatch, a short
    target."""
    rs = np.random.RandomState(0)
    ls, lt = lengths
    src = rs.randint(6, 20, (STEPS, CYCLES, 2 * ROWS, ls)).astype(np.int32)
    tgt = rs.randint(3, 20, (STEPS, CYCLES, 2 * ROWS, lt)).astype(np.int32)
    if tagged:
        src[..., 0] = rs.randint(3, 6, src.shape[:3])
    src[:, :, 1, 5:] = 0
    tgt[:, :, 0, 4:] = 0
    src[:, :, ROWS + 1] = 0
    tgt[:, :, ROWS + 1] = 0
    tgt[:, 1, 2 * ROWS - 1, 2:] = 0
    return src, tgt


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: JAX steps}, {case: JAX per_device_bytes}, {case: the ranks'
    npz})."""
    d = tmp_path_factory.mktemp("sp")
    groups, names, jobs, nbytes = {2: [], 4: []}, {2: [], 4: []}, {}, {}
    for name, over in CASES.items():
        cfg = _case_cfg(name)
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        src, tgt = _batches(over.get("_tagged", False),
                            over.get("_lengths", (8, 8)))
        weights, batches = (str(d / (name + "_w.npz")),
                            str(d / (name + "_b.npz")))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, src=src, tgt=tgt)
        case = {"kind": "train", "cfg": _port_values(_case_cfg(name, True)),
                "weights": weights, "batches": batches, "lrs": LRS,
                "out": str(d / (name + "_%d.npz"))}
        if cfg.model_name in ("transformer_clsr", "transformer_l0drop"):
            case["noise"] = str(d / (name + "_noise.npz"))
            shapes = {(2 * ROWS, src.shape[-1], 1),
                      (2 * ROWS, tgt.shape[-1], 1)}
            np.savez(case["noise"], **{
                "x".join(map(str, s)): np.asarray(jax.random.uniform(
                    NOISE_KEY, s, jnp.float32)) for s in shapes})
        groups[_world(cfg)].append(case)
        names[_world(cfg)].append(name)
        nbytes[name] = {"params": per_device_bytes(state.params),
                        "opt": per_device_bytes(state.opt_state),
                        "ema": per_device_bytes(state.ema)}
        jobs[name] = (cfg, jmodel, mesh, state, src, tgt)
    # the dev eval's decode under the seq axis: whole weights, rows over
    # the processes (the seq leg of tests/test_decode_sharded.py)
    decode = {"kind": "decode", "rows": 5, "out": str(d / "decode_%d.npz"),
              "cfg": _port_values(tiny_config(mesh_seq=2, mesh_data=1,
                                              num_encoder_layer=1,
                                              num_decoder_layer=1))}
    groups[2].append(decode)
    procs = []
    for world in (2, 4):
        spec = str(d / ("spec%d.json" % world))
        with open(spec, "w") as w:
            json.dump({"port": _free_port(), "world": world,
                       "cases": groups[world]}, w)
        procs += [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_sp_worker.py"), spec,
             str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env()) for r in range(world)]
    sample = jl0.hard_concrete_sample
    want = {}
    try:
        with mock.patch.object(jax.random, "split", _jax_split), \
                mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
                mock.patch.object(jl0, "hard_concrete_sample",
                                  lambda rng, la: sample(NOISE_KEY, la)):
            for name, (cfg, jmodel, mesh, state, src, tgt) in jobs.items():
                # the ring reads the published mesh when the step traces
                jring.set_active_mesh(mesh)
                try:
                    step_fn = make_train_step(jmodel, cfg, mesh,
                                              donate=False)
                    want[name] = _jax_steps(src, tgt, state, step_fn, mesh)
                finally:
                    jring.set_active_mesh(None)
        outs = [p.communicate(timeout=420)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {}
    for world in (2, 4):
        for name, case in zip(names[world] + ["decode"], groups[world]):
            got[name] = tuple(dict(np.load(case["out"] % r))
                              for r in range(world))
    return want, nbytes, got


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_step_matches_the_jax_step_on_its_mesh(runs,
                                                                 case):
    """Loss, gnorm, pnorm and the whole state after each step, on every
    rank; every rank gathers the same state, bit for bit."""
    want, _, got = runs
    ranks = got[case]
    for s, (metrics, flat) in enumerate(want[case]):
        for rank in ranks:
            for key, value in metrics.items():
                np.testing.assert_allclose(rank["%s/%d" % (key, s)], value,
                                           rtol=1e-5, err_msg=key)
        _assert_state(ranks[0], flat, s)
    for rank in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith(("held/", "launches/")):
                np.testing.assert_array_equal(rank[k], ranks[0][k],
                                              err_msg=k)
    # the self-attention ran as ring blocks; the kernels cases took #1/#2
    # and #11/#12 (their plain versions) on its blocks, transformer_rpr
    # #3/#4 (its FFN takes no kernel, as in the JAX package)
    for rank in ranks:
        assert int(rank["launches/ring_block_ref"]) > 0
        kernels = CASES[case].get("_flags", False)
        rpr = CASES[case].get("model_name") == "transformer_rpr"
        for key in (("fused_attention_rpr_ref",) if rpr
                    else ("fused_attention_ref", "fused_ffn_ref")):
            assert (int(rank["launches/" + key]) > 0) == kernels, key


@pytest.mark.parametrize("case", list(CASES))
def test_per_rank_bytes_equal_jax_per_device_bytes(runs, case):
    _, nbytes, got = runs
    for rank in got[case]:
        assert {k: int(rank["bytes/" + k]) for k in nbytes[case]} \
            == nbytes[case]


def test_sharded_decode_under_a_seq_mesh_equals_the_plain_decode(runs):
    """Five rows over the two ranks of mesh data 1 x seq 2 (one padded
    row): every rank gets every row's beams, equal to its one-process
    decode (tests/test_decode_sharded.py::test_seq_mesh_decode_matches_
    plain)."""
    _, _, got = runs
    for rank in got["decode"]:
        assert rank["seq"].shape[0] == 5
        np.testing.assert_array_equal(rank["seq"], rank["plain_seq"])
        np.testing.assert_allclose(rank["score"], rank["plain_score"],
                                   rtol=1e-6, atol=1e-6)


def test_a_seq_line_takes_one_slot_of_the_data_groups_batches():
    """R3 over 'seq': the processes of a seq line train on the same rows
    (the slot of their data coordinate), each its block of every
    sequence; the grid orders the axes as make_mesh does."""
    slots = [pdist.Grid({"data": 1, "seq": 2}, r).coord("data")
             for r in range(2)]
    assert slots == [0, 0]
    grids = [pdist.Grid({"data": 2, "seq": 2}, r) for r in range(4)]
    assert [g.coord("data") for g in grids] == [0, 0, 1, 1]
    assert [g.coord("seq") for g in grids] == [0, 1, 0, 1]
    grids = [pdist.Grid({"data": 1, "model": 2, "seq": 2}, r)
             for r in range(4)]
    assert [(g.coord("model"), g.coord("seq")) for g in grids] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    cfg = _case_cfg("stage0-4")
    assert ptrain.check_ported(cfg, world=4) is None
