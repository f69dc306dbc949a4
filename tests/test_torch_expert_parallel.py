"""zero_tpu_torch's expert parallelism (``mesh_expert``; ops/moe.py's
einsum dispatch over a process's experts) against the JAX package's step
on the same mesh, fp32 on the CPU.

Four gloo workers (tests/torch_tp_worker.py) on the mesh (data 2,
expert 2) train transformer_moe (4 experts, top-2, ``relu_dropout`` on:
the expert FFN's mask at the global expert and batch index) from weights
bridged from the JAX init_fn, against JAX's ``make_train_step`` at
``mesh_data=2, mesh_expert=2``: loss, gnorm, pnorm, parameters, moments
and EMA to 1e-5 after each of two steps, at zero_stage 0 and 3 (ZeRO
cuts each process's expert part). Each rank holds half of every expert
stack, the same bits of every other leaf as its expert partner, and the
bytes JAX's ``per_device_bytes`` gives.
"""

import concurrent.futures
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_data_parallel import (  # noqa: E402
    _assert_state, _global_batches, _jax_split, _jax_words, _port_values)
from test_torch_tensor_parallel import (LRS, _cfg, _jax_steps,  # noqa: E402
                                        _launch)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel.mesh import per_device_bytes  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch.saver import layout_name  # noqa: E402

MOE = dict(mesh_data=2, mesh_model=1, mesh_expert=2,
           model_name="transformer_moe", _words=21, filter_size=32,
           moe_num_experts=4, moe_top_k=2, moe_aux_weight=1.0,
           relu_dropout=0.3)
CASES = {"stage0": dict(MOE), "stage3": dict(MOE, zero_stage=3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: JAX steps}, {case: JAX per_device_bytes}, {case: the four
    ranks' npz})."""
    d = tmp_path_factory.mktemp("ep")
    cases, jobs, nbytes = [], {}, {}
    for name, over in CASES.items():
        cfg = _cfg(over)
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        nbytes[name] = {"params": per_device_bytes(state.params),
                        "opt": per_device_bytes(state.opt_state),
                        "ema": per_device_bytes(state.ema)}
        src, tgt = _global_batches(False)
        weights, batches = (str(d / (name + "_w.npz")),
                            str(d / (name + "_b.npz")))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, src=src, tgt=tgt)
        cases.append({"kind": "train", "cfg": _port_values(cfg),
                      "weights": weights, "batches": batches, "lrs": LRS,
                      "out": str(d / (name + "_%d.npz"))})
        jobs[name] = (cfg, jmodel, mesh, state, src, tgt)
    procs = _launch(d, 4, cases, "ep")

    def run(job):
        cfg, jmodel, mesh, state, src, tgt = job
        step_fn = make_train_step(jmodel, cfg, mesh, donate=False)
        return _jax_steps(src, tgt, state, step_fn, mesh)

    try:
        with mock.patch.object(jax.random, "split", _jax_split), \
                mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
                concurrent.futures.ThreadPoolExecutor(2) as pool:
            want = dict(zip(jobs, pool.map(run, jobs.values())))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {name: tuple(dict(np.load(c["out"] % r)) for r in range(4))
           for name, c in zip(CASES, cases)}
    return want, nbytes, got


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_step_matches_the_jax_step_on_its_mesh(runs, case):
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
            if not k.startswith("held/"):
                np.testing.assert_array_equal(rank[k], ranks[0][k],
                                              err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_experts_and_jax_bytes(runs, case):
    """The expert stacks, and only they, are split over 'expert'; every
    other leaf is bit-equal on the two processes of an expert line; the
    bytes are JAX's."""
    _, nbytes, got = runs
    ranks = got[case]
    split = {str(n) for n in ranks[0]["split_names"]}
    assert split and all(".experts." in n for n in split)
    for rank in ranks:
        assert {k: int(rank["bytes/" + k]) for k in nbytes[case]} \
            == nbytes[case]
    held = [k for k in ranks[0] if k.startswith("held/")]
    for line in (0, 2):
        for k in held:
            if layout_name(k[len("held/"):]) in split:
                continue
            np.testing.assert_array_equal(ranks[line][k],
                                          ranks[line + 1][k], err_msg=k)
    w1 = "held/params/encoder/0/moe/experts/w1"
    whole = ranks[0]["params/encoder/0/moe/experts/w1/1"]
    assert ranks[0][w1].shape[0] * 2 == whole.shape[0]
    if case == "stage0":
        for rank, lo in zip(ranks, (0, 2, 0, 2)):
            np.testing.assert_array_equal(rank[w1], whole[lo:lo + 2])


def test_the_expert_rule_needs_a_divisible_expert_count():
    """param_sharding's rule: the expert dim of an 'experts' leaf is split
    only where the expert degree divides it."""
    from zero_tpu_torch.parallel.mesh import param_specs
    shapes = {"encoder.0.moe.experts.w1": (4, 8, 16),
              "encoder.0.moe.experts.b1": (3, 16),
              "encoder.0.moe.router.ws.0": (8, 4)}
    specs = param_specs(shapes, model=1, expert=2)
    assert specs["encoder.0.moe.experts.w1"] == ("expert", None, None)
    assert specs["encoder.0.moe.experts.b1"] == (None, None)
    assert specs["encoder.0.moe.router.ws.0"] == (None, None)
