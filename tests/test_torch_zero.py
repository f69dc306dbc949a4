"""zero_tpu_torch's ZeRO stages (``zero_stage`` 1-3, parallel/mesh.py and
train_step.py) and transformer_moe under data parallelism, against the
JAX package, fp32 on the CPU.

The layout: the port's per-leaf shard-dim table equals the dims where
``zero1_sharding`` puts 'data' (transformer, its scan_layers stack,
transformer_moe, rnnsearch; W = 2 and 4 of the 8 virtual devices). The
values: two gloo workers (tests/torch_zero_worker.py: torch and the port
only) train the global batch of test_torch_data_parallel.py (an all-pad
row in rank 1's slot) at each stage, update_cycle 1 and 2, dropout on
with the seed words injected into both packages, against JAX's
``make_train_step`` at ``mesh_data=2`` and the same stage: loss, gnorm,
pnorm, parameters, moments and EMA to 1e-5 after each of two steps, and
each rank's bytes of parameters, moments and EMA equal to JAX's
``per_device_bytes``. ``filter_size`` 33 leaves FFN biases that no 2
divides whole on every rank: gnorm and pnorm count them once. MoE runs
with ``relu_dropout`` on, whose expert-major mask is JAX's global draw
(ops/common.py:global_index), and the load-balance statistics of the
global batch. Then the draw itself: index_base refuses a batch axis
that is not the leading one.
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

from helpers import tiny_config  # noqa: E402
from test_torch_data_parallel import (_assert_state, _env,  # noqa: E402
                                      _free_port, _global_batches,
                                      _jax_split, _jax_words, _port_values)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel.distributed import put_global_batch  # noqa: E402
from zero_tpu.parallel.mesh import (param_sharding,  # noqa: E402
                                    per_device_bytes, zero1_sharding)
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import common  # noqa: E402
from zero_tpu_torch.parallel.mesh import zero_dims  # noqa: E402
from torch_parity import port_config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 2
LRS = [1e-3, 2e-3]
BASE = dict(num_encoder_layer=1, num_decoder_layer=1, mesh_data=2,
            mesh_model=1, ema_decay=0.9, clip_grad_norm=1.0,
            use_flash_attention=False, use_fused_ffn=False, epsilon=1e-6,
            model_name="transformer", filter_size=33)
CASES = {"stage%d-cycle%d" % (stage, cycle): dict(zero_stage=stage,
                                                   update_cycle=cycle)
         for stage in (1, 2, 3) for cycle in (1, 2)}
CASES["moe"] = dict(model_name="transformer_moe", update_cycle=2,
                    filter_size=32, moe_num_experts=4, moe_top_k=2,
                    moe_aux_weight=1.0, relu_dropout=0.3)


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------

LAYOUT_MODELS = {
    "transformer": dict(model_name="transformer"),
    "scan": dict(model_name="transformer", scan_layers=True),
    "moe": dict(model_name="transformer_moe", moe_num_experts=4),
    "rnnsearch": dict(model_name="rnnsearch", hidden_size=12,
                      embed_size=10),
}


def _path_name(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(LAYOUT_MODELS))
def test_shard_dims_equal_zero1_sharding(name, world):
    cfg = tiny_config(**LAYOUT_MODELS[name])
    shapes = jax.eval_shape(
        lambda k: jget_model(cfg.model_name).init_fn(k, cfg),
        jax.random.PRNGKey(0))
    mesh = make_mesh(data=world, model=1)
    specs = zero1_sharding(shapes, mesh, param_sharding(
        shapes, mesh, warn_unsharded=False))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        axes = list(spec.spec)
        want[_path_name(path)] = axes.index("data") if "data" in axes \
            else None
    module = get_model(cfg.model_name).init_fn(torch.Generator(),
                                               port_config(cfg))
    got = zero_dims({n: tuple(p.shape) for n, p in
                     module.named_parameters()}, world)
    assert got == want
    assert any(d is not None for d in got.values())


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_shards_join_back_to_the_whole(dim):
    """shard_of's slices of every rank, joined in rank order, are the
    whole leaf, their index text _index_key's."""
    from zero_tpu.saver import _index_key
    from zero_tpu_torch.parallel.mesh import (index_key, join_shards,
                                              shard_of, shard_slices)

    full = torch.arange(4 * 6 * 8.0).reshape(4, 6, 8)
    shards = [shard_of(full, dim, rank, 2) for rank in range(2)]
    assert torch.equal(join_shards(shards, dim), full)
    assert torch.equal(shards[1], full.narrow(dim, full.shape[dim] // 2,
                                              full.shape[dim] // 2))
    jidx = [slice(None)] * 3
    jidx[dim] = slice(full.shape[dim] // 2, full.shape[dim])
    assert index_key(shard_slices(full.shape, dim, 1, 2)) \
        == _index_key(tuple(jidx), full.shape)


# ---------------------------------------------------------------------------
# two gloo ranks against the JAX step at mesh_data=2
# ---------------------------------------------------------------------------

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
    """({case: JAX steps}, {case: JAX per_device_bytes}, {case: (rank 0
    npz, rank 1 npz)})."""
    d = tmp_path_factory.mktemp("zero")
    cases, jobs, nbytes = [], {}, {}
    for name, over in CASES.items():
        cfg = tiny_config(**dict(BASE, **over))
        cycles = cfg.update_cycle
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        nbytes[name] = {"params": per_device_bytes(state.params),
                        "opt": per_device_bytes(state.opt_state),
                        "ema": per_device_bytes(state.ema)}
        src, tgt = _global_batches(False)
        src, tgt = src[:, :cycles], tgt[:, :cycles]
        weights, batches = str(d / (name + "_w.npz")), str(d / (name +
                                                                "_b.npz"))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, src=src, tgt=tgt)
        cases.append({"kind": "train", "cfg": _port_values(cfg),
                      "weights": weights, "batches": batches, "lrs": LRS,
                      "out": str(d / (name + "_%d.npz"))})
        jobs[name] = (cfg, jmodel, mesh, state, src, tgt)
    spec = str(d / "spec.json")
    with open(spec, "w") as w:
        json.dump({"port": _free_port(), "world": 2, "cases": cases}, w)
    procs = [subprocess.Popen([sys.executable, os.path.join(
        HERE, "torch_zero_worker.py"), spec, str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env()) for r in range(2)]

    def run(job):
        cfg, jmodel, mesh, state, src, tgt = job
        step_fn = make_train_step(jmodel, cfg, mesh, donate=False)
        return _jax_steps(src, tgt, state, step_fn, mesh)

    try:
        with mock.patch.object(jax.random, "split", _jax_split), \
                mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
                concurrent.futures.ThreadPoolExecutor(4) as pool:
            want = dict(zip(jobs, pool.map(run, jobs.values())))
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {name: tuple(dict(np.load(c["out"] % r)) for r in range(2))
           for name, c in zip(CASES, cases)}
    return want, nbytes, got


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_zero_step(runs, case):
    """Loss, gnorm, pnorm and the whole state after each step; every rank
    gathers the same state, bit for bit."""
    want, _, got = runs
    rank0, rank1 = got[case]
    for s, (metrics, flat) in enumerate(want[case]):
        for rank in (rank0, rank1):
            for key, value in metrics.items():
                np.testing.assert_allclose(rank["%s/%d" % (key, s)], value,
                                           rtol=1e-5, err_msg=key)
        _assert_state(rank0, flat, s)
    for k in rank0:
        np.testing.assert_array_equal(rank0[k], rank1[k], err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if c != "moe"])
def test_per_rank_bytes_equal_jax_per_device_bytes(runs, case):
    _, nbytes, got = runs
    for rank in got[case]:
        assert {k: int(rank["bytes/" + k]) for k in nbytes[case]} \
            == nbytes[case]
    stage = CASES[case]["zero_stage"]
    whole = sum(int(np.prod(v.shape)) * 4 for k, v in got[case][0].items()
                if k.startswith("params/") and k.endswith("/0"))
    assert (nbytes[case]["params"] < whole) == (stage == 3)


@pytest.mark.parametrize("stage", [2, 3])
def test_norms_count_a_whole_leaf_once(runs, stage):
    """filter_size 33: the FFN biases [33] stay whole on both ranks. Their
    gradients' squares enter gnorm once (counted twice, gnorm would leave
    JAX's: the first step's moment gives each gradient, mu / (1 - b1) /
    the clip scale), and pnorm agrees with JAX's."""
    cfg = tiny_config(**dict(BASE, zero_stage=stage))
    module = get_model("transformer").init_fn(torch.Generator(),
                                              port_config(cfg))
    dims = zero_dims({n: tuple(p.shape) for n, p in
                      module.named_parameters()}, 2)
    whole = [n for n, d in dims.items() if d is None]
    assert any("ffn.enlarge.b" in n for n in whole), whole
    want, _, got = runs
    case = "stage%d-cycle2" % stage
    (metrics, flat), _ = want[case]
    gnorm = metrics["gnorm"]
    scale = min(1.0, cfg.clip_grad_norm / gnorm)
    twice = sum(float(np.sum((flat["opt/.mu/" + n.replace(".", "/")]
                              .astype(np.float64) / (1 - cfg.beta1)
                              / scale) ** 2)) for n in whole)
    assert np.sqrt(gnorm ** 2 + twice) - gnorm > 1e-4 * gnorm
    for rank in got[case]:
        np.testing.assert_allclose(rank["gnorm/0"], gnorm, rtol=1e-5)
        np.testing.assert_allclose(rank["pnorm/0"], metrics["pnorm"],
                                   rtol=1e-5)


def test_sharded_norm_adds_whole_leaves_once():
    """Two ranks' shards of a [4, 2] leaf and a [3] leaf held whole by
    both: the norm of the whole tree (the all-reduce stands in for the
    other rank, whose shard is this one's negation)."""
    from zero_tpu_torch import train_step

    full = torch.arange(8.0).reshape(4, 2)
    bias = torch.tensor([1.0, 2.0, 3.0])

    def other_rank(tensors):
        for t in tensors:
            t += torch.sum(full[2:] ** 2)
    with mock.patch.object(train_step.dist, "all_reduce_sum_", other_rank):
        got = train_step.sharded_norm([full[:2]], [bias])
    want = torch.sqrt(torch.sum(full ** 2) + torch.sum(bias ** 2))
    torch.testing.assert_close(got, want)


# ---------------------------------------------------------------------------
# the draw over an expert-major tensor
# ---------------------------------------------------------------------------

def test_index_base_refuses_a_batch_axis_that_is_not_leading():
    with common.global_batch(2, 2, 4):
        with pytest.raises(ValueError, match="batch axis is 1"):
            common.index_base((4, 6, 5), batch_axis=1)
        with pytest.raises(ValueError, match="leading axis is not the batch"):
            common.index_base((3, 6, 5))
        assert common.index_base((2, 6, 5)) == 2 * 30


def test_expert_major_dropout_is_the_global_draw():
    """[E, b*C, d] on rows 2-3 of a 4-row batch: each expert's block of
    the global [E, 4*C, d] draw, which one contiguous offset is not."""
    e, c, d, rows, total = 4, 3, 5, 2, 4
    words = (0x1234, 0x5678)
    x = torch.ones(e, rows * c, d)
    full = common.dropout(words, torch.ones(e, total * c, d), 0.5)
    with common.global_batch(2, rows, total):
        got = common.dropout(words, x, 0.5, batch_axis=1)
        contiguous = (common._hash_bits(words, (rows * c * e, d))
                      .reshape(e, rows * c, d) & 255) < 128
    want = full[:, 2 * c:4 * c]
    assert torch.equal(got, want)
    assert not torch.equal(got != 0, contiguous)
