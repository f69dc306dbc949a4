"""zero_tpu_torch data parallelism across processes against zero_tpu's
data-parallel step, fp32 on the CPU.

Two gloo workers (tests/torch_dp_worker.py: torch and the port only) each
train on their slot of a numpy-seeded global batch (update_cycle=2, one
rank holding an all-pad row, so the ranks' valid rows differ) from weights
bridged from the JAX init_fn; JAX's ``make_train_step`` runs the same
global batch over ``mesh_data=2`` of its virtual CPU devices
(``put_global_batch``). Loss, gnorm, parameters, Adam moments and EMA
agree to 1e-5 after each of two steps, with the composite dropout on (the
seed words of each site injected into both packages' RngGen, the hash
indexed by the global row) and off; transformer_l0drop and
transformer_clsr with their gate noise injected too. The kernel routes'
plain versions, dropout on, give two ranks the one-process run on the
concatenated batch. Then the grouping of host batches against
``zero_tpu/train.py:_pad_group_batch``, the data-sharded decode of an odd
number of rows, and ``--mode train`` in two processes: only rank 0 writes,
both ranks get one BLEU, a restart resumes, and a SIGTERM to one rank
stops both at one checkpoint. Adam's epsilon is 1e-6 in the step cases:
at the default 1e-9 a gradient that is rounding noise (a key bias's)
moves its weight by +-lr in either package, whichever sign the noise has.
"""

import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import time
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dp_worker as worker  # noqa: E402
from helpers import tiny_config  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel.distributed import put_global_batch  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.train import _pad_group_batch as jpad_group  # noqa: E402
from zero_tpu_torch import train as ptrain  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ROWS, CYCLES, STEPS = 3, 2, 2       # rows a rank, update_cycle, steps
LRS = [1e-3, 2e-3]
NOISE_KEY = jax.random.PRNGKey(7)
NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)
BASE = dict(num_encoder_layer=1, num_decoder_layer=1, update_cycle=CYCLES,
            mesh_data=2, mesh_model=1, ema_decay=0.9, clip_grad_norm=1.0,
            use_flash_attention=False, use_fused_ffn=False, epsilon=1e-6)
CASES = {
    "transformer-dropout": dict(model_name="transformer"),
    "transformer-no-dropout": dict(model_name="transformer", **NO_DROPOUT),
    "l0drop": dict(model_name="transformer_l0drop", l0_norm_reg_scalar=0.2,
                   l0_norm_warm_up=False),
    "clsr": dict(model_name="transformer_clsr", num_languages=3,
                 lang_id_offset=3, clsr_budget=0.3, clsr_alpha=0.7),
}
# the kernel routes (their plain versions here), dropout on: two ranks
# against one process on the global batch
KERNELS = dict(model_name="transformer", use_flash_attention=True,
               use_fused_ffn=True)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    """The workers' environment: no JAX settings, one intra-op thread
    each (two ranks share the test's cores)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _global_batches(tagged):
    """[STEPS, CYCLES, 2 * ROWS, L] src and tgt: padded tails, rank 1's
    slot holds an all-pad row and, in one microbatch, a short target."""
    rs = np.random.RandomState(0)
    src = rs.randint(6, 20, (STEPS, CYCLES, 2 * ROWS, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (STEPS, CYCLES, 2 * ROWS, 6)).astype(np.int32)
    if tagged:
        src[..., 0] = rs.randint(3, 6, src.shape[:3])
    src[:, :, 1, 5:] = 0
    tgt[:, :, 0, 4:] = 0
    src[:, :, ROWS + 1] = 0
    tgt[:, :, ROWS + 1] = 0
    tgt[:, 1, 2 * ROWS - 1, 2:] = 0
    return src, tgt


def _port_values(cfg):
    values = {k: v for k, v in cfg.values().items()
              if isinstance(v, (bool, int, float, str))}
    values["_vocab_size"] = cfg.src_vocab.size()
    return values


def _jax_split(key, num=2):
    k0 = jnp.asarray(key).astype(jnp.uint32).ravel()[0]
    return jnp.stack([k0 * jnp.uint32(num)
                      + jnp.arange(num, dtype=jnp.uint32),
                      jnp.zeros((num,), jnp.uint32)], axis=1)


def _jax_words(self):
    """RngGen.__call__ of the JAX package under the test: the words of
    torch_dp_worker.seeded_words, the microbatch from the step's key."""
    if self._key is None:
        return None
    self._count += 1
    micro = jnp.asarray(self._key).astype(jnp.uint32).ravel()[0]
    return jnp.stack([micro * jnp.uint32(1000003) + jnp.uint32(self._count),
                      jnp.uint32((0x9E3779B9 ^ self._count) & 0xFFFFFFFF)])


def _jax_steps(src, tgt, state, step_fn, mesh):
    """The JAX steps: rows of the global batch over the mesh's 'data' axis;
    each step's key [step, 0] splits into the microbatch keys [step * C +
    c, 0] (the worker's microbatch count)."""
    out = []
    for s in range(STEPS):
        batch = put_global_batch({"source": src[s], "target": tgt[s]},
                                 mesh, batch_axis=1)
        state, m = step_fn(state, batch, LRS[s],
                           jnp.array([s, 0], jnp.uint32))
        flat = _flatten(jax.device_get(state.params), "params")
        flat.update(_flatten(jax.device_get(state.opt_state), "opt"))
        flat.update(_flatten(jax.device_get(state.ema), "ema"))
        out.append((float(m["loss"]), float(m["gnorm"]), flat))
    return out


def _jax_runs(jobs):
    """Every case's JAX steps, compiled on threads of their own, under the
    seed words and gate noise of the workers."""
    sample = jl0.hard_concrete_sample

    def run(job):
        cfg, jmodel, mesh, state, src, tgt = job
        step_fn = make_train_step(jmodel, cfg, mesh, donate=False)
        return _jax_steps(src, tgt, state, step_fn, mesh)

    with mock.patch.object(jax.random, "split", _jax_split), \
            mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
            mock.patch.object(jl0, "hard_concrete_sample",
                              lambda rng, la: sample(NOISE_KEY, la)), \
            concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(run, jobs.values())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two workers on every case, run JAX meanwhile; returns
    ({case: JAX steps}, {case: (rank 0 npz, rank 1 npz)}, {kernels: the
    one-process npz})."""
    d = tmp_path_factory.mktemp("dp")
    cases, jobs = [], {}
    for name, over in list(CASES.items()) + [("kernels", KERNELS)]:
        cfg = tiny_config(**dict(BASE, **over))
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        src, tgt = _global_batches(name == "clsr")
        weights, batches = str(d / (name + "_w.npz")), str(d / (name +
                                                                "_b.npz"))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, src=src, tgt=tgt)
        case = {"kind": "train", "cfg": _port_values(cfg),
                "weights": weights, "batches": batches, "lrs": LRS,
                "out": str(d / (name + "_%d.npz"))}
        if name in ("l0drop", "clsr"):
            shapes = {(2 * ROWS, src.shape[-1], 1), (2 * ROWS, tgt.shape[-1],
                                                     1)}
            case["noise"] = str(d / (name + "_noise.npz"))
            np.savez(case["noise"], **{
                "x".join(map(str, s)): np.asarray(jax.random.uniform(
                    NOISE_KEY, s, jnp.float32)) for s in shapes})
        cases.append(case)
        jobs[name] = (cfg, jmodel, mesh, state, src, tgt)
    decode_cfg = _port_values(tiny_config(model_name="transformer",
                                          num_encoder_layer=1,
                                          num_decoder_layer=1))
    cases.append({"kind": "decode", "cfg": decode_cfg, "rows": 5,
                  "out": str(d / "decode_%d.npz")})
    spec = str(d / "spec.json")
    with open(spec, "w") as w:
        json.dump({"port": _free_port(), "world": 2, "cases": cases}, w)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE,
                                                            "torch_dp_worker.py"),
                               spec, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env())
             for r in range(2)]
    try:
        want = _jax_runs({name: jobs[name] for name in CASES})
        # the one-process run of the kernels case, on the global batch
        one = dict(cases[len(CASES)], out=str(d / "kernels_one_%d.npz"))
        one["cfg"] = dict(one["cfg"], mesh_data=-1)
        worker.run_train(one, 0, 1)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {c["out"]: tuple(dict(np.load(c["out"] % r)) for r in range(2))
           for c in cases}
    return (want, {name: got[c["out"]] for name, c in
                   zip(list(CASES) + ["kernels", "decode"], cases)},
            dict(np.load(one["out"] % 0)))


def _assert_state(got, want, s, tol=1e-5):
    """Every parameter, moment and EMA tensor to ``tol`` of its group's
    largest value (the moments' scale is the gradients')."""
    scale = {}
    for k, v in want.items():
        group = k.split("/")[0] + ("/" + k.split("/")[1]
                                   if k.startswith("opt") else "")
        scale[group] = max(scale.get(group, 0.0), float(np.abs(v).max()))
    for k, v in want.items():
        group = k.split("/")[0] + ("/" + k.split("/")[1]
                                   if k.startswith("opt") else "")
        err = float(np.abs(got["%s/%d" % (k, s)] - v).max())
        assert err <= tol * max(scale[group], 1.0 if group == "params"
                                else 0.0) + 1e-12, (k, s, err)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_data_parallel_step(runs, case):
    want, got, _ = runs
    rank0, rank1 = got[case]
    for s, (loss, gnorm, flat) in enumerate(want[case]):
        for rank in (rank0, rank1):
            np.testing.assert_allclose(rank["loss/%d" % s], loss, rtol=1e-5)
            np.testing.assert_allclose(rank["gnorm/%d" % s], gnorm,
                                       rtol=1e-5)
        _assert_state(rank0, flat, s)
    # every rank holds the same state, bit for bit
    for k in rank0:
        np.testing.assert_array_equal(rank0[k], rank1[k], err_msg=k)


def test_two_ranks_on_the_kernel_routes_equal_one_process(runs):
    """The plain versions of #1/#2 and #11/#12, dropout on: rows of the
    global batch draw their own masks on whichever rank holds them."""
    _, got, one = runs
    rank0, rank1 = got["kernels"]
    for k, v in one.items():
        np.testing.assert_allclose(rank0[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(rank0[k], rank1[k], err_msg=k)


def test_sharded_decode_of_odd_rows_equals_the_plain_decode(runs):
    """Five rows over two ranks (one padded row): every rank gets every
    row's beams, equal to its one-process decode."""
    _, got, _ = runs
    for rank in got["decode"]:
        assert rank["seq"].shape[0] == 5
        np.testing.assert_array_equal(rank["seq"], rank["plain_seq"])
        np.testing.assert_allclose(rank["score"], rank["plain_score"],
                                   rtol=1e-6, atol=1e-6)


def test_grouping_matches_the_jax_package():
    """Each rank's slot of every group of two host batches, padded to the
    group's shape: the port's _pad_group_batch against the JAX package's
    on one host stream (token buckets of different shapes, a speech-like
    key whose length is its own)."""
    rs = np.random.RandomState(2)
    stream = []
    for rows, ls, lt in ((4, 7, 5), (6, 3, 9), (2, 8, 8), (5, 5, 4)):
        stream.append({"src": rs.randint(0, 9, (rows, ls)),
                       "tgt": rs.randint(0, 9, (rows, lt)),
                       "transcript": rs.randint(0, 9, (rows, ls + 2)),
                       "raw": ["x"] * rows, "index": list(range(rows))})
    for g in range(0, len(stream), 2):
        group = stream[g:g + 2]
        shapes = []
        for pid in range(2):
            got = ptrain._pad_group_batch(group[pid], group)
            want = jpad_group(group[pid], group)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]))
            shapes.append({k: np.shape(v) for k, v in got.items()
                           if k != "raw" and k != "index"})
        assert shapes[0] == shapes[1]


# ---------------------------------------------------------------------------
# --mode train in two processes (tests/test_distributed.py cases 1-4)
# ---------------------------------------------------------------------------

@pytest.fixture
def corpus(tmp_path):
    rs = np.random.RandomState(0)
    words = ["tok%d" % i for i in range(12)]
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["<pad>", "<unk>", "<eos>"] + words) + "\n")
    for name, n in (("train", 120), ("dev", 7)):
        lines = [" ".join(rs.choice(words, rs.randint(3, 8)))
                 for _ in range(n)]
        (tmp_path / (name + ".src")).write_text("\n".join(lines) + "\n")
        (tmp_path / (name + ".tgt")).write_text("\n".join(lines) + "\n")
    return tmp_path


def _spec(d, steps, batch_or_token="token", evals=4):
    return ("device=cpu,model_name=transformer,hidden_size=16,embed_size=16,"
            "filter_size=32,num_heads=2,num_encoder_layer=1,"
            "num_decoder_layer=1,max_len=16,batch_or_token=%s,batch_size=8,"
            "token_size=60,eval_batch_size=4,beam_size=2,decode_length=4,"
            "decode_max_len=12,lrate=3e-3,lrate_strategy=vanilla,"
            "max_training_steps=%d,disp_freq=2,save_freq=4,eval_freq=%d,"
            "sample_freq=%d,epoches=100,pad_seq_multiple=4,update_cycle=2,"
            "native_tokenizer=false,preempt_sync_freq=2,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "src_dev_file={0}/dev.src,tgt_dev_file={0}/dev.tgt,"
            "output_dir={0}/out".format(d) % (batch_or_token, steps, evals,
                                              evals))


def _start(d, steps, batch_or_token="token", evals=4):
    coordinator = "127.0.0.1:%d" % _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "zero_tpu_torch.run", "--mode", "train",
         "--parameters", _spec(d, steps, batch_or_token, evals)
         + ",dist_coordinator=%s,dist_num_processes=2,dist_process_id=%d"
         % (coordinator, pid)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env()) for pid in range(2)]


def _finish(procs, timeout=240):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "Training finished" in out, out[-3000:]
    return outs


def _final_bleu(out):
    return [line.split("Final BLEU ")[1].split()[0]
            for line in out.splitlines() if "Final BLEU" in line]


def test_two_process_training_saves_on_rank_0_and_agrees_on_bleu(corpus):
    """Token buckets, in-training eval and sampling; a restart resumes
    from the step-8 checkpoint to step 12 on both ranks."""
    outs = _finish(_start(corpus, 8))
    record = json.load(open(corpus / "out" / "record.json"))
    assert record["step"] == 8 and record["valid_script_scores"]
    assert (corpus / "out" / "model-8.npz").exists()
    assert "Saving recorder file" in outs[0]
    assert "Saving recorder file" not in outs[1]
    assert "sample 0" in outs[0] and "sample 0" not in outs[1]
    assert _final_bleu(outs[0]) == _final_bleu(outs[1]) != []
    outs = _finish(_start(corpus, 12))
    for out in outs:
        assert "Restoring from %s" % (corpus / "out" / "model-8.npz") in out
        assert "/10, loss" in out and "/2, loss" not in out
    assert json.load(open(corpus / "out" / "record.json"))["step"] == 12


def test_sigterm_to_one_rank_stops_both_at_one_checkpoint(corpus):
    procs = _start(corpus, 100000, "batch", evals=0)
    try:
        record = corpus / "out" / "record.json"
        deadline = time.time() + 120
        while not record.exists():
            assert time.time() < deadline, "training never reached a save"
            for p in procs:
                assert p.poll() is None, p.communicate()[0][-3000:]
            time.sleep(0.5)
        procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    outs = _finish(procs)
    steps = []
    for out in outs:
        assert "exiting for preemption" in out, out[-3000:]
        steps.append([line.split("checkpointing at step ")[1].split()[0]
                      for line in out.splitlines()
                      if "checkpointing at step" in line])
    assert steps[0] == steps[1] and len(steps[0]) == 1
    assert json.load(open(corpus / "out" / "record.json"))["step"] \
        == int(steps[0][0])
