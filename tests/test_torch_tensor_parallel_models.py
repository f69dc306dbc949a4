"""zero_tpu_torch's tensor parallelism (``mesh_model``) for the nine models
beyond the Transformer core, and expert parallelism under
``scan_layers``, against the JAX package's step on the same mesh, fp32
on the CPU.

Two gloo workers (tests/torch_tp_worker.py) on the mesh (data 1, model
2) train, from weights bridged from the JAX init_fn, update_cycle 2,
composite dropout on with the seed words injected into both packages
and the vocabulary at 24 rows (the embeddings split): transformer_fuse
(its merged attention's AAN average over the rank's columns of ``v``),
transformer_aan with and without ``use_ffn`` (``z_project``'s columns
gathered whole before the gate's chunk: ``distributed.gather_cols``),
transformer_ibdecoder (``dir_embedding`` split over its two rows),
transformer_clsr (``shared`` and ``lang`` column-parallel, gathered;
the gate and its noise whole on both ranks), transformer_multilingual
(``lalt`` column-parallel, gathered before the vocab-parallel cross
entropy) without and with ROBT (the intermediate languages injected;
the greedy decode on whole weights gathered without gradient; on four
workers, mesh (data 2, model 2), at zero_stage 3),
transformer_afs (speech frames, CTC over coarse labels, the gate noise
injected; ``frontend``, the gates and ``ctc_head`` whole), rnnsearch,
deepnmt and rnnsearch_deepatt (only the embeddings split); and, on (data
1, expert 2), transformer_moe under ``scan_layers`` at 2+2 layers (which
it ignores, as the JAX package does: the experts of each layer split).
Against JAX's ``make_train_step``:
loss, gnorm, pnorm, parameters, moments and EMA to 1e-5 after each of
two steps; the leaves that no axis splits are bit-equal on the ranks of
a line; each rank's bytes equal JAX's ``per_device_bytes``.
"""

import ast
import concurrent.futures
import os
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_data_parallel import (NOISE_KEY, ROWS, _assert_state,  # noqa: E402
                                      _global_batches, _jax_split,
                                      _jax_words, _port_values)
from test_torch_tensor_parallel import (EVEN, LRS, MESH2, MESH4,  # noqa: E402
                                        STEPS, _cfg, _launch, _world)
from zero_tpu import robt as jrobt  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import common as jcommon  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.parallel import init_train_state, make_mesh  # noqa: E402
from zero_tpu.parallel import make_train_step  # noqa: E402
from zero_tpu.parallel.distributed import put_global_batch  # noqa: E402
from zero_tpu.parallel.mesh import per_device_bytes  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch.saver import layout_name  # noqa: E402

LANGS = dict(num_languages=3, lang_id_offset=3)
# ROBT's intermediate language of each of the global batch's rows
Z = np.array([[2], [0], [1], [1], [2], [0]], np.int32)
SPEECH = dict(model_name="transformer_afs", data_kind="speech",
              audio_num_mel_bins=6, audio_frame_stride=2,
              num_st_encoder_layer=1, ctc_enable=True, ctc_alpha=0.3,
              coarse_label_base=5, afs_l0_scalar=0.5,
              l0_norm_end_reg_ramp_up=50)
CASES = {
    "fuse": dict(MESH2, model_name="transformer_fuse", _words=EVEN),
    "aan": dict(MESH2, model_name="transformer_aan", _words=EVEN),
    "aan-ffn": dict(MESH2, model_name="transformer_aan", _words=EVEN,
                    use_ffn=True),
    "ibdecoder": dict(MESH2, model_name="transformer_ibdecoder",
                      _words=EVEN),
    "clsr": dict(MESH2, model_name="transformer_clsr", _words=EVEN,
                 clsr_budget=0.3, clsr_alpha=0.7, **LANGS),
    "multilingual": dict(MESH2, model_name="transformer_multilingual",
                         _words=EVEN, **LANGS),
    "multilingual-robt-stage3": dict(
        MESH4, model_name="transformer_multilingual", _words=EVEN,
        robt=True, robt_weight=0.5, zero_stage=3, **LANGS),
    "afs": dict(MESH2, _words=EVEN, **SPEECH),
    "rnnsearch": dict(MESH2, model_name="rnnsearch", _words=EVEN),
    "deepnmt": dict(MESH2, model_name="deepnmt", _words=EVEN),
    "rnnsearch_deepatt": dict(MESH2, model_name="rnnsearch_deepatt",
                              _words=EVEN),
    "moe-scan-ep": dict(mesh_data=1, mesh_model=1, mesh_expert=2,
                        model_name="transformer_moe", _words=EVEN,
                        num_encoder_layer=2, num_decoder_layer=2,
                        scan_layers=True, filter_size=32, moe_num_experts=4,
                        moe_top_k=2, moe_aux_weight=1.0, relu_dropout=0.3),
}
# the leaves each case splits, by their short names
SPLIT = {
    "fuse": {"decoder/fuse/q", "decoder/fuse/k", "decoder/fuse/v",
             "decoder/fuse/o"},
    "aan": {"decoder/z_project"},
    "ibdecoder": {"dir_embedding"},
    "clsr": {"encoder/clsr1/lang", "encoder/clsr1/shared",
             "decoder/clsr3/lang", "decoder/clsr3/shared"},
    "multilingual": {"lalt"},
    "afs": {"asr_encoder/self/qkv", "st_encoder/ffn/output",
            "decoder/cross/k", "tgt_embedding"},
    "rnnsearch": {"src_embedding", "tgt_embedding"},
    "moe-scan-ep": {"encoder/moe/experts/w1", "decoder/moe/experts/b2"},
}


def _speech_batches():
    """[STEPS, C, 2 * ROWS, ...] audio frames, their mask, targets and
    transcripts: padded tails, an all-pad row, from a seed."""
    rs = np.random.RandomState(4)
    shape = (STEPS, 2, 2 * ROWS)
    audio = rs.randn(*shape, 13, 6).astype(np.float32)
    mask = np.ones(shape + (13,), np.float32)
    mask[:, :, 1, 11:] = 0
    mask[:, :, ROWS + 1] = 0
    audio *= mask[..., None]
    tgt = rs.randint(3, 24, shape + (6,)).astype(np.int32)
    tgt[:, :, 0, 4:] = 0
    tgt[:, :, ROWS + 1] = 0
    # folded into the coarse space (the specials, then coarse_label_base
    # labels), at most 3 a row: every row is feasible in its 5 or 6
    # stacked frames (an infeasible row's fp32 CTC differs from optax's,
    # ops/ctc.py's one deliberate difference, held in test_torch_speech)
    transcript = rs.randint(3, 8, shape + (3,)).astype(np.int32)
    transcript[:, :, 2, 2:] = 0
    transcript[:, :, ROWS + 1] = 0
    return {"audio": audio, "audio_mask": mask, "target": tgt,
            "transcript": transcript}


def _noise_shapes(cfg, feats):
    """The global shapes of the hard-concrete gates' draws: CLSR's per
    position of the source and the target, AFS's per stacked frame and
    per feature."""
    rows = 2 * ROWS
    if cfg.model_name == "transformer_clsr":
        return {(rows, feats["source"].shape[-1], 1),
                (rows, feats["target"].shape[-1], 1)}
    frames = feats["audio"].shape[3] // int(cfg.audio_frame_stride)
    return {(rows, frames, 1), (int(cfg.hidden_size),)}


def _jax_steps(feats, state, step_fn, mesh):
    out = []
    for s in range(STEPS):
        batch = put_global_batch({k: v[s] for k, v in feats.items()}, mesh,
                                 batch_axis=1)
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
    """({case: JAX steps}, {case: JAX per_device_bytes}, {case: the
    ranks' npz})."""
    d = tmp_path_factory.mktemp("tp_models")
    cases, jobs, nbytes = {2: [], 4: []}, {}, {}
    for name, over in CASES.items():
        cfg = _cfg(over)
        jmodel = jget_model(cfg.model_name)
        mesh = make_mesh(cfg)
        state = init_train_state(jmodel, cfg, jax.random.PRNGKey(0), mesh)
        nbytes[name] = {"params": per_device_bytes(state.params),
                        "opt": per_device_bytes(state.opt_state),
                        "ema": per_device_bytes(state.ema)}
        if cfg.model_name == "transformer_afs":
            feats = _speech_batches()
        else:
            src, tgt = _global_batches(tagged="num_languages" in over)
            feats = {"source": src, "target": tgt}
        weights, batches = (str(d / (name + "_w.npz")),
                            str(d / (name + "_b.npz")))
        np.savez(weights, **_flatten(jax.device_get(state.params),
                                     "params"))
        np.savez(batches, **feats)
        case = {"kind": "train", "cfg": _port_values(cfg),
                "weights": weights, "batches": batches, "lrs": LRS,
                "out": str(d / (name + "_%d.npz"))}
        if cfg.model_name in ("transformer_clsr", "transformer_afs"):
            case["noise"] = str(d / (name + "_noise.npz"))
            np.savez(case["noise"], **{
                "x".join(map(str, s)): np.asarray(jax.random.uniform(
                    NOISE_KEY, s, jnp.float32))
                for s in _noise_shapes(cfg, feats)})
        if over.get("robt"):
            case["z"] = Z.tolist()
        cases[_world(cfg)].append(case)
        jobs[name] = (cfg, jmodel, mesh, state, feats, _world(cfg), case)
    procs = _launch(d, 2, cases[2], "2") + _launch(d, 4, cases[4], "4")
    sample = jl0.hard_concrete_sample

    def run(job):
        cfg, jmodel, mesh, state, feats, _, _ = job
        step_fn = make_train_step(jmodel, cfg, mesh, donate=False)
        return _jax_steps(feats, state, step_fn, mesh)

    try:
        with mock.patch.object(jax.random, "split", _jax_split), \
                mock.patch.object(jcommon.RngGen, "__call__", _jax_words), \
                mock.patch.object(jl0, "hard_concrete_sample",
                                  lambda rng, la: sample(NOISE_KEY, la)), \
                mock.patch.object(jrobt.jax.random, "randint",
                                  lambda *a, **k: jnp.asarray(Z)), \
                concurrent.futures.ThreadPoolExecutor(4) as pool:
            want = dict(zip(jobs, pool.map(run, jobs.values())))
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-3000:]
    got = {name: tuple(dict(np.load(case["out"] % r)) for r in range(world))
           for name, (*_, world, case) in jobs.items()}
    return want, nbytes, got


@pytest.mark.parametrize("case", list(CASES))
def test_split_step_matches_the_jax_step_on_its_mesh(runs, case):
    """Loss, gnorm, pnorm and the whole state after each step, on every
    rank; all gather the same state, bit for bit."""
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
def test_leaves_no_axis_splits_are_bit_equal_on_the_line(runs, case):
    """The split leaves include the case's own (SPLIT); every other leaf
    holds the same bits on the two ranks of a model line after two
    steps."""
    _, _, got = runs
    ranks = got[case]
    split = {str(n) for n in ranks[0]["split_names"]}
    short = {"/".join(p for p in n.split(".")
                      if p not in ("ws", "b") and not p.isdigit())
             for n in split}
    assert SPLIT.get(case.split("-")[0], SPLIT.get(case, set())) <= short
    if case.startswith(("rnnsearch", "deepnmt")):
        assert short == {"src_embedding", "tgt_embedding"}
    held = [k for k in ranks[0] if k.startswith("held/")]
    whole = [k for k in held
             if layout_name(k[len("held/"):]) not in split | {None}]
    assert whole
    for line in range(0, len(ranks), 2):
        for k in whole:
            np.testing.assert_array_equal(ranks[line][k], ranks[line + 1][k],
                                          err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_per_rank_bytes_equal_jax_per_device_bytes(runs, case):
    _, nbytes, got = runs
    for rank in got[case]:
        assert {k: int(rank["bytes/" + k]) for k in nbytes[case]} \
            == nbytes[case]


def test_expert_parallelism_under_scan_layers_splits_the_experts(runs):
    """transformer_moe has its own init_fn, which ignores scan_layers in
    both packages: its layers stay a list, no leaf is a stacked [L, E,
    ...] one, and each rank holds 2 of the 4 experts of every layer, as
    JAX's expert rule lays them out."""
    _, _, got = runs
    ranks = got["moe-scan-ep"]
    assert not any(k.startswith("params/encoder/moe/") for k in ranks[0])
    for layer in ("encoder/0", "encoder/1", "decoder/1"):
        key = "params/%s/moe/experts/w1" % layer
        whole = ranks[0][key + "/1"]
        for rank, lo in zip(ranks, (0, 2)):
            np.testing.assert_array_equal(rank["held/" + key],
                                          whole[lo:lo + 2])


def test_the_worker_imports_neither_jax_nor_the_jax_package():
    """The ranks run torch and the port only (the JAX side runs in the
    test's process)."""
    path = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
    with open(path) as r:
        tree = ast.parse(r.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "zero_tpu")]
