"""zero_tpu_torch scan_layers against zero_tpu, fp32 on the CPU, on stacked
weights bridged from the JAX init_fn: the stacked init holds the unrolled
values; train_fn loss and stacked grads of transformer and
transformer_l0drop (gate noise injected on both sides), with the kernel
flags and use_remat; scan against the unrolled layers; with dropout on,
scan with remat against scan without under the same seed words, under
every remat_policy, in fp32 and in bf16; the seed draws of the stack;
score_fn, beam search at beam 4 and 1, cache decode against dev mode; a
stacked training checkpoint across the two packages, and an unrolled
checkpoint in a stacked model."""

import contextlib
import logging
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_beam_search,  # noqa: E402
                          check_same_decode, check_score_fn, check_train_fn,
                          jax_loss_and_grads, parity_features, port_config,
                          port_params, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import l0norm as jl0  # noqa: E402
from zero_tpu.parallel.train_step import init_train_state as jinit_state  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import common as ops_common  # noqa: E402
from zero_tpu_torch.ops import l0norm  # noqa: E402
from zero_tpu_torch.saver import Saver, flat_from_module  # noqa: E402
from zero_tpu_torch.train_step import (init_train_state,  # noqa: E402
                                       make_train_step, stack_microbatches)

SCAN = dict(scan_layers=True, l0_norm_reg_scalar=0.2,
            l0_norm_end_reg_ramp_up=50)
MODELS = ("transformer", "transformer_l0drop")
NOISE_KEY = jax.random.PRNGKey(7)
STEP = 20


@contextlib.contextmanager
def _noise():
    """L0Drop's gate noise on both sides: JAX's sampler draws from
    NOISE_KEY, the port's noise is what that draws."""
    jax_sample = jl0.hard_concrete_sample
    with mock.patch.object(jl0, "hard_concrete_sample",
                           lambda rng, la: jax_sample(NOISE_KEY, la)), \
            mock.patch.object(l0norm, "uniform_noise",
                              lambda words, shape, device: t(np.asarray(
                                  jax.random.uniform(NOISE_KEY,
                                                     tuple(shape))))):
        yield


@pytest.fixture(scope="module", params=MODELS)
def setup(request):
    name = request.param
    cfg = tiny_config(model_name=name, loss_chunk_tokens=7, **SCAN,
                      **NO_DROPOUT)
    feats = parity_features()
    jparams = jget_model(name).init_fn(jax.random.PRNGKey(0), cfg)
    with _noise():
        want = jax_loss_and_grads(name, cfg, jparams, feats, step=STEP,
                                  score=True)
    return dict(name=name, cfg=cfg, feats=feats, jparams=jparams, **want)


@pytest.mark.parametrize("name", MODELS)
def test_stacked_init_holds_the_unrolled_values(name):
    cfg = port_config(tiny_config(model_name=name))
    unrolled = get_model(name).init_fn(torch.Generator().manual_seed(3), cfg)
    cfg.scan_layers = True
    stacked = get_model(name).init_fn(torch.Generator().manual_seed(3), cfg)
    flat = dict(unrolled.named_parameters())
    names = dict(stacked.named_parameters())
    assert "encoder.self.qkv.ws.0" in names
    for key, p in names.items():
        stack, _, rest = key.partition(".")
        if stack in ("encoder", "decoder"):
            rows = [flat["%s.%d.%s" % (stack, l, rest)]
                    for l in range(p.shape[0])]
            assert torch.equal(p, torch.stack(rows)), key
        else:
            assert torch.equal(p, flat[key]), key
    assert len(flat) == sum(p.shape[0] if k.split(".")[0] in
                            ("encoder", "decoder") else 1
                            for k, p in names.items())


@pytest.mark.parametrize("flags", [{}, {"kernels": True, "use_remat": True}])
def test_train_fn_and_stacked_grads_match_jax(setup, flags):
    """Each layer's grads land in its row of the stacked grads. Flags on:
    every attention and FFN takes a kernel (plain versions here), their
    forwards twice under use_remat."""
    s = setup
    kernels = flags.get("kernels", False)
    with _noise():
        launches = check_train_fn(
            s["name"], s["cfg"], s["jparams"], s["feats"], s, step=STEP,
            use_flash_attention=kernels, use_fused_ffn=kernels,
            use_remat=flags.get("use_remat", False))
    assert "params/encoder/self/qkv/ws/0" in s["grads"]
    assert launches == ({"fused_attention_ref": 12, "fused_ffn_ref": 8}
                        if kernels else {})


def _loss_and_grads(name, params, cfg, feats, seed):
    loss = get_model(name).train_fn(
        params, {k: t(v) for k, v in feats.items()}, cfg,
        None if seed is None else torch.Generator().manual_seed(seed),
        step=STEP)["loss"]
    return loss, torch.autograd.grad(loss, list(params.parameters()))


def test_scan_equals_the_unrolled_layers_without_dropout(setup):
    s = setup
    pcfg = port_config(s["cfg"])
    stacked = port_params(s["name"], s["jparams"], pcfg)
    unrolled_cfg = port_config(s["cfg"], scan_layers=False)
    unrolled = get_model(s["name"]).init_fn(torch.Generator(), unrolled_cfg)
    with torch.no_grad():
        flat = dict(unrolled.named_parameters())
        for key, p in stacked.named_parameters():
            stack, _, rest = key.partition(".")
            if stack in ("encoder", "decoder"):
                for l in range(p.shape[0]):
                    flat["%s.%d.%s" % (stack, l, rest)].copy_(p[l])
            else:
                flat[key].copy_(p)
    with _noise():
        ls, gs = _loss_and_grads(s["name"], stacked, pcfg, s["feats"], 0)
        lu, gu = _loss_and_grads(s["name"], unrolled, unrolled_cfg,
                                 s["feats"], 0)
    assert abs(ls.item() - lu.item()) <= 1e-6 * abs(lu.item())
    gu = dict(zip([n for n, _ in unrolled.named_parameters()], gu))
    for (key, p), g in zip(stacked.named_parameters(), gs):
        stack, _, rest = key.partition(".")
        if stack in ("encoder", "decoder"):
            ref = torch.stack([gu["%s.%d.%s" % (stack, l, rest)]
                               for l in range(p.shape[0])])
        else:
            ref = gu[key]
        torch.testing.assert_close(g, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_all"])
def test_remat_equals_no_remat_under_dropout(policy, dtype):
    """Dropout on: the stack's seed words do not depend on use_remat, so
    the checkpointed layers give the same loss and grads, bit for bit."""
    name = "transformer"
    cfg = port_config(tiny_config(model_name=name, default_dtype=dtype,
                                  remat_policy=policy, **SCAN),
                      use_flash_attention=True, use_fused_ffn=True)
    params = get_model(name).init_fn(torch.Generator().manual_seed(1), cfg)
    feats = parity_features()
    cfg.use_remat = False
    l0, g0 = _loss_and_grads(name, params, cfg, feats, 5)
    cfg.use_remat = True
    l1, g1 = _loss_and_grads(name, params, cfg, feats, 5)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_the_stack_draws_its_seed_words_before_it_runs():
    """As the JAX package's _stacked_keys: per stack one draw that is
    dropped, then REMAT_KEYS words per layer, whether or not use_remat;
    none in eval."""
    from zero_tpu_torch.models import common

    cfg = port_config(tiny_config(**SCAN))
    params = get_model("transformer").init_fn(torch.Generator(), cfg)
    feats = {k: t(v) for k, v in parity_features().items()}
    counts = {}
    real_call = ops_common.RngGen.__call__
    for remat in (False, True):
        cfg.use_remat = remat
        draws = []

        def spy(self):
            draws.append(1)
            return real_call(self)

        with mock.patch.object(ops_common.RngGen, "__call__", spy):
            get_model("transformer").train_fn(params, feats, cfg,
                                              torch.Generator())
        counts[remat] = len(draws)
    # per stack: the embedding's dropout, the dropped draw, 10 per layer
    want = 2 * (2 + common.REMAT_KEYS * 2)
    assert counts == {False: want, True: want}


def test_score_fn_matches_jax(setup):
    s = setup
    check_score_fn(s["name"], s["cfg"], s["jparams"], s["feats"], s["score"])


@pytest.mark.parametrize("beam", [4, 1])
def test_beam_search_matches_jax(setup, beam):
    s = setup
    check_beam_search(s["name"], tiny_config(model_name=s["name"],
                                             beam_size=beam, **SCAN),
                      s["jparams"], s["feats"]["source"])


def test_cache_decode_equals_dev_mode(setup):
    s = setup
    check_same_decode(s["name"], tiny_config(model_name=s["name"],
                                             beam_size=4, **SCAN),
                      s["jparams"], s["feats"]["source"],
                      {"search_mode": "dev"})


def test_stacked_training_checkpoint_resumes_across_the_packages(tmp_path):
    """A JAX-written stacked training checkpoint (params, Adam moments and
    count, EMA) restores exactly into the port's scan_layers state; the
    port trains a step on it and saves; the JAX package restores that into
    its stacked state, key for key."""
    cfg = tiny_config(ema_decay=0.9, **SCAN)
    jstate = jax.jit(lambda key: jinit_state(jget_model("transformer"), cfg,
                                             key))(jax.random.PRNGKey(3))
    noise = iter(range(10 ** 6))
    rand = (lambda a: jnp.asarray(np.random.RandomState(next(noise))
                                  .rand(*a.shape).astype(np.float32)))
    opt = jstate.opt_state._replace(count=jnp.asarray(4, jnp.int32),
                                    mu=jax.tree.map(rand,
                                                    jstate.opt_state.mu),
                                    nu=jax.tree.map(rand,
                                                    jstate.opt_state.nu))
    trees = {"params": jstate.params, "opt": opt,
             "ema": jax.tree.map(rand, jstate.ema)}
    JSaver(output_dir=str(tmp_path / "jax")).save(trees, step=4)
    want = {}
    for prefix, tree in trees.items():
        want.update(_flatten(tree, prefix))
    assert want["params/encoder/self/qkv/ws/0"].shape[0] == 2

    pcfg = port_config(cfg)
    state = init_train_state(get_model("transformer"), pcfg,
                             torch.Generator(), "cpu")
    ptrees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    assert Saver(output_dir=str(tmp_path / "jax")).restore(ptrees)
    got = {}
    for prefix, tree in ptrees.items():
        got.update(flat_from_module(tree, prefix))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    step = make_train_step(get_model("transformer"), pcfg)
    _, metrics = step(state, stack_microbatches([parity_features()]), 1e-3,
                      torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    Saver(output_dir=str(tmp_path / "port")).save(ptrees, step=5)
    restored = JSaver(output_dir=str(tmp_path / "port")).restore(trees)
    flat = {}
    for prefix, tree in ptrees.items():
        flat.update(flat_from_module(tree, prefix))
    assert int(flat["opt/.count"]) == 5
    for prefix in trees:
        for k, v in _flatten(restored[prefix], prefix).items():
            np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_an_unrolled_checkpoint_in_a_stacked_model_warns(tmp_path, caplog):
    """The layouts do not convert (nor in the JAX package): every layer
    tensor is missed, with a warning, and keeps its init."""
    cfg = port_config(tiny_config())
    unrolled = get_model("transformer").init_fn(
        torch.Generator().manual_seed(1), cfg)
    Saver(output_dir=str(tmp_path)).save({"params": unrolled}, step=1)
    cfg.scan_layers = True
    stacked = get_model("transformer").init_fn(
        torch.Generator().manual_seed(2), cfg)
    before = {k: p.detach().clone() for k, p in stacked.named_parameters()}
    with caplog.at_level(logging.WARNING, logger="zero_tpu_torch.saver"):
        assert Saver(output_dir=str(tmp_path)).restore({"params": stacked})
    assert "params/encoder/self/qkv/ws/0 missed in checkpoint" in caplog.text
    for k, p in stacked.named_parameters():
        if k.startswith(("encoder.", "decoder.")):
            assert torch.equal(p, before[k]), k
        else:
            assert torch.equal(p, dict(unrolled.named_parameters())[k]), k
