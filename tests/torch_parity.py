"""Shared helpers of the tests that hold zero_tpu_torch to zero_tpu: the
config translation and the weight bridge (JAX param tree -> torch module)."""

import numpy as np
import torch

from zero_tpu.saver import _flatten
from zero_tpu_torch import config as port_config_mod
from zero_tpu_torch.saver import params_from_flat


def port_config(cfg, **overrides):
    """The port's Config holding the same values as a JAX-package Config,
    on the CPU."""
    c = port_config_mod.default_config()
    for k, v in cfg.values().items():
        setattr(c, k, v)
    c.device = "cpu"
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def bridge(jax_tree, module):
    """Load a JAX param tree into a port module through the checkpoint key
    paths (saver._flatten) and params_from_flat; returns the module."""
    module.load_state_dict(params_from_flat(_flatten(jax_tree, "p"), "p"))
    return module


def t(x):
    """numpy/JAX array -> torch CPU tensor (copy)."""
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# model-level parity: train_fn, score_fn, beam search, cache decode
# ---------------------------------------------------------------------------

NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)


def parity_features():
    """5 sentences: a padded source tail, a padded target tail and an
    all-pad row (row 2)."""
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (5, 6)).astype(np.int32)
    src[0, 4:] = 0
    tgt[1, 3:] = 0
    src[2] = 0
    tgt[2] = 0
    return {"source": src, "target": tgt}


def tagged_features():
    """parity_features with a language tag (ids 3-5) leading every source
    row but the all-pad row 2 (the multilingual models)."""
    feats = parity_features()
    feats["source"][[0, 1, 3, 4], 0] = [3, 5, 4, 5]
    return feats


def jax_loss_and_grads(name, cfg, jparams, feats, step=0, score=False):
    """The JAX package's train_fn loss and grads (one jitted step) and,
    with ``score``, its score_fn."""
    import jax
    import jax.numpy as jnp
    from zero_tpu.models import get_model as jget_model
    from zero_tpu.saver import _flatten

    jmodel = jget_model(name)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_fn(p, jfeats, cfg, jax.random.PRNGKey(1),
                                  step=step)["loss"]))(jparams)
    out = dict(loss=float(loss), grads=_flatten(grads, "params"))
    if score:
        out["score"] = np.asarray(jax.jit(
            lambda p: jmodel.score_fn(p, jfeats, cfg)["score"])(jparams))
    return out


def port_params(name, jparams, pcfg):
    from zero_tpu_torch.models import get_model
    return bridge(jparams, get_model(name).init_fn(torch.Generator(), pcfg))


def launch_counters():
    from zero_tpu_torch.ops.kernels import decode_attention as da
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    return (fa.launches, ff.launches, da.launches)


def check_train_fn(name, cfg, jparams, feats, want, step=0, **flags):
    """The port's train_fn (a generator, dropout seeds from seed 0) against
    ``want``: loss within 1e-5 relative, each grad within 1e-4 of its max
    |grad| (floored at 1e-3 of the model's largest). Returns the launch
    counts."""
    from zero_tpu_torch.models import get_model

    pcfg = port_config(cfg, **flags)
    params = port_params(name, jparams, pcfg)
    for c in launch_counters():
        c.clear()
    loss = get_model(name).train_fn(
        params, {k: t(v) for k, v in feats.items()}, pcfg,
        torch.Generator().manual_seed(0), step=step)["loss"]
    names = [n for n, _ in params.named_parameters()]
    # a parameter the loss never reads (the additive attention's
    # feed_memory, which every RNN model bypasses with its projected
    # memory) gets no grad here, where JAX gives exact zeros: held as zeros
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.parameters(), grads)]
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"]), (
        loss.item(), want["loss"])
    assert sorted("params/" + n.replace(".", "/") for n in names) \
        == sorted(want["grads"])
    top = max(np.abs(g).max() for g in want["grads"].values())
    for n, g in zip(names, grads):
        ref = want["grads"]["params/" + n.replace(".", "/")]
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-3 * top), (n, err)
    launches = {}
    for c in launch_counters():
        launches.update(+c)
    return launches


def check_score_fn(name, cfg, jparams, feats, want):
    from zero_tpu_torch.models import get_model

    pcfg = port_config(cfg)
    with torch.no_grad():
        score = get_model(name).score_fn(
            port_params(name, jparams, pcfg),
            {k: t(v) for k, v in feats.items()}, pcfg)["score"]
    np.testing.assert_allclose(score.numpy(), want, rtol=1e-5, atol=1e-6)
    return score


def port_beam(name, cfg, jparams, src, **overrides):
    """The port's beam search on the CPU over the bridged weights."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.search import beam_search

    pcfg = port_config(cfg, **overrides)
    with torch.inference_mode():
        return beam_search(port_params(name, jparams, pcfg), t(src).long(),
                           get_model(name).infer_fn(pcfg), pcfg)


def check_beam_search(name, cfg, jparams, src):
    """Beam search (cfg.beam_size) against the JAX package's: the same
    sequences, scores within 1e-4. Returns the port's result."""
    import jax
    import jax.numpy as jnp
    from zero_tpu.models import get_model as jget_model
    from zero_tpu.search import beam_search as jbeam_search

    infer = jget_model(name).infer_fn(cfg)
    want = jax.jit(lambda p, x: jbeam_search(p, x, infer, cfg))(
        jparams, jnp.asarray(src))
    got = port_beam(name, cfg, jparams, src)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got["score"].numpy()).all()
    return got


def check_same_decode(name, cfg, jparams, src, override):
    """Cache decode at cfg's beam against the decode under ``override``
    (dev mode, the classic cache, ...): the same sequences."""
    a = port_beam(name, cfg, jparams, src)
    b = port_beam(name, cfg, jparams, src, **override)
    np.testing.assert_array_equal(b["seq"].numpy(), a["seq"].numpy())
    np.testing.assert_allclose(b["score"].numpy(), a["score"].numpy(),
                               rtol=1e-4, atol=1e-4)


def check_checkpoint_round_trip(name, cfg, jparams, directory):
    """The JAX package's Saver writes the params; the port's Saver restores
    them exactly; the port's Saver writes them back; the JAX Saver
    restores those exactly."""
    import os

    import jax
    from zero_tpu.saver import Saver as JSaver, _flatten
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.saver import Saver, flat_from_module

    jdir, pdir = os.path.join(directory, "jax"), os.path.join(directory,
                                                               "port")
    JSaver(output_dir=jdir).save({"params": jparams}, step=1)
    pcfg = port_config(cfg)
    module = get_model(name).init_fn(torch.Generator(), pcfg)
    assert Saver(output_dir=jdir).restore({"params": module})
    want = _flatten(jparams, "params")
    got = flat_from_module(module, "params")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    Saver(output_dir=pdir).save({"params": module}, step=2)
    template = {"params": jax.tree.map(np.zeros_like, jparams)}
    restored = JSaver(output_dir=pdir).restore(template)
    for k, v in _flatten(restored["params"], "params").items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
