"""zero_tpu_torch ReLA (``relu=True`` attention, the gated-RMSNorm epilogue
and transformer_rela) against zero_tpu, fp32 on the CPU, on weights bridged
from the JAX init functions: ``gated_rms_norm``; relu ``attn_train`` on
encoder self, causal and cross attention (a pad mask with an all-pad row),
whose route stays the composite under use_flash; relu ``self_attn_step``
on the plain cache and the ancestry pools (the pool kernel's relu mode,
its plain version here) and ``cross_attn_step``; then the model:
train_fn loss and grads, score_fn, beam search at beam 3 and 1 (beam 1
never takes the dense decode kernel), and cache decode against dev-mode
decode."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import bridge, port_config, t  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.ops import attention as jattn  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import attention as attn  # noqa: E402
from zero_tpu_torch.ops import rela  # noqa: E402
from zero_tpu_torch.ops.kernels import decode_attention as da  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import streaming_attention as sa  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 3, 2, 8
HIDDEN = H * D
NAME = "transformer_rela"
NO_DROPOUT = dict(dropout=0.0, relu_dropout=0.0, residual_dropout=0.0,
                  attention_dropout=0.0)
# one layer a side keeps the JAX compiles short
SIZE = dict(model_name=NAME, num_encoder_layer=1, num_decoder_layer=1)


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _attention(self_attention, seed=3):
    """A JAX ReLA attention block and its port counterpart on the same
    weights (strict load: no missing or unexpected key)."""
    jp = jattn.init_attention(jax.random.PRNGKey(seed), HIDDEN, HIDDEN,
                              self_attention, rela=True)
    p = attn.init_attention(torch.Generator(), HIDDEN, HIDDEN,
                            self_attention, rela=True)
    return jp, bridge(jp, p)


def test_rela_reexports_the_attention_entry_points():
    assert rela.gated_rms_norm is attn.gated_rms_norm
    assert rela.attn_train is attn.attn_train
    assert rela.self_attn_step is attn.self_attn_step


def test_gated_rms_norm_matches_jax():
    rs = np.random.RandomState(0)
    jp, p = _attention(True)
    post = {k: jnp.asarray(_rand(rs, HIDDEN)) for k in ("scale", "gate")}
    p.post.load_state_dict({k: t(v) for k, v in post.items()})
    x = _rand(rs, B, 5, HIDDEN) * 3.0
    x[1, 2] = 0.0   # a zero row: rsqrt of eps
    want = jattn.gated_rms_norm(post, jnp.asarray(x))
    got = attn.gated_rms_norm(p.post, t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert sorted(n for n, _ in p.post.named_parameters()) == ["gate",
                                                                "scale"]


@pytest.mark.parametrize("case", ["self_pad", "causal", "cross"])
def test_attn_train_relu_matches_jax_on_the_composite(case):
    """use_flash is set, but relu keeps _attn_core (no fused or streaming
    call); a pad mask with an all-pad batch row gives no NaN."""
    rs = np.random.RandomState(1)
    lq, lk = 6, 7 if case == "cross" else 6
    jp, p = _attention(case != "cross", seed=4)
    x = _rand(rs, B, lq, HIDDEN)
    memory = _rand(rs, B, lk, HIDDEN) if case == "cross" else None
    pad = np.ones((B, lk), np.float32)
    pad[0, lk - 2:] = 0
    pad[1] = 0                  # an all-pad batch row
    kw = {}
    if case == "causal":
        keep = np.tril(np.ones((lq, lq), np.float32))[None, None]
        kw["causal"] = True
    else:
        keep = pad[:, None, None, :]
        kw["pad_mask"] = pad
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    pkw = {k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jattn.attn_train(
        jp, jnp.asarray(x), None if memory is None else jnp.asarray(memory),
        jnp.asarray(keep), H, relu=True, **jkw)["output"]
    fa.launches.clear()
    sa.launches.clear()
    got = attn.attn_train(p, t(x), None if memory is None else t(memory),
                          t(keep), H, relu=True, use_flash=True, **pkw)
    assert not +fa.launches and not +sa.launches
    assert got["weights"] is not None
    out = got["output"].detach().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(want), **TOL)


@pytest.mark.parametrize("mode,use_flash", [("plain", True),
                                            ("ancestry", False),
                                            ("ancestry", True)])
def test_self_attn_step_relu_matches_jax(mode, use_flash):
    """Single-beam decode never takes the dense decode kernel for relu;
    beam decode on the ancestry pools takes the pool kernel's relu mode
    (its plain version here) under use_flash, _ancestry_attn otherwise."""
    rs = np.random.RandomState(5)
    beams = 3 if mode == "ancestry" else 1
    rows, t_max = B * beams, 8
    jp, p = _attention(True, seed=6)
    jcache = jattn.init_self_cache(rows, t_max, HIDDEN, jnp.float32)
    cache = attn.init_self_cache(rows, t_max, HIDDEN, torch.float32, "cpu")
    da.launches.clear()
    for time in range(5):
        x = _rand(rs, rows, 1, HIDDEN)
        if mode == "ancestry":
            anc = rs.randint(0, beams, (B, beams, t_max)).astype(np.int32)
            jcache["ancestry"] = jnp.asarray(anc)
            cache["ancestry"] = t(anc)
        jo, jcache = jattn.self_attn_step(jp, jnp.asarray(x), jcache, time, H,
                                          relu=True)
        o, cache = attn.self_attn_step(p, t(x), cache, time, H, relu=True,
                                       use_flash=use_flash)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    pool = 5 if (mode == "ancestry" and use_flash) else 0
    assert dict(+da.launches) == ({"decode_pool_attention_relu_ref": pool}
                                  if pool else {})


def test_cross_attn_step_relu_matches_jax():
    rs = np.random.RandomState(7)
    beams, s_len = 3, 6
    jp, p = _attention(False, seed=8)
    mem = _rand(rs, B, s_len, HIDDEN)
    mem_keep = np.ones((B, s_len), np.float32)
    mem_keep[1, 4:] = 0
    mem_keep[2] = 0             # an all-pad memory row
    x = _rand(rs, B * beams, 1, HIDDEN)
    want, _ = jattn.cross_attn_step(
        jp, jnp.asarray(x), jattn.cross_attn_precompute(jp, jnp.asarray(mem)),
        jnp.asarray(mem_keep), H, relu=True)
    got = attn.cross_attn_step(p, t(x), attn.cross_attn_precompute(p, t(mem)),
                               t(mem_keep), H, relu=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    # 5 x 6 target positions in chunks of 7: a padded tail; row 2 all-pad
    cfg = tiny_config(loss_chunk_tokens=7, **SIZE, **NO_DROPOUT)
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (5, 7)).astype(np.int32)
    tgt = rs.randint(3, 20, (5, 6)).astype(np.int32)
    src[0, 4:] = 0
    tgt[1, 3:] = 0
    src[2] = 0
    tgt[2] = 0
    feats = {"source": src, "target": tgt}
    jmodel = jget_model(NAME)
    jparams = jmodel.init_fn(jax.random.PRNGKey(0), cfg)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_fn(p, jfeats, cfg,
                                  jax.random.PRNGKey(1))["loss"]))(jparams)
    score = jax.jit(lambda p: jmodel.score_fn(p, jfeats, cfg)["score"])(
        jparams)
    return dict(cfg=cfg, feats=feats, jparams=jparams, loss=float(loss),
                grads=_flatten(grads, "params"), score=np.asarray(score))


def _port_params(s, pcfg):
    return bridge(s["jparams"], get_model(NAME).init_fn(torch.Generator(),
                                                        pcfg))


@pytest.mark.parametrize("kernels", [False, True])
def test_train_fn_and_grads_match_jax(setup, kernels):
    """With both kernel flags on, ReLA still runs no attention kernel (nor
    its plain version) and no fused FFN, as in the JAX package."""
    s = setup
    pcfg = port_config(s["cfg"], use_flash_attention=kernels,
                       use_fused_ffn=kernels)
    params = _port_params(s, pcfg)
    feats = {k: t(v) for k, v in s["feats"].items()}
    fa.launches.clear()
    loss = get_model(NAME).train_fn(params, feats, pcfg,
                                    torch.Generator())["loss"]
    assert not +fa.launches
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(loss.item() - s["loss"]) <= 1e-5 * abs(s["loss"])
    assert sorted("params/" + n.replace(".", "/") for n in names) \
        == sorted(s["grads"])
    assert {"params/encoder/0/self/post/gate",
            "params/decoder/0/cross/post/scale"} <= set(s["grads"])
    # each grad within 1e-4 of its max |grad|, floored at 1e-3 of the
    # model's largest
    top = max(np.abs(g).max() for g in s["grads"].values())
    for name, g in zip(names, grads):
        want = s["grads"]["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-3 * top), (name,
                                                                   err)


def test_score_fn_matches_jax(setup):
    s = setup
    pcfg = port_config(s["cfg"])
    with torch.no_grad():
        score = get_model(NAME).score_fn(
            _port_params(s, pcfg), {k: t(v) for k, v in s["feats"].items()},
            pcfg)["score"]
    np.testing.assert_allclose(score.numpy(), s["score"], rtol=1e-5,
                               atol=1e-6)
    assert score[2].item() == 0.0   # the all-pad row


@pytest.mark.parametrize("beam", [3, 1])
def test_beam_search_matches_jax(setup, beam):
    """Beam 3 runs the ancestry pools through the pool kernel's relu mode
    (its plain version on the CPU), beam 1 the plain cache with no decode
    kernel. Sequences identical to JAX's."""
    s = setup
    cfg = tiny_config(beam_size=beam, **SIZE)
    src = s["feats"]["source"]
    infer = jget_model(NAME).infer_fn(cfg)
    want = jax.jit(lambda p, x: jbeam_search(p, x, infer, cfg))(
        s["jparams"], jnp.asarray(src))
    pcfg = port_config(cfg)
    da.launches.clear()
    with torch.inference_mode():
        got = beam_search(_port_params(s, pcfg), t(src).long(),
                          get_model(NAME).infer_fn(pcfg), pcfg)
    steps = got["steps"]
    assert dict(+da.launches) == ({"decode_pool_attention_relu_ref": steps}
                                  if beam > 1 else {})
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got["score"].numpy()).all()


@pytest.mark.parametrize("override", [{"search_mode": "dev"},
                                      {"decode_ancestry": "off"}])
def test_cache_decode_equals_other_decode_paths(setup, override):
    """Cache decode (ancestry pools) == dev-mode (decode_prefix full
    recompute) decode, and == the classic permuted-cache decode."""
    s = setup
    cfg = tiny_config(beam_size=3, **SIZE)
    src = t(s["feats"]["source"]).long()
    out = []
    for pcfg in (port_config(cfg), port_config(cfg, **override)):
        with torch.inference_mode():
            out.append(beam_search(_port_params(s, pcfg), src,
                                   get_model(NAME).infer_fn(pcfg), pcfg))
    np.testing.assert_array_equal(out[1]["seq"].numpy(),
                                  out[0]["seq"].numpy())
    np.testing.assert_allclose(out[1]["score"].numpy(),
                               out[0]["score"].numpy(), rtol=1e-4, atol=1e-4)
