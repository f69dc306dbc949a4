"""zero_tpu_torch ``use_remat`` and ``remat_policy`` (activation
checkpointing of each training layer) on the CPU: with dropout off, the
loss and grads of transformer_fuse (BASELINE config 4's model) under each
policy match the JAX package's under jax.checkpoint; with dropout on, the
checkpointed layers' loss and grads equal the same layers run without
the checkpoint on the same pre-drawn seed words, in fp32 and in bf16 (the
recompute runs after the loss's functional_call has put the fp32 masters
back); each policy keeps the matmuls it names (counted in the backward);
an 11th dropout draw in a layer and an unknown policy raise."""

import collections

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_train_fn,  # noqa: E402
                          jax_loss_and_grads, parity_features, port_config,
                          port_params, t)
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu_torch.models import common  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops.common import RngGen  # noqa: E402

NAME = "transformer_fuse"
POLICIES = ["nothing", "dots", "dots_all"]
SIZE = dict(model_name=NAME, num_encoder_layer=2, num_decoder_layer=1,
            deep_transformer_init=True, loss_chunk_tokens=7)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(use_remat=True, **SIZE, **NO_DROPOUT)
    feats = parity_features()
    jparams = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, feats=feats, jparams=jparams,
                **jax_loss_and_grads(NAME, cfg, jparams, feats))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax(setup, policy):
    s = setup
    launches = check_train_fn(NAME, s["cfg"], s["jparams"], s["feats"], s,
                              remat_policy=policy, use_flash_attention=True,
                              use_fused_ffn=True)
    # 2 encoder layers, each forward again in the backward's recompute
    assert launches == {"fused_attention_ref": 4, "fused_ffn_ref": 4}


def _run(params, feats, pcfg, seed):
    loss = get_model(NAME).train_fn(params, feats, pcfg,
                                    torch.Generator().manual_seed(seed))["loss"]
    return loss, torch.autograd.grad(loss, list(params.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_checkpoint_on_the_same_words(setup, policy, dtype,
                                                      monkeypatch):
    """Dropout on (0.1 at every site) and both kernel flags on (their plain
    versions): the checkpointed run against the same layers called
    directly on the same pre-drawn words."""
    s = setup
    pcfg = port_config(s["cfg"], remat_policy=policy, default_dtype=dtype,
                       dropout=0.1, attention_dropout=0.1, relu_dropout=0.1,
                       residual_dropout=0.1, use_flash_attention=True,
                       use_fused_ffn=True)
    feats = {k: t(v) for k, v in s["feats"].items()}
    params = port_params(NAME, s["jparams"], pcfg)
    loss, grads = _run(params, feats, pcfg, 3)
    monkeypatch.setattr(common, "remat_layer",
                        lambda layer, ctx, fn, *args: fn(layer, *args))
    ref_loss, ref_grads = _run(params, feats, pcfg, 3)
    assert torch.isfinite(loss) and loss.item() == ref_loss.item()
    top = max(g.abs().max().item() for g in ref_grads)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.float32
        assert (g - r).abs().max().item() <= 1e-6 * top
    # dropout is on: a run from other words differs
    other, _ = _run(params, feats, pcfg, 4)
    assert other.item() != loss.item()


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_policies_keep_the_matmuls_they_name(setup):
    """Counted in the backward (the composite, flags off): "nothing"
    recomputes every forward matmul, "dots" none of the plain ones (mm) but
    the batched ones (bmm: attention's), "dots_all" neither."""
    s = setup
    feats = {k: t(v) for k, v in s["feats"].items()}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    counts = {}
    for policy in [None] + POLICIES:
        pcfg = port_config(s["cfg"], use_remat=policy is not None,
                           remat_policy=policy or "nothing")
        params = port_params(NAME, s["jparams"], pcfg)
        loss = get_model(NAME).train_fn(params, feats, pcfg,
                                        torch.Generator())["loss"]
        with _CountOps() as counter:
            torch.autograd.grad(loss, list(params.parameters()))
        counts[policy] = (counter.ops[mm], counter.ops[bmm])
    off = counts[None]
    assert counts["nothing"][0] > off[0] and counts["nothing"][1] > off[1]
    assert counts["dots"][0] == off[0] and counts["dots"][1] > off[1]
    assert counts["dots_all"] == off


def test_an_eleventh_draw_in_a_layer_raises():
    draw = common._key_source(common._draw_keys(
        RngGen(torch.Generator().manual_seed(0))))
    words = [draw() for _ in range(common.REMAT_KEYS)]
    assert len(set(words)) == common.REMAT_KEYS
    with pytest.raises(RuntimeError, match="more than 10 dropout seeds"):
        draw()


def test_unknown_policy_raises(setup):
    s = setup
    pcfg = port_config(s["cfg"], remat_policy="bogus")
    with pytest.raises(ValueError, match="bogus"):
        get_model(NAME).train_fn(port_params(NAME, s["jparams"], pcfg),
                                 {k: t(v) for k, v in s["feats"].items()},
                                 pcfg, torch.Generator())
    # evaluation never checkpoints: the policy is not read there
    with torch.no_grad():
        get_model(NAME).score_fn(port_params(NAME, s["jparams"], pcfg),
                                 {k: t(v) for k, v in s["feats"].items()},
                                 pcfg)
