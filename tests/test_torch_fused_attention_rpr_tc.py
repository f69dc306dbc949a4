"""zero_tpu_torch RPR backward (#4) on the tensor cores: the bf16 inputs it
takes, through the plain version ``fused_attention_rpr_ref`` and through
the JAX package's Pallas RPR kernel in interpret mode (output and the five
gradients dq, dk, dv, dTk, dTv); the route the RPR backward takes; and the
wrapper's CPU dispatch in bf16. The CUDA kernel runs only on the card,
where chip_smoke.py holds it to the plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu.ops.kernels import fused_attention as jfa  # noqa: E402
from zero_tpu_torch.ops import rpr  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402

# bf16 on both sides: the Pallas kernel rounds its weights and bucket sums
# to bf16 before its products, where the plain version keeps fp32 until the
# output (8 mantissa bits), so each result agrees within 1e-2 + 1e-2 * its
# max, the bound of the other bf16 checks against the Pallas kernels
BF16_TOL = 1e-2
B, H, L, D, M = 2, 2, 12, 16, 2


def _bf16_inputs(seed):
    rs = np.random.RandomState(seed)
    qkv = [rs.randn(B, H, L, D).astype(np.float32) for _ in range(3)]
    tables = [rs.randn(2 * M + 1, D).astype(np.float32) for _ in range(2)]
    do = rs.randn(B, H, L, D).astype(np.float32)
    pad = np.ones((B, L), np.float32)
    pad[0, L - 3:] = 0
    pad[1] = 0           # an all-pad batch row
    return qkv + tables, pad, do


def test_bf16_ref_matches_pallas_rpr_kernel_in_interpret_mode(monkeypatch):
    """Causal self-attention whose batch row 1 is all padding: under the
    fused rule that row's weights are uniform over all L keys, so its
    bucket sums feed dTv from the keys past the diagonal (bucket 0 gets
    nothing else), while its dq and dk stay 0. In bf16 through the Pallas
    RPR kernel and through the plain version (fp32 inside, bf16 out)."""
    args, pad, do = _bf16_inputs(11)
    monkeypatch.setattr(jfa, "INTERPRET", True)

    def fn(q, k, v, tk, tv):
        return jfa.fused_attention(q, k, v, jnp.asarray(pad), causal=True,
                                   rpr_tables={"keys": tk, "values": tv},
                                   max_relative_position=M)

    out, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.bfloat16) for x in args))
    want = [np.asarray(x.astype(jnp.float32))
            for x in (out,) + vjp(jnp.asarray(do, jnp.bfloat16))]

    q, k, v, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                       .requires_grad_() for x in args)
    got = fa.fused_attention_rpr_ref(q, k, v, torch.from_numpy(pad), tk, tv,
                                     M, causal=True)
    grads = torch.autograd.grad(got, (q, k, v, tk, tv),
                                torch.from_numpy(do).to(torch.bfloat16))
    got = [x.detach().float().numpy() for x in (got,) + grads]
    for name, g, w in zip(("out", "dq", "dk", "dv", "dTk", "dTv"), got,
                          want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                   atol=BF16_TOL + BF16_TOL
                                   * np.abs(w).max())
    assert not got[1][1].any() and not got[2][1].any()
    # bucket 0 (keys more than m past the row) is reached only by the
    # all-pad row, through the keys past the diagonal
    assert np.abs(want[5][0]).max() > 0.1
    np.testing.assert_allclose(got[5][0], want[5][0], rtol=0,
                               atol=BF16_TOL * np.abs(want[5][0]).max())


@pytest.mark.parametrize("device,dtype,dh,route", [
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 64, "plain"),
    ("cuda", torch.bfloat16, 16, "tensor_cores"),
    ("cuda", torch.bfloat16, 64, "tensor_cores"),
    ("cuda", torch.bfloat16, 128, "tensor_cores"),
    ("cuda", torch.bfloat16, 80, "tensor_cores"),
    ("cuda", torch.bfloat16, 40, "cuda_cores"),
    ("cuda", torch.float32, 64, "cuda_cores")])
def test_rpr_backward_route(device, dtype, dh, route):
    """The RPR backward takes the route of the fused attention: the plain
    version on the CPU; on the card the tensor-core #4 in bf16 at a head
    depth that is a multiple of 16 up to 128 (80 is padded to 128 inside),
    the CUDA-core #4 in fp32 (which must stay exact) and at other depths.
    The table-gradient partials are sized from the dq grid of that route:
    64-row blocks on the tensor cores, 32 on the CUDA cores."""
    assert fa.forward_route(dtype, dh, device) == route
    if route != "plain":
        assert fa._RPR_DQ_ROWS[route] == (64 if route == "tensor_cores"
                                          else 32)


def test_wrapper_takes_the_plain_version_for_cpu_bf16_tensors():
    """On the CPU the wrapper runs the plain version in bf16 too (one call,
    no kernel launch), returning bf16 and gradients for both tables."""
    args, pad, do = _bf16_inputs(12)
    q, k, v, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                       .requires_grad_() for x in args)
    fa.launches.clear()
    out = fa.fused_attention(q, k, v, torch.from_numpy(pad), causal=True,
                             rpr_tables=rpr.RprTables(tk, tv),
                             max_relative_position=M)
    assert dict(fa.launches) == {"fused_attention_rpr_ref": 1}
    assert out.dtype == torch.bfloat16
    ref = fa.fused_attention_rpr_ref(q, k, v, torch.from_numpy(pad), tk, tv,
                                     M, causal=True)
    assert torch.equal(out, ref)
