"""Device times of the RPR forward #3 beside the fused forward #1 on the
same inputs, on the card.

  python -m zero_tpu_torch.scripts.rpr_forward_times [--seed 1234]

Times ``fused_attention``'s RPR forward on the route ``forward_route``
picks (bf16 at head depth 64: the tensor-core #3) and #1 on the same q, k,
v and pad mask without tables, m = 16, dropout 0 and 0.1, at
chip_smoke.py's ``rpr_kernels`` shapes (B=16, H=8, L=256 under the causal
flag and under a pad mask with an all-pad row; cross attention 200 x 256)
and at those of profile_train.py's transformer_rpr step (B=64, H=8, L=64
under a pad mask and under the causal flag). Calls rotate through copies
of the inputs larger than L2, queued behind a device spin. Prints one JSON
line a case: the card, #3's and #1's ms, and #3's largest difference from
``fused_attention_rpr_ref`` (reported, not gated). To compare checkouts on
the same inputs, run it from each checkout's root in turns.
"""

from __future__ import annotations

import argparse
import json

import torch

from zero_tpu_torch.ops.kernels import fused_attention as fa
from zero_tpu_torch.scripts.decode_split_sweep import L2_BYTES, _times

M = 16
# (name, B, H, Lq, Lk, Dh, causal, pad mask with an all-pad row)
CASES = (("self_causal", 16, 8, 256, 256, 64, True, False),
         ("self_pad", 16, 8, 256, 256, 64, False, True),
         ("cross", 16, 8, 200, 256, 64, False, True),
         ("step_pad", 64, 8, 64, 64, 64, False, True),
         ("step_causal", 64, 8, 64, 64, 64, True, True))
WORDS = (0x12345678, 0x9ABCDEF0)


def main(argv=None):
    parser = argparse.ArgumentParser("rpr_forward_times")
    parser.add_argument("--seed", type=int, default=1234)
    args = parser.parse_args(argv)
    gen = torch.Generator().manual_seed(args.seed)
    dev, dtype = "cuda", torch.bfloat16

    for name, b, h, lq, lk, dh, causal, padded in CASES:
        def inputs():
            q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(dev, dtype)
                       for n in (lq, lk, lk))
            tk, tv = (torch.randn(2 * M + 1, dh, generator=gen).to(dev, dtype)
                      for _ in range(2))
            pad = torch.ones(b, lk)
            if padded:
                lens = torch.randint(lk // 4, lk + 1, (b,), generator=gen)
                pad = (torch.arange(lk)[None] < lens[:, None]).float()
                pad[-1] = 0.0
            return q, k, v, tk, tv, pad.to(dev)

        nbytes = 2 * b * h * (lq + 2 * lk) * dh
        sets = [inputs() for _ in range(
            max(2, min(64, -(-4 * L2_BYTES // nbytes))))]
        route = fa.forward_route(dtype, dh)
        for rate in (0.0, 0.1):
            words = WORDS if rate else (0, 0)

            def rpr(q, k, v, tk, tv, pad):
                return fa._forward_rpr(q, k, v, pad, tk, tv, M, 0, causal,
                                       rate, words, route=route)

            def plain_attention(q, k, v, tk, tv, pad):
                return fa._forward_tc(q, k, v, pad, causal, rate, words)

            q, k, v, tk, tv, pad = sets[0]
            ref = fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, M, causal,
                                             rate, WORDS if rate else None)
            err = (rpr(*sets[0])[0].float() - ref.float()).abs().max()
            iters = max(200, 4 * len(sets))
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "case": name,
                "dropout": rate, "route": route,
                "rpr_ms": _times(rpr, sets, iters)[0],
                "fused_ms": _times(plain_attention, sets, iters)[0],
                "max_abs_err": err.item()}), flush=True)


if __name__ == "__main__":
    main()
