"""Times of the decode kernels against the split planners' blocks-per-SM
targets, on the card.

  python -m zero_tpu_torch.scripts.decode_split_sweep [--kernel single]
      [--per-sm 1,2,4,8,16] [--lengths 114,1024,8192] [--batch 2]
      [--beam 4] [--seed 1234] [--package DIR]
  python -m zero_tpu_torch.scripts.decode_split_sweep --kernel cross
      [--lengths 64,16384] [--batch 4] ...

``--kernel single`` (the default): for each cache length T and each
target, sets ``decode_attention.DECODE_BLOCKS_PER_SM``, then times
``decode_attention`` (B rows) and ``decode_pool_attention`` (B x beam rows,
random ancestry) at time T-1. ``--kernel cross``: for each memory length
S, sets ``decode_attention.CROSS_BLOCKS_PER_SM`` and times
``decode_cross_attention`` (B x beam queries over [B, S] memory, random
pad lengths in [S/2, S]). All in bf16, hidden 512, 8 heads
(transformer-base): calls that rotate through copies of the inputs larger
than L2, queued behind a device spin so that the host's enqueue does not
gate the device. Prints one JSON line per (length, target, kernel): the
splits the wrapper launched (``decode_attention.taken``; null where the
package records none), the device ms of one call (CUDA events) and the
host us of one wrapper call (the enqueue). The first line names the
``zero_tpu_torch`` that was imported (its ``__file__``). ``--package DIR``
times another checkout's wrappers on the same inputs: the sweep runs again
in a fresh process whose working directory and ``sys.path[0]`` are DIR, so
that it imports DIR's ``zero_tpu_torch``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HIDDEN, HEADS = 512, 8
L2_BYTES = 50 * 2 ** 20
SLEEP_CYCLES = 500_000_000   # the lead spin, ~0.25 s at the H100's clock


def _times(fn, sets, iters):
    """(device ms, host us) of one call over ``iters`` calls."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


def main(argv=None):
    parser = argparse.ArgumentParser("decode_split_sweep")
    parser.add_argument("--kernel", choices=("single", "cross"),
                        default="single")
    parser.add_argument("--per-sm", default="1,2,4,8,16")
    parser.add_argument("--lengths", default=None,
                        help="default 114,1024,8192 (single), 64,16384 "
                        "(cross)")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 2 (single), 4 (cross)")
    parser.add_argument("--beam", type=int, default=4)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--package", default="")
    args = parser.parse_args(argv)
    if args.package:
        return _in_package(os.path.abspath(args.package), sys.argv[1:]
                           if argv is None else list(argv))
    import zero_tpu_torch
    print(json.dumps({"zero_tpu_torch": zero_tpu_torch.__file__}),
          flush=True)
    from zero_tpu_torch.ops.kernels import decode_attention as da

    taken = getattr(da, "taken", {})
    gen = torch.Generator().manual_seed(args.seed)
    cross = args.kernel == "cross"
    b = args.batch or (4 if cross else 2)
    beams, dev = args.beam, "cuda"
    lengths = args.lengths or ("64,16384" if cross else "114,1024,8192")

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def n_sets(rows, t):
        return max(2, min(64, -(-4 * L2_BYTES // (4 * rows * t * HIDDEN))))

    def report(name, t, beam, per_sm, fn, sets):
        taken.clear()
        ms, host_us = _times(fn, sets, max(200, 4 * len(sets)))
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "kernel": name,
            "T": t, "batch": b, "beam": beam, "blocks_per_sm": per_sm,
            "splits": taken.get(name), "ms": ms, "host_us": host_us}),
            flush=True)

    if cross:
        for s_len in (int(x) for x in lengths.split(",")):
            sets = []
            for _ in range(n_sets(b, s_len)):
                lens = torch.randint(s_len // 2, s_len + 1, (b,),
                                     generator=gen)
                mask = (torch.arange(s_len)[None] < lens[:, None]).float()
                sets.append((rand(b, beams, HIDDEN), rand(b, s_len, HIDDEN),
                             rand(b, s_len, HIDDEN), mask.to(dev)))
            for per_sm in (int(x) for x in args.per_sm.split(",")):
                da.CROSS_BLOCKS_PER_SM = per_sm
                report("decode_cross_attention", s_len, beams, per_sm,
                       lambda q, mk, mv, mask: da.decode_cross_attention(
                           q, mk, mv, mask, HEADS), sets)
        return

    for t in (int(x) for x in lengths.split(",")):
        time_ = t - 1
        dense = [(rand(b, 1, HIDDEN), rand(b, t, HIDDEN), rand(b, t, HIDDEN))
                 for _ in range(n_sets(b, t))]
        pool = []
        for _ in range(n_sets(b * beams, t)):
            anc = torch.randint(0, beams, (b, beams, t), generator=gen,
                                dtype=torch.int32)
            anc[:, :, time_] = torch.arange(beams, dtype=torch.int32)
            pool.append((rand(b, beams, HIDDEN), rand(b, beams, t, HIDDEN),
                         rand(b, beams, t, HIDDEN), anc.to(dev)))
        for per_sm in (int(x) for x in args.per_sm.split(",")):
            da.DECODE_BLOCKS_PER_SM = per_sm
            for name, fn, sets in (
                    ("decode_attention",
                     lambda q, k, v: da.decode_attention(q, k, v, time_,
                                                         HEADS), dense),
                    ("decode_pool_attention",
                     lambda q, k, v, a: da.decode_pool_attention(
                         q, k, v, a, time_, HEADS), pool)):
                report(name, t,
                       beams if name == "decode_pool_attention" else 1,
                       per_sm, fn, sets)


def _in_package(package: str, argv) -> int:
    """Run this script without ``--package`` in a fresh process whose
    working directory and sys.path[0] are ``package``; returns its exit
    code. (This process has already imported its own zero_tpu_torch, the
    script's package, when run with -m.)"""
    rest, skip = [], False
    for arg in argv:
        if skip:
            skip = False
        elif arg == "--package":
            skip = True
        elif not arg.startswith("--package="):
            rest.append(arg)
    script = os.path.abspath(__file__)
    code = ("import runpy, sys; sys.path.insert(0, %r); sys.argv = %r; "
            "runpy.run_path(%r, run_name='__main__')"
            % (package, [script] + rest, script))
    return subprocess.run([sys.executable, "-c", code], cwd=package).returncode


if __name__ == "__main__":
    sys.exit(main())
