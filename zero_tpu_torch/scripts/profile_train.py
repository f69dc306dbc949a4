"""Where a training step spends its time, on the card.

  python -m zero_tpu_torch.scripts.profile_train [--rows 64] [--src-len 64]
      [--tgt-len 64] [--max-len N] [--seed 1234]
      [--config configs/transformer_base_wmt14.json]
      [--parameters k=v,...] [--trace FILE]

Builds the configured model (transformer-base by default) with random
weights from ``--seed``, a 32768-token vocabulary and its optimizer state,
makes ``update_cycle`` microbatches of ``--rows`` random sentences padded to
the given lengths (each row 60-100% full), runs one train step to warm up,
then one more under ``torch.profiler``. Prints one JSON line: wall ms of the
step, device-busy ms (the union of CUDA kernel intervals) and the idle
share, kernel launches, the CUDA kernels with the most device time, and the
host-side ops with the most self time. ``--parameters
use_flash_attention=true,use_fused_ffn=true`` profiles the fused kernels;
``--config configs/transformer_rpr_rela.json`` profiles transformer_rpr
(its attentions over more than 2m keys take the RPR kernels). ``--max-len
16384 --parameters use_flash_attention=true`` profiles one long step: one
row of that many source and target positions per microbatch (``max_len``
set to match), so every attention streams (kernels #5-#7).
``--trace`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zero_tpu_torch.config import default_config, merge_params
from zero_tpu_torch.models import get_model
from zero_tpu_torch.scripts.profile_decode import VOCAB, _busy_us
from zero_tpu_torch.train import device_of
from zero_tpu_torch.train_step import init_train_state, make_train_step
from zero_tpu_torch.vocab import Vocab


def _tokens(rs, rows, length):
    x = rs.randint(3, VOCAB, (rows, length))
    for row, n in enumerate(rs.randint(int(0.6 * length), length + 1, rows)):
        x[row, n:] = 0
    return x


def main(argv=None):
    parser = argparse.ArgumentParser("profile_train")
    parser.add_argument("--config", default="configs/transformer_base_wmt14.json")
    parser.add_argument("--parameters", default="")
    parser.add_argument("--rows", type=int, default=64)
    parser.add_argument("--src-len", type=int, default=64)
    parser.add_argument("--tgt-len", type=int, default=64)
    parser.add_argument("--max-len", type=int, default=0,
                        help="one row of this many source and target "
                        "positions per microbatch")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--trace", default="")
    args = parser.parse_args(argv)

    cfg = merge_params(default_config(), args.config, args.parameters)
    if args.max_len:
        args.rows, args.src_len, args.tgt_len = 1, args.max_len, args.max_len
        cfg.max_len = args.max_len
    cfg.src_vocab = cfg.tgt_vocab = Vocab()
    for i in range(VOCAB - 3):
        cfg.src_vocab.insert("w%d" % i)
    device = device_of(cfg)
    model = get_model(cfg.model_name)
    state = init_train_state(model, cfg,
                             torch.Generator().manual_seed(args.seed), device)
    step_fn = make_train_step(model, cfg)
    cycle = max(int(cfg.update_cycle), 1)
    rs = np.random.RandomState(args.seed)
    batch = {"source": np.stack([_tokens(rs, args.rows, args.src_len)
                                 for _ in range(cycle)]),
             "target": np.stack([_tokens(rs, args.rows, args.tgt_len)
                                 for _ in range(cycle)])}

    def step():
        _, metrics = step_fn(state, batch, 1e-4,
                             torch.Generator().manual_seed(state.step))
        loss = float(metrics["loss"])    # waits for the device
        return loss

    step()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        loss = step()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    by_kernel = {}
    for e in kernels:
        total, count = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    host = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda a: -a.self_cpu_time_total)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "model_name": cfg.model_name,
        "use_flash_attention": bool(cfg.use_flash_attention),
        "use_fused_ffn": bool(cfg.use_fused_ffn),
        "update_cycle": cycle, "rows": args.rows, "src_len": args.src_len,
        "tgt_len": args.tgt_len, "loss": loss, "wall_ms": wall_ms,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None),
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": len(kernels),
        "top_kernels": [
            {"name": name[:80], "ms": total / 1e3, "calls": count}
            for name, (total, count) in top_kernels[:args.top]],
        "top_host_ops": [
            {"name": a.key, "self_ms": a.self_cpu_time_total / 1e3,
             "calls": a.count}
            for a in host[:args.top]],
    }))


if __name__ == "__main__":
    main()
