"""Where a beam-search decode step spends its time, on the card.

  python -m zero_tpu_torch.scripts.profile_decode [--beam 4] [--batch 32]
      [--seed 1234] [--config configs/transformer_base_wmt14.json]
      [--parameters k=v,...] [--trace FILE]

Builds the configured model (transformer-base by default) with random
weights from ``--seed`` and a 32768-token vocabulary, makes one batch of
random sources of 20 to 60 tokens padded to 64, decodes it once to warm
up, then once more under ``torch.profiler``. Prints one JSON line: decode
steps, wall ms per step, device-busy ms per step (the union of CUDA kernel
intervals) and the idle share, the CUDA kernels with the most device time,
and the host-side ops with the most self time. ``--trace`` also writes the
Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zero_tpu_torch import dtypes
from zero_tpu_torch.config import default_config, merge_params
from zero_tpu_torch.models import get_model
from zero_tpu_torch.search import beam_search
from zero_tpu_torch.train import device_of
from zero_tpu_torch.vocab import Vocab

VOCAB = 32768
SRC_LEN = 64


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def main(argv=None):
    parser = argparse.ArgumentParser("profile_decode")
    parser.add_argument("--config", default="configs/transformer_base_wmt14.json")
    parser.add_argument("--parameters", default="")
    parser.add_argument("--beam", type=int, default=4)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--trace", default="")
    args = parser.parse_args(argv)

    cfg = merge_params(default_config(), args.config, args.parameters)
    cfg.beam_size = args.beam
    cfg.src_vocab = cfg.tgt_vocab = Vocab()
    for i in range(VOCAB - 3):
        cfg.src_vocab.insert("w%d" % i)
    device = device_of(cfg)
    model = get_model(cfg.model_name)
    weights = model.init_fn(torch.Generator().manual_seed(args.seed), cfg)
    weights = dtypes.cast_to_compute(weights, cfg).to(device)
    inference = model.infer_fn(cfg)

    rs = np.random.RandomState(args.seed)
    src = rs.randint(3, VOCAB, (args.batch, SRC_LEN))
    for row, n in enumerate(rs.randint(20, 61, args.batch)):
        src[row, n + 1:] = 0          # n tokens + EOS, then padding
        src[row, n] = 2
    source = torch.as_tensor(src, device=device)

    def decode():
        with torch.inference_mode():
            out = beam_search(weights, source, inference, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    decode()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = decode()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = out["steps"]

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
        "beam": args.beam, "batch": args.batch, "src_len": SRC_LEN,
        "steps": steps, "wall_ms": wall_ms, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels": [
            {"name": name[:80], "ms_per_step": total / 1e3 / steps,
             "calls_per_step": count / steps}
            for name, (total, count) in top_kernels[:args.top]],
        "top_host_ops": [
            {"name": a.key, "self_ms_per_step":
             a.self_cpu_time_total / 1e3 / steps,
             "calls_per_step": a.count / steps}
            for a in host[:args.top]],
    }))


if __name__ == "__main__":
    main()
