#!/usr/bin/env python3
"""Smoke test of zero_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold them against their plain PyTorch versions, serve transformer-base
through ``python -m zero_tpu_torch.run --mode test`` (beam 4, then beam 1),
and check the served path against the CPU on a small model.

  python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1 device   card name, power limit, TF32 off
  2 build    nvcc build of csrc/decode_attention.cu (sm_90a)
  3 kernels  decode_attention and decode_pool_attention (softmax, relu) at
             transformer-base beam-4 decode shapes (B=32 sentences x beam
             4, hidden 512, 8 heads, T = 64 + 50), fp32 and bf16, against
             their plain versions; device times of kernel, plain version,
             and scaled_dot_product_attention as a yardstick, beside the
             memory/compute bound
  4 serve    beam 4: random transformer-base weights from a seed saved
             through the port's saver, a synthetic 32768-token vocabulary
             and a 64-sentence test set; counts prove the decode went
             through decode_pool_attention and never a plain version
  5 serve    beam 1: the same through decode_attention
  6 reference  a small fp32 model decoded on the card (kernels) and on the
             CPU (plain versions): identical sequences, scores within 1e-4
Then the `kernels` JSON line, the nvidia-smi name/power-limit line, and
as the last line {"ok": true, "device": {...}}.
"""

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "transformer_base_wmt14.json")
SEED = 1234

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# transformer-base beam-4 decode shapes of the serve phase's longest batch
B, K, HIDDEN, HEADS, T = 32, 4, 512, 8, 64 + 50
TIMES = (0, 1, 57, T - 1)
# |kernel - plain| <= ATOL + RTOL * max|plain|. fp32: summation order only.
# bf16: the plain version rounds logits and weights to bf16 before the
# products (as the JAX package does); the kernel keeps them fp32.
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}
# the card spins this many cycles before each timed run (~0.25 s), so the
# host enqueues the whole run first and events time device work only
SLEEP_CYCLES = 500_000_000
L2_BYTES = 50 * 2 ** 20


def phase(label, **fields):
    print("phase %-9s %s" % (label, json.dumps(fields)), flush=True)


def device_ms(fn, arg_sets, iters):
    """Device time of one call, averaged over ``iters`` back-to-back calls
    that rotate through ``arg_sets`` (together larger than L2, so every
    call reads its inputs from device memory, as a decode step does)."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    if enqueue_s * 1e3 > lead_ms():
        print("warning: host enqueue (%.1f ms) outlasted the lead (%.1f ms); "
              "%s times include host gaps" % (enqueue_s * 1e3, lead_ms(),
                                              fn.__name__))
    return ms


@functools.lru_cache(maxsize=None)
def lead_ms():
    """Device time of the spin that leads each timed run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def copies(make, set_bytes):
    n = max(2, min(64, math.ceil(4 * L2_BYTES / set_bytes)))
    return [make() for _ in range(n)]


def bound(nbytes, flops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def check(name, out, ref, dtype):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    atol, rtol = TOLERANCE[dtype]
    if not (math.isfinite(err) and err <= atol + rtol * scale):
        raise AssertionError("%s %s: max |kernel - plain| %.3g > %.3g + "
                             "%.3g * %.3g" % (name, dtype, err, atol, rtol,
                                              scale))
    return err


def kernels_phase(da):
    dev = "cuda"
    dh = HIDDEN // HEADS
    gen = torch.Generator().manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        eb = torch.tensor([], dtype=dtype).element_size()

        def rand(*shape):
            return torch.randn(shape, generator=gen).to(dev, dtype)

        def anc_at(time):
            anc = torch.randint(0, K, (B, K, T), generator=gen,
                                dtype=torch.int32)
            anc[:, :, time] = torch.arange(K, dtype=torch.int32)
            return anc.to(dev)

        errs = {"decode_attention": 0.0, "decode_pool_attention": 0.0,
                "decode_pool_attention[relu]": 0.0}
        q1, k1, v1 = rand(B, 1, HIDDEN), rand(B, T, HIDDEN), rand(B, T, HIDDEN)
        qp, kp, vp = rand(B, K, HIDDEN), rand(B, K, T, HIDDEN), rand(
            B, K, T, HIDDEN)
        for time_ in TIMES:
            e = check("decode_attention",
                      da.decode_attention(q1, k1, v1, time_, HEADS),
                      da.decode_attention_ref(q1, k1, v1, time_, HEADS), dtype)
            errs["decode_attention"] = max(errs["decode_attention"], e)
            anc = anc_at(time_)
            for relu, key in ((False, "decode_pool_attention"),
                              (True, "decode_pool_attention[relu]")):
                e = check(key, da.decode_pool_attention(qp, kp, vp, anc, time_,
                                                        HEADS, relu=relu),
                          da.decode_pool_attention_ref(qp, kp, vp, anc, time_,
                                                       HEADS, relu=relu),
                          dtype)
                errs[key] = max(errs[key], e)

        # timing at the last position of the longest batch (time = T-1)
        time_ = T - 1
        n = time_ + 1
        dense = copies(lambda: (rand(B, 1, HIDDEN), rand(B, T, HIDDEN),
                                rand(B, T, HIDDEN)), 2 * B * T * HIDDEN * eb)

        def k_dense(q, k, v):
            return da.decode_attention(q, k, v, time_, HEADS)

        def p_dense(q, k, v):
            return da.decode_attention_ref(q, k, v, time_, HEADS)

        def heads(x, length):
            return x.view(x.shape[0], -1, HEADS, dh)[:, :length].transpose(1, 2)

        def l_dense(q, k, v):
            return sdpa(heads(q, 1), heads(k, n), heads(v, n))

        nbytes = (2 * B * n * HIDDEN + 2 * B * HIDDEN) * eb
        b_ms, b_by = bound(nbytes, 4 * B * n * HIDDEN, dtype)
        rows[("decode_attention", dtype)] = dict(
            max_abs_err=errs["decode_attention"],
            ms=device_ms(k_dense, dense, 3 * len(dense)),
            plain_ms=device_ms(p_dense, dense, 3 * len(dense)),
            library_ms=device_ms(l_dense, dense, 3 * len(dense)),
            bound_ms=b_ms, bound_by=b_by)
        del dense

        pool = copies(lambda: (rand(B, K, HIDDEN), rand(B, K, T, HIDDEN),
                               rand(B, K, T, HIDDEN), anc_at(time_)),
                      2 * B * K * T * HIDDEN * eb)
        for relu, key in ((False, "decode_pool_attention"),
                          (True, "decode_pool_attention[relu]")):
            def k_pool(q, k, v, anc, relu=relu):
                return da.decode_pool_attention(q, k, v, anc, time_, HEADS,
                                                relu=relu)

            def p_pool(q, k, v, anc, relu=relu):
                return da.decode_pool_attention_ref(q, k, v, anc, time_,
                                                    HEADS, relu=relu)

            # bytes: each DISTINCT selected pool row once (beams that share
            # an ancestor share its K/V), q, out and the ancestry entries
            anc = pool[0][3][:, :, :n].long()
            distinct = torch.zeros(B, K, n, device=dev).scatter_(
                1, anc, 1.0).sum().item()
            nbytes = (2 * distinct * HIDDEN + 2 * B * K * HIDDEN) * eb \
                + 4 * B * K * n
            b_ms, b_by = bound(nbytes, 4 * B * K * n * HIDDEN, dtype)
            lib_ms = None
            if not relu:
                # yardstick: SDPA over the ancestry-gathered cache (gather
                # done beforehand, outside the timing)
                gathered = [
                    (heads(q.view(B * K, 1, HIDDEN), 1),
                     heads(torch.take_along_dim(
                         k, a.long()[..., None], dim=1).view(
                             B * K, T, HIDDEN), n),
                     heads(torch.take_along_dim(
                         v, a.long()[..., None], dim=1).view(
                             B * K, T, HIDDEN), n))
                    for q, k, v, a in pool]
                lib_ms = device_ms(sdpa, gathered, 3 * len(gathered))
                del gathered
            rows[(key, dtype)] = dict(
                max_abs_err=errs[key],
                ms=device_ms(k_pool, pool, 3 * len(pool)),
                plain_ms=device_ms(p_pool, pool, 3 * len(pool)),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del pool
        torch.cuda.empty_cache()
    for (key, dtype), r in rows.items():
        phase("kernels", kernel=key, dtype=str(dtype).split(".")[-1],
              time=T - 1, **r)
    return rows


def write_corpus(d):
    """A 32768-token vocabulary and a 64-sentence test set of 20 to 60
    tokens, made from SEED."""
    rs = np.random.RandomState(SEED)
    words = ["w%d" % i for i in range(32768 - 3)]   # + pad, unk, eos
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(words) + "\n")
    for name in ("test.src", "test.tgt"):
        with open(os.path.join(d, name), "w") as w:
            for _ in range(64):
                n = rs.randint(20, 61)
                w.write(" ".join(words[i] for i in rs.randint(0, len(words),
                                                              n)) + "\n")


def serve_phase(da, d, beam, kernel):
    """run.main --mode test over the saved weights; returns the launch
    count of ``kernel``."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/model,test_output={0}/trans{1}.txt,"
            "eval_batch_size=32,beam_size={1}".format(d, beam))
    da.launches.clear()
    t0 = time.time()
    summary = run.main(["--mode", "test", "--config", CONFIG,
                        "--parameters", spec])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(da.launches)
    with open(os.path.join(d, "trans%d.txt" % beam)) as r:
        lines = r.read().splitlines()
    layers = load_config_file(CONFIG)["num_decoder_layer"]
    if len(lines) != 64 or summary["sentences"] != 64:
        raise AssertionError("served %d lines" % len(lines))
    if launches.get(kernel, 0) != layers * summary["steps"]:
        raise AssertionError("%s launched %s times, expected %d layers x %d "
                             "steps" % (kernel, launches.get(kernel),
                                        layers, summary["steps"]))
    plain = {n: c for n, c in launches.items() if n.endswith("_ref") and c}
    other = {n: c for n, c in launches.items()
             if not n.endswith("_ref") and n != kernel and c}
    if plain or other:
        raise AssertionError("unexpected calls during serving: %s"
                             % {**plain, **other})
    phase("serve", beam=beam, sentences=summary["sentences"],
          target_tokens=summary["target_tokens"],
          decode_steps=summary["steps"], decode_s=summary["seconds"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          target_tokens_per_s=summary["target_tokens"] / summary["seconds"],
          wall_s=wall, launches=launches, bleu=summary["bleu"])
    return launches[kernel]


def reference_phase(da):
    """A small fp32 model: beam search on the card (CUDA kernels) equals
    beam search on the CPU (plain versions)."""
    import copy

    from zero_tpu_torch.config import default_config
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.search import beam_search
    from zero_tpu_torch.vocab import Vocab

    cfg = default_config()
    for k, v in dict(model_name="transformer", hidden_size=64, embed_size=64,
                     filter_size=128, num_heads=4, num_encoder_layer=2,
                     num_decoder_layer=2, decode_length=10,
                     initializer="uniform_unit_scaling",
                     initializer_gain=1.0).items():
        setattr(cfg, k, v)
    vocab = Vocab()
    for i in range(40):
        vocab.insert("w%d" % i)
    cfg.src_vocab = cfg.tgt_vocab = vocab
    model = get_model("transformer")
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    rs = np.random.RandomState(SEED)
    src = rs.randint(3, 43, (6, 12))
    for i, n in enumerate(rs.randint(3, 12, 6)):
        src[i, n:] = 0
    src[-1] = 0   # an all-pad row
    out = {}
    for beam, kernel in ((4, "decode_pool_attention"), (1, "decode_attention")):
        cfg.beam_size = beam
        inf = model.infer_fn(cfg)
        da.launches.clear()
        with torch.inference_mode():
            g = beam_search(gpu, torch.as_tensor(src).cuda(), inf, cfg)
            c = beam_search(cpu, torch.as_tensor(src), inf, cfg)
        same = torch.equal(g["seq"].cpu(), c["seq"])
        err = (g["score"].cpu() - c["score"]).abs().max().item()
        if not (same and err <= 1e-4 and da.launches[kernel] > 0
                and torch.isfinite(g["score"]).all()):
            raise AssertionError("beam %d: card vs CPU sequences equal %s, "
                                 "score err %.3g, %s launches %d"
                                 % (beam, same, err, kernel,
                                    da.launches[kernel]))
        out["beam%d" % beam] = dict(same_sequences=same, max_score_err=err,
                                    steps=g["steps"])
    phase("reference", **out)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from zero_tpu_torch.ops.kernels import decode_attention as da

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    phase("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count(),
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build
    t0 = time.time()
    lib = da.build()
    da._library()
    with open(lib + ".log") as r:
        ptxas = [line.strip() for line in r if "registers" in line]
    phase("build", seconds=time.time() - t0, library=os.path.relpath(lib, REPO),
          ptxas=ptxas)

    # 3. kernels
    rows = kernels_phase(da)

    # 4./5. serve transformer-base with random weights
    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.saver import Saver
    from zero_tpu_torch.vocab import Vocab

    with tempfile.TemporaryDirectory() as d:
        write_corpus(d)
        cfg = default_config().override_from_dict(load_config_file(CONFIG))
        cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d, "vocab.txt"))
        weights = get_model("transformer").init_fn(
            torch.Generator().manual_seed(SEED), cfg)
        Saver(output_dir=os.path.join(d, "model")).save({"params": weights},
                                                         step=0)
        del weights
        pool_launches = serve_phase(da, d, 4, "decode_pool_attention")
        dense_launches = serve_phase(da, d, 1, "decode_attention")

    # 6. reference
    reference_phase(da)

    src = "zero_tpu_torch/csrc/decode_attention.cu"
    replaced = "zero_tpu/ops/kernels/decode_attention.py:%d"
    kernels = []
    for name, line, launches in (
            ("decode_pool_attention", 288, pool_launches),
            ("decode_attention", 366, dense_launches)):
        r = rows[(name, torch.bfloat16)]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaced % line, launches=launches,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
