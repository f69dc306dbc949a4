#!/usr/bin/env python3
"""Smoke test of zero_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold them against their plain PyTorch versions, serve transformer-base
through ``python -m zero_tpu_torch.run --mode test`` (beam 4, then beam 1),
train it through ``python -m zero_tpu_torch.run --mode train``, train, serve
and score transformer_rpr (Shaw relative positions) the same way, train,
score and serve transformer-base on sequences past 8192 tokens (the
streaming-attention kernels), and check these paths against the CPU on
small models.

  python3 chip_smoke.py                 # every phase (the smoke test)
  python3 chip_smoke.py --phases build,train_kernels   # a subset, no
                                        # summary lines

Phases (each prints one line or more; any failure raises and exits
non-zero):
  device     card name, power limit, TF32 off
  build      nvcc builds of csrc/{decode_attention,fused_attention,
             fused_attention_rpr,fused_ffn,streaming_attention}.cu (sm_90a),
             one process each, all at once; the ptxas register/shared-memory
             report
  kernels    decode_attention and decode_pool_attention (softmax, relu) at
             transformer-base beam-4 decode shapes (B=32 sentences x beam
             4, hidden 512, 8 heads, T = 64 + 50), fp32 and bf16, against
             their plain versions; device times of kernel, plain version,
             and scaled_dot_product_attention as a yardstick, beside the
             memory/compute bound
  train_kernels  fused_attention (forward, backward) at B=16, H=8, Dh=64:
             causal self-attention L=256, self-attention L=256 under a pad
             mask with an all-pad row, cross attention Lq=200 Lk=256; and
             fused_ffn (forward, backward) at N=4096, 512->2048->512; fp32
             and bf16, dropout 0 and 0.1, outputs and every gradient held
             against the plain versions; device times of kernel, plain
             version and a PyTorch yardstick (SDPA; F.linear/relu/F.linear)
             beside the bound
  serve      beam 4: random transformer-base weights from a seed saved
             through the port's saver, a synthetic 32768-token vocabulary
             and a 64-sentence test set; counts prove the decode went
             through decode_pool_attention and never a plain version
  serve      beam 1: the same through decode_attention
  reference  a small fp32 model decoded on the card (kernels) and on the
             CPU (plain versions): identical sequences, scores within 1e-4
  train      transformer-base (configs/transformer_base_wmt14.json: bf16,
             dropout 0.1, token_size 4096, update_cycle 4) trained for
             TRAIN_STEPS steps on a synthetic corpus with both kernel flags
             on: ms/step, target tokens/s, loss and gnorm, model FLOPs and
             MFU; launch counts = 18 attention and 12 FFN forwards and
             backwards per microbatch, no plain version; then the same
             steps with both flags off (the PyTorch composite), and
             --mode test and --mode score on the checkpoint the kernel run
             saved
  train_reference  a small fp32 model: train_fn loss and grads on the card
             (kernels) against the CPU (plain versions), dropout off,
             within 1e-4; dropout on, kernels against plain versions on
             the card from the same seed words, loss within 1e-5
  converge   the copy task (a 12-word vocabulary, target = source;
             hidden 32, 700 steps, lr 3e-3) through --mode train with both
             flags on: final dev BLEU >= 0.95
  rpr_kernels  fused_attention's RPR variant (#3 forward, #4 backward) at
             the train_kernels shapes with max_relative_position 16, fp32
             and bf16, dropout 0 and 0.1: output and the five gradients (dq,
             dk, dv, dTk, dTv) held against fused_attention_rpr_ref; device
             times of kernel, plain version, the composite the model runs
             with use_flash_attention off (_attn_core's one-hot form) and,
             as a floor, SDPA WITHOUT relative positions, beside the bound
             (the RPR terms counted)
  rpr_train  transformer_rpr (configs/transformer_rpr_rela.json: 6+6
             layers, 512/2048, 8 heads, m 16, bf16, token_size 4096,
             update_cycle 4) trained TRAIN_STEPS steps with
             use_flash_attention (and use_fused_ffn, which RPR ignores) on,
             then off: ms/step, tokens/s, MFU (RPR matmuls counted); RPR
             kernel launches = those the steps' own shapes predict (an
             attention over Lk > 2m keys), no FFN kernel, no plain version;
             then --mode test (beam 4: the encoder runs the RPR forward
             kernel, the decoder no decode kernel, RPR keeps both off) and
             --mode score (the RPR forward kernel) of the checkpoint
  rpr_reference  a small fp32 transformer_rpr: train_fn loss and grads,
             tables included, card (kernels) against CPU (plain versions)
             within 1e-4; dropout on, kernels against plain versions on the
             card, loss within 1e-5; beam-4 decode card against CPU,
             identical sequences
  long_kernels  streaming attention (#5 forward, #6 dq, #7 dk/dv) against
             streaming_attention_ref at B*H=8, Lq=Lk=8320 causal; B=2, H=4,
             L=8320 under a pad mask with an all-pad row; cross Lq=256,
             Lk=16384; fp32 and bf16, dropout 0 and 0.1; device times of
             each kernel, the plain version and SDPA (bf16) beside the
             bound. And decode_cross_attention (#9, unwired as in the JAX
             package) against its plain version at B=32 beam 4 S=64 and
             B=4 beam 4 S=16384, timed beside the composite of
             cross_attn_step and SDPA
  long_train transformer-base (configs/transformer_base_wmt14.json with
             use_flash_attention and max_len/token_size 16384,
             pad_seq_multiple 128; a constant learning rate 1e-3) trained
             LONG_STEPS steps on synthetic pairs of 8200-16000 tokens a
             side, one pair per microbatch: ms/step, target tokens/s, MFU,
             peak memory; launches = 18 each of #5, #6 and #7 per
             microbatch, no plain version; then --mode score and --mode test
             (beam 4) of the checkpoint on four long pairs at
             eval_batch_size 2: #5 in every forward, #8 in decoding
  long_reference  a small fp32 model with fa.MAX_LK lowered to 64 (so every
             attention streams): train_fn loss and grads card against CPU
             within 1e-4; dropout on, kernels against plain versions, loss
             within 1e-5; beam 4 card against CPU, identical sequences
Then the `kernels` JSON line, the nvidia-smi name/power-limit line, and
as the last line {"ok": true, "device": {...}}.
"""

import argparse
import collections
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "transformer_base_wmt14.json")
RPR_CONFIG = os.path.join(REPO, "configs", "transformer_rpr_rela.json")
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
# training kernels: fp32 sums run in another order over up to 4096 rows
# (dW, dk/dv), so the relative part is 1e-4; bf16 as above
TRAIN_TOLERANCE = {torch.float32: (1e-5, 1e-4),
                   torch.bfloat16: (1e-2, 2e-2)}
TRAIN_STEPS = 30
PEAK_BF16 = 989e12   # H100 SXM dense bf16, the MFU denominator
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


def check(name, out, ref, dtype, tolerance=TOLERANCE):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    atol, rtol = tolerance[dtype]
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
    tokens, made from SEED; returns the vocabulary's words."""
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
    return words


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


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

# (name, B, H, Lq, Lk, Dh, causal, pad mask with an all-pad row); the
# small cases (train_reference's model shapes: ragged tails, Dh 16) are
# checked, not timed
ATTN_CASES = (("self_causal", 16, 8, 256, 256, 64, True, False),
              ("self_pad", 16, 8, 256, 256, 64, False, True),
              ("cross", 16, 8, 200, 256, 64, False, True))
ATTN_SMALL = (("small_causal", 6, 4, 9, 9, 16, True, False),
              ("small_pad", 6, 4, 12, 12, 16, False, True),
              ("small_cross", 6, 4, 9, 12, 16, False, True))
FFN_SHAPE = (4096, 512, 2048, 512)
FFN_SMALL = ((54, 64, 128, 64), (72, 64, 128, 64))
SEED_WORDS = (0x12345678, 0x9ABCDEF0)


def grad_ms(outputs, inputs, dout):
    """A callable timing one backward pass alone (autograd.grad over a
    retained forward graph)."""
    def run():
        return torch.autograd.grad(outputs, inputs, dout, retain_graph=True)
    return run


def fwd_bwd(fn, n_inputs):
    """fn's forward and backward together, over a set whose first
    ``n_inputs`` tensors take gradients and whose last is the output
    gradient."""
    def run(*s):
        return torch.autograd.grad(fn(*s), s[:n_inputs], s[-1])
    run.__name__ = fn.__name__ + "_fwd_bwd"
    return run


def attention_pairs(pad, h, lq, causal):
    """The (row, key) pairs whose weights the output needs: the valid keys
    of each row, all Lk for a row with no valid key; over B and H."""
    b, lk = pad.shape
    keep = (pad > 0)[:, None, None, :].expand(b, 1, lq, lk)
    if causal:
        keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                 device=pad.device).tril()
    return torch.where(keep.any(-1, keepdim=True), keep,
                       True).sum().item() * h


def attention_pad(gen, b, lk, padded):
    """[B, Lk] key pad mask: random lengths, the last of several rows all
    padding; or all valid."""
    if not padded:
        return torch.ones(b, lk)
    lens = torch.randint(lk // 4, lk + 1, (b,), generator=gen)
    pad = (torch.arange(lk)[None] < lens[:, None]).float()
    if b > 1:
        pad[-1] = 0.0   # an all-pad batch row
    return pad


def train_attention_rows(fa, gen):
    """Kernels #1/#2 against fused_attention_ref; returns the JSON rows of
    the encoder self-attention case (bf16, dropout 0.1)."""
    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, b, h, lq, lk, dh, causal, padded in ATTN_CASES + ATTN_SMALL:
        timed = name in [c[0] for c in ATTN_CASES]
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                pad = attention_pad(gen, b, lk, padded)
                do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                return [t.requires_grad_() for t in (q, k, v)] + [
                    pad.to(dev), do]

            # bound: the keys each row's output needs (all Lk for a row
            # with no valid key) in the forward's two products
            pairs = attention_pairs(inputs()[3], h, lq, causal)
            eb = torch.tensor([], dtype=dtype).element_size()
            fwd_bytes = (2 * b * h * lq * dh + 2 * b * h * lk * dh) * eb \
                + 4 * b * lk
            bwd_bytes = (4 * b * h * lq * dh + 4 * b * h * lk * dh) * eb \
                + 4 * b * lk + 8 * b * h * lq
            for rate in (0.0, 0.1):
                q, k, v, pad, do = inputs()
                words = SEED_WORDS if rate else None
                out = fa.fused_attention(q, k, v, pad, causal=causal,
                                         dropout_rate=rate, rng=words)
                grads = torch.autograd.grad(out, (q, k, v), do)
                ref = fa.fused_attention_ref(q, k, v, pad, causal, rate,
                                             words)
                rgrads = torch.autograd.grad(ref, (q, k, v), do)
                label = "%s[%s,p=%g]" % (name, str(dtype)[6:], rate)
                errs = [check("fused_attention " + label, out, ref, dtype,
                              TRAIN_TOLERANCE)]
                errs += [check("fused_attention_backward %s d%s" % (label, w),
                               g, r, dtype, TRAIN_TOLERANCE)
                         for w, g, r in zip("qkv", grads, rgrads)]
                if not torch.isfinite(out).all():
                    raise AssertionError("fused_attention %s: non-finite "
                                         "output" % label)
                if not timed:
                    phase("train_kernels", kernel="fused_attention",
                          case=label, max_abs_err=errs[0],
                          backward_max_abs_err=max(errs[1:]))
                    continue
                sets = copies(inputs, fwd_bytes)

                def k_fwd(q, k, v, pad, do):
                    return fa.fused_attention(q, k, v, pad, causal=causal,
                                              dropout_rate=rate, rng=words)

                def p_fwd(q, k, v, pad, do):
                    return fa.fused_attention_ref(q, k, v, pad, causal, rate,
                                                  words)

                def l_fwd(q, k, v, pad, do):
                    if causal:
                        return sdpa(q, k, v, is_causal=True)
                    return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

                iters = 2 * len(sets)
                fwd = dict(ms=device_ms(k_fwd, sets, iters),
                           plain_ms=device_ms(p_fwd, sets, iters))
                bwd = {}
                for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                    graphs = [(grad_ms(fn(*s), s[:3], s[4]),) for s in sets]
                    bwd[key] = device_ms(lambda run: run(), graphs, iters)
                    del graphs
                if rate == 0.0:
                    fwd["library_ms"] = device_ms(l_fwd, sets, iters)
                    graphs = [(grad_ms(l_fwd(*s), s[:3], s[4]),)
                              for s in sets]
                    bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                                  iters)
                    del graphs
                    bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 3), sets,
                                                  iters)
                    bwd["library_fwd_bwd_ms"] = device_ms(
                        fwd_bwd(l_fwd, 3), sets, iters)
                fb, fby = bound(fwd_bytes, 4 * pairs * dh, dtype)
                bb, bby = bound(bwd_bytes, 10 * pairs * dh, dtype)
                fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
                bwd.update(bound_ms=bb, bound_by=bby,
                           max_abs_err=max(errs[1:]))
                phase("train_kernels", kernel="fused_attention", case=label,
                      **fwd)
                phase("train_kernels", kernel="fused_attention_backward",
                      case=label, **bwd)
                rows[("fused_attention", name, dtype, rate)] = fwd
                rows[("fused_attention_backward", name, dtype, rate)] = bwd
                del sets
                torch.cuda.empty_cache()
    return rows


def train_ffn_rows(ff, gen):
    """Kernels #11/#12 against fused_ffn_ref; returns the rows."""
    dev = "cuda"
    rows = {}
    for (n, d_in, f, d_out), dtype in [
            (shape, dtype) for shape in FFN_SMALL + (FFN_SHAPE,)
            for dtype in (torch.float32, torch.bfloat16)]:
        timed = (n, d_in, f, d_out) == FFN_SHAPE

        def inputs():
            x = torch.randn(n, d_in, generator=gen).to(dev, dtype)
            w1 = (torch.randn(d_in, f, generator=gen) * d_in ** -0.5).to(
                dev, dtype)
            b1 = (torch.randn(f, generator=gen) * 0.1).to(dev, dtype)
            w2 = (torch.randn(f, d_out, generator=gen) * f ** -0.5).to(
                dev, dtype)
            b2 = (torch.randn(d_out, generator=gen) * 0.1).to(dev, dtype)
            dy = torch.randn(n, d_out, generator=gen).to(dev, dtype)
            return [t.requires_grad_() for t in (x, w1, b1, w2, b2)] + [dy]

        eb = torch.tensor([], dtype=dtype).element_size()
        weights = d_in * f + f + f * d_out + d_out
        fwd_bytes = (n * d_in + weights + n * d_out) * eb
        bwd_bytes = (n * d_in + weights + n * d_out) * eb \
            + (n * d_in + weights) * eb
        fwd_flops = 2 * n * (d_in * f + f * d_out)
        bwd_flops = 2 * n * (3 * d_in * f + 2 * f * d_out)
        for rate in (0.0, 0.1):
            words = SEED_WORDS if rate else None
            x, w1, b1, w2, b2, dy = inputs()
            out = ff.fused_ffn(x, w1, b1, w2, b2, words, rate)
            grads = torch.autograd.grad(out, (x, w1, b1, w2, b2), dy)
            ref = ff.fused_ffn_ref(x, w1, b1, w2, b2, words, rate)
            rgrads = torch.autograd.grad(ref, (x, w1, b1, w2, b2), dy)
            label = "N%d[%s,p=%g]" % (n, str(dtype)[6:], rate)
            errs = [check("fused_ffn " + label, out, ref, dtype,
                          TRAIN_TOLERANCE)]
            errs += [check("fused_ffn_backward %s d%s" % (label, w), g, r,
                           dtype, TRAIN_TOLERANCE)
                     for w, g, r in zip(("x", "W1", "b1", "W2", "b2"), grads,
                                        rgrads)]
            if not timed:
                phase("train_kernels", kernel="fused_ffn", case=label,
                      max_abs_err=errs[0], backward_max_abs_err=max(errs[1:]))
                continue
            sets = copies(inputs, fwd_bytes)

            def k_fwd(x, w1, b1, w2, b2, dy):
                return ff.fused_ffn(x, w1, b1, w2, b2, words, rate)

            def p_fwd(x, w1, b1, w2, b2, dy):
                return ff.fused_ffn_ref(x, w1, b1, w2, b2, words, rate)

            iters = 2 * len(sets)
            fwd = dict(ms=device_ms(k_fwd, sets, iters),
                       plain_ms=device_ms(p_fwd, sets, iters))
            bwd = {}
            for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                graphs = [(grad_ms(fn(*s), s[:5], s[5]),) for s in sets]
                bwd[key] = device_ms(lambda run: run(), graphs, iters)
                del graphs
            if rate == 0.0:
                # yardstick: F.linear / relu / F.linear on [out, in] weights
                lsets = [[t.detach().t().contiguous().requires_grad_()
                          if t.dim() == 2 and i in (1, 3)
                          else t for i, t in enumerate(s)] for s in sets]

                def l_fwd(x, w1t, b1, w2t, b2, dy):
                    lin = torch.nn.functional.linear
                    return lin(torch.relu(lin(x, w1t, b1)), w2t, b2)

                fwd["library_ms"] = device_ms(l_fwd, lsets, iters)
                graphs = [(grad_ms(l_fwd(*s), s[:5], s[5]),) for s in lsets]
                bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                              iters)
                bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 5), sets, iters)
                bwd["library_fwd_bwd_ms"] = device_ms(fwd_bwd(l_fwd, 5),
                                                      lsets, iters)
                del graphs, lsets
            fb, fby = bound(fwd_bytes, fwd_flops, dtype)
            bb, bby = bound(bwd_bytes, bwd_flops, dtype)
            fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
            bwd.update(bound_ms=bb, bound_by=bby, max_abs_err=max(errs[1:]))
            phase("train_kernels", kernel="fused_ffn", case=label, **fwd)
            phase("train_kernels", kernel="fused_ffn_backward", case=label,
                  **bwd)
            rows[("fused_ffn", dtype, rate)] = fwd
            rows[("fused_ffn_backward", dtype, rate)] = bwd
            del sets
            torch.cuda.empty_cache()
    return rows


def train_kernels_phase():
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    gen = torch.Generator().manual_seed(SEED)
    rows = train_attention_rows(fa, gen)
    rows.update(train_ffn_rows(ff, gen))
    return rows


# ---------------------------------------------------------------------------
# RPR attention kernels (#3/#4)
# ---------------------------------------------------------------------------

RPR_MAX = 16        # max_relative_position of RPR_CONFIG, at ATTN_CASES
RPR_SMALL_MAX = 3   # rpr_reference's model, at ATTN_SMALL: 2m < every Lk
# the tables as the wrappers read them (.keys, .values), without the
# parameter wrapping of ops/rpr.py:RprTables, so gradients reach tk and tv
Tables = collections.namedtuple("Tables", "keys values")


def rpr_attention_rows(fa, gen):
    """Kernels #3/#4 against fused_attention_rpr_ref; returns the rows."""
    from zero_tpu_torch.ops import attention as attn

    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, b, h, lq, lk, dh, causal, padded in ATTN_CASES + ATTN_SMALL:
        timed = name in [c[0] for c in ATTN_CASES]
        m = RPR_MAX if timed else RPR_SMALL_MAX
        r = 2 * m + 1
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                tk = torch.randn(r, dh, generator=gen).to(dev, dtype)
                tv = torch.randn(r, dh, generator=gen).to(dev, dtype)
                pad = attention_pad(gen, b, lk, padded)
                do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                return [t.requires_grad_() for t in (q, k, v, tk, tv)] + [
                    pad.to(dev), do]

            # bound: attention's products over the pairs each row needs,
            # plus the RPR terms per row (q.Tk and wb.Tv forward; their
            # recompute, do.Tv, ds_b.Tk, dTk and dTv backward)
            pairs = attention_pairs(inputs()[5], h, lq, causal)
            eb = torch.tensor([], dtype=dtype).element_size()
            rows_rd = b * h * lq * r * dh
            fwd_bytes = (2 * b * h * lq * dh + 2 * b * h * lk * dh
                         + 2 * r * dh) * eb + 4 * b * lk
            bwd_bytes = (4 * b * h * lq * dh + 4 * b * h * lk * dh
                         + 4 * r * dh) * eb + 4 * b * lk + 8 * b * h * lq
            for rate in (0.0, 0.1):
                q, k, v, tk, tv, pad, do = inputs()
                words = SEED_WORDS if rate else None
                out = fa.fused_attention(q, k, v, pad, causal=causal,
                                         dropout_rate=rate, rng=words,
                                         rpr_tables=Tables(tk, tv),
                                         max_relative_position=m)
                grads = torch.autograd.grad(out, (q, k, v, tk, tv), do)
                ref = fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, m,
                                                 causal, rate, words)
                rgrads = torch.autograd.grad(ref, (q, k, v, tk, tv), do)
                label = "%s[%s,p=%g,m=%d]" % (name, str(dtype)[6:], rate, m)
                errs = [check("fused_attention_rpr " + label, out, ref, dtype,
                              TRAIN_TOLERANCE)]
                errs += [check("fused_attention_rpr_backward %s d%s"
                               % (label, w), g, rg, dtype, TRAIN_TOLERANCE)
                         for w, g, rg in zip(("q", "k", "v", "Tk", "Tv"),
                                             grads, rgrads)]
                if not all(torch.isfinite(x).all() for x in (out,) + grads):
                    raise AssertionError("fused_attention_rpr %s: non-finite "
                                         "output or gradient" % label)
                if not timed:
                    phase("rpr_kernels", kernel="fused_attention_rpr",
                          case=label, max_abs_err=errs[0],
                          backward_max_abs_err=max(errs[1:]))
                    continue
                sets = copies(inputs, fwd_bytes)

                def k_fwd(q, k, v, tk, tv, pad, do):
                    return fa.fused_attention(
                        q, k, v, pad, causal=causal, dropout_rate=rate,
                        rng=words, rpr_tables=Tables(tk, tv),
                        max_relative_position=m)

                def p_fwd(q, k, v, tk, tv, pad, do):
                    return fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, m,
                                                      causal, rate, words)

                def l_fwd(q, k, v, tk, tv, pad, do):
                    # a floor: SDPA computes attention WITHOUT the RPR terms
                    if causal:
                        return sdpa(q, k, v, is_causal=True)
                    return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

                iters = 2 * len(sets)
                fwd = dict(ms=device_ms(k_fwd, sets, iters),
                           plain_ms=device_ms(p_fwd, sets, iters))
                bwd = {}
                for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                    graphs = [(grad_ms(fn(*s), s[:5], s[6]),) for s in sets]
                    bwd[key] = device_ms(lambda run: run(), graphs, iters)
                    del graphs
                if rate == 0.0:
                    fwd["library_ms"] = device_ms(l_fwd, sets, iters)
                    graphs = [(grad_ms(l_fwd(*s), s[:3], s[6]),)
                              for s in sets]
                    bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                                  iters)
                    del graphs
                    # the composite of use_flash_attention=false on
                    # [B, L, hidden] projections, under the same mask
                    keep = (sets[0][5] > 0)[:, None, None, :]
                    if causal:
                        keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                                 device=dev).tril()
                    keep = keep.float()
                    csets = [[attn.combine_heads(x.detach()).requires_grad_()
                              for x in s[:3]]
                             + [x.detach().requires_grad_() for x in s[3:5]]
                             + [attn.combine_heads(s[6])] for s in sets]

                    def c_fwd(q2, k2, v2, tk, tv, do2):
                        return attn._attn_core(q2, k2, v2, keep, h,
                                               rpr_tables=Tables(tk, tv),
                                               rpr_max=m)[0]

                    fwd["composite_ms"] = device_ms(c_fwd, csets, iters)
                    graphs = [(grad_ms(c_fwd(*s), s[:5], s[5]),)
                              for s in csets]
                    bwd["composite_ms"] = device_ms(lambda run: run(), graphs,
                                                    iters)
                    del graphs, csets
                    bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 5), sets,
                                                  iters)
                fb, fby = bound(fwd_bytes, 4 * pairs * dh + 4 * rows_rd, dtype)
                bb, bby = bound(bwd_bytes, 10 * pairs * dh + 10 * rows_rd,
                                dtype)
                fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
                bwd.update(bound_ms=bb, bound_by=bby,
                           max_abs_err=max(errs[1:]))
                phase("rpr_kernels", kernel="fused_attention_rpr",
                      case=label, **fwd)
                phase("rpr_kernels", kernel="fused_attention_rpr_backward",
                      case=label, **bwd)
                rows[("fused_attention_rpr", name, dtype, rate)] = fwd
                rows[("fused_attention_rpr_backward", name, dtype, rate)] = bwd
                del sets
                torch.cuda.empty_cache()
    return rows


def rpr_kernels_phase():
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    return rpr_attention_rows(fa, torch.Generator().manual_seed(SEED + 2))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def write_train_corpus(d, words, sentences=8000):
    """Parallel training text of 10 to 100 tokens per side over the
    synthetic vocabulary, made from SEED."""
    rs = np.random.RandomState(SEED + 1)
    for name in ("train.src", "train.tgt"):
        with open(os.path.join(d, name), "w") as w:
            for _ in range(sentences):
                n = rs.randint(10, 101)
                w.write(" ".join(words[i] for i in rs.randint(0, len(words),
                                                              n)) + "\n")


def stacked_shape(shapes):
    """A step's microbatches all run at its stacked shape: the largest
    rows, source and target lengths among them."""
    return (max(s[0][0] for s in shapes), max(s[0][1] for s in shapes),
            max(s[1][1] for s in shapes))


def model_flops(shapes, cfg):
    """Matmul FLOPs of one training step: its microbatches run at the
    step's stacked shape; forward x 3 for forward + backward, plus the
    chunked CE's recomputed logits. transformer_rpr adds its RPR matmuls,
    q.Tk and the bucket sums' product with Tv: 4 * rows * (2m+1) * hidden
    per attention (the one-hot expansions are not counted)."""
    d, f = cfg["hidden_size"], cfg["filter_size"]
    v = 32768
    b, ls, lt = stacked_shape(shapes)
    rpr = 0
    if cfg.get("model_name") == "transformer_rpr":
        r = 2 * cfg["max_relative_position"] + 1
        rpr = 4 * r * d
    total = 0
    for _ in shapes:
        ns, nt = b * ls, b * lt
        enc = cfg["num_encoder_layer"] * (
            2 * ns * d * 4 * d + 4 * ns * d * f + 4 * b * ls * ls * d
            + rpr * ns)
        dec = cfg["num_decoder_layer"] * (
            2 * nt * d * 4 * d + 2 * nt * d * 2 * d + 2 * ns * d * 2 * d
            + 4 * nt * d * f + 4 * b * lt * lt * d + 4 * b * lt * ls * d
            + 2 * rpr * nt)
        logits = 2 * nt * d * v
        total += 3 * (enc + dec + logits) + logits
    return total


def expected_launches(cfg, summary):
    """Per microbatch: one attention per encoder layer and two per decoder
    layer (18 at 6+6), one FFN per layer (12); forward and backward."""
    microbatches = cfg["update_cycle"] * summary["steps"]
    attn = cfg["num_encoder_layer"] + 2 * cfg["num_decoder_layer"]
    ffn = cfg["num_encoder_layer"] + cfg["num_decoder_layer"]
    return {"fused_attention": attn * microbatches,
            "fused_attention_backward": attn * microbatches,
            "fused_ffn": ffn * microbatches,
            "fused_ffn_backward": ffn * microbatches}


def rpr_expected_launches(cfg, summary):
    """transformer_rpr: an attention takes the RPR kernels where its keys
    outnumber 2m (ops/attention.py:_rpr_flash_ok), at each step's stacked
    lengths: encoder self-attention and decoder cross attention over the
    source, decoder self-attention over the target. Its FFN never fuses."""
    two_m = 2 * cfg["max_relative_position"]
    n = 0
    for shapes in summary["shapes"]:
        _, ls, lt = stacked_shape(shapes)
        n += len(shapes) * (cfg["num_encoder_layer"] * (ls > two_m)
                            + cfg["num_decoder_layer"] * ((lt > two_m)
                                                          + (ls > two_m)))
    return {"fused_attention_rpr": n, "fused_attention_rpr_backward": n}


def train_run(d, out, flags, counters, config=CONFIG):
    from zero_tpu_torch import run

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "output_dir={1},use_flash_attention={2},use_fused_ffn={2},"
            "max_training_steps={3},disp_freq=1,save_freq=0,eval_freq=0,"
            "sample_freq=0,epoches=100".format(d, out, flags, TRAIN_STEPS))
    for c in counters:
        c.clear()
    summary = run.main(["--mode", "train", "--config", config,
                        "--parameters", spec])
    return summary, collect(counters)


def collect(counters):
    launches = {}
    for c in counters:
        launches.update({k: v for k, v in c.items() if v})
    return launches


def train_phase(d, da, config=CONFIG, label="train",
                expected=expected_launches):
    """Train ``config`` TRAIN_STEPS steps with both kernel flags on, then
    off; then serve (--mode test) and score the kernel run's checkpoint.
    Returns the kernel run's launch counts."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    cfg = load_config_file(config)
    counters = (fa.launches, ff.launches, da.launches)
    results = {}
    for flags in ("true", "false"):
        out = os.path.join(d, "%s_%s" % (label, flags))
        summary, launches = train_run(d, out, flags, counters, config)
        steps = summary["steps"]
        if steps != TRAIN_STEPS:
            raise AssertionError("trained %d steps, wanted %d"
                                 % (steps, TRAIN_STEPS))
        if not all(math.isfinite(x) for x in summary["losses"]):
            raise AssertionError("non-finite loss: %s" % summary["losses"])
        want = expected(cfg, summary) if flags == "true" else {}
        if launches != want:
            raise AssertionError("%s (flags %s) launches %s, expected %s "
                                 "(no plain version)" % (label, flags,
                                                         launches, want))
        ends = summary["step_end_times"]
        step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
        ms = 1e3 * step_s[len(step_s) // 2]
        tokens = summary["target_tokens"]
        flops = [model_flops(s, cfg) for s in summary["shapes"]]
        timed = sum(b - a for a, b in zip(ends[:-1], ends[1:]))
        tok_s = sum(tokens[1:]) / timed
        mfu = sum(flops[1:]) / timed / PEAK_BF16
        results[flags] = dict(
            kernels=flags == "true", steps=steps, ms_per_step_median=ms,
            ms_per_step_mean=1e3 * timed / (steps - 1),
            target_tokens_per_s=tok_s,
            model_tflop_per_step=sum(flops) / steps / 1e12, mfu=mfu,
            loss_first=summary["losses"][0], loss_last=summary["losses"][-1],
            gnorm_first=summary["gnorms"][0],
            gnorm_last=summary["gnorms"][-1], launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        phase(label, **results[flags])
        torch.cuda.reset_peak_memory_stats()
    # the kernel run's checkpoint serves through --mode test
    from zero_tpu_torch import run
    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/{1}_true,test_output={0}/{1}_trained.txt,"
            "eval_batch_size=32".format(d, label))
    for c in counters:
        c.clear()
    served = run.main(["--mode", "test", "--parameters", spec])
    serve_launches = collect(counters)
    with open(os.path.join(d, label + "_trained.txt")) as r:
        lines = r.read().splitlines()
    if len(lines) != 64 or served["sentences"] != 64:
        raise AssertionError("served %d lines of the trained model"
                             % len(lines))
    # and scores it through --mode score (the saved param.json keeps both
    # kernel flags on, so the forward runs the kernels)
    for c in counters:
        c.clear()
    scores, ppl = run.main(["--mode", "score", "--parameters", spec.replace(
        "_trained.txt", "_scores.txt")])
    score_launches = collect(counters)
    if len(scores) != 64 or not all(map(math.isfinite, scores)):
        raise AssertionError("scored %d sentences: %s" % (len(scores),
                                                          scores[:4]))
    plain = [n for n in list(serve_launches) + list(score_launches)
             if n.endswith("_ref")]
    if plain:
        raise AssertionError("%s: plain versions ran while serving or "
                             "scoring: %s %s" % (label, serve_launches,
                                                 score_launches))
    if cfg.get("model_name") == "transformer_rpr" and (
            set(serve_launches) != {"fused_attention_rpr"}
            or set(score_launches) != {"fused_attention_rpr"}):
        # RPR decode runs no decode kernel; the encoder (serving) and the
        # scoring forward run #3, as the saved flags say
        raise AssertionError("%s: serving launched %s, scoring %s"
                             % (label, serve_launches, score_launches))
    phase(label, served_sentences=len(lines), served_bleu=served["bleu"],
          served_s=served["seconds"], serve_launches=serve_launches,
          scored_sentences=len(scores), score_ppl=ppl,
          score_launches=score_launches)
    return results["true"]["launches"]


def _small_model(dropout, model_name="transformer"):
    from zero_tpu_torch.config import default_config
    from zero_tpu_torch.vocab import Vocab

    cfg = default_config()
    for k, v in dict(model_name=model_name, hidden_size=64, embed_size=64,
                     filter_size=128, num_heads=4, num_encoder_layer=2,
                     num_decoder_layer=2, initializer="uniform_unit_scaling",
                     initializer_gain=1.0, use_flash_attention=True,
                     use_fused_ffn=True, dropout=dropout,
                     attention_dropout=dropout, relu_dropout=dropout,
                     residual_dropout=dropout, label_smooth=0.1,
                     loss_chunk_tokens=16, decode_length=10,
                     max_relative_position=RPR_SMALL_MAX).items():
        setattr(cfg, k, v)
    vocab = Vocab()
    for i in range(40):
        vocab.insert("w%d" % i)
    cfg.src_vocab = cfg.tgt_vocab = vocab
    return cfg


def _small_batch():
    rs = np.random.RandomState(SEED)
    src = rs.randint(3, 43, (6, 12))
    tgt = rs.randint(3, 43, (6, 9))
    for i, (ns, nt) in enumerate(zip(rs.randint(3, 12, 6),
                                     rs.randint(2, 9, 6))):
        src[i, ns:] = 0
        tgt[i, nt:] = 0
    src[-1] = 0   # an all-pad row
    tgt[-1] = 0
    return {"source": torch.as_tensor(src), "target": torch.as_tensor(tgt)}


def plain_attention(q, k, v, pad_mask=None, *, causal=False,
                    dropout_rate=0.0, rng=None, rpr_tables=None,
                    max_relative_position=None):
    """fused_attention's interface over its plain versions: from the same
    seed words they draw the kernels' dropout masks."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    pad = (torch.ones(q.shape[0], k.shape[2], device=q.device)
           if pad_mask is None else pad_mask.float())
    rate = dropout_rate if rng is not None else 0.0
    if rpr_tables is None:
        return fa.fused_attention_ref(q, k, v, pad, causal, rate, rng)
    return fa.fused_attention_rpr_ref(
        q, k, v, pad, rpr_tables.keys.to(q.dtype),
        rpr_tables.values.to(q.dtype), max_relative_position, causal, rate,
        rng)


def plain_ffn(x, w1, b1, w2, b2, rng=None, rate=0.0):
    """fused_ffn's interface over its plain version."""
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    y = ff.fused_ffn_ref(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, rng,
                         rate)
    return y.reshape(*x.shape[:-1], w2.shape[1])


def train_reference_phase():
    """train_fn on the card (kernels) against the CPU (plain versions)."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    model = get_model("transformer")
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.0)
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    fa.launches.clear()
    ff.launches.clear()
    lc = model.train_fn(cpu, feats, cfg, None)["loss"]
    gc = torch.autograd.grad(lc, list(cpu.parameters()))
    lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
    gg = torch.autograd.grad(lg, list(gpu.parameters()))
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    if not (loss_err <= 1e-4 and grad_err <= 1e-4
            and fa.launches["fused_attention_backward"] == 6
            and ff.launches["fused_ffn_backward"] == 4):
        raise AssertionError("train_reference: loss rel err %.3g, grad rel "
                             "err %.3g (%s), launches %s %s"
                             % (loss_err, grad_err, worst,
                                dict(fa.launches), dict(ff.launches)))

    # dropout on: kernels against plain versions on the card, same words
    cfg = _small_model(0.1)
    losses = []
    for plain in (False, True):
        with mock.patch.object(fa, "fused_attention",
                               plain_attention if plain
                               else fa.fused_attention), \
                mock.patch.object(ff, "fused_ffn",
                                  plain_ffn if plain else ff.fused_ffn):
            loss = model.train_fn(gpu, gfeats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
        losses.append(loss.item())
    drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
    if not drop_err <= 1e-5:
        raise AssertionError("train_reference: dropout-on loss kernels %r "
                             "vs plain %r" % tuple(losses))
    phase("train_reference", loss_rel_err=loss_err, grad_rel_err=grad_err,
          dropout_loss_kernels=losses[0], dropout_loss_plain=losses[1],
          dropout_rel_err=drop_err)


def grad_errors(cpu, gc, gg):
    """Each card grad's max error relative to its CPU grad's max |grad|,
    floored at 1e-3 of the model's largest: the cross-attention key bias
    has an exactly zero gradient in exact arithmetic (softmax ignores a
    per-row constant), so both sides hold rounding noise there."""
    names = [n for n, _ in cpu.named_parameters()]
    top = max(b.abs().max().item() for b in gc)
    scale = {n: max(b.abs().max().item(), 1e-3 * top)
             for n, b in zip(names, gc)}
    return {n: (a.cpu() - b).abs().max().item() / scale[n]
            for n, a, b in zip(names, gg, gc)}


def rpr_reference_phase(da):
    """A small fp32 transformer_rpr (m = 3 < half of every length, so all
    six attentions take the RPR kernels): train_fn card against CPU, with
    dropout on kernels against plain versions, beam-4 decode card against
    CPU."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.search import beam_search

    model = get_model("transformer_rpr")
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.0, "transformer_rpr")
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    fa.launches.clear()
    lc = model.train_fn(cpu, feats, cfg, None)["loss"]
    gc = torch.autograd.grad(lc, list(cpu.parameters()))
    lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
    gg = torch.autograd.grad(lg, list(gpu.parameters()))
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    table_err = max(e for n, e in errs.items() if "_rpr." in n)
    want = {"fused_attention_rpr": 6, "fused_attention_rpr_backward": 6,
            "fused_attention_rpr_ref": 6}
    if not (loss_err <= 1e-4 and errs[worst] <= 1e-4
            and collect([fa.launches]) == want):
        raise AssertionError("rpr_reference: loss rel err %.3g, grad rel err "
                             "%.3g (%s), launches %s" % (
                                 loss_err, errs[worst], worst,
                                 dict(fa.launches)))

    # dropout on: kernels against plain versions on the card, same words
    cfg = _small_model(0.1, "transformer_rpr")
    losses = []
    for plain in (False, True):
        fa.launches.clear()
        with mock.patch.object(fa, "fused_attention",
                               plain_attention if plain
                               else fa.fused_attention):
            loss = model.train_fn(gpu, gfeats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
        losses.append(loss.item())
        key = "fused_attention_rpr" + ("_ref" if plain else "")
        if fa.launches[key] != 6:
            raise AssertionError("rpr_reference: dropout run launched %s"
                                 % dict(fa.launches))
    drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
    if not drop_err <= 1e-5:
        raise AssertionError("rpr_reference: dropout-on loss kernels %r vs "
                             "plain %r" % tuple(losses))

    # beam 4: the card runs the classic permuted cache (RPR has no pool
    # kernel), the CPU the ancestry pools; no decode kernel either way
    cfg.beam_size = 4
    inf = model.infer_fn(cfg)
    src = feats["source"]
    da.launches.clear()
    with torch.inference_mode():
        g = beam_search(gpu, src.cuda(), inf, cfg)
        c = beam_search(cpu, src, inf, cfg)
    same = torch.equal(g["seq"].cpu(), c["seq"])
    score_err = (g["score"].cpu() - c["score"]).abs().max().item()
    if not (same and score_err <= 1e-4 and not collect([da.launches])
            and torch.isfinite(g["score"]).all()):
        raise AssertionError("rpr_reference beam 4: card vs CPU sequences "
                             "equal %s, score err %.3g, decode launches %s"
                             % (same, score_err, dict(da.launches)))
    phase("rpr_reference", loss_rel_err=loss_err, grad_rel_err=errs[worst],
          worst=worst, table_grad_rel_err=table_err,
          dropout_loss_kernels=losses[0], dropout_loss_plain=losses[1],
          dropout_rel_err=drop_err, beam4_same_sequences=same,
          beam4_max_score_err=score_err, beam4_steps=g["steps"])


def converge_phase(d):
    """The copy task through --mode train on the card, both flags on."""
    from zero_tpu_torch import run

    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(12)]
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(["<pad>", "<unk>", "<eos>"] + words) + "\n")
    for name, n in (("train", 400), ("dev", 16), ("test", 16)):
        lines = [" ".join(rs.choice(words, rs.randint(3, 8)))
                 for _ in range(n)]
        for side in ("src", "tgt"):
            with open(os.path.join(d, "%s.%s" % (name, side)), "w") as w:
                w.write("\n".join(lines) + "\n")
    spec = ("model_name=transformer,hidden_size=32,embed_size=32,"
            "filter_size=64,num_heads=2,num_encoder_layer=1,"
            "num_decoder_layer=1,dropout=0.0,residual_dropout=0.0,"
            "relu_dropout=0.0,attention_dropout=0.0,max_len=16,"
            "batch_or_token=batch,batch_size=32,eval_batch_size=16,"
            "beam_size=2,decode_length=12,decode_max_len=24,lrate=3e-3,"
            "lrate_strategy=vanilla,max_training_steps=700,disp_freq=200,"
            "save_freq=300,eval_freq=350,sample_freq=300,epoches=200,"
            "pad_seq_multiple=4,pad_batch_multiple=4,"
            "use_flash_attention=true,use_fused_ffn=true,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "src_dev_file={0}/dev.src,tgt_dev_file={0}/dev.tgt,"
            "output_dir={0}/out".format(d))
    t0 = time.time()
    summary = run.main(["--mode", "train", "--parameters", spec])
    if not (summary["bleu"] is not None and summary["bleu"] >= 0.95):
        raise AssertionError("copy task BLEU %s < 0.95" % summary["bleu"])
    phase("converge", steps=summary["steps"], bleu=summary["bleu"],
          loss_last=summary["losses"][-1], wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# long sequences: streaming attention (#5-#7), cross-attention decode (#9)
# ---------------------------------------------------------------------------

# (name, B, H, Lq, Lk, Dh, causal, pad mask with an all-pad row): decoder
# self-attention past the fused kernels' 8192 keys; encoder self-attention
# under a pad mask; cross attention of a short target over a 16k memory
LONG_CASES = (("causal_8320", 1, 8, 8320, 8320, 64, True, False),
              ("pad_8320", 2, 4, 8320, 8320, 64, False, True),
              ("cross_256x16384", 1, 8, 256, 16384, 64, False, True))
# (B, beams, S): transformer-base MT decode and the long-memory serving shape
CROSS_CASES = ((32, 4, 64), (4, 4, 16384))
LONG_STEPS = 3
LONG_PARAMS = ("use_flash_attention=true,max_len=16384,token_size=16384,"
               "pad_seq_multiple=128")


def plain_stream(q, k, v, pad_mask=None, *, causal=False, dropout_rate=0.0,
                 rng=None):
    """streaming_attention's interface over its plain version: from the
    same seed words it draws the kernels' dropout masks."""
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    pad = (torch.ones(q.shape[0], k.shape[2], device=q.device)
           if pad_mask is None else pad_mask.float())
    rate = dropout_rate if rng is not None else 0.0
    return sa.streaming_attention_ref(q, k, v, pad, causal, rate, rng)


def streaming_rows(sa, gen):
    """Kernels #5-#7 against streaming_attention_ref; bf16 timings."""
    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, b, h, lq, lk, dh, causal, padded in LONG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                pad = attention_pad(gen, b, lk, padded)
                do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                return [t.requires_grad_() for t in (q, k, v)] + [
                    pad.to(dev), do]

            for rate in (0.0, 0.1):
                q, k, v, pad, do = inputs()
                words = SEED_WORDS if rate else None
                out = sa.streaming_attention(q, k, v, pad, causal=causal,
                                             dropout_rate=rate, rng=words)
                grads = torch.autograd.grad(out, (q, k, v), do)
                ref = sa.streaming_attention_ref(q, k, v, pad, causal, rate,
                                                 words)
                rgrads = torch.autograd.grad(ref, (q, k, v), do)
                label = "%s[%s,p=%g]" % (name, str(dtype)[6:], rate)
                errs = [check("streaming_attention " + label, out, ref,
                              dtype, TRAIN_TOLERANCE)]
                errs += [check("streaming_attention_backward %s d%s"
                               % (label, w), g, r, dtype, TRAIN_TOLERANCE)
                         for w, g, r in zip("qkv", grads, rgrads)]
                if not all(torch.isfinite(x).all() for x in (out,) + grads):
                    raise AssertionError("streaming_attention %s: non-finite"
                                         " output or gradient" % label)
                del out, grads, ref, rgrads
                if dtype != torch.bfloat16:
                    phase("long_kernels", kernel="streaming_attention",
                          case=label, max_abs_err=errs[0],
                          backward_max_abs_err=max(errs[1:]))
                    continue
                rows.update(time_streaming(sa, sdpa, name, inputs, pad,
                                           h, lq, lk, dh, causal, rate,
                                           words, errs))
                torch.cuda.empty_cache()
    return rows


def time_streaming(sa, sdpa, name, inputs, pad, h, lq, lk, dh, causal,
                   rate, words, errs):
    """Device times of #5, #6 and #7 alone, of the plain version's forward
    and backward, and of SDPA (dropout off), beside each bound: the bytes
    of each input once and each output once, and the products over the
    (row, key) pairs the output needs (4 flops per pair and depth forward,
    6 for #6: s, dP, dQ; 8 for #7: s, dP, dV, dK)."""
    b = pad.shape[0]
    pairs = attention_pairs(pad, h, lq, causal)
    dtype = torch.bfloat16
    eb = 2
    qb, kb = b * h * lq * dh * eb, b * h * lk * dh * eb
    rows_f32 = 4 * b * h * lq
    sets = copies(inputs, 2 * qb + 2 * kb)
    f_args = [(s[0].detach(), s[1].detach(), s[2].detach(), s[3], bool(causal),
               rate, words or (0, 0)) for s in sets]
    fwds = [sa._forward(*a) for a in f_args]
    dq_args = [a[:4] + (o, s[4], m, l) + a[4:]
               for a, (o, m, l), s in zip(f_args, fwds, sets)]
    deltas = [sa._backward_dq(*a)[1] for a in dq_args]
    kv_args = [a[:4] + (s[4], m, l, delta) + a[4:]
               for a, (o, m, l), s, delta in zip(f_args, fwds, sets, deltas)]

    def p_fwd(q, k, v, pad, do):
        return sa.streaming_attention_ref(q, k, v, pad, causal, rate, words)

    def l_fwd(q, k, v, pad, do):
        if causal:
            return sdpa(q, k, v, is_causal=True)
        return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

    iters = 2 * len(sets)
    plain_bwd = device_ms(lambda run: run(), [(grad_ms(p_fwd(*s), s[:3],
                                                       s[4]),)
                                              for s in sets], iters)
    out = {}
    for key, fn, args, nbytes, flops in (
            ("streaming_attention", sa._forward, f_args,
             2 * qb + 2 * kb + rows_f32 * 2 + 4 * b * lk, 4 * pairs * dh),
            ("streaming_attention_dq", sa._backward_dq, dq_args,
             4 * qb + 2 * kb + rows_f32 * 3 + 4 * b * lk, 6 * pairs * dh),
            ("streaming_attention_dkdv", sa._backward_dkdv, kv_args,
             2 * qb + 4 * kb + rows_f32 * 3 + 4 * b * lk, 8 * pairs * dh)):
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        r = dict(ms=device_ms(fn, args, iters), bound_ms=bound_ms,
                 bound_by=bound_by)
        if key == "streaming_attention":
            r.update(plain_ms=device_ms(p_fwd, sets, iters),
                     max_abs_err=errs[0])
        else:
            # the plain version's backward computes dq, dk and dv at once
            r.update(plain_ms=plain_bwd, max_abs_err=max(errs[1:]))
        if rate == 0.0:
            if key == "streaming_attention":
                r["library_ms"] = device_ms(l_fwd, sets, iters)
            else:
                r["library_ms"] = device_ms(
                    lambda run: run(), [(grad_ms(l_fwd(*s), s[:3], s[4]),)
                                        for s in sets], iters)
        phase("long_kernels", kernel=key, case="%s[bf16,p=%g]" % (name, rate),
              **r)
        out[(key, name, rate)] = r
    return out


def cross_rows(da, gen):
    """Kernel #9 against decode_cross_attention_ref; bf16 timings beside
    the composite cross_attn_step runs (_attn_core over the beam-folded
    queries) and SDPA."""
    from zero_tpu_torch.ops import attention as attn

    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dh = HIDDEN // HEADS
    rows = {}
    for b, beams, s_len in CROSS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, beams, HIDDEN, generator=gen).to(dev,
                                                                    dtype)
                mk = torch.randn(b, s_len, HIDDEN, generator=gen).to(dev,
                                                                     dtype)
                mv = torch.randn(b, s_len, HIDDEN, generator=gen).to(dev,
                                                                     dtype)
                lens = torch.randint(s_len // 2, s_len + 1, (b,),
                                     generator=gen)
                mask = (torch.arange(s_len)[None] < lens[:, None]).float()
                return q, mk, mv, mask.to(dev)

            args = inputs()
            label = "B%d_beams%d_S%d[%s]" % (b, beams, s_len, str(dtype)[6:])
            err = check("decode_cross_attention " + label,
                        da.decode_cross_attention(*args, HEADS),
                        da.decode_cross_attention_ref(*args, HEADS), dtype)
            if dtype != torch.bfloat16:
                phase("long_kernels", kernel="decode_cross_attention",
                      case=label, max_abs_err=err)
                continue
            sets = copies(inputs, 2 * b * s_len * HIDDEN * 2)

            def k_cross(q, mk, mv, mask):
                return da.decode_cross_attention(q, mk, mv, mask, HEADS)

            def p_cross(q, mk, mv, mask):
                return da.decode_cross_attention_ref(q, mk, mv, mask, HEADS)

            def c_cross(q, mk, mv, mask):
                return attn._attn_core(q, mk, mv, mask[:, None, None, :],
                                       HEADS)[0]

            def heads(x):
                return x.view(x.shape[0], x.shape[1], HEADS,
                              dh).transpose(1, 2)

            lsets = [(heads(q), heads(mk), heads(mv),
                      (mask > 0)[:, None, None, :])
                     for q, mk, mv, mask in sets]

            def l_cross(q, k, v, keep):
                return sdpa(q, k, v, attn_mask=keep)

            iters = 3 * len(sets)
            nbytes = (2 * b * s_len * HIDDEN + 2 * b * beams * HIDDEN) * 2 \
                + 4 * b * s_len
            b_ms, b_by = bound(nbytes, 4 * b * beams * s_len * HIDDEN, dtype)
            r = dict(max_abs_err=err, ms=device_ms(k_cross, sets, iters),
                     plain_ms=device_ms(p_cross, sets, iters),
                     composite_ms=device_ms(c_cross, sets, iters),
                     library_ms=device_ms(l_cross, lsets, iters),
                     bound_ms=b_ms, bound_by=b_by)
            phase("long_kernels", kernel="decode_cross_attention",
                  case=label, **r)
            rows[("decode_cross_attention", s_len)] = r
            del sets, lsets
            torch.cuda.empty_cache()
    return rows


def long_kernels_phase(da):
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    gen = torch.Generator().manual_seed(SEED + 4)
    rows = streaming_rows(sa, gen)
    rows.update(cross_rows(da, gen))
    return rows


def write_long_corpus(d, words):
    """Training pairs (one per microbatch: LONG_STEPS steps of update_cycle
    4) and four test pairs, 8200 to 16000 tokens a side, from SEED."""
    rs = np.random.RandomState(SEED + 3)
    for prefix, n in (("long_train", 4 * LONG_STEPS), ("long_test", 4)):
        for side in ("src", "tgt"):
            with open(os.path.join(d, "%s.%s" % (prefix, side)), "w") as w:
                for _ in range(n):
                    length = rs.randint(8200, 16001)
                    w.write(" ".join(words[i] for i in rs.randint(
                        0, len(words), length)) + "\n")


def long_train_phase(d, da):
    """--mode train of transformer-base on the long pairs, then --mode
    score and --mode test of its checkpoint; returns the train run's
    launch counts."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    cfg = load_config_file(CONFIG)
    counters = (sa.launches, fa.launches, ff.launches, da.launches)
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "output_dir={0}/long_model,".format(d))
    spec = (files + LONG_PARAMS + ",src_train_file={0}/long_train.src,"
            "tgt_train_file={0}/long_train.tgt,lrate_strategy=vanilla,"
            "lrate=1e-3,max_training_steps={1},disp_freq=1,save_freq=0,"
            "eval_freq=0,sample_freq=0,epoches=100".format(d, LONG_STEPS))
    for c in counters:
        c.clear()
    torch.cuda.reset_peak_memory_stats()
    summary = run.main(["--mode", "train", "--config", CONFIG,
                        "--parameters", spec])
    torch.cuda.synchronize()
    launches = collect(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = summary["losses"]
    if summary["steps"] != LONG_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError("long_train: %d steps, losses %s (finite and "
                             "falling wanted)" % (summary["steps"], losses))
    shapes = summary["shapes"]
    lengths = [stacked_shape(s)[1:] for s in shapes]
    if min(min(x) for x in lengths) <= 8192:
        raise AssertionError("long_train: stacked lengths %s, wanted > 8192"
                             % lengths)
    microbatches = cfg["update_cycle"] * summary["steps"]
    attn = cfg["num_encoder_layer"] + 2 * cfg["num_decoder_layer"]
    want = {k: attn * microbatches for k in (
        "streaming_attention", "streaming_attention_dq",
        "streaming_attention_dkdv")}
    if launches != want:
        raise AssertionError("long_train launches %s, expected %s (no plain "
                             "version)" % (launches, want))
    ends = summary["step_end_times"]
    step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
    timed = sum(step_s)
    flops = [model_flops(s, cfg) for s in shapes]
    phase("long_train", steps=summary["steps"], stacked_lengths=lengths,
          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
          ms_per_step_mean=1e3 * timed / len(step_s),
          target_tokens_per_s=sum(summary["target_tokens"][1:]) / timed,
          model_tflop_per_step=sum(flops) / len(flops) / 1e12,
          mfu=sum(flops[1:]) / timed / PEAK_BF16, losses=losses,
          gnorms=summary["gnorms"], launches=launches, peak_gib=peak)

    # score and serve the checkpoint on four long pairs, two per batch
    spec = (files + "src_test_file={0}/long_test.src,"
            "tgt_test_file={0}/long_test.tgt,eval_batch_size=2,"
            "eval_max_len=16384,beam_size=4".format(d))
    for c in counters:
        c.clear()
    scores, ppl = run.main(["--mode", "score", "--parameters", spec
                            + ",test_output=%s/long_scores.txt" % d])
    score_launches = collect(counters)
    if len(scores) != 4 or not all(map(math.isfinite, scores)) \
            or score_launches != {"streaming_attention": attn * 2}:
        raise AssertionError("long_train scoring: %s, launches %s"
                             % (scores, score_launches))
    for c in counters:
        c.clear()
    served = run.main(["--mode", "test", "--parameters", spec
                       + ",test_output=%s/long_trans.txt" % d])
    serve_launches = collect(counters)
    with open(os.path.join(d, "long_trans.txt")) as r:
        lines = r.read().splitlines()
    layers = cfg["num_decoder_layer"]
    want = {"streaming_attention": cfg["num_encoder_layer"] * 2,
            "decode_pool_attention": layers * served["steps"]}
    if len(lines) != 4 or served["sentences"] != 4 \
            or serve_launches != want:
        raise AssertionError("long_train serving: %d lines, launches %s, "
                             "expected %s" % (len(lines), serve_launches,
                                              want))
    phase("long_train", scored=len(scores), score_ppl=ppl,
          score_launches=score_launches, served_sentences=len(lines),
          served_s=served["seconds"], decode_steps=served["steps"],
          serve_launches=serve_launches)
    return launches


def _long_small_batch():
    """Six rows of 160 source and 136 target positions (random lengths,
    the last row all padding), from SEED."""
    rs = np.random.RandomState(SEED + 5)
    src = rs.randint(3, 43, (6, 160))
    tgt = rs.randint(3, 43, (6, 136))
    for i, (ns, nt) in enumerate(zip(rs.randint(70, 161, 6),
                                     rs.randint(70, 137, 6))):
        src[i, ns:] = 0
        tgt[i, nt:] = 0
    src[-1] = 0
    tgt[-1] = 0
    return {"source": torch.as_tensor(src), "target": torch.as_tensor(tgt)}


def long_reference_phase(da):
    """A small fp32 model whose every attention streams (fa.MAX_LK lowered
    to 64, lengths 136-160): train_fn card (kernels) against CPU (plain
    versions), dropout on kernels against plain versions on the card, and
    beam 4 card against CPU."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa
    from zero_tpu_torch.search import beam_search

    model = get_model("transformer")
    feats = _long_small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    with mock.patch.object(fa, "MAX_LK", 64):
        cfg = _small_model(0.0)
        cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
        gpu = copy.deepcopy(cpu).cuda()
        sa.launches.clear()
        fa.launches.clear()
        lc = model.train_fn(cpu, feats, cfg, None)["loss"]
        gc = torch.autograd.grad(lc, list(cpu.parameters()))
        lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
        gg = torch.autograd.grad(lg, list(gpu.parameters()))
        loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
        errs = grad_errors(cpu, gc, gg)
        worst = max(errs, key=errs.get)
        want = {"streaming_attention_ref": 6, "streaming_attention": 6,
                "streaming_attention_dq": 6, "streaming_attention_dkdv": 6}
        if not (loss_err <= 1e-4 and errs[worst] <= 1e-4
                and collect([sa.launches, fa.launches]) == want):
            raise AssertionError("long_reference: loss rel err %.3g, grad "
                                 "rel err %.3g (%s), launches %s %s" % (
                                     loss_err, errs[worst], worst,
                                     dict(sa.launches), dict(fa.launches)))

        # dropout on: kernels against plain versions on the card, same words
        cfg = _small_model(0.1)
        losses = []
        for plain in (False, True):
            sa.launches.clear()
            with mock.patch.object(sa, "streaming_attention",
                                   plain_stream if plain
                                   else sa.streaming_attention), \
                    mock.patch.object(ff, "fused_ffn",
                                      plain_ffn if plain else ff.fused_ffn):
                loss = model.train_fn(gpu, gfeats, cfg,
                                      torch.Generator().manual_seed(SEED))
            losses.append(loss["loss"].item())
            key = "streaming_attention" + ("_ref" if plain else "")
            if sa.launches[key] != 6:
                raise AssertionError("long_reference: dropout run launched "
                                     "%s" % dict(sa.launches))
        drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
        if not drop_err <= 1e-5:
            raise AssertionError("long_reference: dropout-on loss kernels %r"
                                 " vs plain %r" % tuple(losses))

        # beam 4: the encoder streams (#5), decoding runs the pool kernel
        cfg.beam_size = 4
        cfg.decode_max_len = 24
        inf = model.infer_fn(cfg)
        sa.launches.clear()
        da.launches.clear()
        with torch.inference_mode():
            g = beam_search(gpu, gfeats["source"], inf, cfg)
            c = beam_search(cpu, feats["source"], inf, cfg)
        same = torch.equal(g["seq"].cpu(), c["seq"])
        score_err = (g["score"].cpu() - c["score"]).abs().max().item()
        if not (same and score_err <= 1e-4
                and sa.launches["streaming_attention"] == 2
                and da.launches["decode_pool_attention"] > 0
                and torch.isfinite(g["score"]).all()):
            raise AssertionError("long_reference beam 4: card vs CPU "
                                 "sequences equal %s, score err %.3g, "
                                 "launches %s %s" % (
                                     same, score_err, dict(sa.launches),
                                     dict(da.launches)))
    phase("long_reference", loss_rel_err=loss_err, grad_rel_err=errs[worst],
          worst=worst, dropout_loss_kernels=losses[0],
          dropout_loss_plain=losses[1], dropout_rel_err=drop_err,
          beam4_same_sequences=same, beam4_max_score_err=score_err,
          beam4_steps=g["steps"])


PHASES = ("device", "build", "kernels", "train_kernels", "serve",
          "reference", "train", "train_reference", "converge", "rpr_kernels",
          "rpr_train", "rpr_reference", "long_kernels", "long_train",
          "long_reference")


def main(argv=None):
    parser = argparse.ArgumentParser("chip_smoke")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %s (device and "
                        "build always run; a subset prints no summary "
                        "lines)" % ",".join(PHASES))
    args = parser.parse_args(argv)
    todo = set(args.phases.split(","))
    unknown = todo - set(PHASES)
    if unknown:
        parser.error("unknown phases %s" % sorted(unknown))
    full = todo == set(PHASES)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from zero_tpu_torch.ops.kernels import cuda_build
    from zero_tpu_torch.ops.kernels import decode_attention as da

    # device
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

    # build: one nvcc per source, all at once
    sources = cuda_build.SOURCES
    t0 = time.time()
    libs = cuda_build.build(*sources)
    for name in sources:
        cuda_build.load(name)
    phase("build", seconds=time.time() - t0,
          libraries=[os.path.relpath(libs[n], REPO) for n in sources],
          ptxas={n: cuda_build.ptxas_report(n) for n in sources})

    rows, train_rows, rpr_rows, long_rows, launches = {}, {}, {}, {}, {}
    if "kernels" in todo:
        rows = kernels_phase(da)
    if "train_kernels" in todo:
        train_rows = train_kernels_phase()
    if "rpr_kernels" in todo:
        rpr_rows = rpr_kernels_phase()
    if "long_kernels" in todo:
        long_rows = long_kernels_phase(da)

    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.saver import Saver
    from zero_tpu_torch.vocab import Vocab

    with tempfile.TemporaryDirectory() as d:
        words = write_corpus(d)
        if "serve" in todo:
            # serve transformer-base with random weights
            cfg = default_config().override_from_dict(
                load_config_file(CONFIG))
            cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d,
                                                               "vocab.txt"))
            weights = get_model("transformer").init_fn(
                torch.Generator().manual_seed(SEED), cfg)
            Saver(output_dir=os.path.join(d, "model")).save(
                {"params": weights}, step=0)
            del weights
            launches["decode_pool_attention"] = serve_phase(
                da, d, 4, "decode_pool_attention")
            launches["decode_attention"] = serve_phase(
                da, d, 1, "decode_attention")
        if "reference" in todo:
            reference_phase(da)
        if "train" in todo or "rpr_train" in todo:
            write_train_corpus(d, words)
        if "train" in todo:
            launches.update(train_phase(d, da))
        if "rpr_train" in todo:
            launches.update(train_phase(d, da, RPR_CONFIG, "rpr_train",
                                        rpr_expected_launches))
        if "long_train" in todo:
            write_long_corpus(d, words)
            launches.update(long_train_phase(d, da))
    if "train_reference" in todo:
        train_reference_phase()
    if "rpr_reference" in todo:
        rpr_reference_phase(da)
    if "long_reference" in todo:
        long_reference_phase(da)
    if "converge" in todo:
        with tempfile.TemporaryDirectory() as d:
            converge_phase(d)
    if not full:
        return 0

    kernels = []
    decode_src = "zero_tpu_torch/csrc/decode_attention.cu"
    for name, line in (("decode_pool_attention", 288),
                       ("decode_attention", 366)):
        r = rows[(name, torch.bfloat16)]
        kernels.append(dict(
            name=name, route="cuda", source=decode_src,
            replaces="zero_tpu/ops/kernels/decode_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # training kernels: bf16 at rate 0.1, as the train phase runs them;
    # attention at the encoder self-attention case; the library yardstick
    # is timed with dropout off
    for name, source, replaces, key in (
            ("fused_attention", "fused_attention.cu", "fused_attention.py:488",
             ("self_pad",)),
            ("fused_attention_backward", "fused_attention.cu",
             "fused_attention.py:525", ("self_pad",)),
            ("fused_ffn", "fused_ffn.cu", "fused_ffn.py:186", ()),
            ("fused_ffn_backward", "fused_ffn.cu", "fused_ffn.py:214", ())):
        r = train_rows[(name,) + key + (torch.bfloat16, 0.1)]
        lib = train_rows[(name,) + key + (torch.bfloat16, 0.0)]["library_ms"]
        kernels.append(dict(
            name=name, route="cuda", source="zero_tpu_torch/csrc/" + source,
            replaces="zero_tpu/ops/kernels/" + replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=lib))
    # RPR kernels: bf16 at rate 0.1, encoder self-attention at m 16; the
    # library column is SDPA WITHOUT relative positions (a floor, not the
    # same function), composite_ms the use_flash_attention=false path
    for name, line in (("fused_attention_rpr", 580),
                       ("fused_attention_rpr_backward", 624)):
        r = rpr_rows[(name, "self_pad", torch.bfloat16, 0.1)]
        r0 = rpr_rows[(name, "self_pad", torch.bfloat16, 0.0)]
        kernels.append(dict(
            name=name, route="cuda",
            source="zero_tpu_torch/csrc/fused_attention_rpr.cu",
            replaces="zero_tpu/ops/kernels/fused_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r0["library_ms"],
            library="scaled_dot_product_attention without RPR (floor)",
            composite_ms=r0["composite_ms"]))
    # streaming kernels: bf16 at rate 0.1 on the encoder-like case (pad
    # mask, an all-pad row), as long_train runs them; SDPA with dropout off
    for name, line in (("streaming_attention", 308),
                       ("streaming_attention_dq", 353),
                       ("streaming_attention_dkdv", 371)):
        r = long_rows[(name, "pad_8320", 0.1)]
        kernels.append(dict(
            name=name, route="cuda",
            source="zero_tpu_torch/csrc/streaming_attention.cu",
            replaces="zero_tpu/ops/kernels/streaming_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            library_ms=long_rows[(name, "pad_8320", 0.0)]["library_ms"]))
    # the cross-attention decode kernel stays unwired, as in the JAX
    # package: no launch on the main path; long-memory shape, bf16
    r = long_rows[("decode_cross_attention", CROSS_CASES[-1][2])]
    kernels.append(dict(
        name="decode_cross_attention", route="cuda", source=decode_src,
        replaces="zero_tpu/ops/kernels/decode_attention.py:329",
        launches=launches.get("decode_cross_attention", 0),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], composite_ms=r["composite_ms"],
        wired=False))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
