"""One rank of the gloo group that tests/test_torch_data_parallel.py
starts: it imports torch and zero_tpu_torch only, never JAX.

    python tests/torch_dp_worker.py <spec.json> <rank>

The spec names the group's port and world size and a list of cases:
  * "train": the port's data-parallel step on this rank's slot of a
    global batch (``batches``: [steps, C, W*B, L] src and tgt), from the
    weights in ``weights`` (JAX tree paths); dropout seed words are
    injected as the test injects them into the JAX step (``seeded_words``),
    the gate noise of each global shape (``noise``) is sliced to this
    rank's rows. Writes the losses, gnorms, parameters, moments and EMA
    after every step.
  * "decode": the data-sharded decode (train.make_decode_fn(sharded=True))
    of ``rows`` source rows against the one-process decode on this rank.
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from zero_tpu_torch import config as config_mod  # noqa: E402
from zero_tpu_torch import train as train_mod  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops import common, l0norm  # noqa: E402
from zero_tpu_torch.saver import (flat_from_module,  # noqa: E402
                                  params_from_flat)
from zero_tpu_torch.train_step import (init_train_state,  # noqa: E402
                                       make_train_step)
from zero_tpu_torch.vocab import Vocab  # noqa: E402

U32 = 0xFFFFFFFF


def seeded_words(microbatch: int, site: int):
    """The seed words of dropout site ``site`` (1, 2, ...) of the
    ``microbatch``-th microbatch of the run: the rule the test patches
    into the JAX package's RngGen."""
    return ((microbatch * 1000003 + site) & U32,
            (0x9E3779B9 ^ site) & U32)


@contextlib.contextmanager
def seeded(noise=None, micro=None):
    """Within: common.RngGen draws seeded_words in place of the
    generator's words, each training RngGen the next microbatch's (the
    k-th made draws those of microbatch ``micro(k)`` where given); with
    ``noise`` ({global shape: array}), the gate noise of a draw is this
    rank's rows of the array of its global shape."""
    made = [0]
    saved = (common.RngGen.__init__, common.RngGen.__call__,
             l0norm.uniform_noise)

    def init(self, gen):
        self._gen = gen
        self._count = 0
        if gen is not None:
            self._micro = made[0] if micro is None else micro(made[0])
            made[0] += 1

    def call(self):
        if self._gen is None:
            return None
        self._count += 1
        return seeded_words(self._micro, self._count)

    def sliced_noise(words, shape, device):
        offset, rows, total = common.global_rows()
        if not rows:
            offset, total = 0, shape[0]
        full = noise[(total,) + tuple(shape[1:])]
        return torch.from_numpy(full[offset:offset + shape[0]]).to(device)

    common.RngGen.__init__ = init
    common.RngGen.__call__ = call
    if noise:
        l0norm.uniform_noise = sliced_noise
    try:
        yield
    finally:
        (common.RngGen.__init__, common.RngGen.__call__,
         l0norm.uniform_noise) = saved


def port_cfg(values):
    cfg = config_mod.default_config()
    size = int(values.pop("_vocab_size"))
    for k, v in values.items():
        setattr(cfg, k, v)
    vocab = Vocab()
    while vocab.size() < size:
        vocab.insert("w%d" % vocab.size())
    cfg.src_vocab = cfg.tgt_vocab = vocab
    cfg.device = "cpu"
    return cfg


def state_arrays(state):
    out = flat_from_module(state.params, "params")
    out.update(flat_from_module(state.opt, "opt"))
    if state.ema is not None:
        out.update(flat_from_module(state.ema, "ema"))
    return out


def run_train(case, rank, world):
    cfg = port_cfg(dict(case["cfg"]))
    model = get_model(cfg.model_name)
    with np.load(case["weights"]) as z:
        flat = {k: z[k] for k in z.files}
    state = init_train_state(model, cfg, torch.Generator(), "cpu")
    with torch.no_grad():
        state.params.load_state_dict(params_from_flat(flat))
        if state.ema is not None:
            for name, p in state.params.named_parameters():
                state.ema[name] = p.detach().clone()
    noise = {}
    if case.get("noise"):
        with np.load(case["noise"]) as z:
            noise = {tuple(int(d) for d in k.split("x")): z[k]
                     for k in z.files}
    step_fn = make_train_step(model, cfg)
    with np.load(case["batches"]) as z:
        src, tgt = z["src"], z["tgt"]
    rows = src.shape[2] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    out = {}
    with seeded(noise):
        for s in range(src.shape[0]):
            batch = {"source": src[s][:, mine], "target": tgt[s][:, mine]}
            _, m = step_fn(state, batch, case["lrs"][s], torch.Generator())
            out["loss/%d" % s] = np.float64(m["loss"])
            out["gnorm/%d" % s] = np.float64(m["gnorm"])
            for k, v in state_arrays(state).items():
                out["%s/%d" % (k, s)] = v.copy()
    np.savez(case["out"] % rank, **out)


def run_decode(case, rank, world):
    cfg = port_cfg(dict(case["cfg"]))
    model = get_model(cfg.model_name)
    weights = model.init_fn(torch.Generator().manual_seed(3), cfg).eval()
    rs = np.random.RandomState(5)
    src = rs.randint(3, 20, (case["rows"], 7)).astype(np.int64)
    src[1, 4:] = 0
    batch = {"src": src}
    plain = train_mod.make_decode_fn(cfg, model)(weights, batch)
    sharded = train_mod.make_decode_fn(cfg, model, sharded=True)(weights,
                                                                  batch)
    np.savez(case["out"] % rank, plain_seq=plain["seq"],
             plain_score=plain["score"], seq=sharded["seq"],
             score=sharded["score"])


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as r:
        spec = json.load(r)
    world = int(spec["world"])
    tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                             % spec["port"], world_size=world, rank=rank)
    try:
        for case in spec["cases"]:
            if case["kind"] == "train":
                run_train(case, rank, world)
            else:
                run_decode(case, rank, world)
    finally:
        tdist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
