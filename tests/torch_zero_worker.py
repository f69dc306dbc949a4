"""One rank of the gloo group that tests/test_torch_zero.py and
tests/test_torch_sharded_save.py start: it imports torch and
zero_tpu_torch only, never JAX.

    python tests/torch_zero_worker.py <spec.json> <rank>

The spec names the group's port and world size and a list of cases:
  * "train": torch_dp_worker's case under ZeRO (the config's
    ``zero_stage``): the losses, gnorms and pnorms after every step, the
    whole parameters, moments and EMA (gathered, host_fetchable) and each
    process's bytes of them (parallel/mesh.py:per_rank_bytes).
  * "save": a stage-3 state after one step written as a sharded
    checkpoint, synchronously and asynchronously, then restored into a
    fresh state of the same world; the saver's index writes and removals
    on this rank are counted; the weights a dev eval decodes with
    (train.py:_eval_weights) with the EMA on and off.
"""

import json
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_dp_worker as dp  # noqa: E402
from zero_tpu_torch import saver as saver_mod  # noqa: E402
from zero_tpu_torch import train as train_mod  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.parallel import distributed as dist  # noqa: E402
from zero_tpu_torch.parallel.mesh import per_rank_bytes  # noqa: E402
from zero_tpu_torch.saver import params_from_flat  # noqa: E402
from zero_tpu_torch.train_step import (init_train_state,  # noqa: E402
                                       make_train_step)


def whole_arrays(state):
    """The whole state as numpy by checkpoint key (a collective)."""
    trees = dist.host_fetchable({"params": state.params, "opt": state.opt,
                                 "ema": state.ema}, state.layout)
    return {k: saver_mod._numpy(t).copy()
            for k, t in saver_mod.flat_tensors(trees).items()}


def load_weights(state, flat):
    """Whole weights (JAX tree paths) into a state of any stage: each
    tensor takes its slice where it is held as a shard."""
    whole = params_from_flat(flat)
    layout = state.layout
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            p.copy_(layout.local(name, whole[name])
                    if layout and layout.is_shard(name, p) else whole[name])
            if state.ema is not None:
                state.ema[name] = (layout.local(name, whole[name])
                                   if layout else whole[name]).clone()


def run_train(case, rank, world):
    cfg = dp.port_cfg(dict(case["cfg"]))
    model = get_model(cfg.model_name)
    with np.load(case["weights"]) as z:
        flat = {k: z[k] for k in z.files}
    state = init_train_state(model, cfg, torch.Generator(), "cpu")
    load_weights(state, flat)
    out = {"bytes/params": per_rank_bytes(state.params),
           "bytes/opt": per_rank_bytes(state.opt),
           "bytes/ema": per_rank_bytes(state.ema)}
    step_fn = make_train_step(model, cfg)
    with np.load(case["batches"]) as z:
        src, tgt = z["src"], z["tgt"]
    rows = src.shape[2] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    with dp.seeded():
        for s in range(src.shape[0]):
            batch = {"source": src[s][:, mine], "target": tgt[s][:, mine]}
            _, m = step_fn(state, batch, case["lrs"][s], torch.Generator())
            for key in ("loss", "gnorm", "pnorm"):
                out["%s/%d" % (key, s)] = np.float64(m[key])
            for k, v in whole_arrays(state).items():
                out["%s/%d" % (k, s)] = v
    np.savez(case["out"] % rank, **out)


def run_save(case, rank, world):
    """Writes, under case["dir"]: sync/ and async/ (the same checkpoint
    each way), keep/ (two saves at checkpoints=1: the first evicted) and
    the rank's npz: the whole state, its own slices as held, the restored
    slices and the bookkeeping calls it made."""
    cfg = dp.port_cfg(dict(case["cfg"]))
    model = get_model(cfg.model_name)
    state = init_train_state(model, cfg, torch.Generator().manual_seed(3),
                             "cpu")
    rs = np.random.RandomState(0)
    batch = {"source": rs.randint(3, 20, (1, 2, 7)),
             "target": rs.randint(3, 20, (1, 2, 6))}
    make_train_step(model, cfg)(state, batch, 1e-3,
                                torch.Generator().manual_seed(5))
    trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    calls = {"index": 0, "remove": 0}
    real_index, real_remove = saver_mod._write_index, saver_mod._remove_files

    def index(*args):
        calls["index"] += 1
        return real_index(*args)

    def remove(paths):
        calls["remove"] += 1
        return real_remove(paths)

    with mock.patch.object(saver_mod, "_write_index", index), \
            mock.patch.object(saver_mod, "_remove_files", remove):
        for sub, async_save in (("sync", False), ("async", True)):
            saver = saver_mod.Saver(output_dir=os.path.join(case["dir"], sub),
                                    async_save=async_save, sharded=True,
                                    layout=state.layout)
            saver.save(trees, 1, 0.5)
            saver.wait()
        keep = saver_mod.Saver(checkpoints=1, sharded=True,
                               layout=state.layout,
                               output_dir=os.path.join(case["dir"], "keep"))
        for step, score in ((1, 0.1), (2, 0.2)):
            keep.save(trees, step, score)
    tdist.barrier()
    out = {"whole/" + k: v for k, v in whole_arrays(state).items()}
    out.update({"held/" + k: saver_mod._numpy(t).copy()
                for k, t in saver_mod.flat_tensors(trees).items()})
    fresh = init_train_state(model, cfg, torch.Generator().manual_seed(9),
                             "cpu")
    restored = {"params": fresh.params, "opt": fresh.opt, "ema": fresh.ema}
    saver_mod.Saver(output_dir=os.path.join(case["dir"], "sync"),
                    layout=fresh.layout).restore(restored)
    out.update({"restored/" + k: saver_mod._numpy(t)
                for k, t in saver_mod.flat_tensors(restored).items()})
    out["own_keys"] = len(saver_mod.load_own_shards(
        os.path.join(case["dir"], "sync", "model-1"), fresh.layout))
    # the weights a dev eval decodes with, gathered collectively: the
    # EMA with ema_decay > 0, else the stage-3 parameters
    plain = dp.port_cfg(dict(case["cfg"], ema_decay=0.0))
    for tag, c in (("eval_ema/", cfg), ("eval_params/", plain)):
        weights = train_mod._eval_weights(c, model, state)
        out.update({tag + k: saver_mod._numpy(t).copy() for k, t in
                    saver_mod.flat_tensors({"params": weights}).items()})
    out["calls/index"] = calls["index"]
    out["calls/remove"] = calls["remove"]
    np.savez(case["out"] % rank, **out)


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as r:
        spec = json.load(r)
    world = int(spec["world"])
    tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                             % spec["port"], world_size=world, rank=rank)
    try:
        for case in spec["cases"]:
            {"train": run_train, "save": run_save}[case["kind"]](
                case, rank, world)
    finally:
        tdist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
