"""One rank of the gloo group that tests/test_torch_tensor_parallel.py and
tests/test_torch_expert_parallel.py start: it imports torch and
zero_tpu_torch only, never JAX.

    python tests/torch_tp_worker.py <spec.json> <rank>

The spec names the group's port and world size and a list of cases:
  * "train": torch_dp_worker's case on the config's mesh (``mesh_data``
    x ``mesh_model`` x ``mesh_expert`` processes, ``zero_stage``): this
    rank's rows are the slot of its data coordinate in the global batch.
    Writes the losses, gnorms and pnorms after every step, the whole
    parameters, moments and EMA (gathered, host_fetchable), what the rank
    holds of each leaf after the last step ("held/"), the names of the
    leaves a model or expert axis splits and its bytes of parameters,
    moments and EMA (parallel/mesh.py:per_rank_bytes); gate noise as
    torch_dp_worker injects it (``noise``). The batches file holds
    ``src`` and ``tgt`` or any feature dict ([steps, C, B, ...] arrays
    by feature name: speech); ``z`` ([B, 1] language indices) stands in
    for ROBT's draw of the intermediate languages, whose two training
    passes a microbatch draw the seed words of the JAX step's two keys.
  * "save": the state after one step written as a sharded checkpoint,
    then restored into a fresh state of the same mesh; the whole state
    and the restored parts.
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
from torch_zero_worker import whole_arrays  # noqa: E402
from zero_tpu_torch import robt  # noqa: E402
from zero_tpu_torch import saver as saver_mod  # noqa: E402
from zero_tpu_torch.ops import common  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.parallel import distributed as dist  # noqa: E402
from zero_tpu_torch.parallel.mesh import per_rank_bytes  # noqa: E402
from zero_tpu_torch.saver import params_from_flat  # noqa: E402
from zero_tpu_torch.train_step import (init_train_state,  # noqa: E402
                                       make_train_step)


def load_weights(state, flat):
    """Whole weights (JAX tree paths) into a state of any mesh and stage:
    each tensor takes what the layout gives this rank of the whole leaf."""
    whole = params_from_flat(flat)
    layout = state.layout

    def held(name, t):
        if layout is None:
            return whole[name]
        part = layout.part(name, whole[name])
        return (layout.local(name, part) if tuple(part.shape) != tuple(
            t.shape) else part)
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            p.copy_(held(name, p))
            if state.ema is not None:
                state.ema[name] = held(name, state.ema[name]).clone()


def held_arrays(state):
    """What this rank holds of every leaf, by checkpoint key."""
    trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
    return {"held/" + k: saver_mod._numpy(t).copy()
            for k, t in saver_mod.flat_tensors(trees).items()}


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
    out["split_names"] = np.array(sorted(state.layout.splits)
                                  if state.layout else [], dtype=str)
    step_fn = make_train_step(model, cfg)
    names = {"src": "source", "tgt": "target"}
    with np.load(case["batches"]) as z:
        feats = {names.get(k, k): z[k] for k in z.files}
    noise = {}
    if case.get("noise"):
        with np.load(case["noise"]) as z:
            noise = {tuple(int(d) for d in k.split("x")): z[k]
                     for k in z.files}
    grid = dist.grid()
    rows = feats["target"].shape[2] // grid.degree("data")
    mine = slice(grid.coord("data") * rows, (grid.coord("data") + 1) * rows)
    micro, draw = None, robt.draw_languages
    if case.get("z") is not None:
        z = torch.tensor(case["z"])

        def draw(gen, n, num_languages, device):
            offset, local, _ = common.global_rows()
            return (z[offset:offset + n] if local else z).to(device)

        # the JAX step's keys a microbatch m: 3m (main), 3m + 1 (synthetic)
        micro = lambda k: 3 * (k // 2) + k % 2  # noqa: E731
    with dp.seeded(noise, micro), \
            mock.patch.object(robt, "draw_languages", draw):
        for s in range(feats["target"].shape[0]):
            batch = {k: v[s][:, mine] for k, v in feats.items()}
            _, m = step_fn(state, batch, case["lrs"][s], torch.Generator())
            for key in ("loss", "gnorm", "pnorm"):
                out["%s/%d" % (key, s)] = np.float64(m[key])
            for k, v in whole_arrays(state).items():
                out["%s/%d" % (k, s)] = v
    out.update(held_arrays(state))
    np.savez(case["out"] % rank, **out)


def run_save(case, rank, world):
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
    saver_mod.Saver(output_dir=case["dir"], sharded=True,
                    layout=state.layout).save(trees, 1, 0.5)
    tdist.barrier()
    out = {"whole/" + k: v for k, v in whole_arrays(state).items()}
    out.update(held_arrays(state))
    fresh = init_train_state(model, cfg, torch.Generator().manual_seed(9),
                             "cpu")
    restored = {"params": fresh.params, "opt": fresh.opt, "ema": fresh.ema}
    saver_mod.Saver(output_dir=case["dir"],
                    layout=fresh.layout).restore(restored)
    out.update({"restored/" + k: saver_mod._numpy(t)
                for k, t in saver_mod.flat_tensors(restored).items()})
    out["own_keys"] = len(saver_mod.load_own_shards(
        os.path.join(case["dir"], "model-1"), fresh.layout))
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
