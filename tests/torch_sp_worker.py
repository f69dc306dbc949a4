"""One rank of the gloo group that tests/test_torch_sequence_parallel.py
starts: it imports torch and zero_tpu_torch only, never JAX.

    python tests/torch_sp_worker.py <spec.json> <rank>

The spec names the group's port and world size and a list of cases:
"decode" is torch_dp_worker's (the data-sharded decode against the
plain one, here under a 'seq' mesh axis); "train" torch_tp_worker's
on the config's mesh (``mesh_data`` x
``mesh_model`` x ``mesh_seq`` processes): this rank's rows are the slot of
its data coordinate in the global batch, and the processes of a seq line
hold the same rows, each its block of every sequence. The gate noise of a
draw (``noise``: {global shape: array}) is sliced to this rank's rows and,
for a sequence block, to its positions. The counts of the ring's blocks
and of the fused attention's and FFN's plain versions that the case ran
are written beside its arrays (``launches/<counter>``).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_tp_worker as tp_worker  # noqa: E402
from zero_tpu_torch.ops import common, l0norm  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_attention as fa  # noqa: E402
from zero_tpu_torch.ops.kernels import fused_ffn as ff  # noqa: E402
from zero_tpu_torch.parallel import ring  # noqa: E402

# the counters of the routes the case ran (written beside its arrays)
COUNTERS = {"ring_block_ref": ring.launches,
            "fused_attention_ref": fa.launches,
            "fused_attention_rpr_ref": fa.launches,
            "fused_ffn_ref": ff.launches}


@contextlib.contextmanager
def block_noise(path):
    """Within: l0norm.uniform_noise returns this rank's rows and sequence
    block of the array of the draw's global shape."""
    if not path:
        yield
        return
    with np.load(path) as z:
        noise = {tuple(int(d) for d in k.split("x")): z[k] for k in z.files}
    saved = l0norm.uniform_noise

    def sliced(words, shape, device, split=None):
        offset, rows, total = common.global_rows()
        if not rows:
            offset, total = 0, shape[0]
        lo, whole = (split[1], split[2]) if split else (0, shape[1])
        full = noise[(total, whole) + tuple(shape[2:])]
        return torch.from_numpy(np.ascontiguousarray(
            full[offset:offset + shape[0], lo:lo + shape[1]])).to(device)

    l0norm.uniform_noise = sliced
    try:
        yield
    finally:
        l0norm.uniform_noise = saved


def run_train(case, rank, world):
    before = {k: c[k] for k, c in COUNTERS.items()}
    with block_noise(case.get("noise")):
        tp_worker.run_train(dict(case, noise=None), rank, world)
    path = case["out"] % rank
    out = dict(np.load(path))
    for k, c in COUNTERS.items():
        out["launches/" + k] = np.int64(c[k] - before[k])
    np.savez(path, **out)


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as r:
        spec = json.load(r)
    world = int(spec["world"])
    tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                             % spec["port"], world_size=world, rank=rank)
    try:
        for case in spec["cases"]:
            {"train": run_train, "decode": tp_worker.dp.run_decode}[
                case["kind"]](case, rank, world)
    finally:
        tdist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
