"""Average the last k checkpoints into a new checkpoint.

A copy of ``zero_tpu/scripts/checkpoint_averaging.py`` on the port's
saver, which writes the same npz layout and index: read the latest k
checkpoints of a training directory, take the arithmetic mean of every
parameter tensor (the optimizer's moments and step count are dropped: the
averaged model is for decoding), and write a directory of one checkpoint,
``model-avg``, with the run's param.json beside it.

  python -m zero_tpu_torch.scripts.checkpoint_averaging \
      --path train_dir --output avg_dir --checkpoints 5
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from zero_tpu_torch.saver import (_read_index, _write_index,
                                  load_checkpoint_file)


def average_checkpoints(path: str, output: str, checkpoints: int = 5) -> str:
    names = _read_index(path)
    if not names:
        raise FileNotFoundError("no checkpoint index in %s" % path)
    names = names[-checkpoints:]
    print("Averaging %d checkpoints: %s" % (len(names), names))

    total = {}
    count = 0
    for name in names:
        flat = load_checkpoint_file(os.path.join(path, name + ".npz"))
        count += 1
        for key, arr in flat.items():
            if not key.startswith("params/"):
                continue
            if not np.issubdtype(arr.dtype, np.floating):
                # integer tensors (none expected in params) are kept as-is
                total.setdefault(key, arr)
                continue
            if key in total:
                total[key] = total[key] + arr.astype(np.float64)
            else:
                total[key] = arr.astype(np.float64)

    averaged = {}
    for key, arr in total.items():
        if np.issubdtype(arr.dtype, np.floating):
            averaged[key] = (arr / count).astype(np.float32)
        else:
            averaged[key] = arr

    os.makedirs(output, exist_ok=True)
    out_name = "model-avg"
    with open(os.path.join(output, out_name + ".npz"), "wb") as f:
        np.savez(f, **averaged)
    _write_index(output, [out_name])
    # carry param.json along for --mode test usability
    src_param = os.path.join(path, "param.json")
    if os.path.exists(src_param):
        with open(src_param) as r, \
                open(os.path.join(output, "param.json"), "w") as w:
            w.write(r.read())
    print("Averaged checkpoint written to %s" % output)
    return os.path.join(output, out_name + ".npz")


def main():
    parser = argparse.ArgumentParser("Average checkpoints")
    parser.add_argument("--path", required=True, help="training directory")
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--checkpoints", type=int, default=5,
                        help="number of latest checkpoints to average")
    args = parser.parse_args()
    average_checkpoints(args.path, args.output, args.checkpoints)


if __name__ == "__main__":
    main()
