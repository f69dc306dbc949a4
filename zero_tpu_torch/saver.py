"""Checkpoints in the JAX package's monolithic format: rolling latest-k plus
best-k by dev metric, and the weight bridge.

Counterpart of the monolithic part of ``zero_tpu/saver.py``: one
``model-<step>.npz`` per checkpoint holding the flattened state keyed by
tree path, plus a ``checkpoint`` JSON index ({"latest", "all"}) per
directory, with the latest ``checkpoints`` kept; ``best/`` holds the
``best_checkpoints`` best by dev score with its ``topk_checkpoint`` ledger
(name\\tscore lines), ``metric.log`` (best-score history) and copies of
``param.json``/``record.json``. A checkpoint written by either package
restores in the other, training state included:

  params/<path>            the parameters (``params/encoder/0/self/qkv/ws/0``)
  opt/.count               Adam's step count (optax ScaleByAdamState)
  opt/.mu/<path>, opt/.nu/<path>   Adam's moments
  ema/<path>               the EMA weights, when ema_decay > 0

The port's parameter modules name their tensors so that the state-dict key
is the path with '/' turned into '.'; the bridge (``params_from_flat``) is
therefore a rename. The sharded multi-host format is a later slice.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("zero_tpu_torch.saver")


def params_from_flat(flat: Dict[str, np.ndarray],
                     prefix: str = "params") -> Dict[str, torch.Tensor]:
    """Flat checkpoint arrays (JAX tree paths) -> a state dict for the
    port's parameter module: ``<prefix>/a/b/0`` becomes ``a.b.0``; keys of
    other prefixes are left out."""
    head = prefix + "/"
    return {k[len(head):].replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in flat.items() if k.startswith(head)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """fp32/int numpy copy (bf16 widens losslessly to fp32, the JAX storage
    dtype)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def tensors_of(tree) -> Dict[str, torch.Tensor]:
    """{JAX sub-path: tensor} of a checkpoint tree: a module (its state
    dict), a {dotted name: tensor} dict, or the Adam state
    {'count', 'mu': {...}, 'nu': {...}} (keys ``.count``, ``.mu/<path>``,
    ``.nu/<path>``, optax's ScaleByAdamState field names)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if "count" in tree and "mu" in tree:
        out = {".count": tree["count"]}
        for field in ("mu", "nu"):
            for name, t in tree[field].items():
                out[".%s/%s" % (field, name.replace(".", "/"))] = t
        return out
    return {name.replace(".", "/"): t for name, t in tree.items()}


def flat_from_module(module, prefix: str = "params") -> Dict[str, np.ndarray]:
    """A checkpoint tree's tensors keyed by JAX tree path, as numpy."""
    return {prefix + "/" + k: _numpy(t) for k, t in tensors_of(module).items()}


def load_flat(tree, flat: Dict[str, np.ndarray],
              prefix: str = "params") -> None:
    """Copy checkpoint arrays into a checkpoint tree in place, by name,
    keeping (with a warning) every tensor the checkpoint lacks or holds at
    another shape -- the JAX package's name-based partial restore."""
    with torch.no_grad():
        for sub, t in tensors_of(tree).items():
            key = prefix + "/" + sub
            if key not in flat:
                log.warning("%s missed in checkpoint", key)
            elif tuple(flat[key].shape) != tuple(t.shape):
                log.warning("shape mismatch for %s: saved %s vs model %s; "
                            "keeping model value", key,
                            tuple(flat[key].shape), tuple(t.shape))
            else:
                t.copy_(torch.from_numpy(np.array(flat[key])))


def _read_index(directory: str) -> List[str]:
    path = os.path.join(directory, "checkpoint")
    if not os.path.exists(path):
        return []
    with open(path) as r:
        return json.load(r).get("all", [])


def _write_index(directory: str, names: List[str]) -> None:
    with open(os.path.join(directory, "checkpoint"), "w") as w:
        json.dump({"latest": names[-1] if names else None, "all": names}, w,
                  indent=2)


def save_checkpoint_file(directory: str, name: str, trees: dict) -> str:
    """Write ``{prefix: tree or None}`` as ``<directory>/<name>.npz``."""
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for prefix, tree in trees.items():
        if tree is not None:
            flat.update(flat_from_module(tree, prefix))
    path = os.path.join(directory, name + ".npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return path


def load_checkpoint_file(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class Saver:
    """Latest-k + best-k checkpoint manager over the JAX package's file
    layout."""

    def __init__(self, checkpoints: int = 5,
                 output_dir: Optional[str] = None, best_score: float = -1.0,
                 best_checkpoints: int = 1):
        self.output_dir = output_dir or "./output"
        self.output_best_dir = os.path.join(self.output_dir, "best")
        self.max_keep = checkpoints
        self.best_checkpoints = best_checkpoints
        self.best_score = best_score
        metric_path = os.path.join(self.output_best_dir, "metric.log")
        if os.path.exists(metric_path):
            with open(metric_path) as r:
                lines = r.read().strip().splitlines()
            if lines:
                self.best_score = float(lines[-1].strip().split()[-1])
        self.topk_scores: List[Tuple[str, float]] = []
        topk_path = os.path.join(self.output_best_dir, "topk_checkpoint")
        if os.path.exists(topk_path):
            with open(topk_path) as r:
                for line in r:
                    name, score = line.strip().split("\t")
                    self.topk_scores.append((name, float(score)))

    def save(self, trees: dict, step: int,
             metric_score: Optional[float] = None) -> str:
        """trees: {'params': module, 'opt': adam state or None, 'ema': ...}.
        With a dev ``metric_score``, also updates best/."""
        os.makedirs(self.output_best_dir, exist_ok=True)
        name = "model-%d" % int(step)
        path = save_checkpoint_file(self.output_dir, name, trees)
        names = [n for n in _read_index(self.output_dir) if n != name] + [name]
        while len(names) > self.max_keep:
            victim = os.path.join(self.output_dir, names.pop(0) + ".npz")
            if os.path.exists(victim):
                os.remove(victim)
        _write_index(self.output_dir, names)

        if metric_score is not None and metric_score > self.best_score:
            self.best_score = metric_score
            for fname in ("param.json", "record.json"):
                src = os.path.join(self.output_dir, fname)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(self.output_best_dir, fname))
            with open(os.path.join(self.output_best_dir, "metric.log"),
                      "a") as w:
                w.write("Steps {}, Metric Score {}\n".format(step,
                                                             metric_score))

        if self._topk_admit(name, metric_score):
            save_checkpoint_file(self.output_best_dir, name, trees)
            keep = {n for n, _ in self.topk_scores}
            for fname in os.listdir(self.output_best_dir):
                if fname.endswith(".npz") and fname[:-4] not in keep:
                    os.remove(os.path.join(self.output_best_dir, fname))
            _write_index(self.output_best_dir,
                         [n for n, _ in self.topk_scores])
            with open(os.path.join(self.output_best_dir, "topk_checkpoint"),
                      "w") as w:
                for n, s in self.topk_scores:
                    w.write("{}\t{}\n".format(n, s))
        return path

    def _topk_admit(self, name: str, metric_score) -> bool:
        if metric_score is None or not (
                len(self.topk_scores) < self.best_checkpoints
                or metric_score > min(v[1] for v in self.topk_scores)):
            return False
        self.topk_scores.append((name, float(metric_score)))
        self.topk_scores = sorted(
            self.topk_scores, key=lambda x: x[1])[-self.best_checkpoints:]
        return True

    def latest_path(self, path: Optional[str] = None) -> Optional[str]:
        check_dir = path if (path and os.path.exists(path)) else self.output_dir
        names = _read_index(check_dir)
        if not names:
            return None
        return os.path.join(check_dir, names[-1] + ".npz")

    def restore(self, trees: dict, path: Optional[str] = None) -> bool:
        """Load the latest checkpoint of ``path`` (or output_dir) into
        ``{prefix: tree}`` in place; returns False (trees unchanged) when
        there is none."""
        ckpt = self.latest_path(path)
        if ckpt is None:
            log.warning("No existing model detected")
            return False
        log.info("Restoring from %s", ckpt)
        flat = load_checkpoint_file(ckpt)
        for prefix, tree in trees.items():
            if tree is not None:
                load_flat(tree, flat, prefix)
        return True
