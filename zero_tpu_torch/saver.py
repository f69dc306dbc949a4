"""Checkpoints in the JAX package's monolithic format, and the weight bridge.

Counterpart of the monolithic part of ``zero_tpu/saver.py``: one
``model-<step>.npz`` per checkpoint holding the flattened state keyed by
tree path (``params/encoder/0/self/qkv/ws/0``, ``params/emb_bias``, ...),
plus a ``checkpoint`` JSON index ({"latest", "all"}) per directory, with
the latest ``checkpoints`` kept. A checkpoint written by either package
restores in the other.

The port's parameter modules name their tensors so that the state-dict key
is the JAX path with the prefix dropped and '/' turned into '.'; the
bridge (``params_from_flat``) is therefore a rename. Best-k bookkeeping and
the sharded format come with the training slice.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

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


def flat_from_module(module: torch.nn.Module,
                     prefix: str = "params") -> Dict[str, np.ndarray]:
    """The inverse: a module's tensors keyed by JAX tree path, as fp32/int
    numpy arrays (bf16 widens losslessly to fp32, the JAX storage dtype)."""
    flat = {}
    for name, t in module.state_dict().items():
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        flat[prefix + "/" + name.replace(".", "/")] = t.numpy()
    return flat


def load_flat(module: torch.nn.Module, flat: Dict[str, np.ndarray],
              prefix: str = "params") -> None:
    """Copy checkpoint arrays into ``module`` by name, keeping (with a
    warning) every tensor the checkpoint lacks or holds at another shape --
    the JAX package's name-based partial restore."""
    saved = params_from_flat(flat, prefix)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            key = prefix + "/" + name.replace(".", "/")
            if name not in saved:
                log.warning("%s missed in checkpoint", key)
            elif tuple(saved[name].shape) != tuple(t.shape):
                log.warning("shape mismatch for %s: saved %s vs model %s; "
                            "keeping model value", key,
                            tuple(saved[name].shape), tuple(t.shape))
            else:
                t.copy_(saved[name])


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


def save_checkpoint_file(directory: str, name: str, modules: dict) -> str:
    """Write ``{prefix: module}`` as ``<directory>/<name>.npz``."""
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for prefix, module in modules.items():
        if module is not None:
            flat.update(flat_from_module(module, prefix))
    path = os.path.join(directory, name + ".npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return path


def load_checkpoint_file(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class Saver:
    """Latest-k checkpoint manager over the JAX package's file layout."""

    def __init__(self, checkpoints: int = 5,
                 output_dir: Optional[str] = None):
        self.output_dir = output_dir or "./output"
        self.max_keep = checkpoints

    def save(self, modules: dict, step: int) -> str:
        """modules: {'params': module, 'ema': module or None, ...}."""
        name = "model-%d" % int(step)
        path = save_checkpoint_file(self.output_dir, name, modules)
        names = [n for n in _read_index(self.output_dir) if n != name] + [name]
        while len(names) > self.max_keep:
            victim = os.path.join(self.output_dir, names.pop(0) + ".npz")
            if os.path.exists(victim):
                os.remove(victim)
        _write_index(self.output_dir, names)
        return path

    def latest_path(self) -> Optional[str]:
        names = _read_index(self.output_dir)
        if not names:
            return None
        return os.path.join(self.output_dir, names[-1] + ".npz")

    def restore(self, modules: dict) -> bool:
        """Load the latest checkpoint into ``{prefix: module}`` in place;
        returns False (modules unchanged) when there is none."""
        ckpt = self.latest_path()
        if ckpt is None:
            log.warning("No existing model detected")
            return False
        log.info("Restoring from %s", ckpt)
        flat = load_checkpoint_file(ckpt)
        for prefix, module in modules.items():
            load_flat(module, flat, prefix)
        return True
