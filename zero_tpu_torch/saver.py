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
therefore a rename. The port writes the npz members with a fixed time
stamp, so one state gives one file, byte for byte.

``Saver(async_save=True)`` (``async_checkpoint``) snapshots the state on
its device and writes it on a worker thread; ``wait()`` joins the write
and raises its error.

The sharded format ("sharded-v1", ``Saver(sharded=True)``, the JAX
package's ``save_checkpoint_sharded``): under ZeRO or tensor and expert
parallelism (parallel/mesh.py's layout) every process writes
``model-<step>.shard<rank>.npz`` holding its own rectangles of the whole
leaves under ``key@a:b,c:d`` (every dim listed, ``_index_key``'s text;
a fused ``qkv`` part is three), each rectangle written by one process (a
leaf no axis cuts by the coordinate-0 process of that axis), shard0 also
the leaves every process holds whole under the bare key; the primary
writes ``model-<step>.shardmeta.json`` ({"format",
"nproc", "keys": {key: shape}}). A training restore under the same
number of processes reads each process's slices from its own file; any
other restore (another number of processes, a monolithic checkpoint,
``--mode test`` on one device) assembles every leaf from all the shard
files and, in training, slices it.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from zero_tpu_torch.parallel import distributed as dist

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


def layout_name(key: str) -> Optional[str]:
    """The parameter name (parallel/mesh.py's layout) of a checkpoint key:
    ``params/a/b``, ``ema/a/b``, ``opt/.mu/a/b`` and ``opt/.nu/a/b`` are
    ``a.b``; Adam's count has none."""
    prefix, _, sub = key.partition("/")
    if prefix == "opt":
        field, _, sub = sub.partition("/")
        if field not in (".mu", ".nu"):
            return None
    return sub.replace("/", ".")


def load_flat(tree, flat: Dict[str, np.ndarray],
              prefix: str = "params", layout=None) -> None:
    """Copy checkpoint arrays into a checkpoint tree in place, by name,
    keeping (with a warning) every tensor the checkpoint lacks or holds at
    another shape -- the JAX package's name-based partial restore. Under
    a ZeRO ``layout`` a tensor held as a shard takes its slice of the
    whole array."""
    with torch.no_grad():
        for sub, t in tensors_of(tree).items():
            key = prefix + "/" + sub
            arr = flat.get(key)
            name = layout_name(key)
            if arr is not None and layout is not None \
                    and name in layout.shapes \
                    and tuple(arr.shape) != tuple(t.shape):
                if tuple(arr.shape) == layout.wholes.get(name):
                    arr = layout.part(name, arr)
                if layout.is_shard(name, t) \
                        and tuple(arr.shape) == layout.shapes[name]:
                    arr = layout.local(name, arr)
            if arr is None:
                log.warning("%s missed in checkpoint", key)
            elif tuple(arr.shape) != tuple(t.shape):
                log.warning("shape mismatch for %s: saved %s vs model %s; "
                            "keeping model value", key,
                            tuple(arr.shape), tuple(t.shape))
            else:
                t.copy_(torch.from_numpy(np.array(arr)))


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


def flat_tensors(trees: dict) -> Dict[str, torch.Tensor]:
    """``{prefix: tree or None}`` -> {checkpoint key: tensor}."""
    flat = {}
    for prefix, tree in trees.items():
        if tree is not None:
            flat.update({prefix + "/" + k: t
                         for k, t in tensors_of(tree).items()})
    return flat


# the time stamp of every npz member: one state, one file
_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


def write_checkpoint_file(directory: str, name: str,
                          flat: Dict[str, torch.Tensor]) -> str:
    """Write {key: tensor} as ``<directory>/<name>.npz``: np.savez's
    layout (one ``<key>.npy`` member each, stored), fixed time stamps."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name + ".npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, t in flat.items():
            info = zipfile.ZipInfo(key + ".npy", date_time=_ZIP_TIME)
            with z.open(info, "w", force_zip64=True) as member:
                np.lib.format.write_array(member, _numpy(t),
                                          allow_pickle=False)
    return path


def save_checkpoint_file(directory: str, name: str, trees: dict) -> str:
    """Write ``{prefix: tree or None}`` as ``<directory>/<name>.npz``."""
    return write_checkpoint_file(directory, name, flat_tensors(trees))


def load_checkpoint_file(path: str,
                         prefixes=None) -> Dict[str, np.ndarray]:
    """The arrays of ``<path>`` by key; with ``prefixes``, only the keys
    under them (an eval restore of the EMA weights reads neither the
    parameters nor the Adam moments)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files
                if prefixes is None or k.split("/", 1)[0] in prefixes}


def sharded_members(flat: Dict[str, torch.Tensor], layout=None):
    """This process's part of a sharded-v1 checkpoint of ``flat`` ({key:
    tensor as held}): (its members, the meta's {key: whole shape}). A
    tensor held as a part (under the ``layout``: a ZeRO shard, a model or
    expert part) goes under ``key@<index>`` for each rectangle of the
    whole leaf it holds (``zero_tpu/saver.py:_index_key``'s text), where
    this process is the one that writes it (Layout.writes); a tensor
    every process holds whole under the bare key, in shard0 only."""
    rank = dist.process_index()
    members, shapes = {}, {}
    for key, t in flat.items():
        name = layout_name(key)
        sharded = layout is not None and layout.is_shard(name, t)
        if sharded or (layout is not None and layout.split(name)):
            if layout.writes(name, sharded):
                for index, piece in layout.pieces(name, t, sharded):
                    members[key + "@" + index] = piece
            shapes[key] = list(layout.wholes[name])
        else:
            if rank == 0:
                members[key] = t
            shapes[key] = list(t.shape)
    return members, shapes


def write_sharded_checkpoint(directory: str, name: str,
                             members: Dict[str, torch.Tensor],
                             shapes: Dict[str, list]) -> str:
    """Write this process's ``<name>.shard<rank>.npz`` and, on the
    primary, ``<name>.shardmeta.json``. Every process calls it; no
    collective."""
    rank = dist.process_index()
    path = write_checkpoint_file(directory, "%s.shard%d" % (name, rank),
                                 members)
    if rank == 0:
        with open(os.path.join(directory, name + ".shardmeta.json"),
                  "w") as w:
            json.dump({"format": "sharded-v1",
                       "nproc": dist.process_count(), "keys": shapes}, w)
    return path


def load_own_shards(base: str, layout, prefixes=None) -> Dict[str, np.ndarray]:
    """This process's parts from its own shard file of the sharded-v1
    checkpoint ``base``, where it was written by as many processes as run
    now and holds exactly the rectangles the ``layout`` gives this
    process's ZeRO shard: {key: the shard as held}. Empty otherwise (a
    part whole over the data axis is assembled from every file)."""
    with open(base + ".shardmeta.json") as r:
        nproc = int(json.load(r)["nproc"])
    own = "%s.shard%d.npz" % (base, dist.process_index())
    if nproc != dist.process_count() or not os.path.exists(own):
        return {}
    found: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(own, allow_pickle=False) as z:
        for member in z.files:
            key, _, index = member.partition("@")
            name = layout_name(key)
            if index and name in layout.dims \
                    and layout.dims[name] is not None \
                    and (prefixes is None
                         or key.split("/", 1)[0] in prefixes):
                found.setdefault(key, {})[index] = z[member]
    out = {}
    for key, pieces in found.items():
        name = layout_name(key)
        shape = list(layout.shapes[name])
        shape[layout.dims[name]] //= layout.world
        held = np.zeros(shape, next(iter(pieces.values())).dtype)
        wanted = layout.pieces(name, held, True)
        if {index for index, _ in wanted} != set(pieces):
            continue
        for index, view in wanted:
            view[...] = pieces[index]
        out[key] = held
    return out


def load_sharded_checkpoint(base: str, prefixes=None,
                            skip=()) -> Dict[str, np.ndarray]:
    """The arrays of the sharded-v1 checkpoint ``base`` (its path without
    extension), each leaf assembled from every ``<base>.shard*.npz``: a
    bare key is read as it is; ``key@a:b,c:d`` index keys are placed into
    a zero array of the shape ``<base>.shardmeta.json`` gives
    (``zero_tpu/saver.py:_load_sharded_leaf``). A key with no entry is
    left out, so load_flat keeps the template's value with its warning;
    so are the keys in ``skip``."""
    with open(base + ".shardmeta.json") as r:
        shapes = json.load(r)["keys"]
    pieces: Dict[str, list] = {}
    bare: Dict[str, np.ndarray] = {}
    for fname in sorted(glob.glob(glob.escape(base) + ".shard*.npz")):
        with np.load(fname, allow_pickle=False) as z:
            for member in z.files:
                key, _, index = member.partition("@")
                if key not in shapes or key in skip or (
                        prefixes is not None
                        and key.split("/", 1)[0] not in prefixes):
                    continue
                if index:
                    pieces.setdefault(key, []).append((index, z[member]))
                else:
                    bare[key] = z[member]
    flat = dict(bare)
    for key, parts in pieces.items():
        if key in flat:
            continue
        full = np.zeros(shapes[key], parts[0][1].dtype)
        for index, arr in parts:
            full[tuple(slice(*map(int, span.split(":")))
                       for span in index.split(","))] = arr
        flat[key] = full
    return flat


def _checkpoint_files(directory: str, name: str) -> List[str]:
    """Every file of checkpoint ``name``: its npz, or its shard files and
    meta."""
    base = os.path.join(directory, name)
    return ([base + ".npz", base + ".shardmeta.json"]
            + glob.glob(glob.escape(base) + ".shard*.npz"))


class Saver:
    """Latest-k + best-k checkpoint manager over the JAX package's file
    layout. With ``async_save`` the index and top-k bookkeeping run in
    ``save`` and the npz writes on a worker thread, over a snapshot of the
    state taken on its device; at most one write is in flight. With
    ``sharded`` every process calls ``save`` with the state as it holds
    it (its ZeRO shards, ``layout``) and writes its own shard file; the
    primary alone writes the index, the ledgers and evicts, the others
    take the same top-k decisions (``zero_tpu/saver.py:_bookkeep_only``).
    A sharded save starts with a barrier, once every process's earlier
    writes are done, so that no eviction removes a shard still being
    written (the JAX package has no such wait).
    """

    def __init__(self, checkpoints: int = 5,
                 output_dir: Optional[str] = None, best_score: float = -1.0,
                 best_checkpoints: int = 1, async_save: bool = False,
                 sharded: bool = False, layout=None):
        self.output_dir = output_dir or "./output"
        self.output_best_dir = os.path.join(self.output_dir, "best")
        self.max_keep = checkpoints
        self.best_checkpoints = best_checkpoints
        self.best_score = best_score
        self.async_save = async_save
        self.sharded = sharded
        self.layout = layout
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
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

    def wait(self) -> None:
        """Block until a pending async write has finished; raise the error
        it met, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("the async checkpoint write failed") \
                from error

    def _write(self, directories, name, flat, shapes=None) -> None:
        try:
            for directory in directories:
                if self.sharded:
                    write_sharded_checkpoint(directory, name, flat, shapes)
                else:
                    write_checkpoint_file(directory, name, flat)
        except BaseException as e:      # surfaces at the next wait()
            if not self.async_save:
                raise
            self._error = e

    def save(self, trees: dict, step: int,
             metric_score: Optional[float] = None) -> str:
        """trees: {'params': module, 'opt': adam state or None, 'ema': ...}.
        With a dev ``metric_score``, also updates best/. Returns the path
        of the checkpoint (written once wait() returns, when async): its
        npz, or, sharded, this process's shard file."""
        self.wait()
        if self.sharded:
            # every process has written its earlier shards before the
            # primary evicts any of them
            dist.barrier()
        os.makedirs(self.output_best_dir, exist_ok=True)
        name = "model-%d" % int(step)
        flat, shapes = flat_tensors(trees), None
        if self.sharded:
            flat, shapes = sharded_members(flat, self.layout)
            path = os.path.join(self.output_dir, "%s.shard%d.npz"
                                % (name, dist.process_index()))
        else:
            path = os.path.join(self.output_dir, name + ".npz")
        if self.async_save:
            # the on-device snapshot: training goes on updating in place
            flat = {k: t.detach().clone() for k, t in flat.items()}
        directories = [self.output_dir]
        if self.sharded and not dist.is_primary():
            # the primary's decisions on the same inputs, no ledger file
            if metric_score is not None and metric_score > self.best_score:
                self.best_score = metric_score
            if self._topk_admit(name, metric_score):
                directories.append(self.output_best_dir)
            self._start_write(directories, name, flat, shapes)
            return path
        names = [n for n in _read_index(self.output_dir) if n != name] + [name]
        while len(names) > self.max_keep:
            _remove_files(_checkpoint_files(self.output_dir, names.pop(0)))
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
            directories.append(self.output_best_dir)
            keep = {n for n, _ in self.topk_scores}
            for fname in os.listdir(self.output_best_dir):
                base = _checkpoint_name(fname)
                if base is not None and base not in keep:
                    os.remove(os.path.join(self.output_best_dir, fname))
            _write_index(self.output_best_dir,
                         [n for n, _ in self.topk_scores])
            with open(os.path.join(self.output_best_dir, "topk_checkpoint"),
                      "w") as w:
                for n, s in self.topk_scores:
                    w.write("{}\t{}\n".format(n, s))
        self._start_write(directories, name, flat, shapes)
        return path

    def _start_write(self, directories, name, flat, shapes) -> None:
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(directories, name, flat, shapes),
                daemon=True)
            self._pending.start()
        else:
            self._write(directories, name, flat, shapes)

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
        """The latest checkpoint of ``path`` (or output_dir): its npz, or
        the meta file of a sharded one."""
        check_dir = path if (path and os.path.exists(path)) else self.output_dir
        names = _read_index(check_dir)
        if not names:
            return None
        base = os.path.join(check_dir, names[-1])
        if not os.path.exists(base + ".npz") and \
                os.path.exists(base + ".shardmeta.json"):
            return base + ".shardmeta.json"
        return base + ".npz"

    def restore(self, trees: dict, path: Optional[str] = None) -> bool:
        """Load the latest checkpoint of ``path`` (or output_dir) into
        ``{prefix: tree}`` in place; returns False (trees unchanged) when
        there is none. A sharded one is assembled on this device, except
        that under a ZeRO layout of as many processes as wrote it each
        process reads its own slices from its own file; a tensor held as
        a shard takes its slice of an assembled or monolithic leaf."""
        self.wait()
        ckpt = self.latest_path(path)
        if ckpt is None:
            log.warning("No existing model detected")
            return False
        prefixes = {p for p, tree in trees.items() if tree is not None}
        if ckpt.endswith(".shardmeta.json"):
            log.info("Restoring from sharded checkpoint %s", ckpt)
            base = ckpt[:-len(".shardmeta.json")]
            own = {}
            if self.layout is not None:
                held = flat_tensors(trees)
                own = {k: v for k, v in load_own_shards(
                    base, self.layout, prefixes).items()
                    if k in held and tuple(v.shape) == tuple(held[k].shape)}
            flat = load_sharded_checkpoint(base, prefixes, skip=own)
            flat.update(own)
        else:
            log.info("Restoring from %s", ckpt)
            flat = load_checkpoint_file(ckpt, prefixes)
        for prefix, tree in trees.items():
            if tree is not None:
                load_flat(tree, flat, prefix, self.layout)
        return True


def _checkpoint_name(fname: str) -> Optional[str]:
    """The checkpoint a file of a checkpoint directory belongs to (its npz,
    a shard file or the meta), None for any other file."""
    if fname.endswith(".shardmeta.json"):
        return fname[:-len(".shardmeta.json")]
    if fname.endswith(".npz"):
        return fname[:-4].split(".shard")[0]
    return None


def _remove_files(paths) -> None:
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
