"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into a shared
library with a plain C interface, ``zero_tpu_torch/_build/lib<name>_<tag>.so``
(git-ignored), where the tag hashes the source and the shared headers
(``csrc/*.cuh``). A library of the same tag is reused. ptxas' register and
shared-memory report goes beside it as ``<lib>.log``. ``build`` starts one
``nvcc`` per missing library, all at once, and waits for them; ``load``
builds on first use (never at import) and opens the library with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

# every kernel source of the port, csrc/<name>.cu
SOURCES = ("decode_attention", "fused_attention", "fused_attention_rpr",
           "fused_ffn", "streaming_attention")

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels cannot be built")
    return path


def source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [source(name)] + sorted(glob.glob(os.path.join(CSRC,
                                                                "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name,
                                                     digest.hexdigest()[:16]))


def build(*names: str) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process each, all running at once; returns {name: library path}."""
    libs = {name: library_path(name) for name in names}
    todo = {n: lib for n, lib in libs.items() if not os.path.exists(lib)}
    if not todo:
        return libs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, lib in todo.items():
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-I", CSRC, "-o", tmp, source(name)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors: List[str] = []
    for name, lib, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append("nvcc failed on %s.cu (%d):\n%s"
                          % (name, proc.returncode, err))
            continue
        with open(lib + ".log", "w") as w:
            w.write(err)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name)[name])


def ptxas_report(name: str) -> List[str]:
    """The register/shared-memory lines of the library's ptxas log."""
    with open(library_path(name) + ".log") as r:
        return [line.strip() for line in r
                if "registers" in line or "smem" in line]
