"""Native (C++) host-runtime components, loaded through ctypes.

Counterpart of ``zero_tpu/native``: the corpus tokeniser (tokenizer.cpp,
a copy of the JAX package's) in place of the first pure-python pass over
a training corpus (data.py:Dataset._tokenize_serial, or the forked
_tokenize_parallel).

The shared library is built on first use with g++ (-O3, ~2 s) into the
package's git-ignored ``_build/``, keyed by a hash of the source. Every
entry point falls back to the python path, with a warning, when the
toolchain or library is unavailable (``available()`` -> False), and
``encode_corpus`` returns None on a file it cannot read or on invalid
UTF-8 (the python path then gives the same ids, or raises).
``calls["encode_corpus"]`` counts the corpora the library tokenised.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("zero_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(__file__), "tokenizer.cpp")
# the package's git-ignored build directory (the CUDA kernels' too)
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

# corpora tokenised by the native library (the python fallback does not
# count): the proof that the native path ran
calls: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_lib() -> Optional[str]:
    """Compile tokenizer.cpp into a cached .so; returns its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_CACHE_DIR, f"tokenizer_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_CACHE_DIR, exist_ok=True)
    # build into a temp name then rename: concurrent processes race here
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("native tokeniser build failed (%s); "
                       "falling back to python", exc)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so_path = _build_lib()
    if so_path is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as exc:
        logger.warning("native tokeniser load failed (%s)", exc)
        _lib_failed = True
        return None
    lib.zt_vocab_load.restype = ctypes.c_void_p
    lib.zt_vocab_load.argtypes = [ctypes.c_char_p]
    lib.zt_vocab_size.restype = ctypes.c_int64
    lib.zt_vocab_size.argtypes = [ctypes.c_void_p]
    lib.zt_vocab_free.argtypes = [ctypes.c_void_p]
    lib.zt_encode_corpus.restype = ctypes.c_void_p
    lib.zt_encode_corpus.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32]
    lib.zt_corpus_n_pairs.restype = ctypes.c_int64
    lib.zt_corpus_n_pairs.argtypes = [ctypes.c_void_p]
    for name in ("zt_corpus_src_ids", "zt_corpus_tgt_ids"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int32)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("zt_corpus_src_off", "zt_corpus_tgt_off"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.zt_corpus_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built/loadable on this host."""
    return _load() is not None


def encode_corpus(src_file: str, tgt_file: str,
                  src_vocab_file: str, tgt_vocab_file: str,
                  max_len: int, n_threads: int = 0,
                  ) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
    """Tokenise a parallel corpus natively.

    Returns [(src_ids, tgt_ids), ...] with int32 numpy views into two
    flat buffers (zero-copy), exactly matching the python
    Dataset._tokenize_serial output (same ids, same skip/truncate/eos
    rules). None when the native path is unavailable or a file can't be
    read -- callers fall back to python.
    """
    lib = _load()
    if lib is None:
        return None
    sv = lib.zt_vocab_load(src_vocab_file.encode())
    tv = lib.zt_vocab_load(tgt_vocab_file.encode()) if \
        tgt_vocab_file != src_vocab_file else sv
    if not sv or not tv:
        for h in {sv, tv}:
            if h:
                lib.zt_vocab_free(h)
        return None
    try:
        corpus = lib.zt_encode_corpus(
            src_file.encode(), tgt_file.encode(), sv, tv,
            int(max_len), int(n_threads))
    finally:
        lib.zt_vocab_free(sv)
        if tv != sv:
            lib.zt_vocab_free(tv)
    if not corpus:
        return None
    calls["encode_corpus"] += 1
    try:
        n = lib.zt_corpus_n_pairs(corpus)
        src_off = np.ctypeslib.as_array(lib.zt_corpus_src_off(corpus),
                                        (n + 1,))
        tgt_off = np.ctypeslib.as_array(lib.zt_corpus_tgt_off(corpus),
                                        (n + 1,))
        # copy out of the C++ heap so the handle can be freed here
        src_ids = np.ctypeslib.as_array(lib.zt_corpus_src_ids(corpus),
                                        (int(src_off[-1]),)).copy()
        tgt_ids = np.ctypeslib.as_array(lib.zt_corpus_tgt_ids(corpus),
                                        (int(tgt_off[-1]),)).copy()
        src_off = src_off.copy()
        tgt_off = tgt_off.copy()
    finally:
        lib.zt_corpus_free(corpus)
    return [(src_ids[src_off[i]:src_off[i + 1]],
             tgt_ids[tgt_off[i]:tgt_off[i + 1]]) for i in range(n)]
