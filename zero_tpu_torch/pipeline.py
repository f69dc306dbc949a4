"""Host->device feed: background prefetching over the Dataset batcher.

A copy of ``zero_tpu/pipeline.py`` (the port imports nothing of the JAX
package). The JAX package's notes on it follow.

Replaces the reference's multiprocessing EnQueuer (utils/queuer.py:15-127,
whose README flags "Problems Exist") with a bounded-queue daemon thread:
batch *assembly* is numpy-light, so a thread overlaps it with device
compute without fork/pickle races. CPU-heavy first-epoch *tokenisation* is
parallelised separately with worker processes inside Dataset.load_data
(data.py), which is where the time actually goes -- the reference's
EnQueuer parallelised the whole batcher instead and the README flags the
problems. A passthrough mode mirrors ``worker_processes_num == 0``
(utils/queuer.py:58-66).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

_DONE = object()


class Prefetcher:
    """Iterate a generator on a daemon thread through a bounded queue.

    ``close()`` stops the worker promptly (it re-checks a stop flag around
    every queue put), so an abandoned iteration (early break from training)
    does not keep consuming the underlying generator -- important because
    Dataset generators share leak-buffer state across epochs.
    """

    def __init__(self, gen_fn: Callable[[], Iterator], maxsize: int = 100,
                 background: bool = True):
        self._gen_fn = gen_fn
        self._maxsize = maxsize
        self._passthrough = not background
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        """Bounded put that gives up when close() was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for item in self._gen_fn():
                if not self._put(item):
                    return
        except BaseException as e:  # surface errors on the consumer side
            self._error = e
        finally:
            self._put(_DONE)

    def close(self) -> None:
        """Stop the worker and drop queued items."""
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __iter__(self):
        if self._passthrough:
            yield from self._gen_fn()
            return
        self._queue = queue.Queue(maxsize=self._maxsize)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is _DONE:
                break
            yield item
        if self._error is not None:
            raise self._error
