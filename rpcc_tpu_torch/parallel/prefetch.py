"""Background-thread batch prefetcher for the datalist pipelines (port of
``rpcc_tpu/parallel/prefetch.py``, whose package imports jax).

A reader thread keeps up to ``depth`` loaded batches queued ahead of the
consumer, so file reads (fread releases the GIL) overlap device compute
and the entropy stage, and a pipeline pull never waits on the disk.  It
loads one rank's frames, given by their indices in the whole (already
``--skip_existing``-filtered) datalist, and a frame's seed is ``--seed``
plus that global index, as for one process.
"""

from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np

_SENTINEL = object()


def prefetch_loaded_batches(
    indices: Sequence[int],
    batch_size: int,
    load_fn: Callable[[int], np.ndarray],
    seed_base: int = 0,
    depth: int = 3,
    workers: int = 4,
) -> Iterator[Tuple[List[np.ndarray], List[int]]]:
    """Yield ``(clouds, seeds)`` for consecutive chunks of ``batch_size``
    of ``indices`` (a rank's global frame indices; ``range(n)`` for one
    process), with up to ``depth`` batches loaded ahead on a background
    thread.

    ``load_fn(index)`` loads the frame of a global index (error handling,
    e.g. --keep_going fallbacks, belongs inside it).  A frame's seed is
    ``seed_base`` plus its global index, whichever rank encodes it, so its
    bytes do not depend on the number of ranks.
    """
    n = len(indices)
    if n == 0:
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    pool = futures.ThreadPoolExecutor(max(1, workers))
    abandoned = threading.Event()  # consumer gone: stop loading, drop batches

    def _put(item) -> bool:
        """put that gives up when the consumer abandoned the generator —
        otherwise the reader would block forever on the bounded queue,
        pinning up to ``depth`` loaded batches (~125 MB each at KITTI
        batch-64) and its pool for the process lifetime."""
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def reader() -> None:
        try:
            for start in range(0, n, batch_size):
                if abandoned.is_set():
                    return
                chunk = indices[start : start + batch_size]
                clouds = list(pool.map(load_fn, chunk))
                if not _put((clouds, [seed_base + i for i in chunk])):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # surface in the consumer, not the thread
            _put(e)
        finally:
            pool.shutdown(wait=False)

    t = threading.Thread(target=reader, daemon=True, name="datalist-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # Runs on exhaustion, on a consumer-side exception, and on early
        # generator close (GeneratorExit) — unblocks and retires the reader.
        abandoned.set()
