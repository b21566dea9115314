"""Background-thread batch prefetcher for the datalist pipelines (a copy of
``rpcc_tpu/parallel/prefetch.py``, whose package imports jax).

A reader thread keeps up to ``depth`` loaded batches queued ahead of the
consumer, so file reads (fread releases the GIL) overlap device compute
and the entropy stage, and a pipeline pull never waits on the disk.
"""

from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np

_SENTINEL = object()


def prefetch_loaded_batches(
    files: Sequence[str],
    batch_size: int,
    load_fn: Callable[[int], np.ndarray],
    seed_base: int = 0,
    depth: int = 3,
    workers: int = 4,
) -> Iterator[Tuple[List[np.ndarray], range]]:
    """Yield ``(clouds, seeds)`` batches with up to ``depth`` batches loaded
    ahead on a background thread.

    ``load_fn(index)`` loads one cloud (error handling — e.g. --keep_going
    fallbacks — belongs inside it).  ``seeds`` for batch starting at file
    index ``s`` is ``range(seed_base + s, seed_base + s + len(batch))``,
    matching the synchronous generators this replaces.
    """
    n = len(files)
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
                stop = min(start + batch_size, n)
                clouds = list(pool.map(load_fn, range(start, stop)))
                if not _put((clouds, range(seed_base + start, seed_base + stop))):
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
