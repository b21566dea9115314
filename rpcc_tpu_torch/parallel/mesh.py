"""Data parallelism over devices: one process per device (port of
``rpcc_tpu/parallel/mesh.py``).

The JAX package shards each batch over a 1-D mesh inside one program.
Here each device gets a process of its own with its own
:class:`~rpcc_tpu_torch.parallel.engine.BatchEngine`, joined to a
``torch.distributed`` process group: one Python process driving N cards
would run N dispatch threads under one interpreter lock, and the engine is
bound by the host's launch rate.  The frames split as the mesh splits a
batch (:func:`rank_frames`), and the only collective is the one
``all_reduce`` of the stats (:mod:`rpcc_tpu_torch.parallel.aggregate`).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def data_devices(num_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The first ``num_devices`` devices of a kind: ``cuda:0 .. cuda:n-1``
    (``None``: every visible card), or ``n`` CPU devices for ``"cpu"``
    (``None``: one).

    Raises when the request cannot be met, as ``data_mesh`` does: running
    fewer ranks than asked for would size each rank's share of a batch
    wrongly."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"data_devices takes cuda or cpu devices, got {device!r}")
    visible = torch.cuda.device_count() if kind == "cuda" else None
    n = (visible if kind == "cuda" else 1) if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"data_devices needs >= 1 device, got {num_devices}")
    if visible is not None and n > visible:
        raise ValueError(f"data_devices({num_devices}) but only {visible} CUDA device(s) visible")
    return [torch.device("cuda", i) for i in range(n)] if kind == "cuda" else [torch.device("cpu")] * n


def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank holds a CUDA device of its own, else
    ``gloo`` (CPU ranks, or several ranks on one card, which NCCL
    refuses)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def rank_frames(n: int, global_batch: int, rank: int, world: int) -> Tuple[int, List[int]]:
    """-> (b, the frame indices of ``rank``) for ``n`` frames split over
    ``world`` ranks at a global batch of ``global_batch``.

    Each rank's batch is ``b = ceil(global_batch / world)``, as the mesh
    rounds a batch up to a multiple of its devices.  Global batch k covers
    frames ``[k b world, (k + 1) b world)`` and rank r takes
    ``[k b world + r b, k b world + (r + 1) b)`` of them, so chunks of b of
    the returned indices are the rank's batches; only the last can be short
    or missing."""
    if global_batch < 1 or not 0 <= rank < world:
        raise ValueError(f"need global_batch >= 1 and 0 <= rank < world, got {global_batch}, {rank}, {world}")
    b = -(-global_batch // world)
    step = b * world
    return b, [i for k in range(0, n, step) for i in range(k + rank * b, min(k + (rank + 1) * b, n))]


def _rank_main(rank: int, fn: Callable, devices: List[torch.device], workdir: str, args: tuple) -> None:
    """One rank: bind its device, join the group, run ``fn``, and leave its
    result in ``workdir`` for the launcher."""
    import torch.distributed as dist

    # Every rank runs on this host: the transports bind to loopback and
    # never need the host name to resolve.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(devices), init_method="file://" + os.path.join(workdir, "init"),
                            rank=rank, world_size=len(devices))
    try:
        result = fn(rank, len(devices), device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_data_parallel(fn: Callable, devices: Sequence, *args) -> list:
    """Run ``fn(rank, world, device, *args)`` in one spawned process per
    entry of ``devices``, each joined to one ``torch.distributed`` group
    (even a world of one), and -> their return values in rank order.

    ``fn`` must be importable by name (a module-level function of the
    package): a spawned process imports it afresh.  The backend follows
    :func:`backend_for` and is printed; a backend that fails to start fails
    the run.  A rank that raises makes this raise with its traceback, after
    the other ranks are stopped."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("run_data_parallel needs >= 1 device")
    print(f"data parallel: {len(devices)} rank(s) on {[str(d) for d in devices]}, backend {backend_for(devices)}",
          flush=True)
    workdir = tempfile.mkdtemp(prefix="rpcc_ranks_")  # a fresh rendezvous file for each run
    try:
        mp.spawn(_rank_main, args=(fn, devices, workdir, args), nprocs=len(devices), join=True)
        results = []
        for rank in range(len(devices)):
            with open(os.path.join(workdir, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by the ranks above
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
