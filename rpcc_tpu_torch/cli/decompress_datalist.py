"""Batch decompression over a datalist of .rpcc files.

Usage:
    python -m rpcc_tpu_torch.cli.decompress_datalist --datalist list.txt \
        --output_dir rec/ --lidar Velodyne64E --device cuda \
        [--decode_backend device|host --batch 8 --workers 4 --skip_existing --keep_going --num_devices N]

Reads each bitstream, decodes it in batches and writes the reconstructed
cloud as .bin (float32 x, y, z, 0 rows; points at the origin dropped),
mirroring the input paths under ``--output_dir``.  ``--decode_backend
device`` (the default) runs the batched decoder graph on ``--device``,
the card unless the CPU is asked for, and decodes the rANS containers
there (on a card, the decode kernel); ``host`` decodes and reconstructs on
the host with the native coder and decoder, in one process.  Both write
the same floats.  With more than one device (``--num_devices``; by
default every visible card) the device backend runs one engine process
per device, each on its share of every global batch
(``parallel/mesh.py::rank_frames``), and sums the totals with one
``all_reduce``.  The configuration flags must match
the ones the frames were compressed with.
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import os
import time

import numpy as np

from rpcc_tpu_torch.cli.common import (
    add_codec_args,
    config_from_args,
    devices_from_args,
    lidar_from_args,
    run_ranks,
)
from rpcc_tpu_torch.cli.compress_datalist import _kernel_launches, _mirror_path, output_path_for


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_batch_async(io_pool, names, write_one, keep_going: bool):
    """Submit one decoded batch's writes on the IO pool, with per-frame
    failure isolation.  Returns ``drain() -> the positions written``; the
    caller drains the previous batch after dispatching the next, so one
    batch of writes is in flight while the next one decodes."""

    def safe(i: int):
        try:
            write_one(i)
            return None
        except Exception as e:  # noqa: BLE001 — isolate, report, re-raise in drain
            return (names[i], e)

    futs = [io_pool.submit(safe, i) for i in range(len(names))]

    def drain() -> list:
        results = [f.result() for f in futs]
        fails = [r for r in results if r is not None]
        for name, err in fails:
            print(f"ERROR writing output for {name}: {err}")
        if fails and not keep_going:
            raise fails[0][1]
        return [i for i, r in enumerate(results) if r is None]

    return drain


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser, datalist=True)
    parser.add_argument("--decode_backend", choices=("device", "host"), default="device",
                        help="device (default): the batched decoder graph on --device; host: native C++ "
                        "reconstruction, in one process.")
    return parser


def main(argv=None) -> list:
    """-> each rank's :func:`decompress_rank` result."""
    args = build_parser().parse_args(argv)
    config_from_args(args)
    lidar_from_args(args)  # flag errors surface here, before any rank starts

    from rpcc_tpu_torch.data import read_datalist

    file_list = read_datalist(args.datalist)
    for fp in file_list:
        if fp.split(".")[-1] != "rpcc":
            raise ValueError(f"expected .rpcc input, got {fp}")
    if args.skip_existing:
        before = len(file_list)
        file_list = [f for f in file_list if not os.path.exists(_mirror_path(f, args.output_dir, "bin"))]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")
    devices = devices_from_args(args) if args.decode_backend == "device" else [None]
    return run_ranks(decompress_rank, devices, args, file_list)


def decompress_rank(rank: int, world: int, device, args: argparse.Namespace, file_list, t_launch: float) -> dict:
    """Decode and write rank ``rank``'s frames of ``file_list`` (of
    ``world``; ``parallel/mesh.py::rank_frames``) on ``device`` (unused by
    the host backend; ``t_launch`` is unused).  With a process group the totals (frames written,
    their points and input bits, errors) are summed over the ranks by the
    engine's ``sharded_stats``, and rank 0 prints the summary line.  -> the
    summed report, the wall seconds from the start (the group's barrier) to
    the totals, and the kernel launches this rank made."""
    import torch.distributed as dist

    from rpcc_tpu_torch.parallel.aggregate import batch_report, batch_totals
    from rpcc_tpu_torch.parallel.mesh import rank_frames

    cfg = config_from_args(args)
    lidar = lidar_from_args(args)
    group = dist.group.WORLD if dist.is_initialized() else None
    b, indices = rank_frames(len(file_list), args.batch, rank, world)
    launches0 = _kernel_launches()
    name_batches = [[file_list[i] for i in indices[s : s + b]] for s in range(0, len(indices), b)]
    if args.decode_backend == "host":
        from rpcc_tpu_torch.models.host_decoder import HostDecoder

        decode = HostDecoder(lidar, cfg).decode_blobs_points
        engine = None
    else:
        from rpcc_tpu_torch.parallel.engine import BatchEngine

        engine = BatchEngine(lidar, cfg, device, batch_size=b, workers=args.workers, group=group)
        decode = engine.decode_blobs_points
    io_pool = futures.ThreadPoolExecutor(args.workers)
    points, sizes = [], []
    pending = None

    def count(names, pts, drain) -> None:
        for i in drain():
            points.append(len(pts[i]))
            sizes.append(os.path.getsize(names[i]))

    def queue_writes(names, pts) -> None:
        nonlocal pending

        def write(i: int) -> None:
            np.ascontiguousarray(pts[i], "<f4").tofile(output_path_for(names[i], args.output_dir, "bin"))

        if pending is not None:
            count(*pending)
        pending = (names, pts, _write_batch_async(io_pool, names, write, args.keep_going))

    if group is not None:
        dist.barrier(group)
    t0 = time.time()  # after start-up, as in compress_datalist
    if engine is None or args.keep_going:
        # One batch at a time, so a corrupt bitstream only skips its batch.
        for names in name_batches:
            try:
                pts = decode(list(io_pool.map(_read_bytes, names)))
            except Exception as e:
                if not args.keep_going:
                    raise
                print(f"ERROR decoding batch at {names[0]}: {e}")
                continue
            queue_writes(names, pts)
    else:
        # Throughput path: the engine's pipeline, one write batch in flight.
        blob_batches = ([_read_bytes(fp) for fp in names] for names in name_batches)
        for names, pts in zip(name_batches, engine.decode_pipeline(blob_batches)):
            queue_writes(names, pts)
    if pending is not None:
        count(*pending)
    errors = len(indices) - len(points)
    if group is None:
        rep = {**batch_report(batch_totals(points, sizes)), "errors": errors}
    else:
        rep = engine.sharded_stats(points, sizes, errors)
    dt = time.time() - t0
    if engine is not None:
        engine.close()
    if rank == 0:
        done = rep["frames"]
        print(f"\nDecompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s)"
              + (f", {rep['errors']} errors" if rep["errors"] else ""))
    launches = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    return dict(report=rep, seconds=dt, launches=launches)


if __name__ == "__main__":
    main()
