"""Batch decompression over a datalist of .rpcc files.

Usage:
    python -m rpcc_tpu_torch.cli.decompress_datalist --datalist list.txt \
        --output_dir rec/ --lidar Velodyne64E --device cuda \
        [--decode_backend host|device --batch 8 --workers 4 --skip_existing --keep_going]

Reads each bitstream, decodes it in batches and writes the reconstructed
cloud as .bin (float32 x, y, z, 0 rows; points at the origin dropped),
mirroring the input paths under ``--output_dir``.  ``--decode_backend
host`` (the default) reconstructs on the host with the native decoder;
``device`` runs the batched decoder graph on ``--device``.  Both write the
same floats.  The configuration flags must match the ones the frames were
compressed with.
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import os
import time

import numpy as np

from rpcc_tpu_torch.cli.common import add_codec_args, config_from_args, device_from_args, lidar_from_args
from rpcc_tpu_torch.cli.compress_datalist import _mirror_path, output_path_for


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_batch_async(io_pool, names, write_one, keep_going: bool):
    """Submit one decoded batch's writes on the IO pool, with per-frame
    failure isolation.  Returns ``drain() -> number written``; the caller
    drains the previous batch after dispatching the next, so one batch of
    writes is in flight while the next one decodes."""

    def safe(i: int):
        try:
            write_one(i)
            return None
        except Exception as e:  # noqa: BLE001 — isolate, report, re-raise in drain
            return (names[i], e)

    futs = [io_pool.submit(safe, i) for i in range(len(names))]

    def drain() -> int:
        fails = [r for r in (f.result() for f in futs) if r is not None]
        for name, err in fails:
            print(f"ERROR writing output for {name}: {err}")
        if fails and not keep_going:
            raise fails[0][1]
        return len(names) - len(fails)

    return drain


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser, datalist=True)
    parser.add_argument("--decode_backend", choices=("device", "host"), default="host",
                        help="host (default): native C++ reconstruction; device: the batched "
                        "decoder graph on --device.")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    lidar = lidar_from_args(args)

    from rpcc_tpu_torch.data import read_datalist

    file_list = read_datalist(args.datalist)
    for fp in file_list:
        if fp.split(".")[-1] != "rpcc":
            raise ValueError(f"expected .rpcc input, got {fp}")
    if args.skip_existing:
        before = len(file_list)
        file_list = [f for f in file_list if not os.path.exists(_mirror_path(f, args.output_dir, "bin"))]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")
    name_batches = [file_list[s : s + args.batch] for s in range(0, len(file_list), args.batch)]
    io_pool = futures.ThreadPoolExecutor(args.workers)
    done = 0
    pending = None

    def queue_writes(names, pts) -> None:
        nonlocal done, pending

        def write(i: int) -> None:
            np.ascontiguousarray(pts[i], "<f4").tofile(output_path_for(names[i], args.output_dir, "bin"))

        if pending is not None:
            done += pending()
        pending = _write_batch_async(io_pool, names, write, args.keep_going)

    if args.decode_backend == "host":
        from rpcc_tpu_torch.models.host_decoder import HostDecoder

        decode = HostDecoder(lidar, cfg).decode_blobs_points
        engine = None
    else:
        from rpcc_tpu_torch.parallel.engine import BatchEngine

        engine = BatchEngine(lidar, cfg, device_from_args(args), batch_size=args.batch, workers=args.workers)
        decode = engine.decode_blobs_points

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
        done += pending()
    if engine is not None:
        engine.close()
    dt = time.time() - t0
    print(f"\nDecompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s)")


if __name__ == "__main__":
    main()
