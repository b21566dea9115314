"""Batch compression over a datalist.

Usage:
    python -m rpcc_tpu_torch.cli.compress_datalist --datalist list.txt \
        --output_dir out/ --lidar Velodyne64E --device cuda \
        [--batch 8 --workers 4 --skip_existing --keep_going --output --eval --num_devices N]

Frames are loaded by IO threads, encoded in (B, H, W) batches on the device
(:class:`rpcc_tpu_torch.parallel.engine.BatchEngine`), entropy-coded on a
host pool, and written mirroring the input paths under ``--output_dir``
with the ``.rpcc`` suffix.  Frame i of the list being compressed is encoded
with seed ``--seed + i``, as in ``rpcc_tpu``'s datalist CLI.  ``--eval``
decodes each written batch on the engine and prints one quality line per
frame against the encoder's own range image.

With more than one device (``--num_devices``; by default every visible
card) one engine process runs per device, each on its share of every
global batch of ``--batch`` frames (``parallel/mesh.py::rank_frames``);
a frame's bytes do not depend on the number of processes.  Their totals
are summed with one ``all_reduce`` and the first prints the summary.
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
    error_bound,
    lidar_from_args,
    quality,
    run_ranks,
)


def output_path_for(file_name: str, output_dir: str, suffix: str) -> str:
    """Mirror the input path under output_dir with the given suffix, and
    make its directory.  Only the trailing extension is replaced (the
    original tool's ``replace`` also rewrote a directory named like the
    extension, e.g. ``bin/``)."""
    out = _mirror_path(file_name, output_dir, suffix)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    return out


def _mirror_path(file_name: str, output_dir: str, suffix: str) -> str:
    # Normalize and strip every leading slash and any '..' segments so a
    # datalist entry like '//srv/data/a.bin' or '../x/a.bin' can never make
    # the mirrored output escape --output_dir (os.path.join discards
    # output_dir entirely when the right side is absolute).
    file_name = os.path.normpath(file_name.strip()).lstrip(os.sep)
    parts = [p for p in file_name.split(os.sep) if p not in ("..", "")]
    out = os.path.join(output_dir, *parts) if parts else output_dir
    root, _ = os.path.splitext(out)
    return root + "." + suffix


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser, datalist=True)
    return parser


LAUNCH_COUNTERS = {"fps": "launch.fps", "dbscan": "launch.dbscan", "rans": "launch.rans_encode",
                   "rans_decode": "launch.rans_decode"}


def _kernel_launches() -> dict:
    """This process's launch counts of the CUDA kernels, by kernel (the
    counters of ``utils/timer.py``)."""
    from rpcc_tpu_torch.utils import timer

    now = timer.counters()
    return {k: now.get(name, 0) for k, name in LAUNCH_COUNTERS.items()}


def main(argv=None) -> list:
    """-> each rank's :func:`compress_rank` result."""
    args = build_parser().parse_args(argv)
    config_from_args(args)
    lidar_from_args(args)  # flag errors surface here, before any rank starts

    from rpcc_tpu_torch.data import read_datalist

    file_list = read_datalist(args.datalist)
    if args.skip_existing:
        before = len(file_list)
        file_list = [f for f in file_list if not os.path.exists(_mirror_path(f, args.output_dir, "rpcc"))]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")
    return run_ranks(compress_rank, devices_from_args(args), args, file_list)


def compress_rank(rank: int, world: int, device, args: argparse.Namespace, file_list, t_launch: float) -> dict:
    """Encode and write rank ``rank``'s frames of ``file_list`` (of
    ``world``; ``parallel/mesh.py::rank_frames``) on ``device``.  With a
    process group the totals are summed over the ranks by the engine's
    ``sharded_stats``, and rank 0 prints the summary line.  -> the summed
    report (with ``errors``), the wall seconds from the start (the group's
    barrier) to the totals, this rank's start-up seconds since
    ``t_launch`` (to this function's start, and to the barrier), the wall
    clock around the reduce and at each batch written (with its frames),
    and the kernel launches this rank made."""
    t_entry = time.time()
    import torch.distributed as dist

    from rpcc_tpu_torch.data.pointcloud_io import load_point_cloud_f32
    from rpcc_tpu_torch.parallel.aggregate import batch_report, batch_totals
    from rpcc_tpu_torch.parallel.engine import BatchEngine
    from rpcc_tpu_torch.parallel.mesh import rank_frames
    from rpcc_tpu_torch.parallel.prefetch import prefetch_loaded_batches

    cfg = config_from_args(args)
    group = dist.group.WORLD if dist.is_initialized() else None
    b, indices = rank_frames(len(file_list), args.batch, rank, world)
    launches0 = _kernel_launches()
    engine = BatchEngine(lidar_from_args(args), cfg, device, batch_size=b, workers=args.workers, group=group)
    io_pool = futures.ThreadPoolExecutor(args.workers)
    failed_loads: set = set()  # indices whose load failed (--keep_going)

    def load(idx: int):
        try:
            return load_point_cloud_f32(file_list[idx])
        except Exception as e:  # failure isolation (--keep_going)
            if not args.keep_going:
                raise
            failed_loads.add(idx)
            print(f"ERROR loading {file_list[idx]}: {e}")
            # A placeholder keeps the batch whole; its output is never
            # written: a dummy .rpcc at the real path would be skipped
            # forever by a --skip_existing resume.
            return np.zeros((1, 3), np.float32)

    errors = 0
    points, sizes = [], []

    def write(idxs, results) -> list:
        """Write a batch's blobs; -> the batch positions written."""
        nonlocal errors
        written = []
        for j, ((blob, _), idx) in enumerate(zip(results, idxs)):
            name = file_list[idx]
            if idx in failed_loads:
                errors += 1  # load already logged; no output written
                continue
            try:
                path = output_path_for(name, args.output_dir, "rpcc")
                with open(path, "wb") as f:
                    f.write(blob)
            except Exception as e:
                if not args.keep_going:
                    raise
                errors += 1
                print(f"ERROR writing output for {name}: {e}")
                continue
            written.append(j)
            n_pts = max(int(results.stream_len[j]), 1)  # live residuals = nonzero points
            points.append(n_pts)
            sizes.append(len(blob))
            if args.output:
                print(f"binary bitstream save in {path}  BPP: {len(blob) * 8 / n_pts:.4f}  "
                      f"ratio: {(n_pts * 96) / (len(blob) * 8):.2f}")
        return written

    batches = [indices[s : s + b] for s in range(0, len(indices), b)]
    marks = []  # (wall clock, frames) as each batch is written
    startup_s = time.time() - t_launch
    if group is not None:
        dist.barrier(group)
    t0 = time.time()
    if args.output or args.eval:
        # Diagnostic path: one batch at a time with per-stage times (and
        # quality lines); batch i+1 is dispatched before batch i is
        # downloaded and coded.
        pending = None
        for idxs in batches:
            t_l = time.time()
            clouds = list(io_pool.map(load, idxs))
            load_s = time.time() - t_l
            fut = engine.encode_batch_async(clouds, [cfg.seed + i for i in idxs])
            if pending is not None:
                _drain(engine, write, args, file_list, *pending)
                marks.append((time.time(), len(pending[1])))
            pending = (fut, idxs, load_s)
        if pending is not None:
            _drain(engine, write, args, file_list, *pending)
            marks.append((time.time(), len(pending[1])))
    else:
        # Throughput path: the engine's 4-stage pipeline fed by a background
        # prefetcher, so disk reads never stall a pipeline pull.
        gen = prefetch_loaded_batches(indices, b, load, seed_base=cfg.seed, workers=args.workers)
        for idxs, results in zip(batches, engine.encode_pipeline(gen)):
            write(idxs, results)
            marks.append((time.time(), len(idxs)))
    t_reduce = time.time()
    if group is None:
        rep = {**batch_report(batch_totals(points, sizes)), "errors": errors}
    else:
        rep = engine.sharded_stats(points, sizes, errors)
    t_end = time.time()
    dt = t_end - t0
    engine.close()
    if rank == 0:
        done = rep["frames"]
        print(f"\nCompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s), "
              f"BPP {rep['bpp']:.4f}, ratio {rep['ratio']:.2f}" + (f", {rep['errors']} errors" if rep["errors"] else ""))
    launches = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    return dict(report=rep, seconds=dt, entry_s=t_entry - t_launch, startup_s=startup_s, reduce=(t_reduce, t_end),
                marks=marks, launches=launches)


def _drain(engine, write, args, file_list, fut, idxs, load_s: float) -> None:
    """Download, entropy-code and write one dispatched batch, with its
    per-frame host times (``--output``) and quality lines (``--eval``)."""
    dispatched = fut.result()
    t_f = time.time()
    results = engine.finalize_encoded(dispatched)
    entropy_s = time.time() - t_f
    t_w = time.time()
    written = write(idxs, results)
    names = [file_list[i] for i in idxs]
    if args.output:
        per = 1000.0 / max(len(names), 1)
        print(f"Time cost (per frame, batch of {len(names)}): load {load_s * per:.2f} ms | "
              f"entropy+download {entropy_s * per:.2f} ms | write {(time.time() - t_w) * per:.2f} ms")
    if args.eval and written:
        # Against the encoder's own range images; the decode is exact, so
        # the bound has no snap term.
        ris = dispatched.out.range_image.cpu().numpy()
        recs = engine.decode_range_images([results[j][0] for j in written])
        bound = error_bound(engine.cfg)
        for j, rec in zip(written, recs):
            q = quality(ris[j], rec, engine.transform_map, engine.device)
            status = "OK" if q["max_err"] <= bound + 1e-5 else "RECONSTRUCTION ERROR"
            print(f"eval {names[j]}: depth error mean {q['mean_err']:.6f} max {q['max_err']:.5f} "
                  f"(bound {bound:.5f}) chamfer {q['chamfer']:.6f} F1 {q['f1']:.4f} "
                  f"p2p_psnr {q['p2p']:.2f} p2plane_psnr {q['p2plane']:.2f} {status}")


if __name__ == "__main__":
    main()
