"""Batch compression over a datalist.

Usage:
    python -m rpcc_tpu_torch.cli.compress_datalist --datalist list.txt \
        --output_dir out/ --lidar Velodyne64E --device cuda \
        [--batch 8 --workers 4 --skip_existing --keep_going --output --eval]

Frames are loaded by IO threads, encoded in (B, H, W) batches on the device
(:class:`rpcc_tpu_torch.parallel.engine.BatchEngine`), entropy-coded on a
host pool, and written mirroring the input paths under ``--output_dir``
with the ``.rpcc`` suffix.  Frame i of the list being compressed is encoded
with seed ``--seed + i``, as in ``rpcc_tpu``'s datalist CLI.  ``--eval``
decodes each written batch on the engine and prints one quality line per
frame against the encoder's own range image.
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
    device_from_args,
    error_bound,
    lidar_from_args,
    quality,
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser, datalist=True)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    lidar = lidar_from_args(args)

    from rpcc_tpu_torch.data import read_datalist
    from rpcc_tpu_torch.data.pointcloud_io import load_point_cloud_f32
    from rpcc_tpu_torch.parallel.aggregate import batch_report, batch_totals
    from rpcc_tpu_torch.parallel.engine import BatchEngine
    from rpcc_tpu_torch.parallel.prefetch import prefetch_loaded_batches

    file_list = read_datalist(args.datalist)
    if args.skip_existing:
        before = len(file_list)
        file_list = [f for f in file_list if not os.path.exists(_mirror_path(f, args.output_dir, "rpcc"))]
        print(f"--skip_existing: {before - len(file_list)} done, {len(file_list)} to go")
    n = len(file_list)
    engine = BatchEngine(lidar, cfg, device_from_args(args), batch_size=args.batch, workers=args.workers)
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

    done = errors = 0
    points, sizes = [], []

    def write(bi: int, results, names) -> list:
        """Write a batch's blobs; -> the batch indices written."""
        nonlocal done, errors
        written = []
        for j, ((blob, _), name) in enumerate(zip(results, names)):
            if bi * args.batch + j in failed_loads:
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
            done += 1
            written.append(j)
            n_pts = max(int(results.stream_len[j]), 1)  # live residuals = nonzero points
            points.append(n_pts)
            sizes.append(len(blob))
            if args.output:
                print(f"binary bitstream save in {path}  BPP: {len(blob) * 8 / n_pts:.4f}  "
                      f"ratio: {(n_pts * 96) / (len(blob) * 8):.2f}")
        return written

    name_batches = [file_list[s : s + args.batch] for s in range(0, n, args.batch)]
    t0 = time.time()
    if args.output or args.eval:
        # Diagnostic path: one batch at a time with per-stage times (and
        # quality lines); batch i+1 is dispatched before batch i is
        # downloaded and coded.
        pending = None
        for bi, names in enumerate(name_batches):
            start = bi * args.batch
            t_l = time.time()
            clouds = list(io_pool.map(load, range(start, start + len(names))))
            load_s = time.time() - t_l
            fut = engine.encode_batch_async(clouds, [cfg.seed + start + i for i in range(len(clouds))])
            if pending is not None:
                _drain(engine, write, args, *pending)
            pending = (fut, bi, names, load_s)
        if pending is not None:
            _drain(engine, write, args, *pending)
    else:
        # Throughput path: the engine's 4-stage pipeline fed by a background
        # prefetcher, so disk reads never stall a pipeline pull.
        gen = prefetch_loaded_batches(file_list, args.batch, load, seed_base=cfg.seed, workers=args.workers)
        for bi, (names, results) in enumerate(zip(name_batches, engine.encode_pipeline(gen))):
            write(bi, results, names)
    dt = time.time() - t0
    engine.close()
    rep = batch_report(batch_totals(points, sizes))
    print(f"\nCompressed {done} frames in {dt:.2f}s ({done / dt:.2f} frames/s), "
          f"BPP {rep['bpp']:.4f}, ratio {rep['ratio']:.2f}" + (f", {errors} errors" if errors else ""))


def _drain(engine, write, args, fut, bi: int, names, load_s: float) -> None:
    """Download, entropy-code and write one dispatched batch, with its
    per-frame host times (``--output``) and quality lines (``--eval``)."""
    dispatched = fut.result()
    t_f = time.time()
    results = engine.finalize_encoded(dispatched)
    entropy_s = time.time() - t_f
    t_w = time.time()
    written = write(bi, results, names)
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
