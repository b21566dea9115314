"""Single-frame compression CLI.

Usage:
    python -m rpcc_tpu_torch.cli.compress --input frame.bin --output frame.rpcc \
        --lidar Velodyne64E --device cuda [--accuracy 0.02 --seed 0]
        [--segment_method DBSCAN --model_method plane --nonuniform ...]
        [--channel_distribute_csv table.csv --transfer_precision f32 --cpu]
        [--compressor_yaml codec.yaml --self_describing --eval --profile]

``frame.bin`` is KITTI layout: float32 (x, y, z, intensity) rows.
``--self_describing`` prefixes the stream with a header naming its
configuration and LiDAR, so decompress needs no matching flags.
``--profile`` runs one more encode under ``torch.profiler`` and prints the
operations that took the most time: CUDA kernels on the card, CPU operators
with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from rpcc_tpu_torch.cli.common import (
    add_codec_args,
    config_from_args,
    device_from_args,
    error_bound,
    lidar_from_args,
    print_quality,
    quality,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser)
    parser.add_argument("--self_describing", action="store_true",
                        help="prefix the stream with a configuration header (the reference format is headerless).")
    parser.add_argument("--profile", action="store_true",
                        help="profile one encode and print the operations with the most summed time.")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = device_from_args(args)

    from rpcc_tpu_torch.codec.bitstream import pack_header
    from rpcc_tpu_torch.data.pointcloud_io import load_point_cloud
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    codec = RPCCCodec(lidar_from_args(args), cfg, device)
    t0 = time.perf_counter()
    points = load_point_cloud(args.input)
    t1 = time.perf_counter()
    codec.compress(points)  # warm-up: kernel build and first launches
    t2 = time.perf_counter()
    blob, fields, times = codec.compress(points)
    head = b""
    if args.self_describing:
        head = pack_header(cfg.uniform, cfg.accuracy, cfg.segment_method, cfg.cluster_num,
                           cfg.modeling_method, cfg.basic_compressor, args.lidar)
    with open(args.output, "wb") as f:
        f.write(head + blob)
    t3 = time.perf_counter()

    # BPP over the nonzero projected points, which the residual stream
    # covers exactly (reference accounting).
    point_num = max(int(fields["residual_quantized"].size), 1)
    bits = os.path.getsize(args.output) * 8
    print(f"device: {device}")
    print(f"Load data:      {t1 - t0:.6f} s")
    print(f"Warm-up encode: {t2 - t1:.6f} s")
    for k, v in times.items():
        print(f"{k + ':':15} {v:.6f} s")
    print(f"Total (no load, no warm-up): {t3 - t2:.6f} s")
    print(f"Compression ratio: {point_num * 96 / bits:.4f}")
    print(f"BPP: {bits / point_num:.6f}")

    if args.profile:
        from rpcc_tpu_torch.utils.profiling import print_op_table

        print_op_table(lambda: codec.encode_device(points), codec.device)

    if args.eval:
        q, d = codec.project(points)
        ri = q.astype(np.float32) * d  # the encoder's range image, bit for bit
        _, ri_rec, _ = codec.decompress(blob)
        res = quality(ri, ri_rec, codec.transform_map, device)
        bound = error_bound(cfg)
        if res["max_err"] > bound + 1e-5:
            raise AssertionError(f"Reconstruction error {res['max_err']} exceeds bound {bound}")
        print("\nReconstruction quality: ")
        print_quality(res)


if __name__ == "__main__":
    main()
