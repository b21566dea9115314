"""Single-frame decompression CLI.

Usage:
    python -m rpcc_tpu_torch.cli.decompress --input frame.rpcc --output rec.bin \
        --lidar Velodyne64E --device cuda [--decode_backend device|host] [--accuracy 0.02 ...]
        [--eval --original_point_cloud frame.bin]

A self-describing stream (``compress --self_describing``, of this package
or of ``rpcc_tpu``) configures the decoder from its header, LiDAR included;
otherwise the configuration flags must match the ones the frame was
compressed with.  ``rec.bin`` holds float32 (x, y, z, 0) rows; decoded
empty pixels (the origin) are dropped.  ``--decode_backend device`` (the
default) runs ``RPCCCodec`` on ``--device``: its rANS containers decode
there too (on a card, the decode kernel); ``host`` decodes and
reconstructs on the host with the native coder and decoder
(``models/host_decoder.py``).  Both write the same floats.
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
    parser.add_argument("--original_point_cloud", default=None,
                        help="the uncompressed frame, for --eval.")
    parser.add_argument("--decode_backend", choices=("device", "host"), default="device",
                        help="device (default): the decoder graph on --device; host: native C++ reconstruction.")
    args = parser.parse_args(argv)
    if args.eval and args.original_point_cloud is None:
        parser.error("--eval needs --original_point_cloud")
    cfg = config_from_args(args)
    device = device_from_args(args)

    from rpcc_tpu_torch.codec.bitstream import unpack_header
    from rpcc_tpu_torch.ops.projection_host import build_transform_map, project_for_encoder

    with open(args.input, "rb") as f:
        head, blob = unpack_header(f.read())
    if head is not None:
        print("self-describing bitstream:", head)
        cfg = cfg.replace(
            compress_framework="uniform" if head["uniform"] else "non-uniform",
            accuracy=head["accuracy"],
            segment_method=head["segment_method"],
            cluster_num=head["cluster_num"],
            modeling_method=head["modeling_method"],
            basic_compressor=head["basic_compressor"],
        )
        if args.lidar is None:
            args.lidar = head["lidar_name"]
    lidar = lidar_from_args(args)
    transform_map = build_transform_map(lidar)
    if args.decode_backend == "host":
        from rpcc_tpu_torch.models.host_decoder import HostDecoder

        host = HostDecoder(lidar, cfg)

        def decompress(b: bytes):
            t0 = time.perf_counter()
            fields = host.entropy_decode_blobs([b])[0]
            t1 = time.perf_counter()
            ri = host.decode_fields(fields)
            return ri[..., None] * transform_map, ri, {"entropy": t1 - t0, "host_decode": time.perf_counter() - t1}
    else:
        from rpcc_tpu_torch.models.pipeline import RPCCCodec

        decompress = RPCCCodec(lidar, cfg, device).decompress
    decompress(blob)  # warm-up
    t0 = time.perf_counter()
    pc, ri_rec, times = decompress(blob)
    pc = pc.reshape(-1, 3)
    pc = pc[pc.sum(-1) != 0]  # reference save rule: drop points at the origin
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], -1).astype(np.float32).tofile(args.output)
    t1 = time.perf_counter()
    print(f"decode backend: {args.decode_backend}, device: {device}")
    for k, v in times.items():
        print(f"{k + ':':15} {v:.6f} s")
    print(f"Total (with save): {t1 - t0:.6f} s")
    print(f"points: {pc.shape[0]}")

    if args.eval:
        from rpcc_tpu_torch.data.pointcloud_io import load_point_cloud

        q, d = project_for_encoder(load_point_cloud(args.original_point_cloud), lidar, cfg)
        ri = q.astype(np.float32) * d
        n_points = max(int((ri > 0).sum()), 1)
        res = quality(ri, ri_rec, transform_map, device)
        bound = error_bound(cfg)
        if res["max_err"] > bound + 1e-5:
            raise AssertionError(f"Reconstruction error {res['max_err']} exceeds bound {bound}: do the "
                                 "configuration flags match the ones the frame was compressed with?")
        bits = os.path.getsize(args.input) * 8
        print("\nCompared with ", args.original_point_cloud)
        print("    BPP: ", bits / n_points)
        print("    Compression Ratio: ", n_points * 96 / bits)
        print_quality(res)


if __name__ == "__main__":
    main()
