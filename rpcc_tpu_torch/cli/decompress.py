"""Single-frame decompression CLI.

Usage:
    python -m rpcc_tpu_torch.cli.decompress --input frame.rpcc --output rec.bin \
        --lidar Velodyne64E --device cuda [--accuracy 0.02 ...]

The configuration flags must match the ones the frame was compressed with
(the bitstream does not describe itself).  ``rec.bin`` holds float32
(x, y, z, 0) rows; decoded empty pixels (the origin) are dropped.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rpcc_tpu_torch.cli.common import add_codec_args, config_from_args, lidar_from_args


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_codec_args(parser)
    args = parser.parse_args(argv)

    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    codec = RPCCCodec(lidar_from_args(args), config_from_args(args), args.device)
    with open(args.input, "rb") as f:
        blob = f.read()
    codec.decompress(blob)  # warm-up
    t0 = time.perf_counter()
    pc, _, times = codec.decompress(blob)
    pc = pc.reshape(-1, 3)
    pc = pc[pc.sum(-1) != 0]  # reference save rule: drop points at the origin
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], -1).astype(np.float32).tofile(args.output)
    t1 = time.perf_counter()
    print(f"device: {args.device}")
    for k, v in times.items():
        print(f"{k + ':':15} {v:.6f} s")
    print(f"Total (with save): {t1 - t0:.6f} s")
    print(f"points: {pc.shape[0]}")


if __name__ == "__main__":
    main()
