"""Shared single-frame CLI flags (the subset of ``rpcc_tpu/cli/common.py``
the port carries), mapped onto :class:`CodecConfig` as the reference maps
them, with its defaults."""

from __future__ import annotations

import argparse

from rpcc_tpu.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data import lidar_config


def add_codec_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--input", required=True, help="input file.")
    parser.add_argument("--output", required=True, help="output file.")
    parser.add_argument("--lidar", required=True, help="lidar type, e.g. Velodyne64E.")
    parser.add_argument("--accuracy", type=float, default=None,
                        help="max reconstruction error (default 0.02; step = 2 * accuracy).")
    parser.add_argument("--basic_compressor", type=str, default=None,
                        help="entropy coder: rans (default), lz4, bzip2, gzip, deflate.")
    parser.add_argument("--seed", type=int, default=0, help="deterministic RANSAC seed.")
    parser.add_argument("--segment_method", type=str, default=None, help="FPS (default) or DBSCAN.")
    parser.add_argument("--cluster_num", type=int, default=None, help="clusters per frame (default 100).")
    parser.add_argument("--DBSCAN_eps", type=float, default=None, help="DBSCAN radius in metres (default 1.5).")
    parser.add_argument("--model_method", type=str, default=None, help="point (default) or plane.")
    parser.add_argument("--angle_threshold", type=float, default=None,
                        help="plane models: max scan-ray angle in degrees (default 75).")
    parser.add_argument("--nonuniform", action="store_true",
                        help="non-uniform (salience) quantization.")
    parser.add_argument("--device", required=True,
                        help="torch device to run on, e.g. cuda, cuda:0 or cpu.")


def config_from_args(args: argparse.Namespace) -> CodecConfig:
    cfg = CodecConfig().replace(
        accuracy=args.accuracy,
        basic_compressor=args.basic_compressor,
        seed=args.seed,
        segment_method=args.segment_method,
        cluster_num=args.cluster_num,
        dbscan_eps=args.DBSCAN_eps,
        modeling_method=args.model_method,
        plane_angle_threshold=args.angle_threshold,
    )
    if args.nonuniform:
        cfg = cfg.replace(compress_framework="non-uniform")
    return cfg


def lidar_from_args(args: argparse.Namespace) -> LidarConfig:
    return lidar_config(args.lidar)
