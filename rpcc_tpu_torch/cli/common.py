"""Shared CLI flags (the flags of ``rpcc_tpu/cli/common.py`` that act on the
port), mapped onto :class:`CodecConfig` as the reference maps them: the
codec YAML (``--compressor_yaml``, default the package's
``cfgs/compressor.yaml``) with the flags set on top.  ``datalist=True``
gives the datalist CLIs' flags in place of ``--input``/``--output``, and
the quality report of ``--eval`` lives here for all of them."""

from __future__ import annotations

import argparse
import time

import numpy as np

from rpcc_tpu_torch.config import DEFAULT_CODEC_YAML, CodecConfig, LidarConfig, load_codec_config
from rpcc_tpu_torch.data import lidar_config


def add_codec_args(parser: argparse.ArgumentParser, datalist: bool = False) -> None:
    if datalist:
        parser.add_argument("--datalist", required=True, help="txt file listing input frames.")
        parser.add_argument("--output_dir", required=True, help="output directory mirroring input paths.")
        parser.add_argument("--workers", type=int, default=4, help="IO/entropy worker threads.")
        parser.add_argument("--batch", type=int, default=8, help="frames per device batch.")
        parser.add_argument("--output", action="store_true", help="verbose per-frame reports.")
        parser.add_argument("--skip_existing", action="store_true",
                            help="resume: skip frames whose output file already exists.")
        parser.add_argument("--keep_going", action="store_true",
                            help="failure isolation: log per-frame errors and continue.")
        parser.add_argument("--num_devices", type=int, default=None,
                            help="engine processes, one per device (cuda:0 .. cuda:N-1, or N CPU ranks with "
                            "--device cpu); --batch is split across them (default: every visible card with "
                            "--device cuda, else 1).")
    else:
        parser.add_argument("--input", required=True, help="input file.")
        parser.add_argument("--output", required=True, help="output file.")
    parser.add_argument("--lidar", default=None,
                        help="lidar type, e.g. Velodyne64E (required, except to decompress a "
                        "self-describing stream, whose header names it).")
    parser.add_argument("--channel_distribute_csv", default=None,
                        help="per-channel vertical-angle CSV for an unevenly spaced lidar "
                        "(rows 'channel,vertical_angle').")
    parser.add_argument("--compressor_yaml", default=DEFAULT_CODEC_YAML, help="codec configuration YAML.")
    parser.add_argument("--transfer_precision", choices=("f32", "u16", "i8", "m8"), default=None,
                        help="range-image upload: u16, i8 and m8 (the default) the u16 snap grid, "
                        "f32 exact depths.")
    parser.add_argument("--device_entropy", action=argparse.BooleanOptionalAction, default=None,
                        help="rANS-code the residual and contour fields on the device in the batch engine "
                        "(rans coder only; default: the YAML's, on; --no-device_entropy codes their containers "
                        "outside the encoder graph, on --device).")
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
    parser.add_argument("--eval", action="store_true", help="evaluate the reconstruction quality.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default), cuda:N or cpu; "
                        "without a card, cuda raises.")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (--device cpu), with FPS over the compacted "
                        "non-ground set (cpu_fps), as the reference's --cpu.")


def config_from_args(args: argparse.Namespace) -> CodecConfig:
    cfg = load_codec_config(
        args.compressor_yaml,
        basic_compressor=args.basic_compressor,
        accuracy=args.accuracy,
        segment_method=args.segment_method,
        cluster_num=args.cluster_num,
        dbscan_eps=args.DBSCAN_eps,
        modeling_method=args.model_method,
        plane_angle_threshold=args.angle_threshold,
        seed=args.seed,
        transfer_precision=args.transfer_precision,
        device_entropy=args.device_entropy,
    )
    if args.nonuniform:
        cfg = cfg.replace(compress_framework="non-uniform")
    if args.cpu:
        cfg = cfg.replace(cpu_fps=True)
    return cfg


def device_from_args(args: argparse.Namespace) -> str:
    """``--device``, or the CPU when ``--cpu`` asks for it."""
    return "cpu" if args.cpu else args.device


def devices_from_args(args: argparse.Namespace) -> list:
    """The datalist CLIs' devices: ``--num_devices`` of ``--device``'s kind
    (``parallel/mesh.py::data_devices``), or ``--device`` itself for one."""
    import torch

    from rpcc_tpu_torch.parallel.mesh import data_devices

    device = torch.device(device_from_args(args))
    n = args.num_devices
    if n is None:
        n = max(torch.cuda.device_count(), 1) if device == torch.device("cuda") else 1
    if n == 1:
        return [device]  # one engine in this process; a missing card raises when it is built
    if device.index is not None:
        raise SystemExit(f"--num_devices {n} runs on cuda:0 .. cuda:{n - 1}; pass --device cuda, not {device}")
    return data_devices(n, device.type)


def run_ranks(rank_fn, devices: list, *args) -> list:
    """``rank_fn(rank, world, device, *args, t_launch)`` for each device:
    in this process for one device (no process group), else in one process
    per device (``parallel/mesh.py::run_data_parallel``); -> the ranks'
    results.  ``t_launch`` is the wall clock before the ranks start, for
    their start-up times."""
    t_launch = time.time()
    if len(devices) == 1:
        return [rank_fn(0, 1, devices[0], *args, t_launch)]
    from rpcc_tpu_torch.parallel.mesh import run_data_parallel

    return run_data_parallel(rank_fn, devices, *args, t_launch)


def lidar_from_args(args: argparse.Namespace) -> LidarConfig:
    if args.lidar is None:
        raise SystemExit("--lidar is required")
    return lidar_config(args.lidar, args.channel_distribute_csv)


def error_bound(cfg: CodecConfig) -> float:
    """The codec's max depth error: the step, plus the largest level delta
    in non-uniform mode.  Decoding is exact, so no snap term is added."""
    return cfg.step + (0.0 if cfg.uniform else max(cfg.level_delta_acc))


def quality(ri: np.ndarray, ri_rec: np.ndarray, transform_map: np.ndarray, device) -> dict:
    """Depth errors, chamfer distance, F1 and PSNRs of a decoded (H, W)
    range image against the encoder's; chamfer runs on ``device``."""
    from rpcc_tpu_torch.metrics import calc_chamfer_distance, calc_point_to_point_plane_psnr

    dif = np.abs(ri_rec - ri)
    pc = (ri[..., None] * transform_map).reshape(-1, 3)
    pc_rec = (ri_rec[..., None] * transform_map).reshape(-1, 3)
    cd = calc_chamfer_distance(pc, pc_rec, out=False, device=device)
    p2p, p2pl = calc_point_to_point_plane_psnr(pc, pc_rec, out=False)
    return dict(mean_err=float(dif.mean()), max_err=float(dif.max()), chamfer=cd["mean"],
                f1=cd["f_score"], p2p=p2p["psnr_mean"], p2plane=p2pl["psnr_mean"])


def print_quality(q: dict) -> None:
    print("    Depth Error (mean): ", q["mean_err"])
    print("    Depth Error (max): ", q["max_err"])
    print("    Chamfer Distance (mean): ", q["chamfer"])
    print("    F1 score (threshold=0.02): ", q["f1"])
    print("    Point-to-Point PSNR (r=59.7): ", q["p2p"])
    print("    Point-to-Plane PSNR (r=59.7): ", q["p2plane"])
