"""Hold the model tables of a benchmark cell's timed window to the plain
plane reference (``portbench/reference_plane.py``), on the card.

    python3 tools/plane_reference_check.py --workload hdl64e_kitti_plane.archive_encode \
        --seeds 11 12 --seconds 51 [--control bf16] [--device cuda]

From the root of a checkout.  For each seed the cell's traffic runs as
``portbench/run.py`` runs it (the same frames, engine, batch size and
window); then, for each distinct frame's first payload of the window, the
reference's table is computed from the frame's true inputs: the u16-snapped
range image of its float32 cloud (the port's host projection, the image a
sound run gives the program), the cluster map read from the payload as
``portbench/reference.py`` reads it, and the frame's seed.  The payload's
own table is compared with it (``reference_plane.compare``: decisions,
normals within 1e-5 and d within 1e-4 m, or an ill-conditioned fit's
float32 turn where that is larger).  With ``--control bf16`` the program
is given bfloat16 clouds while the reference keeps the float32 ones, so
the comparison has to fail.

Prints one JSON line per seed (the counts summed over frames, the largest
deviations, the encoder graph's eager calls, captures and replays over the
run, warm-up included, and the card); with ``--out FILE`` also appends them to the JSON
list in FILE.
"""

from __future__ import annotations

import argparse
import bz2
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import bench, frames, reference, runners  # noqa: E402
from portbench import reference_plane as plain  # noqa: E402
from portbench.trace import Spans  # noqa: E402

SUMMED = ("clusters", "planes", "decisions_equal", "exempt", "fragile", "decisions_differ", "widened_rows")
WORST = ("max_normal_dev", "max_d_dev", "max_mean_dev", "normal_dev_over_tol", "d_dev_over_tol")


def _table(blob: bytes, uniform: bool) -> np.ndarray:
    field = reference.unpack_payload(blob, uniform)["plane_param"]
    if field[:1] != b"\x42":
        raise ValueError("the model table is not in a bzip2 container")
    return np.frombuffer(bz2.decompress(field[1:]), np.float32).reshape(-1, 4)


def check(cell: str, seed: int, seconds: float, control, device: str) -> dict:
    from rpcc_tpu_torch.ops.projection_host import project_for_encoder
    from rpcc_tpu_torch.utils import timer

    spec = bench.load_benchmark()
    w = bench.workload(spec, cell)
    config, traffic = bench.load_config(spec, w["config"]), bench.load_traffic(w["traffic"])
    lidar, codec = config["lidar"], config["codec"]
    if codec["modeling_method"] != "plane":
        raise SystemExit(f"cell {cell} does not run plane models")
    seed = int(seed) % (1 << 63)
    fs = frames.make_frames(lidar, traffic, seed)
    t0 = time.perf_counter()
    ctx = runners.Context(config, traffic, fs, float(seconds), False, device, seed, control, t0)
    before = timer.counters()
    record = runners.RUNNERS[traffic["runner"]](ctx, Spans())
    moved = timer.counters_since(before)
    p_lidar, p_cfg = runners.program_config(config)
    first = {}
    for k, blob in record.outputs:
        first.setdefault(k, blob)
    keys = sorted(first)
    decoded = reference.decode_payloads([first[k] for k in keys], lidar, codec)
    uniform = codec["compress_framework"] == "uniform"
    num_models = int(codec["cluster_num"]) + (3 if codec["segment_method"] == "DBSCAN" else 2)
    out = dict.fromkeys(SUMMED, 0)
    out.update(dict.fromkeys(WORST, 0.0))
    out.update(frames=0, frames_ok=0, undecodable=0)
    t1 = time.perf_counter()
    for k, d in zip(keys, decoded):
        if d is None:
            out["undecodable"] += 1
            continue
        q, delta = project_for_encoder(fs.clouds[k], p_lidar, p_cfg)
        ri = torch.from_numpy(q.astype(np.float32) * delta).to(device)
        seg = torch.from_numpy(np.ascontiguousarray(d.seg)).to(device)
        fit = plain.plane_models(ri, seg, p_cfg.seed, lidar, num_models, float(codec["plane_angle_threshold"]))
        res = plain.compare(torch.from_numpy(_table(first[k], uniform).copy()), fit,
                            float(codec["plane_angle_threshold"]))
        out["frames"] += 1
        out["frames_ok"] += int(res["ok"])
        for key in SUMMED:
            out[key] += res[key]
        for key in WORST:
            out[key] = max(out[key], res[key])
    out.update(seed=seed, control=control, payloads=len(record.outputs), distinct_frames=len(keys),
               graph_calls={k: moved.get("graph." + k, 0) for k in ("eager", "captures", "replays")},
               ok=out["frames"] > 0 and out["frames_ok"] == out["frames"] and out["undecodable"] == 0,
               reference_s=time.perf_counter() - t1, device=torch.cuda.get_device_name(0)
               if torch.device(device).type == "cuda" else "cpu")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="hdl64e_kitti_plane.archive_encode")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--control", choices=("bf16",), default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="a JSON file to append the results to")
    args = p.parse_args(argv)
    results = []
    for seed in args.seeds:
        results.append(check(args.workload, seed, args.seconds, args.control, args.device))
        print(json.dumps(results[-1]), flush=True)
    if args.out is None:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prior = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
    with open(args.out, "w") as f:
        json.dump(prior + results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
