#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rpcc_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root:

    python3 chip_smoke.py

Phases (each raises on failure, and the process then exits nonzero):
  0. environment: card name and power limit, torch/CUDA versions; the port
     imports without jax;
  1. build the CUDA kernels from the sources in the checkout, one nvcc per
     source, all started together (timed);
  2. threefry draws on the GPU equal the CPU draws bit for bit;
  3. the FPS kernel against its plain PyTorch version on the GPU: indices
     exactly equal at three shapes, and both timed with CUDA events;
  3b. the DBSCAN kernel against its plain PyTorch version on the GPU: raw
     labels exactly equal on a 64x2000 multi-object scene, a 16x256 long
     wall, a random blob scene across the column seam and an all-inactive
     frame; both timed with CUDA events at 64x2000;
  4. the main path: ``RPCCCodec(Velodyne64E, CodecConfig(), "cuda")``
     compresses and decompresses four synthetic 64x2000 frames; error
     bound, exact zero pixels, one FPS launch per encode, byte-identical
     repeat encodes, and the GPU-vs-CPU bpp difference;
  4b. the DBSCAN, plane-model and non-uniform paths, each on two 64x2000
     multi-object frames: error bound (step, or step + max level delta),
     exact zero pixels, one DBSCAN (or FPS) launch per encode,
     byte-identical repeat encodes, GPU-vs-CPU bpp within 0.5%;
  5. the compress/decompress CLIs with ``--device cuda`` in subprocesses.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside this script, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
LIDAR = "Velodyne64E"
SEEDS = (0, 1, 2, 3)
MODE_SEEDS = (10, 11)
FPS_SHAPES = ((1, 128000, 100), (4, 128000, 100), (2, 4133, 32))
TIMED_RUNS = 21
BPP_TOL = 0.005  # GPU vs CPU encode of the same frame


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median of per-run CUDA-event times (one warm-up run first)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ scenes
def scene_ranges(np, tm, seed: int):
    """(H, W) ranges of a multi-object street scene ray-cast on the unit-ray
    table ``tm`` (H, W, 3): ground at z = -1.8, a surrounding wall, boxes
    (cars, kiosks) and poles at 4-40 m, some of them across the column seam
    (azimuth 0, the +x axis); 1 cm range noise; 0 where nothing is hit
    within 2-80 m."""
    rng = np.random.default_rng(seed)
    dx, dy, dz = tm[..., 0].astype(np.float64), tm[..., 1].astype(np.float64), tm[..., 2].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(dz < -1e-4, -1.8 / dz, np.inf)
        az = np.arctan2(dy, dx)
        horiz = np.hypot(dx, dy)
        wall = 30 + 8 * np.sin(3 * az + seed) + 4 * np.sin(7 * az)
        r = np.minimum(r, np.where(horiz > 1e-4, wall / horiz, np.inf))
        azs = np.concatenate([[0.0, 0.02, -0.03], rng.uniform(-np.pi, np.pi, 9)])
        for i, a in enumerate(azs):  # boxes: the first three straddle the seam
            dist = rng.uniform(6, 35)
            cx, cy = dist * np.cos(a), dist * np.sin(a)
            hx, hy, hz = rng.uniform(0.8, 2.5), rng.uniform(0.8, 2.5), rng.uniform(0.7, 1.6)
            lo = np.array([cx - hx, cy - hy, -1.8])
            hi = np.array([cx + hx, cy + hy, -1.8 + 2 * hz])
            tmin = np.full(dx.shape, -np.inf)
            tmax = np.full(dx.shape, np.inf)
            for d, l, h in ((dx, lo[0], hi[0]), (dy, lo[1], hi[1]), (dz, lo[2], hi[2])):
                t1, t2 = l / d, h / d
                tmin = np.maximum(tmin, np.minimum(t1, t2))
                tmax = np.minimum(tmax, np.maximum(t1, t2))
            hit = (tmax >= tmin) & (tmin > 0)
            r = np.where(hit, np.minimum(r, tmin), r)
        for a in np.concatenate([[0.005], rng.uniform(-np.pi, np.pi, 11)]):  # poles
            dist, rad = rng.uniform(4, 40), rng.uniform(0.1, 0.35)
            cx, cy = dist * np.cos(a), dist * np.sin(a)
            qa = dx * dx + dy * dy
            qb = -2 * (dx * cx + dy * cy)
            qc = cx * cx + cy * cy - rad * rad
            disc = qb * qb - 4 * qa * qc
            t = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
            z = t * dz
            hit = (disc >= 0) & (t > 0) & (z > -1.8) & (z < 3.0)
            r = np.where(hit, np.minimum(r, t), r)
    r = np.where(np.isfinite(r) & (r > 2.0) & (r < 80.0), r, 0.0)
    return (r + rng.normal(0, 0.01, r.shape) * (r > 0)).astype(np.float32)


def scene_cloud(np, tm, seed: int):
    """The street scene as an (N, 3) f32 point cloud."""
    r = scene_ranges(np, tm, seed)
    pts = tm * r[..., None]
    return pts[r > 0].reshape(-1, 3).astype(np.float32)


def scene_long_wall(np):
    """tests/test_dbscan_pallas.py::test_pallas_matches_jnp_long_wall."""
    H, W = 16, 256
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in (7, 8):
        for c in range(20, 220):
            pc[r, c] = [0.245 * c, 14.0, 0.3 * r]
            active[r, c] = True
    return pc, active, 1.5


def scene_blobs(np, seed: int):
    """tests/test_dbscan_pallas.py::test_pallas_matches_jnp_fuzz: random
    blobs, some across the column seam, plus far noise pixels."""
    H, W = 16, 128
    rng = np.random.default_rng(seed)
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    centers = rng.uniform(-30, 30, (rng.integers(2, 6), 3))
    centers[:, 2] = rng.uniform(-1, 2, centers.shape[0])
    for ctr in centers:
        r0, c0 = int(rng.integers(1, H - 5)), int(rng.integers(0, W))
        nr, nc = int(rng.integers(2, 5)), int(rng.integers(4, 13))
        for r in range(r0, r0 + nr):
            for c in range(c0, c0 + nc):
                if rng.random() < 0.85:
                    pc[r, c % W] = ctr + [0.245 * (c - c0), 0.3 * (r - r0), 0] + rng.normal(0, 0.02, 3)
                    active[r, c % W] = True
    for _ in range(6):
        r, c = int(rng.integers(0, H)), int(rng.integers(0, W))
        if not active[r, c]:
            pc[r, c] = rng.uniform(40, 80, 3)
            active[r, c] = True
    return pc, active, 1.2


# ------------------------------------------------------------------ phases
def phase_build():
    from rpcc_tpu_torch.ops import dbscan, fps

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for f in [pool.submit(k._kernel) for k in (fps, dbscan)]:
            f.result()
    print(f"[phase 1] fps.cu and dbscan.cu built and loaded in {time.perf_counter() - t:.2f} s")


def phase_prng(torch, dev):
    from rpcc_tpu_torch.ops import prng

    for seed in (0, 1, 12345, 2**32 - 1):
        draws = []
        for d in ("cpu", dev):
            k = prng.split(prng.prng_key(seed, d))
            ks = prng.split(k[0])
            draws.append([
                k, prng.uniform(k[0], (100, 10)), prng.uniform(ks[1], (20000,)),
                prng.randint(ks[0], (), 0, 6),
            ])
        for a, b in zip(*draws):
            check(torch.equal(a, b.cpu()), f"threefry differs between cpu and cuda (seed {seed})")
    print("[phase 2] threefry cuda == cpu bits: ok")


def phase_fps(torch, np, dev, card):
    from rpcc_tpu_torch.ops import fps

    rng = np.random.default_rng(0)
    fps_err = 0
    fps_ms = plain_ms = None
    for B, N, K in FPS_SHAPES:
        pts = rng.uniform(-40.0, 40.0, (3, B, N)).astype(np.float32)
        if B == 1:
            pts[:, :, 20000:60000] = 0.0  # a zeroed block, like ground/empty pixels: ties
        xs, ys, zs = (torch.from_numpy(p).to(dev) for p in pts)
        got = fps.furthest_point_sample_cuda(xs, ys, zs, K)
        ref = fps.furthest_point_sample_planar(xs, ys, zs, K)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        fps_err = max(fps_err, err)
        check(err == 0, f"FPS kernel indices differ from the plain version at {(B, N, K)}")
        print(f"[phase 3] fps kernel == plain at (B={B}, N={N}, K={K})")
        if (B, N, K) == FPS_SHAPES[0]:
            fps_ms = median_ms(torch, lambda: fps.furthest_point_sample_cuda(xs, ys, zs, K))
            plain_ms = median_ms(torch, lambda: fps.furthest_point_sample_planar(xs, ys, zs, K))
            print(f"[phase 3] [{card}] fps (1, 128000, 100) median of {TIMED_RUNS}: "
                  f"kernel {fps_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return fps_err, fps_ms, plain_ms


def phase_dbscan(torch, np, dev, card, lidar):
    from rpcc_tpu_torch.ops import dbscan, segment
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    tm = build_transform_map(lidar)
    r = scene_ranges(np, tm, 0)
    planes64 = np.ascontiguousarray(np.transpose(tm * r[..., None], (2, 0, 1)))
    res = segment.ground_depth_residual(
        torch.from_numpy(r), torch.tensor([0.0, 0.0, 1.0, 1.8]),
        torch.from_numpy(np.ascontiguousarray(np.transpose(tm, (2, 0, 1)))),
    ).numpy()
    active64 = (np.abs(res) > 0.5) & (r > 0)
    empty = np.random.default_rng(4).uniform(-20, 20, (3, 32, 512)).astype(np.float32)
    wall, blobs = scene_long_wall(np), scene_blobs(np, 305)
    inputs = [
        ("64x2000 street scene", planes64, active64, 1.5),
        ("16x256 long wall", np.transpose(wall[0], (2, 0, 1)), wall[1], wall[2]),
        ("16x128 blobs across the seam", np.transpose(blobs[0], (2, 0, 1)), blobs[1], blobs[2]),
        ("32x512 all inactive", empty, np.zeros((32, 512), bool), 1.5),
    ]
    err_max = 0
    ms = plain_ms = None
    for name, planes, active, eps in inputs:
        p = torch.from_numpy(np.ascontiguousarray(planes)).to(dev)
        a = torch.from_numpy(active).to(dev)
        got = dbscan.dbscan_labels_cuda(p, a, eps)
        ref = dbscan.dbscan_labels_planar(p, a, eps)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        err_max = max(err_max, err)
        check(err == 0, f"DBSCAN kernel labels differ from the plain version on the {name}")
        ids = dbscan._compact_labels(got, a, 1 << 20)
        n_clusters = int(ids.max()) - dbscan.FIRST_CLUSTER_ID + 1 if bool(a.any()) else 0
        print(f"[phase 3b] dbscan kernel == plain on the {name}: {int(a.sum())} active px, "
              f"{max(n_clusters, 0)} clusters")
        if planes is planes64:
            ms = median_ms(torch, lambda: dbscan.dbscan_labels_cuda(p, a, eps))
            plain_ms = median_ms(torch, lambda: dbscan.dbscan_labels_planar(p, a, eps))
            print(f"[phase 3b] [{card}] dbscan 64x2000 median of {TIMED_RUNS}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err_max, ms, plain_ms


def encode_frames(codec, frames):
    """compress -> decompress -> compress again, per frame (timed)."""
    results = {}
    for s, pc in frames.items():
        t0 = time.perf_counter()
        blob, fields, enc_t = codec.compress(pc)
        t1 = time.perf_counter()
        _, ri_rec, dec_t = codec.decompress(blob)
        t2 = time.perf_counter()
        blob2, _, _ = codec.compress(pc)
        results[s] = (pc, blob, blob2, fields, enc_t, dec_t, ri_rec, t2 - t0)
    return results


def check_frames(np, codec, results, bound, card, tag, phase):
    bpps = {}
    for s, (pc, blob, blob2, fields, enc_t, dec_t, ri_rec, e2e) in results.items():
        q, d = codec.project(pc)
        ri = q.astype(np.float32) * d
        err = float(np.abs(ri_rec - ri).max())
        check(err <= bound, f"{tag} seed {s}: max |decoded - encoded| {err} > {bound}")
        check(bool((ri_rec[ri == 0] == 0).all()), f"{tag} seed {s}: a zero pixel decoded nonzero")
        check(blob == blob2, f"{tag} seed {s}: repeat encode gave different bytes")
        bpps[s] = len(blob) * 8 / fields["residual_quantized"].size
        print(f"[phase {phase}] [{card}] {tag} seed {s}: bpp {bpps[s]:.5f} max_err {err:.6f} "
              f"(bound {bound:.5f}) device_encode {enc_t['device_encode'] * 1e3:.3f} ms "
              f"device_decode {dec_t['device_decode'] * 1e3:.3f} ms e2e {e2e * 1e3:.3f} ms "
              f"repeat_encode_identical True")
    med = lambda key, i: statistics.median(r[i][key] for r in results.values()) * 1e3  # noqa: E731
    print(f"[phase {phase}] [{card}] {tag} median over {len(results)} frames: device_encode "
          f"{med('device_encode', 4):.3f} ms, entropy {med('entropy', 4):.3f} ms, "
          f"device_decode {med('device_decode', 5):.3f} ms, e2e "
          f"{statistics.median(r[7] for r in results.values()) * 1e3:.3f} ms")
    return bpps


def phase_main(torch, np, dev, card, lidar):
    from rpcc_tpu.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import dbscan, fps

    cfg = CodecConfig()
    bound = cfg.step + 1e-5
    codec = RPCCCodec(lidar, cfg, dev)
    frames = {s: synth_cloud_for(lidar, s) for s in SEEDS}
    codec.decompress(codec.compress(frames[SEEDS[0]])[0])  # warm-up
    torch.cuda.synchronize()

    fps.LAUNCHES = dbscan.LAUNCHES = 0
    results = encode_frames(codec, frames)
    launches = fps.LAUNCHES
    check(launches == 2 * len(SEEDS), f"fps.LAUNCHES rose by {launches} over {2 * len(SEEDS)} encodes")
    check(dbscan.LAUNCHES == 0, "the FPS path launched the DBSCAN kernel")
    print(f"[phase 4] fps.LAUNCHES = {launches} for {2 * len(SEEDS)} encodes")
    bpps = check_frames(np, codec, results, bound, card, "default", 4)

    cpu_codec = RPCCCodec(lidar, cfg, "cpu")
    pc0 = frames[SEEDS[0]]
    seg_gpu = codec.encode_device(pc0).seg_idx.cpu()
    seg_cpu = cpu_codec.encode_device(pc0).seg_idx
    flips = int((seg_gpu != seg_cpu).sum())
    blob_cpu, fields_cpu, _ = cpu_codec.compress(pc0)
    bpp_cpu = len(blob_cpu) * 8 / fields_cpu["residual_quantized"].size
    rel = abs(bpps[SEEDS[0]] - bpp_cpu) / bpp_cpu
    _, ri_x, _ = cpu_codec.decompress(results[SEEDS[0]][1])  # GPU blob, CPU decoder
    q, d = codec.project(pc0)
    x_err = float(np.abs(ri_x - q.astype(np.float32) * d).max())
    print(f"[phase 4] seed {SEEDS[0]} cuda vs cpu: seg flips {flips}, bpp {bpps[SEEDS[0]]:.5f} "
          f"vs {bpp_cpu:.5f} (rel diff {rel:.5f}), cpu decode of the cuda blob max_err {x_err:.6f}, "
          f"blobs identical {blob_cpu == results[SEEDS[0]][1]}")
    check(rel <= BPP_TOL, f"cuda vs cpu bpp differ by {rel:.4%}")
    check(x_err <= bound, f"cpu decode of the cuda blob: max_err {x_err} > {bound}")
    return codec, frames, launches


def phase_modes(torch, np, dev, card, lidar):
    """The DBSCAN, plane and non-uniform paths; returns DBSCAN's launches."""
    from rpcc_tpu.config import CodecConfig
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import dbscan, fps
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    tm = build_transform_map(lidar)
    frames = {s: scene_cloud(np, tm, s) for s in MODE_SEEDS}
    n_enc = 2 * len(MODE_SEEDS)
    dbscan_launches = None
    for tag, cfg in (
        ("DBSCAN", CodecConfig(segment_method="DBSCAN")),
        ("plane", CodecConfig(modeling_method="plane")),
        ("non-uniform", CodecConfig(compress_framework="non-uniform")),
    ):
        bound = (cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)) + 1e-5
        codec = RPCCCodec(lidar, cfg, dev)
        codec.decompress(codec.compress(frames[MODE_SEEDS[0]])[0])  # warm-up
        torch.cuda.synchronize()
        fps.LAUNCHES = dbscan.LAUNCHES = 0
        results = encode_frames(codec, frames)
        counts = {"fps": fps.LAUNCHES, "dbscan": dbscan.LAUNCHES}
        want = {"fps": 0, "dbscan": n_enc} if tag == "DBSCAN" else {"fps": n_enc, "dbscan": 0}
        check(counts == want, f"{tag}: kernel launches {counts} over {n_enc} encodes, expected {want}")
        print(f"[phase 4b] {tag}: launches {counts} for {n_enc} encodes")
        if tag == "DBSCAN":
            dbscan_launches = counts["dbscan"]
        bpps = check_frames(np, codec, results, bound, card, tag, "4b")

        cpu_codec = RPCCCodec(lidar, cfg, "cpu")
        for s, pc in frames.items():
            blob_cpu, fields_cpu, _ = cpu_codec.compress(pc)
            bpp_cpu = len(blob_cpu) * 8 / fields_cpu["residual_quantized"].size
            rel = abs(bpps[s] - bpp_cpu) / bpp_cpu
            _, ri_x, _ = cpu_codec.decompress(results[s][1])  # GPU blob, CPU decoder
            q, d = codec.project(pc)
            x_err = float(np.abs(ri_x - q.astype(np.float32) * d).max())
            print(f"[phase 4b] {tag} seed {s} cuda vs cpu: bpp {bpps[s]:.5f} vs {bpp_cpu:.5f} "
                  f"(rel diff {rel:.5f}), cpu decode of the cuda blob max_err {x_err:.6f}, "
                  f"blobs identical {blob_cpu == results[s][1]}")
            check(rel <= BPP_TOL, f"{tag} seed {s}: cuda vs cpu bpp differ by {rel:.4%}")
            check(x_err <= bound, f"{tag} seed {s}: cpu decode of the cuda blob: max_err {x_err} > {bound}")
    return dbscan_launches


def phase_cli(np, codec, frames):
    from rpcc_tpu.config import CodecConfig

    bound = CodecConfig().step + 1e-5
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        pc = frames[SEEDS[-1]]
        src = os.path.join(work, "frame.bin")
        out = os.path.join(work, "frame.rpcc")
        rec = os.path.join(work, "rec.bin")
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
        common = ["--lidar", LIDAR, "--device", "cuda"]
        for mod, a, b in (("compress", src, out), ("decompress", out, rec)):
            proc = subprocess.run(
                [sys.executable, "-m", f"rpcc_tpu_torch.cli.{mod}", "--input", a, "--output", b, *common],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
            )
            check(proc.returncode == 0, f"cli.{mod} failed:\n{proc.stdout}\n{proc.stderr}")
            print(f"[phase 5] cli.{mod}: " + " | ".join(proc.stdout.strip().splitlines()))
        with open(out, "rb") as f:
            blob = f.read()
        pc_dec, ri_rec, _ = codec.decompress(blob)
        q, d = codec.project(pc)
        err = float(np.abs(ri_rec - q.astype(np.float32) * d).max())
        check(err <= bound, f"CLI blob: max_err {err} > {bound}")
        pts = pc_dec.reshape(-1, 3)
        pts = pts[pts.sum(-1) != 0]
        cli_pts = np.fromfile(rec, np.float32).reshape(-1, 4)[:, :3]
        check(np.array_equal(cli_pts, pts), "CLI decode differs from the in-process decode")
        print(f"[phase 5] CLI roundtrip ok: max_err {err:.6f}, {cli_pts.shape[0]} points")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from rpcc_tpu_torch.data import lidar_config

    # ---------------------------------------------------------------- 0
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    try:
        import yaml  # noqa: F401

        print("yaml: ok")
    except ImportError:
        print("yaml: absent")
    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    lidar = lidar_config(LIDAR)

    phase_build()  # 1
    phase_prng(torch, dev)  # 2
    fps_err, fps_ms, fps_plain_ms = phase_fps(torch, np, dev, card)  # 3
    db_err, db_ms, db_plain_ms = phase_dbscan(torch, np, dev, card, lidar)  # 3b
    codec, frames, fps_launches = phase_main(torch, np, dev, card, lidar)  # 4
    db_launches = phase_modes(torch, np, dev, card, lidar)  # 4b
    phase_cli(np, codec, frames)  # 5
    check("jax" not in sys.modules, "the port imported jax")

    print(json.dumps({"kernels": [
        {
            "name": "fps",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/fps.cu",
            "replaces": "rpcc_tpu/ops/fps_pallas.py:31",
            "launches": fps_launches,
            "max_abs_err": fps_err,
            "ms": fps_ms,
            "plain_ms": fps_plain_ms,
        },
        {
            "name": "dbscan",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/dbscan.cu",
            "replaces": "rpcc_tpu/ops/dbscan_pallas.py:42",
            "launches": db_launches,
            "max_abs_err": db_err,
            "ms": db_ms,
            "plain_ms": db_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
