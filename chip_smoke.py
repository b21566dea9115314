#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rpcc_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root:

    python3 chip_smoke.py                      # every phase below
    python3 chip_smoke.py --against CHECKOUT   # kernel times and blob hashes only

``--against`` runs the unmasked FPS kernel timings of phases 3/6 (B = 1, 8),
the DBSCAN kernel timings of phases 3b/3c (B = 1, 4, 8), the rANS kernel
timings of phase 3e (B = 1, 8) where the checkout has that kernel (with both
blocks' phase split where it stamps both) and phase 6's main-path
device-entropy engine run (20 frames at B = 8, their blobs' sha256), the
rANS decode kernel's timings of phase 3f on that run's first batch (B = 1,
8: the two field groups as two launches, and in one launch with its phase
split, where the checkout has ``decode_fields_cuda``; each launch's device time under
``torch.profiler``, at full length and at T = 16), the rANS coder's calls
on the card with the wrappers' host time (a 1,000-symbol field's encode and
decode calls, a T = 16 decode call, the big fields' encode and decode calls
at B = 1 and 8; a checkout whose coder takes no ``device=`` must be run
with the reference's device variable set to ``default``), the main
path's encodes of phase 4 and the DBSCAN-mode encodes of phases 4b/6 with the
``rpcc_tpu_torch``
package of another checkout (``.`` for this one), through entry points
every checkout of the port has, and prints the same times and sha256 lines:
run it for a parent and a change in turns (P C C P) in one call to compare
them.

Phases (each raises on failure, and the process then exits nonzero):
  0. environment: card name and power limit, torch/CUDA versions; the port
     imports neither jax nor ``rpcc_tpu`` (checked again at the end);
  1. build the CUDA kernels (``fps.cu``, ``dbscan.cu``, ``rans.cu``,
     ``rans_decode.cu``) from the sources in the checkout, one nvcc per
     source, all started together (timed);
  2. threefry draws on the GPU equal the CPU draws bit for bit;
  3. the FPS kernel (one thread-block cluster per frame) against its plain
     PyTorch version on the GPU: the occupancy query for clusters of 8 and
     16, indices exactly equal at five shapes (N not divisible by the
     cluster, N < C, N above the on-chip capacity) with the cluster size
     chosen, and both timed with CUDA events; at (1|8, 128000, 100) both
     cluster sizes, each equal to the plain version, timed in turns;
  3d. (run after 3) the same kernel masked by a per-frame count (the
     ``cpu_fps`` mode) against the plain masked version: (1, 128000, 100)
     at counts 0, 1, 50, 99, 64000, 127999 and 128000, (8, 128000, 100)
     with a different count per frame (each frame equal to its own
     single-frame launch), (1, 400000, 16) at 300000 past the on-chip
     capacity; timed at counts of about N / 2, at B = 1 and 8;
  3b. the DBSCAN kernels (two launches per batch: a grid-wide mask pass,
     then one thread-block cluster per frame) against their plain PyTorch
     version on the GPU: raw labels
     exactly equal on a 64x2000 multi-object scene, a 16x256 long wall, a
     random blob scene across the column seam, an all-inactive frame, an
     8x20 frame (W not divisible by the cluster, bands narrower than the
     window), a 64x2000 ring wall that wraps the seam and spans every band,
     and a 128x4000 frame past a cluster's on-chip capacity; the launch plan
     of each; both versions timed with CUDA events at 64x2000, and the
     kernel's per-phase split (``%globaltimer`` stamps of frame 0);
  3h. the projection kernel (``csrc/raster.cu``, two launches) against the
     host projection (``raster.cpp``) and its plain version on the card,
     bit for bit, on a full 64E street sweep and its returns within 26 m,
     u16 and f32; the kernel, the plain version, the host projection and
     the cloud's pinned upload timed;
  4. the main path: ``RPCCCodec(Velodyne64E, CodecConfig(), "cuda")``
     compresses and decompresses four synthetic 64x2000 frames; error
     bound, exact zero pixels, one FPS launch per encode, its rANS
     containers coded on the card (one encode launch per coded field, one
     decode launch for both big fields and one per small rANS field; none
     with ``device="cpu"``), byte-identical
     repeat encodes, and the GPU-vs-CPU bpp difference;
  3e. (run after 4) the rANS kernel (one launch per batch: a block per
     frame and field) against its plain PyTorch version on the GPU, every
     output exactly equal, and against the native host coder at the
     device's lane geometry (L = 32, T = resid_T(HW)): the residual streams
     and contours of phase 4's four frames at B = 1 and 4; stream lengths
     0, 1 and HW; a frame with more than 512 escapes; all-zero and all-one
     contours; a 32E channel-table frame (32x2250); phase 6's first batch
     (eight distinct frames) at B = 8, timed there and at B = 1, with the
     phase split of frame 0's residual and contour blocks and the walk's ns
     per step; the walk loop's dependent instructions per step and the
     chain floor they model, as ``python -m
     rpcc_tpu_torch.utils.rans_sass`` prints them (not a check);
  4b. the DBSCAN, plane-model and non-uniform paths, each on two 64x2000
     multi-object frames: error bound (step, or step + max level delta),
     exact zero pixels, one DBSCAN (or FPS) launch per encode,
     byte-identical repeat encodes, GPU-vs-CPU bpp within 0.5%; the sha256
     of each DBSCAN-mode blob;
  4c. the same checks for the remaining codec modes, each through
     ``RPCCCodec(..., "cuda")`` on two street scenes: ``cpu_fps`` and
     ``transfer_precision="f32"`` on the 64E, and the HDL-32E channel
     table (32x2250, not cut) in FPS and in DBSCAN mode; one FPS (or
     DBSCAN) wrapper call per encode;
  4d. the point-cloud entry: ``make_encoder(Velodyne64E, CodecConfig(),
     from_ri=False)`` on phase 4's four frames, two street scenes and a
     random 120,000-point cloud: the in-graph range image against the host's
     native f32 projection and the CPU's in-graph one (support agreement
     >= 0.9999, >= 0.999 of the depths within rtol 2e-6; the differing
     pixels counted), one FPS and one rANS launch per encode, repeat encodes
     byte-identical, blobs assembled as the engine assembles its
     device-entropy containers decoded by the host decoder within step +
     1e-5 of the in-graph range image, bpp within 0.5% of the CPU's
     encode and of the f32 host-projected engine encode; the same in
     DBSCAN mode on the street scenes (one DBSCAN wrapper call per encode)
     and on the 32E channel table (32x2250, rows by the nearest channel
     angle); a zero-padded B = 8 ``make_batch_encoder`` batch equal to its
     B = 1 encodes; ``build_dataset(datalist, lidar_type="Velodyne64E")``
     over four ``.bin`` frames on the card and ``spot_check_datalist``;
     ``codec/api.py`` round-tripping one frame's fields on the card; the
     in-graph projection timed at (1|8, 128000) points (one call and 10
     back to back) beside the host's f32 projection and its byte bound,
     and the from-points encode's wall and profiled device time at B = 1
     and 8;
  5. the compress/decompress CLIs with ``--device cuda`` in subprocesses,
     then in this process with the launch counts read (compress codes its
     containers on the card, ``--decode_backend device`` decodes them
     there, ``host`` launches neither rANS kernel, each writing what its
     subprocess wrote); compress ``--profile`` names the FPS kernel in its table; compress
     ``--self_describing --eval`` decoded by a decompress with no
     codec flags and no ``--lidar`` (then with ``--eval
     --original_point_cloud``), and the 32E channel table with ``f32`` and
     a ``--compressor_yaml`` that sets ``cpu_fps`` through both CLIs;
  3c. (run after 3b) the batched DBSCAN kernel at (4, 64, 2000) and
     (8, 64, 2000) on street scenes: labels equal the batched plain version
     and the single-frame kernel runs; the launch plan (clusters of 8 at
     B = 8) and the per-phase split; both versions timed with CUDA events;
  6. the batch engine on the main path: ``BatchEngine(Velodyne64E,
     CodecConfig(), "cuda", batch_size=8)`` (device entropy, the default)
     encodes 20 frames through ``encode_pipeline`` (batches of 8, 8, 4) and
     decodes them through ``decode_pipeline`` and the host decoder: points
     within bound with zero pixels dropped, blobs equal the B = 1 engine's,
     a repeat run byte-identical, one FPS and one rANS launch per batch
     (and one for each frame whose i16 stream came back, re-encoded on the
     card), the count of those frames, the decode's launches (one a batch
     for both big fields, one a small rANS field; none in the host
     decoder); then with ``device_entropy=False``: blobs equal phase 4's
     single-frame blobs byte for byte, one FPS launch per batch and the
     containers' rANS launches on the card (one a residual lane geometry,
     one for the contours, one a sequence field); the
     DBSCAN mode at B = 4 (host entropy) equals its single-frame blobs with
     one DBSCAN launch per batch (their sha256 printed); encode and decode
     frames/s at B = 1 and B = 8 for both entropy settings (median, min and
     max of five passes), the stage stats, and one profiled B = 8 encode
     (launches, summed device time); the engine at B = 8 on the 32E channel
     table and in f32 (its 4-byte ring), host entropy: blobs equal the
     single-frame blobs, one FPS launch per batch and the containers' rANS
     launches, decodes within bound;
     device entropy on the 32E channel table at B = 8 and in DBSCAN mode at
     B = 4, each batch holding street scenes cut at 26 m (dropped returns),
     a ground sector of at most
     32,768 returns and a frame of random ranges (past 512 escapes): one
     segmentation and one rANS launch per batch (and one a re-encoded
     frame), the host's pick and the
     escape fallback both taken, the i16 stream downloads counted, blobs
     equal the B = 1 engine's, a repeat run byte-identical, decodes within
     bound through both decoders, street-scene bytes within 2% of host
     entropy;
  3f. (run after 6) the rANS decode kernel (a block per frame, a thread per
     lane; one launch per field group, or a residual group and the contours
     together) against its plain PyTorch version on the GPU and the native
     host decoder, every symbol equal, each field group alone and the
     largest residual group with the contours in one launch, and the
     codec's decode on the card against the native host coder's
     (``device=None``): phase 6's first batch (eight distinct frames, device
     containers) at B = 8 and B = 1, phase 4's four host-coded frames, a
     mixed-T batch (device containers and cut street scenes), stream lengths
     0, 1 and HW and a few hundred escapes (device) and > 512 escapes
     (host), two order-0 'D' containers, a 32x2250 32E frame (cases without
     contours share their launch with phase 6's frame 0's); a corrupt
     escape list and a 513-row contour raising; the engine's decode of phase
     6's 20 blobs on the card and with its coder on the host, range images
     equal, one decode launch per batch and per small rANS field, its steps
     split (unpack, parse, staged call, finalize, small fields, stacking);
     the renormalizations per live step of phase 6's 20 frames;
     ``python -m rpcc_tpu_torch.utils.chain_probe`` (the latencies of a
     step's dependent operations, measured); both fields in one launch,
     each alone, the plain version and the native host decode timed on
     phase 6's first batch at B = 1 and 8, with the phase stamps of both
     blocks, ns per step, the byte bound and the chain floor from the
     measured latencies, the codec's and the engine's decode on the card and
     on the host coder, in turns;
  3g. (run after 3f) the rANS encode kernel on the host containers' path
     (every card encode's containers): phase 4's and 4b's
     single-frame blobs, the engine's ``--no-device_entropy`` blobs of
     phase 6's first batch and the host-encode test's edge fields (stream
     lengths 0 to 128,000, lanes 1 / 2 / 8 / 32, int32 deltas of
     +-(2^31 - 1), 513 escapes, a u16 run field) byte-equal to the native
     host coder's (``device=None``), one launch per batch call (a field, a
     lane-geometry group or a contour batch), divergence 33's mixed small /
     big batch equal to the reference's default bytes (decoded on both,
     sizes within 0.5%) and a 513-row contour
     raising; the kernel at the host geometry against its plain version,
     timed on phase 6's first batch at B = 1 and 8 (both fields in one
     launch, each alone, 10 back to back) beside the byte bound, the staged
     wrapper's pieces equal to the kernel's on uploaded tensors, the encode
     calls on the card and on the host coder in turns and the native host
     encode of the same batch; a 1,000-symbol field (16 lanes): its encode
     call and its container's decode call, a frame's sequence field, and a
     T = 16 decode call of both big fields, each against the native coder
     in turns;
  7. the datalist CLIs: ``compress_datalist --batch 4
     --device cuda`` on 10 frames at the default (device entropy) and with
     ``--no-device_entropy``, the latter equal to the single-frame codec per
     seed, each with its rank's rANS launches (> 0); ``decompress_datalist``
     of both on the host (no launch) and the device backend (rANS decode
     launches) within bound and equal to each other, all in this process;
     then, in subprocesses, both CLIs on four
     32E channel-table frames in f32 with ``cpu_fps`` from a
     ``--compressor_yaml``, ``--no-device_entropy`` and ``--eval`` (one OK
     line per frame);
  8. the data-parallel layer: phase 6's 20 frames written five times (100
     frames; copy 0 holds phase 6's seeds) encoded at a global B = 8 by the
     datalist CLI's rank function through ``run_data_parallel``, on
     ``[cuda:0]`` (NCCL, a world of one) and on ``[cuda:0, cuda:0]`` (gloo,
     two processes on the one card): the backend printed is the rule's,
     copy 0's blobs equal phase 6's, both runs' blobs are equal, each
     rank's ``sharded_stats`` equals the host sums, and each rank launched
     the FPS and rANS kernels once per batch of its own; the rate after
     every rank's first batch, each rank's start-up and the all-reduce's
     time are printed; the 2-rank device decode of copy 0 writes the host
     decoder's points, each rank decoding its batches' rANS containers on
     the card (its decode launches counted); ``compress_datalist`` at its default
     ``--num_devices`` (one process on one card) writes phase 6's blobs.
     A watchdog stops the ranks of a launch that outlasts 300 s.

A time is the median of 21 CUDA-event samples of one call each, as in
every earlier run; a kernel is also timed over 10 calls back to back per
sample (``ms_10_back_to_back``), where the host's time between calls
overlaps the device's.  The line before the last is a JSON object
describing each kernel, timed at the engine's batch shape (``shape``) and
at one frame, with its bound at the card's peaks (``bound_ms``,
``bound_by``); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside this script, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
LIDAR = "Velodyne64E"
SEEDS = (0, 1, 2, 3)
MODE_SEEDS = (10, 11)
CSV_LIDAR = "Velodyne32E"  # with the HDL-32E channel table (data.VELODYNE_32E_CSV)
BATCH_SEEDS = tuple(range(20))  # phase 6: batches of 8, 8 and 4
STREET_SEEDS = (10, 11, 12, 13)  # phases 3c and 6 (DBSCAN at B = 4)
STREET_SEEDS_8 = tuple(range(10, 18))  # phase 3c at B = 8
CLI_FRAMES = 10  # phase 7: batches of 4, 4 and 2
# Phase 8: phase 6's 20 frames written this many times (frames 20 p .. 20 p
# + 19 of the datalist are copy p), so a rank's first-call costs weigh on
# 100 frames, not 20; copy 0 keeps phase 6's seeds.
DP_COPIES = 5
DP_TIMEOUT_S = 300  # phase 8: the ranks of one launch are stopped after this
# Phase 3: a 64E frame, a batch, N not divisible by C * threads, N < C, and
# N above a cluster's on-chip capacity (16 CTAs x 16,384 points).
FPS_SHAPES = ((1, 128000, 100), (4, 128000, 100), (2, 4133, 32), (1, 7, 5), (1, 400000, 16))
# Phase 3d: the masked kernel's counts at (1, 128000, 100), a count per frame
# at B = 8, and the counts it is timed at (about N / 2).
MASKED_COUNTS = (0, 1, 50, 99, 64000, 127999, 128000)
MASKED_COUNTS_8 = (0, 1, 50, 99, 64000, 100000, 127999, 128000)
MASKED_TIMED = tuple(64000 + 500 * i for i in range(8))
TIMED_RUNS = 21
BACK_TO_BACK = 10  # calls per CUDA-event sample of a kernel's ``ms_10_back_to_back``
# Kernel launches per wrapper call, whatever the batch: DBSCAN's mask pass
# and cluster kernel are two, the projection's scatter and snap passes two.
LAUNCHES_PER_CALL = {"fps": 1, "dbscan": 2, "project": 2}
KERNELS = ("fps", "dbscan", "rans", "rans_decode")
# The card's published peaks (H100 SXM, at its full 700 W): f32 outside the
# tensor cores, and device memory.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
RATE_PASSES = 5  # phase 6: timed pipeline passes per batch size
PLAIN_RANS_RUNS = 3  # phases 3e, 3f: samples of the plain rANS walks (~10-15 launches per step)
HOST_RUNS = 21  # phase 3f: samples of a host-clock time (the native host decode)
BPP_TOL = 0.005  # GPU vs CPU encode of the same frame


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel: ``fps``,
    ``dbscan`` (wrapper calls), ``rans`` and ``rans_decode`` (the counters
    of ``rpcc_tpu_torch/utils/timer.py``)."""
    from rpcc_tpu_torch.cli.compress_datalist import _kernel_launches

    return _kernel_launches()


def launches_since(before: dict, kernels=KERNELS) -> dict:
    """Each of ``kernels``' launches since ``before`` (a :func:`launch_counts`)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in kernels}


def counter(name: str) -> int:
    """The counter ``name`` of ``rpcc_tpu_torch/utils/timer.py`` so far."""
    from rpcc_tpu_torch.utils import timer

    return timer.counters().get(name, 0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_isolated() -> None:
    """The port has imported neither jax nor the JAX package."""
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "rpcc_tpu" or m.startswith("rpcc_tpu.") for m in sys.modules),
          "the port imported rpcc_tpu")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, per_sample: int = 1, runs: int = TIMED_RUNS) -> float:
    """Median over ``runs`` CUDA-event samples of the time per call, each
    sample spanning ``per_sample`` calls back to back (one warm-up call
    first)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the f32 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fps_bound(B: int, N: int, K: int):
    """FPS: (K - 1) steps over B * N points of 9 f32 operations (3 sub,
    3 mul, 2 add, 1 min); x/y/z read once, the indices written once."""
    return bound(9.0 * (K - 1) * B * N, 12.0 * B * N + 4.0 * B * K)


def masked_fps_bound(counts, K: int):
    """Masked FPS: (K - 1) steps over the valid points only, 9 f32
    operations each; their x/y/z and the counts read once, the indices
    written once."""
    n = float(sum(counts))
    return bound(9.0 * (K - 1) * n, 12.0 * n + 4.0 * len(counts) * (K + 1))


def dbscan_bound(active, B: int, H: int, W: int):
    """DBSCAN labels: the 48 window shifts of each active pixel at 9 f32
    operations (3 sub, 3 mul, 2 add, 1 compare); x/y/z and the mask read
    once, the labels written once."""
    return bound(9.0 * 48 * int(active.sum()), 17.0 * B * H * W)


def rans_bound(B: int, hw: int, H: int, W: int):
    """rANS encode of B frames' residual streams (HW int32 + a length) and
    contours (H x W int32): those read once, the container pieces written
    once (u16 words over 32 lanes x resid_T and H lanes x contour_T, lane
    counts and u64-held states, 4 x 512 + 8 i32 tables, 512 u64-held
    escapes, 4 scalars).  Bytes only: its integer operations, tens a
    symbol, would take less time than its bytes at the f32 rate."""
    from rpcc_tpu_torch.ops.rans_device import contour_T, resid_T

    per = (4 * hw + 4 + 2 * 32 * resid_T(hw) + 12 * 32 + 4 * 4 * 512 + 8 * 512 + 12
           + 4 * H * W + 2 * H * contour_T(H, W) + 12 * H + 4 * 8 + 4)
    return bound(0.0, float(B * per))


def projection_bound(N: int, hw: int):
    """The projection: the cloud read once (12 B a point), the int32 grid
    and delta written once; its ~70 f64 operations a point are far under
    the bytes' time."""
    return bound(0.0, 12.0 * N + 4.0 * hw + 4.0)


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


def drop_far(np, pc, max_range: float = 26.0):
    """A scene's returns nearer than ``max_range``: the far stretches of its
    wall dropped, as a sensor drops weak returns (``stream_len`` < HW)."""
    return pc[np.linalg.norm(pc, axis=1) < max_range]


def ground_sector(np, pc):
    """A street scene's ground returns within 0.8 rad of +x: fewer than
    32,768 points of smooth residuals (the engine's small-frame pick)."""
    return pc[(pc[:, 2] < -1.5) & (np.abs(np.arctan2(pc[:, 1], pc[:, 0])) < 0.8)]


def random_cloud(np, tm, n: int, seed: int):
    """``n`` pixels of the unit-ray table ``tm`` at uniformly random ranges
    in 3-70 m: far more than 512 escapes."""
    rng = np.random.default_rng(seed)
    rays = tm.reshape(-1, 3)[rng.choice(tm.shape[0] * tm.shape[1], n, replace=False)]
    return (rays * rng.uniform(3.0, 70.0, (n, 1))).astype(np.float32)


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


def scene_ring(np, H: int, W: int, radius: float, gap):
    """A wall on a ring around the sensor in rows H/4..3H/4 of every column
    but the ``gap`` columns: one component that wraps the column seam and,
    at 64x2000, spans every band of a cluster."""
    az = 2 * np.pi * np.arange(W) / W
    planes = np.zeros((3, H, W), np.float32)
    active = np.zeros((H, W), bool)
    for r in range(H // 4, 3 * H // 4):
        planes[0, r], planes[1, r], planes[2, r] = radius * np.cos(az), radius * np.sin(az), 0.3 * r
        active[r] = True
    active[:, gap[0] : gap[1]] = False
    return planes, active


def scene_narrow(np, seed: int, H: int, W: int):
    """A small ring of jittered points with 70% of the pixels active: at
    W = 20 a cluster's bands are narrower than the window."""
    rng = np.random.default_rng(seed)
    az = 2 * np.pi * np.arange(W) / W
    planes = np.zeros((3, H, W), np.float32)
    for r in range(H):
        planes[0, r], planes[1, r], planes[2, r] = 2 * np.cos(az), 2 * np.sin(az), 0.3 * r
    planes += rng.normal(0, 0.05, planes.shape).astype(np.float32)
    return planes, rng.random((H, W)) < 0.7


# ------------------------------------------------------------------ phases
def phase_build():
    from rpcc_tpu_torch.ops import dbscan, fps, projection_device, rans_device
    from rpcc_tpu_torch.utils import chain_probe

    t = time.perf_counter()
    builds = (fps._kernel, dbscan._kernel, rans_device._kernel, rans_device._decode_kernel, chain_probe._library,
              projection_device._library)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(k) for k in builds]:
            f.result()
    print(f"[phase 1] fps.cu, dbscan.cu, rans.cu, rans_decode.cu, chain_probe.cu and raster.cu built and loaded in "
          f"{time.perf_counter() - t:.2f} s")


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


def fps_plan(torch, fps, B: int, N: int):
    """The launch plan the FPS wrapper picks for (B, N) on this card."""
    dev = torch.cuda.current_device()
    return fps.launch_plan(B, N, lambda p: fps.max_active_clusters(dev, p.cluster, p.smem_bytes))


def phase_fps(torch, np, dev, card):
    from rpcc_tpu_torch.ops import fps

    for c in (8, 16):
        p = fps.plan_for(128000, c)
        print(f"[phase 3] [{card}] occupancy query: {fps.max_active_clusters(torch.cuda.current_device(), c, p.smem_bytes)} "
              f"clusters of {c} CTAs ({p.smem_bytes} B of shared memory each, a 64E frame) run at once")
    rng = np.random.default_rng(0)
    fps_err = 0
    fps_ms = fps_b2b = plain_ms = None
    for B, N, K in FPS_SHAPES:
        pts = rng.uniform(-40.0, 40.0, (3, B, N)).astype(np.float32)
        if B == 1 and N > 60000:
            pts[:, :, 20000:60000] = 0.0  # a zeroed block, like ground/empty pixels: ties
        if N == 400000:
            pts[:, :, -1000:] = 300.0  # far points among those each CTA streams from device memory
        xs, ys, zs = (torch.from_numpy(p).to(dev) for p in pts)
        got = fps.furthest_point_sample_cuda(xs, ys, zs, K)
        ref = fps.furthest_point_sample_planar(xs, ys, zs, K)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        fps_err = max(fps_err, err)
        check(err == 0, f"FPS kernel indices differ from the plain version at {(B, N, K)}")
        plan = fps_plan(torch, fps, B, N)
        print(f"[phase 3] fps kernel == plain at (B={B}, N={N}, K={K}): clusters of {plan.cluster}, "
              f"{plan.onchip} points per CTA on chip, {plan.spill} streamed")
        if (B, N, K) == FPS_SHAPES[0]:
            fps_ms = median_ms(torch, lambda: fps.furthest_point_sample_cuda(xs, ys, zs, K))
            fps_b2b = median_ms(torch, lambda: fps.furthest_point_sample_cuda(xs, ys, zs, K), BACK_TO_BACK)
            plain_ms = median_ms(torch, lambda: fps.furthest_point_sample_planar(xs, ys, zs, K))
            print(f"[phase 3] [{card}] fps (1, 128000, 100) median of {TIMED_RUNS}: kernel {fps_ms:.4f} ms "
                  f"({fps_b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {plain_ms:.4f} ms, "
                  f"bound {fps_bound(B, N, K)[0]:.6f} ms")
    # The launcher's choice at the main path's shapes: both cluster sizes,
    # each held to the plain version, timed in turns (8, 16, 16, 8).
    for B in (1, 8):
        pts = rng.uniform(-40.0, 40.0, (3, B, 128000)).astype(np.float32)
        pts[:, :, 20000:60000] = 0.0
        xs, ys, zs = (torch.from_numpy(p).to(dev) for p in pts)
        ref = fps.furthest_point_sample_planar(xs, ys, zs, 100)
        times = {8: [], 16: []}
        for c in (8, 16, 16, 8):
            run = lambda c=c: fps_at_cluster(fps, c, xs, ys, zs, 100)  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"FPS with clusters of {c} differs from the plain version at B={B}")
            times[c].append(median_ms(torch, run))
        print(f"[phase 3] [{card}] fps ({B}, 128000, 100) == plain at both cluster sizes; median of "
              f"{TIMED_RUNS} (in turns): clusters of 8 {times[8][0]:.4f} / {times[8][1]:.4f} ms, clusters of 16 "
              f"{times[16][0]:.4f} / {times[16][1]:.4f} ms; chosen: {fps_plan(torch, fps, B, 128000).cluster}")
    return fps_err, fps_ms, fps_b2b, plain_ms


def fps_at_cluster(fps, cluster: int, xs, ys, zs, K: int):
    """The FPS kernel launched with clusters of ``cluster`` CTAs, whatever
    the occupancy query would pick."""
    chosen = fps.launch_plan
    fps.launch_plan = lambda b, n, _: fps.plan_for(n, cluster)
    try:
        return fps.furthest_point_sample_cuda(xs, ys, zs, K)
    finally:
        fps.launch_plan = chosen


def phase_fps_masked(torch, np, dev, card):
    """3d: the FPS kernel masked by per-frame counts against the plain
    masked version, at every count of MASKED_COUNTS, per frame at B = 8,
    and past the on-chip capacity; timed at counts of about N / 2."""
    from rpcc_tpu_torch.ops import fps

    K = 100
    rng = np.random.default_rng(3)
    pts = rng.uniform(-40.0, 40.0, (3, 8, 128000)).astype(np.float32)
    pts[:, :, 20000:60000] = 0.0  # exact ties
    xs, ys, zs = (torch.from_numpy(p).to(dev) for p in pts)
    one = (xs[:1], ys[:1], zs[:1])

    def held(planes, counts, k, what):
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        got = fps.furthest_point_sample_cuda(*planes, k, cnt)
        ref = fps.furthest_point_sample_planar_masked(*planes, cnt, k)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"masked FPS kernel differs from the plain masked version {what}")
        return got, cnt

    for nv in MASKED_COUNTS:
        held(one, (nv,), K, f"at (1, 128000, {K}), count {nv}")
    print(f"[phase 3d] masked fps kernel == plain at (1, 128000, {K}) for counts {list(MASKED_COUNTS)}")
    got8, cnt8 = held((xs, ys, zs), MASKED_COUNTS_8, K, f"at (8, 128000, {K})")
    single = torch.stack([fps.furthest_point_sample_cuda(xs[b], ys[b], zs[b], K, cnt8[b : b + 1]) for b in range(8)])
    torch.cuda.synchronize()
    check(torch.equal(got8, single), "a frame's masked FPS indices depend on its batch")
    print(f"[phase 3d] masked fps kernel (8, 128000, {K}) == plain == per-frame launches for counts "
          f"{list(MASKED_COUNTS_8)}")
    big = rng.uniform(-40.0, 40.0, (3, 1, 400000)).astype(np.float32)
    big[:, :, 266400:267400] = 300.0  # valid far points among those a CTA streams
    big[:, :, 350000:351000] = 900.0  # farther, past the count: never picked
    held(tuple(torch.from_numpy(p).to(dev) for p in big), (300000,), 16, "at (1, 400000, 16), count 300000")
    plan = fps_plan(torch, fps, 1, 400000)
    print(f"[phase 3d] masked fps kernel == plain at (1, 400000, 16), count 300000: {plan.onchip} points per "
          f"CTA on chip, {plan.spill} streamed")

    res = {}
    for B, counts in ((1, MASKED_TIMED[:1]), (8, MASKED_TIMED)):
        planes = one if B == 1 else (xs, ys, zs)
        _, cnt = held(planes, counts, K, f"at ({B}, 128000, {K}), counts {list(counts)}")
        run = lambda planes=planes, cnt=cnt: fps.furthest_point_sample_cuda(*planes, K, cnt)  # noqa: E731
        ms, b2b = median_ms(torch, run), median_ms(torch, run, BACK_TO_BACK)
        plain_ms = median_ms(torch, lambda planes=planes, cnt=cnt: fps.furthest_point_sample_planar_masked(*planes, cnt, K))
        bound_ms, bound_by = masked_fps_bound(counts, K)
        res[B] = dict(ms=ms, b2b=b2b, plain_ms=plain_ms, bound=(bound_ms, bound_by),
                      shape=f"B={B} N=128000 K={K} n_valid={list(counts)}")
        print(f"[phase 3d] [{card}] masked fps ({B}, 128000, {K}), counts {list(counts)}, median of {TIMED_RUNS}: "
              f"kernel {ms:.4f} ms ({b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})")
    return res


def dbscan_plan(torch, dbscan, B: int, H: int, W: int):
    """The launch plan the DBSCAN wrapper picks for (B, H, W) on this card."""
    dev = torch.cuda.current_device()
    return dbscan.launch_plan(B, H, W, lambda p: dbscan.max_active_clusters(dev, p.cluster, p.smem_bytes))


def dbscan_split(torch, dbscan, p, a, eps):
    """Median over TIMED_RUNS calls of each kernel phase's time (us) in frame
    0's first CTA, from the kernel's %globaltimer stamps."""
    stamps = torch.zeros(len(dbscan.PHASES) + 1, dtype=torch.int64, device=a.device)
    rows = []
    for _ in range(TIMED_RUNS):
        dbscan.dbscan_labels_cuda(p, a, eps, phase_stamps=stamps)
        torch.cuda.synchronize()
        rows.append(stamps.diff().cpu().tolist())
    return {name: statistics.median(r[i] for r in rows) / 1e3 for i, name in enumerate(dbscan.PHASES)}


def street_frame(np, segment, torch, tm, seed: int):
    """A street scene as (3, H, W) planes and its active pixels."""
    r = scene_ranges(np, tm, seed)
    return np.ascontiguousarray(np.transpose(tm * r[..., None], (2, 0, 1))), street_active(np, segment, torch, tm, r)


def phase_dbscan(torch, np, dev, card, lidar):
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.ops import dbscan, segment
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    tm = build_transform_map(lidar)
    planes64, active64 = street_frame(np, segment, torch, tm, 0)
    planes32, active32 = street_frame(np, segment, torch, build_transform_map(lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)), 1)
    empty = np.random.default_rng(4).uniform(-20, 20, (3, 32, 512)).astype(np.float32)
    wall, blobs = scene_long_wall(np), scene_blobs(np, 305)
    # Past a cluster's on-chip capacity: four street scenes tiled to 128x4000.
    (pa, aa), (pb, ab) = street_frame(np, segment, torch, tm, 2), street_frame(np, segment, torch, tm, 3)
    big = np.concatenate([np.concatenate([pa, pb], 2), np.concatenate([pb, pa], 2)], 1)
    big_active = np.concatenate([np.concatenate([aa, ab], 1), np.concatenate([ab, aa], 1)], 0)
    inputs = [
        ("64x2000 street scene", planes64, active64, 1.5),
        ("16x256 long wall", np.transpose(wall[0], (2, 0, 1)), wall[1], wall[2]),
        ("16x128 blobs across the seam", np.transpose(blobs[0], (2, 0, 1)), blobs[1], blobs[2]),
        ("32x512 all inactive", empty, np.zeros((32, 512), bool), 1.5),
        ("8x20 narrow frame", *scene_narrow(np, 0, 8, 20), 1.0),
        ("64x2000 ring wall across the seam", *scene_ring(np, 64, 2000, 20.0, (1000, 1010)), 1.5),
        ("128x4000 frame past the on-chip capacity", big, big_active, 1.5),
        ("32x2250 street scene on the HDL-32E channel table", planes32, active32, 1.5),
    ]
    err_max = 0
    ms = b2b = plain_ms = split = None
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
        plan = dbscan_plan(torch, dbscan, 1, *active.shape)
        print(f"[phase 3b] dbscan kernel == plain on the {name}: {int(a.sum())} active px, "
              f"{max(n_clusters, 0)} clusters; plan: clusters of {plan.cluster}, {plan.band} columns per CTA, "
              f"{plan.onchip} px on chip and {plan.spill} in device memory per CTA, {plan.smem_bytes} B shared")
        if planes is planes64:
            ms = median_ms(torch, lambda: dbscan.dbscan_labels_cuda(p, a, eps))
            b2b = median_ms(torch, lambda: dbscan.dbscan_labels_cuda(p, a, eps), BACK_TO_BACK)
            plain_ms = median_ms(torch, lambda: dbscan.dbscan_labels_planar(p, a, eps))
            split = dbscan_split(torch, dbscan, p, a, eps)
            print(f"[phase 3b] [{card}] dbscan 64x2000 median of {TIMED_RUNS}: kernel {ms:.4f} ms "
                  f"({b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {plain_ms:.4f} ms, "
                  f"bound {dbscan_bound(active, 1, *active.shape)[0]:.6f} ms")
            print(f"[phase 3b] [{card}] dbscan 64x2000 phase split (us, median of {TIMED_RUNS}): "
                  + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return err_max, ms, b2b, plain_ms, dbscan_bound(active64, 1, *active64.shape), split


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


def phase_projection(torch, np, dev, card, lidar):
    """3h: the projection kernel (``csrc/raster.cu``) == the host projection
    == the plain version on the card, bit for bit, on a full street sweep
    and its returns within 26 m, in u16 and f32; each timed: the kernel
    (one call, 10 back to back), the plain version on the card, the host
    projection it replaces, the cloud's pinned upload."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.ops import projection_device as pd
    from rpcc_tpu_torch.ops.projection_host import build_transform_map, project_for_encoder

    full = scene_cloud(np, build_transform_map(lidar), 10)
    out = {}
    for tag, pc in (("full", full), ("dropped", drop_far(np, full))):
        for cfg in (CodecConfig(), CodecConfig(transfer_precision="f32")):
            ws = pd.Workspace(lidar, cfg, dev)
            pts = ws.upload(pc)
            q, d = project_for_encoder(pc, lidar, cfg)
            for grid, delta in (pd.project_cuda(pts, ws), pd.project_plain(pts, lidar, cfg)):
                got = grid.cpu().numpy()
                check(np.array_equal(got.view(np.int32), q.view(np.int32)) if q.dtype == np.float32
                      else np.array_equal(got, q.astype(np.int32)), f"projection {tag} {cfg.transfer_precision}: grid")
                check(np.float32(delta.item()) == d, f"projection {tag} {cfg.transfer_precision}: delta")
        cfg = CodecConfig()
        ws = pd.Workspace(lidar, cfg, dev)
        pts = ws.upload(pc)
        ms = median_ms(torch, lambda: pd.project_cuda(pts, ws))
        b2b = median_ms(torch, lambda: pd.project_cuda(pts, ws), per_sample=10)
        plain = median_ms(torch, lambda: pd.project_plain(pts, lidar, cfg))
        host = host_median_ms(lambda: project_for_encoder(pc, lidar, cfg))
        upload = host_median_ms(lambda: (ws.upload(pc), torch.cuda.synchronize()))  # the same rows again
        device_us = {k: decode_device_us(torch, lambda: pd.project_cuda(pts, ws), name=f"project_{k}_kernel")
                     for k in ("scatter", "snap")}
        b = projection_bound(pc.shape[0], lidar.height * lidar.width)
        out[tag] = dict(shape=f"N={pc.shape[0]} H={lidar.height} W={lidar.width}", ms=ms, b2b=b2b, plain_ms=plain,
                        host_ms=host, upload_ms=upload, device_us=device_us, bound=b)
        print(f"[phase 3h] [{card}] projection kernel == host == plain (u16, f32) on the {tag} sweep "
              f"({pc.shape[0]} points), median of {TIMED_RUNS}: kernel {ms:.4f} ms one call, {b2b:.4f} ms "
              f"back to back, device time a launch (us, torch.profiler) {device_us}; plain on the card "
              f"{plain:.4f} ms; host projection {host:.4f} ms; pinned upload {upload:.4f} ms; bound {b[0]:.6f} ms "
              f"({b[1]})")
    return out


def phase_main(torch, np, dev, card, lidar):
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    cfg = CodecConfig()
    bound = cfg.step + 1e-5
    codec = RPCCCodec(lidar, cfg, dev)
    frames = {s: synth_cloud_for(lidar, s) for s in SEEDS}
    codec.decompress(codec.compress(frames[SEEDS[0]])[0])  # warm-up
    torch.cuda.synchronize()

    c0 = launch_counts()
    p0 = counter("launch.project")
    results = encode_frames(codec, frames)
    n = launches_since(c0)
    projects = counter("launch.project") - p0
    check(projects == 2 * len(SEEDS), f"launch.project rose by {projects} over {2 * len(SEEDS)} encodes")
    launches, rans_enc, rans_dec = n["fps"], n["rans"], n["rans_decode"]
    want_enc = sum(2 * rans_encode_calls(np, r[3]) for r in results.values())
    want_dec = sum(1 + small_rans_fields(r[1]) for r in results.values())
    check(launches == 2 * len(SEEDS), f"launch.fps rose by {launches} over {2 * len(SEEDS)} encodes")
    check(n["dbscan"] == 0, "the FPS path launched the DBSCAN kernel")
    check(rans_enc == want_enc > 0, f"the single-frame codec's encodes made {rans_enc} rANS launches, expected "
          f"{want_enc} (one per coded field and the contour)")
    check(rans_dec == want_dec > 0, f"the single-frame codec's decodes made {rans_dec} rANS decode launches, "
          f"expected {want_dec} (both big fields in one, one per small rANS field)")
    print(f"[phase 4] launch.fps = {launches} for {2 * len(SEEDS)} encodes; launch.rans_encode = {rans_enc}, "
          f"launch.rans_decode = {rans_dec} for {2 * len(SEEDS)} encodes and {len(SEEDS)} decodes on the card")
    for s, res in results.items():
        print(f"[phase 4] default seed {s} blob sha256 {hashlib.sha256(res[1]).hexdigest()}")
    bpps = check_frames(np, codec, results, bound, card, "default", 4)

    cpu_codec = RPCCCodec(lidar, cfg, "cpu")
    pc0 = frames[SEEDS[0]]
    c0 = launch_counts()
    seg_gpu = codec.encode_device(pc0).seg_idx.cpu()
    seg_cpu = cpu_codec.encode_device(pc0).seg_idx
    flips = int((seg_gpu != seg_cpu).sum())
    blob_cpu, fields_cpu, _ = cpu_codec.compress(pc0)
    bpp_cpu = len(blob_cpu) * 8 / fields_cpu["residual_quantized"].size
    rel = abs(bpps[SEEDS[0]] - bpp_cpu) / bpp_cpu
    _, ri_x, _ = cpu_codec.decompress(results[SEEDS[0]][1])  # GPU blob, CPU decoder
    q, d = codec.project(pc0)
    x_err = float(np.abs(ri_x - q.astype(np.float32) * d).max())
    n = launches_since(c0, ("rans", "rans_decode"))
    check(n["rans"] == n["rans_decode"] == 0, f"the codec on device='cpu' launched the rANS kernels ({n})")
    print(f"[phase 4] seed {SEEDS[0]} cuda vs cpu: seg flips {flips}, bpp {bpps[SEEDS[0]]:.5f} "
          f"vs {bpp_cpu:.5f} (rel diff {rel:.5f}), cpu decode of the cuda blob max_err {x_err:.6f}, "
          f"blobs identical {blob_cpu == results[SEEDS[0]][1]}")
    check(rel <= BPP_TOL, f"cuda vs cpu bpp differ by {rel:.4%}")
    check(x_err <= bound, f"cpu decode of the cuda blob: max_err {x_err} > {bound}")
    print(f"[phase 4] RPCCCodec(..., 'cpu') encode and decode: 0 rANS launches of either kernel")
    return codec, frames, dict(fps=launches / (2 * len(SEEDS)), rans=rans_enc / (2 * len(SEEDS)),
                               rans_decode=rans_dec / len(SEEDS), project=projects / (2 * len(SEEDS)))


def rans_inputs(torch, codec, clouds):
    """(q (B, HW) int32, stream_len (B,) int32, contour (B, H, W) int32)
    of the codec's encodes of ``clouds``: what the engine's encoder hands
    the rANS kernel."""
    from rpcc_tpu_torch.ops.contour import unpack_bits_msb

    outs = [codec.encode_device(pc) for pc in clouds]
    q = torch.stack([o.stream.to(torch.int32) for o in outs]).contiguous()
    n = torch.stack([o.stream_len.to(torch.int32).reshape(()) for o in outs]).contiguous()
    c = torch.stack([unpack_bits_msb(o.contour_packed, codec.hw).reshape(codec.H, codec.W) for o in outs])
    return q, n, c.to(torch.int32).contiguous()


def rans_native_check(np, res, cnt, q, n, c, what):
    """The kernel's pieces against the port's native host coder called with
    the device's lane geometry (L = 32, T = resid_T(HW)), on the data it
    emits: the word prefix, counts, states, tables, escapes, q0."""
    from rpcc_tpu_torch.codec import rans_native
    from rpcc_tpu_torch.ops import rans_device as rd

    q_np, n_np, c_np = q.cpu().numpy(), n.cpu().numpy(), c.cpu().numpy()
    r = [t.cpu().numpy() for t in res]
    k = [t.cpu().numpy() for t in cnt]
    B, hw = q_np.shape
    H, W = c_np.shape[1:]
    packed, nw, counts, states, freqs, esc, n_esc, q0 = rans_native.delta_encode_frames(
        [q_np[b, : n_np[b]] for b in range(B)], rd.RESID_LANES, rd.resid_T(hw), rd.ALPHABET, rd.NUM_CTX)
    cw, cnw, ccounts, cstates, cfreqs = rans_native.contour_encode_frames(
        np.packbits(c_np.reshape(B, -1) != 0, axis=1), H, W, rd.contour_T(H, W))
    for b in range(B):
        check(n_esc[b] == r[6][b], f"rans {what} frame {b}: escape count {r[6][b]} vs native {n_esc[b]}")
        if n_esc[b] >= 0:
            m, e = int(nw[b]), min(int(n_esc[b]), rd.ESC_CAP_DEV)
            check(m == r[1][b] and np.array_equal(packed[b, :m], r[0][b, :m].view(np.uint16))
                  and np.array_equal(counts[b], r[2][b]) and np.array_equal(states[b], r[3][b])
                  and np.array_equal(freqs[b], r[4][b]) and np.array_equal(esc[b, :e], r[5][b, :e])
                  and q0[b] == r[7][b], f"rans {what} frame {b}: residual pieces differ from the native coder")
        m = int(cnw[b])
        check(m == k[1][b] and np.array_equal(cw[b, :m], k[0][b, :m].view(np.uint16))
              and np.array_equal(ccounts[b], k[2][b]) and np.array_equal(cstates[b], k[3][b])
              and np.array_equal(cfreqs[b], k[4][b]), f"rans {what} frame {b}: contour pieces differ from the native coder")


def rans_held(torch, np, q, n, c, what):
    """One kernel launch on (q, n, c) held to the plain version and the
    native coder; -> (residual pieces, contour pieces, max |kernel - plain|)."""
    from rpcc_tpu_torch.ops import rans_device as rd

    res, cnt = rd.encode_fields_cuda(q, n, c)
    p_res, p_cnt = rd.encode_streams_plain(q, n, rd.RESID_LANES, rd.resid_T(q.shape[1])), rd.encode_contour_field_plain(c)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in list(zip(res._fields, res, p_res)) + list(zip(cnt._fields, cnt, p_cnt)):
        check(a.shape == b.shape and a.dtype == b.dtype, f"rans {what}: {name} shape or type differs from the plain version")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
        check(torch.equal(a, b), f"rans kernel {name} differs from the plain version {what}")
    rans_native_check(np, res, cnt, q, n, c, what)
    return res, cnt, err


def rans_split(torch, rd, q, n, c):
    """Medians over TIMED_RUNS calls of each kernel phase's time (us) in
    frame 0's residual block and in frame 0's contour block, from their
    %globaltimer stamps, with each block's span and its end (us) after the
    first of the two blocks started."""
    k = len(rd.PHASES) + 1
    stamps = torch.zeros(len(rd.STAMP_BLOCKS) * k, dtype=torch.int64, device=q.device)
    rows = []
    for _ in range(TIMED_RUNS):
        rd.encode_fields_cuda(q, n, c, phase_stamps=stamps)
        torch.cuda.synchronize()
        rows.append(stamps.reshape(-1, k).cpu().tolist())
    out = {}
    for bi, block in enumerate(rd.STAMP_BLOCKS):
        med = lambda f: statistics.median(f(r) for r in rows) / 1e3  # noqa: E731
        out[block] = {name: med(lambda r, i=i: r[bi][i + 1] - r[bi][i]) for i, name in enumerate(rd.PHASES)}
        out[block]["span"] = med(lambda r: r[bi][-1] - r[bi][0])
        out[block]["ends_at"] = med(lambda r: r[bi][-1] - min(b[0] for b in r))
    return out


def phase_rans(torch, np, dev, card, lidar, codec, frames):
    """3e: the rANS kernel against its plain version and the native coder."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import rans_device as rd
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    q, n, c = rans_inputs(torch, codec, [frames[s] for s in SEEDS])
    hw = codec.hw
    err = 0
    for b in range(len(SEEDS)):
        res, _, e = rans_held(torch, np, q[b : b + 1], n[b : b + 1], c[b : b + 1], f"64E seed {SEEDS[b]}")
        err = max(err, e)
        print(f"[phase 3e] rans kernel == plain == native on 64E seed {SEEDS[b]}: stream_len {int(n[b])}, "
              f"{int(res.n_words[0])} residual words, {int(res.n_esc[0])} escapes")
    res4, cnt4, e = rans_held(torch, np, q, n, c, "at B=4")
    err = max(err, e)
    print(f"[phase 3e] rans kernel (B=4) == plain == native: residual words {res4.n_words.tolist()}, "
          f"contour words {cnt4.n_words.tolist()}")

    # Edge cases on frame 0: stream lengths 0, 1 and HW (the tail filled),
    # a block of random residuals (> 512 escapes), all-zero and all-one contours.
    rng = np.random.default_rng(5)
    q0 = q[0].cpu().numpy()
    edge = np.stack([np.zeros(hw, np.int32), np.r_[q0[:1], np.zeros(hw - 1, np.int32)], q0.copy(), q0.copy()])
    edge[2, int(n[0]):] = rng.integers(-6, 7, hw - int(n[0]))
    edge[3, 1000:3000] = rng.integers(-3000, 3000, 2000)
    lens = np.array([0, 1, hw, int(n[0])], np.int32)
    cont = np.stack([np.zeros((codec.H, codec.W), np.int32), np.ones((codec.H, codec.W), np.int32),
                     c[1].cpu().numpy(), c[2].cpu().numpy()])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    res, _, e = rans_held(torch, np, to(edge), to(lens), to(cont), "on the edge cases")
    err = max(err, e)
    check(int(res.n_esc[3]) > rd.ESC_CAP_DEV, "the random block gave no escape overflow")
    print(f"[phase 3e] rans kernel == plain == native at stream lengths 0, 1, {hw} and with "
          f"{int(res.n_esc[3])} escapes; all-zero and all-one contours")

    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    codec32 = RPCCCodec(lidar32, CodecConfig(), dev)
    q32, n32, c32 = rans_inputs(torch, codec32, [scene_cloud(np, build_transform_map(lidar32), MODE_SEEDS[0])])
    _, _, e = rans_held(torch, np, q32, n32, c32, "on the 32E channel table")
    err = max(err, e)
    print(f"[phase 3e] rans kernel == plain == native on a 32x2250 32E frame (T {rd.resid_T(codec32.hw)} "
          f"residual, {rd.contour_T(32, 2250)} contour)")

    # The engine's batch: phase 6's first eight frames, held at B = 8, then
    # timed at B = 1 (frame 0) and at B = 8 on the same tensors.
    q8, n8, c8 = rans_inputs(torch, codec, [synth_cloud_for(lidar, s) for s in BATCH_SEEDS[:8]])
    res8, _, e = rans_held(torch, np, q8, n8, c8, "at B=8")
    err = max(err, e)
    print(f"[phase 3e] rans kernel (B=8, phase 6's first batch) == plain == native: stream lengths "
          f"{n8.tolist()}, residual words {res8.n_words.tolist()}, escapes {res8.n_esc.tolist()}")

    out = {"err": err}
    T_res, T_cnt = rd.resid_T(hw), rd.contour_T(codec.H, codec.W)
    for B in (1, 8):
        qb, nb, cb = (t[:B].contiguous() for t in (q8, n8, c8))
        run = lambda qb=qb, nb=nb, cb=cb: rd.encode_fields_cuda(qb, nb, cb)  # noqa: E731
        ms, b2b = median_ms(torch, run), median_ms(torch, run, BACK_TO_BACK)
        plain_ms = median_ms(torch, lambda qb=qb, nb=nb, cb=cb: (rd.encode_streams_plain(qb, nb, rd.RESID_LANES, T_res),
                                                                rd.encode_contour_field_plain(cb)),
                             runs=PLAIN_RANS_RUNS)
        bound_ms, bound_by = rans_bound(B, hw, codec.H, codec.W)
        split = rans_split(torch, rd, qb, nb, cb)
        ns_step = {"residual": split["residual"]["walk"] * 1e3 / T_res, "contour": split["contour"]["walk"] * 1e3 / T_cnt}
        out[B] = dict(ms=ms, b2b=b2b, plain_ms=plain_ms, bound=(bound_ms, bound_by), split=split, ns_step=ns_step,
                      shape=f"B={B} HW={hw} T={T_res} contour {codec.H}x{codec.W} T={T_cnt}")
        print(f"[phase 3e] [{card}] rans ({out[B]['shape']}) median of {TIMED_RUNS}: kernel {ms:.4f} ms "
              f"({b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {plain_ms:.4f} ms (median of "
              f"{PLAIN_RANS_RUNS}), bound {bound_ms:.6f} ms ({bound_by}); serial steps per lane "
              f"{T_res} residual, {T_cnt} contour")
        for block in rd.STAMP_BLOCKS:
            print(f"[phase 3e] [{card}] rans B={B} frame 0 {block} block phase split (us, median of {TIMED_RUNS}): "
                  + json.dumps({k: round(v, 3) for k, v in split[block].items()})
                  + f"; walk {ns_step[block]:.2f} ns per step")

    # The step's dependent chain in the walk loop's SASS and the chain floor
    # it models, printed as they come (the analysis and its own checks are
    # rpcc_tpu_torch/utils/rans_sass.py's; its exit code gates nothing here).
    proc = subprocess.run([sys.executable, "-m", "rpcc_tpu_torch.utils.rans_sass"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
        print(f"[phase 3e] rans_sass: {line}")
    return out


# ------------------------------------------------------------------ 3f: rANS decode
def rans_decode_bound(lanes_list):
    """rANS decode of field groups: the words the containers hold, each
    lane's count, live steps (i32) and u64-held state, and the i32 tables
    read once; the (B, L, T) i32 symbols written once.  Bytes only: its
    integer operations, a few a symbol, would take less at the f32 rate."""
    nbytes = sum(2 * int(g.counts.sum()) + 16 * g.counts.size + 4 * g.freqs.size + 4 * g.words.size
                 for g in lanes_list)
    return bound(0.0, float(nbytes))


@contextlib.contextmanager
def coder_on(owner, device):
    """``owner``'s (a codec's or an engine's) rANS coder on ``device`` in
    the block: None asks for the native host coder explicitly."""
    old, owner.entropy.device = owner.entropy.device, device
    try:
        yield
    finally:
        owner.entropy.device = old


def in_turns(fa, fb, passes: int = RATE_PASSES):
    """Host-clock medians (ms) of ``fa`` and ``fb`` over ``passes`` samples
    each, taken in turns (a b b a a b ...) after one warm-up call each."""
    fa()
    fb()
    times = ([], [])
    for i in range(passes):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            t = time.perf_counter()
            (fa, fb)[k]()
            times[k].append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[0]), statistics.median(times[1])


def small_rans_fields(blob: bytes, uniform: bool = True) -> int:
    """The fields of a payload other than the two big ones that are coded
    in rANS containers ('C' or 'D'): one decode launch each on the card."""
    from rpcc_tpu_torch.codec import rans_codec
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream

    return sum(v[0] in (rans_codec.MAGIC_CTX, rans_codec.MAGIC_DELTA)
               for k, v in unpack_bitstream(blob, uniform=uniform).items()
               if k not in ("residual_quantized", "contour_map") and v)


def rans_encode_calls(np, fields) -> int:
    """The encode launches of a single-frame codec's encode on the card: one
    a field coded in rANS (the int fields' batch calls), one for the contour."""
    return sum(1 for k, v in fields.items() if k != "contour_map" and v.dtype in (np.int16, np.uint16, np.int32)) + 1


def big_rans_decodes(blobs, uniform: bool = True) -> int:
    """1 when a batch decode of ``blobs`` has a rANS big field (both go in one launch), else 0."""
    from rpcc_tpu_torch.codec import rans_codec
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream

    fields = [unpack_bitstream(b, uniform=uniform) for b in blobs]
    res = all(f["residual_quantized"][0] in (rans_codec.MAGIC_CTX, rans_codec.MAGIC_DELTA, rans_codec.MAGIC_BZD)
              for f in fields) and any(f["residual_quantized"][0] != rans_codec.MAGIC_BZD for f in fields)
    cnt = all(f["contour_map"][:1] == bytes([rans_codec.MAGIC_BITS]) for f in fields)
    return int(res or cnt)


def upload_lanes(dev, lanes):
    """A codec ``Lanes`` group's tensors on ``dev``, as the decode wrapper uploads them."""
    from rpcc_tpu_torch.ops import rans_device

    return rans_device.upload_decode_lanes(*lanes[:5], dev)


def host_median_ms(fn, runs: int = HOST_RUNS) -> float:
    fn()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def decode_group_cuda(rd, args, mode):
    """One field group's CUDA tensors (words, counts, states, lives, freqs)
    decoded with ``mode``'s contexts: one launch of ``rd.decode_fields_cuda``."""
    if mode == rd.MODE_WAVEFRONT:
        return rd.decode_fields_cuda(None, args)[1]
    return rd.decode_fields_cuda(args, None, mode)[0]


def decode_held(torch, np, dev, lanes, what):
    """One decode kernel launch on a field group's lanes held to the plain
    version on the card and to the native host decoder -> max |kernel - plain|."""
    from rpcc_tpu_torch.codec import rans_native
    from rpcc_tpu_torch.ops import rans_device as rd

    args = upload_lanes(dev, lanes)
    got = decode_group_cuda(rd, args, lanes.mode)
    plain = rd.decode_streams_plain(*args, lanes.mode)
    torch.cuda.synchronize()
    check(got.shape == plain.shape and got.dtype == plain.dtype, f"rans decode {what}: shape or type differs")
    err = int((got.long() - plain.long()).abs().max())
    check(err == 0, f"rans decode kernel differs from the plain version {what}")
    native = rans_native.decode_ctx_batch(lanes.words, lanes.counts, lanes.states, lanes.freqs, lanes.words.shape[2],
                                          lanes.mode, lives=lanes.lives)
    check(np.array_equal(got.cpu().numpy(), native), f"rans decode kernel differs from the native decoder {what}")
    return err


def fields_held(torch, np, dev, rl, cl, what):
    """One launch of both field groups (``decode_fields_cuda``: a residual
    group's lanes ``rl`` and a contour group's ``cl``, either None) held to
    each group's plain version on the card and to the native host decoder
    -> max |kernel - plain|."""
    from rpcc_tpu_torch.codec import rans_native
    from rpcc_tpu_torch.ops import rans_device as rd

    args = [None if g is None else upload_lanes(dev, g) for g in (rl, cl)]
    got = rd.decode_fields_cuda(*args, rl.mode if rl is not None else rd.MODE_ZIGZAG)
    err = 0
    for g, a, out in zip((rl, cl), args, got):
        if g is None:
            check(out is None, f"rans decode fields {what}: an output for a group not given")
            continue
        plain = rd.decode_streams_plain(*a, g.mode)
        torch.cuda.synchronize()
        check(out.shape == plain.shape and out.dtype == plain.dtype, f"rans decode fields {what}: shape or type differs")
        err = max(err, int((out.long() - plain.long()).abs().max()))
        check(err == 0, f"the both-fields decode launch differs from the plain version {what}")
        native = rans_native.decode_ctx_batch(g.words, g.counts, g.states, g.freqs, g.words.shape[2], g.mode,
                                              lives=g.lives)
        check(np.array_equal(out.cpu().numpy(), native), f"the both-fields decode launch differs from the native "
              f"decoder {what}")
    return err


def decode_split(torch, rd, args_r, args_c, mode):
    """Medians over TIMED_RUNS one-launch decodes of each phase's time (us)
    in the residual group's frame 0 block and the contour group's, from
    their %globaltimer stamps, with each block's span."""
    k = len(rd.DECODE_PHASES) + 1
    stamps = torch.zeros(len(rd.DECODE_STAMP_BLOCKS) * k, dtype=torch.int64, device=args_r[0].device)
    rows = []
    for _ in range(TIMED_RUNS):
        rd.decode_fields_cuda(args_r, args_c, mode, phase_stamps=stamps)
        torch.cuda.synchronize()
        rows.append(stamps.reshape(-1, k).cpu().tolist())
    out = {}
    for bi, block in enumerate(rd.DECODE_STAMP_BLOCKS):
        med = lambda f: statistics.median(f(r) for r in rows) / 1e3  # noqa: E731
        check(all(all(a <= b for a, b in zip(r[bi], r[bi][1:])) for r in rows), f"decode stamps of the {block} "
              "block out of phase order")
        out[block] = {name: med(lambda r, i=i: r[bi][i + 1] - r[bi][i]) for i, name in enumerate(rd.DECODE_PHASES)}
        out[block]["span"] = med(lambda r: r[bi][-1] - r[bi][0])
    return out


def run_chain_probe(phase: str):
    """``python -m rpcc_tpu_torch.utils.chain_probe`` in a subprocess: its
    lines printed, its JSON returned."""
    proc = subprocess.run([sys.executable, "-m", "rpcc_tpu_torch.utils.chain_probe"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    check(proc.returncode == 0 and lines and lines[-1].startswith('{"chain_probe"'),
          "the chain probe failed:\n" + "\n".join(lines[-20:]))
    for line in lines[:-1]:
        print(f"[{phase}] chain_probe: {line}")
    return json.loads(lines[-1])["chain_probe"]


def residual_containers(np, res, lens, hw: int):
    """'C' containers of the encode kernel's residual pieces at the
    device's lane geometry, as the engine assembles them."""
    from rpcc_tpu_torch.codec import rans_codec
    from rpcc_tpu_torch.ops import rans_device as rd

    words, nw, counts, states, freqs, escapes, n_esc, q0 = (t.cpu().numpy() for t in res)
    return [rans_codec.build_ctx_container(rd.RESID_LANES, rd.resid_T(hw), int(lens[b]), int(q0[b]),
                                           escapes[b, :n_esc[b]], freqs[b].astype(np.int64), states[b],
                                           counts[b].astype(np.uint16), words[b, :nw[b]].view(np.uint16), np.int16)
            for b in range(len(lens))]


def order0_container(np, arr):
    """A 'D' (order-0) container of an int16 stream in the reference's
    layout (``rpcc_tpu/codec/rans_codec.py``: header, escapes, one table,
    states, counts, words, dtype), coded by the port's native coder with one
    context.  The port decodes 'D'; nothing of it emits one."""
    from rpcc_tpu_torch.codec import rans_codec, rans_native

    sym, escapes, q0, n = rans_codec._symbolize(arr)
    L = rans_codec._lanes_for(max(n, 1))
    T = -(-max(1, -(-n // L)) // rans_codec.T_BUCKET) * rans_codec.T_BUCKET
    sym3d = np.zeros((1, L, T), np.int32)
    sym3d.reshape(-1)[:n] = sym
    words, counts, states, freqs = rans_native.encode_ctx_batch(sym3d, np.zeros_like(sym3d), rans_codec.ALPHABET, 1)
    return b"".join([
        struct.pack("<BBHIi", rans_codec.MAGIC_DELTA, L.bit_length() - 1, T, n, q0),
        struct.pack("<I", escapes.shape[0]), escapes.astype("<u4").tobytes(),
        rans_codec._pack_table(freqs[0, 0].astype(np.int64)), states[0].astype("<u4").tobytes(),
        counts[0].astype("<u2").tobytes(), rans_codec._lane_words(words[0], counts[0]).tobytes(),
        struct.pack("<B", 0),
    ])


def phase_rans_decode(torch, np, dev, card, lidar, codec, frames, eng):
    """3f: the rANS decode kernel against its plain version and the native
    decoder, the codec's decode on the card against the native host coder
    (``device=None``), the engine's decode of phase 6's blobs on both, and
    times."""
    from rpcc_tpu_torch.codec import rans_codec, rans_native
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import rans_device as rd
    from rpcc_tpu_torch.ops.projection_host import build_transform_map
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    cfg = CodecConfig()
    hw = codec.hw
    fields = lambda blob: unpack_bitstream(blob, uniform=cfg.uniform)  # noqa: E731
    main = [fields(b) for b in eng["blobs"]]
    res8, cnt8 = [f["residual_quantized"] for f in main[:8]], [f["contour_map"] for f in main[:8]]
    check(all(r[:2] == bytes([rans_codec.MAGIC_CTX, 5]) for r in res8) and all(c[0] == rans_codec.MAGIC_BITS for c in cnt8),
          "phase 6's first batch is not eight device containers")
    host4 = [fields(codec.compress(frames[s])[0]) for s in SEEDS]
    tm = build_transform_map(lidar)
    cut = [fields(codec.compress(drop_far(np, scene_cloud(np, tm, s)))[0])["residual_quantized"] for s in MODE_SEEDS]
    mixed_T = {struct.unpack_from("<H", b, 2)[0] for b in res8[:2] + cut}
    check(all(b[:2] == bytes([rans_codec.MAGIC_CTX, 5]) for b in cut) and len(mixed_T) > 1,
          f"the cut street scenes give no mixed-T batch of 32-lane containers (T {sorted(mixed_T)})")
    # Device containers at stream lengths 0, 1, HW and with ~300 escapes
    # (150 spikes, two escapes each); a host container past 512 escapes.
    rng = np.random.default_rng(7)
    q = np.round(rng.normal(0, 3, (4, hw))).astype(np.int32)
    q[3, 100:1000:6] = rng.integers(-3000, 3000, 150)
    lens = np.array([0, 1, hw, hw // 2], np.int32)
    for b in range(4):
        q[b, lens[b]:] = 0
    res, _ = rd.encode_fields_cuda(torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev), None)
    check(0 < int(res.n_esc[3]) <= rd.ESC_CAP_DEV, f"the edge frame has {int(res.n_esc[3])} escapes")
    edge = residual_containers(np, res, lens, hw)
    many = rans_codec.compress_delta_batch([rng.integers(-3000, 3000, hw).astype(np.int16)])[0]
    stream0 = np.frombuffer(rans_codec.decompress(host4[0]["residual_quantized"]), np.int16)
    d_blobs = [order0_container(np, stream0), order0_container(np, stream0[:1000])]
    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    f32e = fields(RPCCCodec(lidar32, cfg, dev).compress(scene_cloud(np, build_transform_map(lidar32), MODE_SEEDS[0]))[0])
    cases = [
        ("phase 6's first batch (B=8, device containers)", res8, cnt8),
        ("phase 6's frame 0 (B=1)", res8[:1], cnt8[:1]),
        ("phase 4's host-coded frames (B=4)", [h["residual_quantized"] for h in host4], [h["contour_map"] for h in host4]),
        ("a mixed-T batch (device T 4000, cut street scenes)", res8[:2] + cut, []),
        (f"stream lengths 0, 1, HW, {int(res.n_esc[3])} escapes (device) and > 512 escapes (host)", edge + [many], []),
        ("'D' containers (order-0)", d_blobs, []),
        ("a 32x2250 32E frame", [f32e["residual_quantized"]], [f32e["contour_map"]]),
    ]
    err = 0
    for what, res_blobs, cnt_blobs in cases:
        groups = {}
        for b in res_blobs:
            groups.setdefault(b[:2], []).append(b)
        shapes = []
        for g in groups.values():
            lanes = rans_codec.delta_lanes(g)
            err = max(err, decode_held(torch, np, dev, lanes, f"on {what}"))
            shapes.append(f"{chr(g[0][0])} {lanes.words.shape} T {sorted({struct.unpack_from('<H', b, 2)[0] for b in g})}")
        if cnt_blobs:
            lanes, H, W = rans_codec.contour_lanes(cnt_blobs)
            err = max(err, decode_held(torch, np, dev, lanes, f"on {what}'s contours"))
            shapes.append(f"N {lanes.words.shape}")
        # One launch of the largest residual group and the contours (phase
        # 6's frame 0's where the case has none), as the codec pairs them.
        first = max(groups.values(), key=len)
        pair_cnt = cnt_blobs or cnt8[:1]
        err = max(err, fields_held(torch, np, dev, rans_codec.delta_lanes(first),
                                   rans_codec.contour_lanes(pair_cnt)[0], f"on {what}"))
        shapes.append(f"one launch: {len(first)} residual + {len(pair_cnt)} contour frames")
        for fn, blobs in ((rans_codec.decompress_delta_batch, res_blobs), (rans_codec.decompress_contour_batch, cnt_blobs)):
            if blobs:
                check(fn(blobs, dev) == fn(blobs, None), f"the card's decoded bytes differ from the host coder's on {what}")
        if cnt_blobs:
            packed = [{"residual_quantized": r, "contour_map": c} for r, c in zip(res_blobs, cnt_blobs)]
            check(rans_codec.batch_decode_big_fields(packed, dev) == rans_codec.batch_decode_big_fields(packed, None),
                  f"batch_decode_big_fields on the card differs from the host coder's on {what}")
        print(f"[phase 3f] rans decode kernel == plain == native, the codec's card decode == host decode on {what}: "
              + "; ".join(shapes))

    # Raises: a corrupt escape list (one more listed than decoded), a contour
    # of 513 rows (past the kernel's limit; the native decoder takes it).
    bad = bytearray(edge[3])
    (n_esc,) = struct.unpack_from("<I", bad, 12)
    bad[12:16] = struct.pack("<I", n_esc + 1)
    bad[16 + 4 * n_esc:16 + 4 * n_esc] = struct.pack("<I", 7)
    H, W = rd.MAX_CONTOUR_ROWS + 1, 8
    tall_bits = np.packbits(rng.random(H * W) < 0.1)
    T_tall = rd.contour_T(H, W)
    cw, cnw, ccounts, cstates, cfreqs = rans_native.contour_encode_frames(tall_bits[None], H, W, T_tall)
    tall = rans_codec.build_bits_container(T_tall, H, W, cfreqs[0], cstates[0], ccounts[0].astype(np.uint16),
                                           cw[0, :cnw[0]])
    check(rans_codec.decompress_contour_batch([tall], None) == [tall_bits.tobytes()], "the native decoder of 513 rows")
    for what, fn, blob in (("a corrupt escape list", rans_codec.decompress_delta_batch, bytes(bad)),
                           (f"a contour of {H} rows", rans_codec.decompress_contour_batch, tall)):
        try:
            fn([blob], dev)
        except ValueError as e:
            print(f"[phase 3f] the card's decode raises on {what}: {e}")
        else:
            raise RuntimeError(f"the card's decode decoded {what}")

    # End to end: the engine's decode of phase 6's 20 blobs with its coder on
    # the card (the default) and on the host (asked for explicitly); on the
    # card one decode launch per batch (residual and contour together) and
    # one per small rANS field.
    B = 8
    engine = BatchEngine(lidar, cfg, dev, batch_size=B)
    batches = _batches(eng["blobs"], B)
    try:
        with coder_on(engine, None):
            want = [engine.decode_range_images(b) for b in batches]
        engine.decode_range_images(batches[0])  # warm-up
        torch.cuda.synchronize()
        c0 = launch_counts()
        got = [engine.decode_range_images(b) for b in batches]
        launches = launches_since(c0)["rans_decode"]

        def host_decode():
            with coder_on(engine, None):
                engine.decode_range_images(batches[0])

        cpu_ms, dev_ms = in_turns(host_decode, lambda: engine.decode_range_images(batches[0]), 2 * RATE_PASSES)
        split = engine_decode_split(np, rd, rans_codec, engine, batches[0], dev)
    finally:
        engine.close()
    small = sum(map(small_rans_fields, eng["blobs"]))
    check(all(np.array_equal(a, b) for a, b in zip(got, want)), "the engine's range images differ between the coders")
    check(launches == len(batches) + small, f"{launches} decode launches for {len(batches)} engine batches and {small} "
          "small rANS fields, expected one each")
    print(f"[phase 3f] engine decode of phase 6's {len(eng['blobs'])} blobs in batches {[len(b) for b in batches]} "
          f"on the card: range images == the host coder's, {launches} decode launches ({len(batches)} batches, "
          f"{small} small fields)")

    # Words read back per live step (a renormalization each) over phase 6's
    # 20 frames, and the latencies of a step's dependent operations.
    all_res = rans_codec.delta_lanes([f["residual_quantized"] for f in main])
    all_cnt = rans_codec.contour_lanes([f["contour_map"] for f in main])[0]
    renorm = {f: float(g.counts.sum()) / float(g.lives.clip(0, g.words.shape[2]).sum())
              for f, g in (("residual", all_res), ("contour", all_cnt))}
    print(f"[phase 3f] renormalizations per live step over phase 6's {len(main)} frames (words / live steps): "
          f"residual {renorm['residual']:.4f}, contour {renorm['contour']:.4f}")
    probe = run_chain_probe("phase 3f")
    floor_ns = {"residual": probe["floor_ns_per_step"]["decode_residual"],
                "contour": probe["floor_ns_per_step"]["decode_contour"]}

    out = {"err": err, "launches": launches, "batches": len(batches), "renorm": renorm, "probe": probe}
    for Bt in (1, B):
        rl = rans_codec.delta_lanes(res8[:Bt])
        cl = rans_codec.contour_lanes(cnt8[:Bt])[0]
        args_r, args_c = upload_lanes(dev, rl), upload_lanes(dev, cl)
        short = [upload_lanes(dev, g._replace(words=g.words[:, :, :16], lives=np.minimum(g.lives, 16)))
                 for g in (rl, cl)]
        both = lambda: rd.decode_fields_cuda(args_r, args_c, rl.mode)  # noqa: E731
        row = dict(ms=median_ms(torch, both), b2b=median_ms(torch, both, BACK_TO_BACK),
                   tables_ms=median_ms(torch, lambda: rd.decode_fields_cuda(*short, rl.mode)),
                   split=decode_split(torch, rd, args_r, args_c, rl.mode), bound=rans_decode_bound([rl, cl]),
                   shape=f"B={Bt} residual {tuple(rl.words.shape)} + contour {tuple(cl.words.shape)}",
                   ns_step={}, floor_ms={})
        for field, lanes, args in (("residual", rl, args_r), ("contour", cl, args_c)):
            T = lanes.words.shape[2]
            run = lambda a=args, m=lanes.mode: decode_group_cuda(rd, a, m)  # noqa: E731
            row[field] = dict(
                ms=median_ms(torch, run), b2b=median_ms(torch, run, BACK_TO_BACK),
                plain_ms=median_ms(torch, lambda a=args, m=lanes.mode: rd.decode_streams_plain(*a, m),
                                   runs=PLAIN_RANS_RUNS),
                host_ms=host_median_ms(lambda g=lanes: rans_codec.decode_lanes(g)),
                bound=rans_decode_bound([lanes]), shape=f"{tuple(lanes.words.shape)}",
            )
            # the one launch's walk stamp over its steps, and the chain floor at them
            row["ns_step"][field] = row["split"][field]["walk"] * 1e3 / T
            row["floor_ms"][field] = T * floor_ns[field] / 1e6
            r = row[field]
            print(f"[phase 3f] [{card}] rans decode {field} B={Bt} {r['shape']} alone, median of {TIMED_RUNS}: kernel "
                  f"{r['ms']:.4f} ms ({r['b2b']:.4f} ms over {BACK_TO_BACK} back to back); plain {r['plain_ms']:.4f} "
                  f"ms (median of {PLAIN_RANS_RUNS}); native host decode {r['host_ms']:.4f} ms (median of {HOST_RUNS}); "
                  f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]}). In the one launch: its walk "
                  f"{row['ns_step'][field]:.2f} ns a step; chain floor (measured latencies x the chain counted in the "
                  f"source) {row['floor_ms'][field]:.6f} ms ({T} steps x {floor_ns[field]:.3f} ns)")
        row.update(plain_ms=row["residual"]["plain_ms"] + row["contour"]["plain_ms"],
                   host_ms=row["residual"]["host_ms"] + row["contour"]["host_ms"])
        print(f"[phase 3f] [{card}] rans decode both fields in one launch ({row['shape']}), median of {TIMED_RUNS}: "
              f"{row['ms']:.4f} ms ({row['b2b']:.4f} ms over {BACK_TO_BACK} back to back), at T = 16 (tables and "
              f"launch) {row['tables_ms']:.4f} ms; the two fields as two launches {row['residual']['ms']:.4f} + "
              f"{row['contour']['ms']:.4f} ms; bound {row['bound'][0]:.6f} ms ({row['bound'][1]})")
        for block in rd.DECODE_STAMP_BLOCKS:
            print(f"[phase 3f] [{card}] rans decode B={Bt} frame 0 {block} block phase split (us, median of "
                  f"{TIMED_RUNS}): " + json.dumps({k: round(v, 3) for k, v in row["split"][block].items()}))
        out[Bt] = row
        # The codec's decode of the batch's two big fields, host work included.
        packed = main[:Bt]
        cpu_fields, dev_fields = in_turns(lambda: rans_codec.batch_decode_big_fields(packed, None),
                                          lambda: rans_codec.batch_decode_big_fields(packed, dev), 2 * RATE_PASSES)
        out[Bt].update(codec_cpu_ms=cpu_fields, codec_default_ms=dev_fields)
        print(f"[phase 3f] [{card}] B={Bt}: both fields' launch {out[Bt]['ms']:.4f} ms against the native host decode "
              f"{out[Bt]['host_ms']:.4f} ms; batch_decode_big_fields (parse, assemble, decode, finalize), median of "
              f"{2 * RATE_PASSES} in turns: host coder (device=None) {cpu_fields:.3f} ms, card {dev_fields:.3f} ms")
    out.update(engine_cpu_ms=cpu_ms, engine_default_ms=dev_ms, engine_split=split)
    print(f"[phase 3f] [{card}] engine decode_range_images of phase 6's first batch (B={B}), median of "
          f"{2 * RATE_PASSES} in turns: host coder (device=None) {cpu_ms:.3f} ms, card {dev_ms:.3f} ms; the native "
          f"rANS decode of its two fields {out[B]['host_ms']:.3f} ms = {out[B]['host_ms'] / cpu_ms:.3f} of the host "
          f"coder's decode")
    print(f"[phase 3f] [{card}] engine decode of phase 6's first batch (B={B}) on the card, split (ms, median of "
          f"{HOST_RUNS} each, host clock): " + json.dumps({k: round(v, 4) for k, v in split.items()}))
    return out


def engine_decode_split(np, rd, rans_codec, engine, blobs, dev):
    """The engine's decode of ``blobs`` on the card, step by step, each
    timed alone on the host clock (ms): unpack the payloads; parse the big
    fields' containers and assemble their lanes; stage, upload, launch and
    download (one call of ``decode_fields_host``; beside it the host
    coder's native decode of the same lanes); finalize the symbols
    into field bytes; decode the small fields; the whole entropy stage
    (``decompress_dict_batch``), the engine's stage 1 (the entropy stage
    and the stacking) and the whole decode (``decode_range_images``)."""
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream

    packed = [unpack_bitstream(b, uniform=True) for b in blobs]
    res = [p["residual_quantized"] for p in packed]
    cms = [p["contour_map"] for p in packed]

    def parse():
        _, groups = rans_codec._parse_delta_batch(res)
        (k, items), = groups.items()
        return items, rans_codec._delta_lanes([p for _, p in items]), rans_codec.contour_lanes(cms)

    items, rl, (cl, H, W) = parse()
    sym = rd.decode_fields_host(rl[:5], cl[:5], rl.mode, dev)

    def finalize():
        out = [b""] * len(res)
        rans_codec._finalize_delta_group(out, items, rl, sym[0])
        return out, rans_codec._finalize_contours(sym[1], cl, H, W)

    small = {k: v for p in packed for k, v in p.items() if k not in ("residual_quantized", "contour_map")}
    return dict(
        unpack=host_median_ms(lambda: [unpack_bitstream(b, uniform=True) for b in blobs]),
        parse_and_lanes=host_median_ms(parse),
        stage_upload_launch_download=host_median_ms(lambda: rd.decode_fields_host(rl[:5], cl[:5], rl.mode, dev)),
        native_decode_in_its_place=host_median_ms(lambda: (rans_codec.decode_lanes(rl, None),
                                                           rans_codec.decode_lanes(cl, None))),
        finalize=host_median_ms(finalize),
        small_fields=host_median_ms(lambda: [engine.entropy.decompress(p[k]) for p in packed for k in small]),
        entropy_stage=host_median_ms(lambda: engine.entropy.decompress_dict_batch(packed)),
        engine_prepare=host_median_ms(lambda: engine._prepare_decode(blobs)),
        decode_range_images=host_median_ms(lambda: engine.decode_range_images(blobs)),
    )


# ------------------------------------------------------------------ 3g: rANS encode, host path
def walk(np, n: int, seed: int = 0, dtype="int16", step: int = 3):
    """A random walk of n integers (the host-encode test's fields)."""
    return np.cumsum(np.random.default_rng(seed).integers(-step, step + 1, n)).astype(dtype)


def host_edge_fields(np):
    """(what, arrays, lanes) batches of tests/test_torch_rans_host_encode.py's
    edge fields: stream lengths around every lane-count and 'Z' boundary,
    explicit lane counts, int32 deltas of +-(2^31 - 1), 513 escapes and a
    u16 run field; the mixed small / big batch is apart (its bytes are the
    reference's default bytes, not the native backend's)."""
    rng = np.random.default_rng(11)
    wide = np.zeros(3000, np.int32)
    wide[1::2] = 2**31 - 1  # deltas of +-(2^31 - 1): the widest a delta container takes
    spiky = walk(np, 40000, 12)
    spiky[100:100 + 2 * 256:2] += rng.integers(3000, 9000, 256).astype(np.int16)  # two escapes a spike
    spiky[30000:] += 5000  # and one step: 513
    seq = np.repeat(rng.integers(0, 300, 400), rng.integers(1, 30, 400)).astype(np.uint16)
    out = [(f"n {n}", [walk(np, n, n)], None) for n in (0, 1, 64, 65, 1024, 1025, 32768, 32769, 128000)]
    out += [(f"lanes {L}", [walk(np, 8000, L, step=1), walk(np, 500, L, step=1)], L) for L in (1, 2, 8, 32)]
    out += [("int32 deltas +-(2^31 - 1)", [wide], None), ("513 escapes", [spiky], None), ("u16 run field", [seq], None)]
    return out


def host_rans_bound(lens, L: int, T: int, n_contours: int, H: int, W: int):
    """The host path's encode at its geometry: each stream's int32 symbols
    and its length read once, the pieces written once (u16 words over L
    lanes x T, lane counts and u64-held states, 4 x 512 i32 tables, 512
    u64-held escapes, 4 scalars); each contour's H x W int32 plane read
    once and its pieces (H lanes x contour_T words, counts, states, 8
    tables) written once.  Bytes only, as rans_bound."""
    from rpcc_tpu_torch.ops.rans_device import contour_T

    res = sum(4 * n + 4 + 2 * L * T + 12 * L + 4 * 4 * 512 + 8 * 512 + 12 for n in lens)
    cnt = n_contours * (4 * H * W + 2 * H * contour_T(H, W) + 12 * H + 4 * 8 + 4)
    return bound(0.0, float(res + cnt))


def phase_rans_host(torch, np, dev, card, lidar, codec, frames, eng_blobs):
    """3g: the host containers encoded on the card (the codec's and the
    engine's default): bytes against the native host coder's (asked for
    with ``device=None``), one launch per batch call, and the kernel at the
    host geometry, the encode calls on both and the native host encode of
    the same batch timed, in turns; the small fields' calls (a 1,000-symbol
    encode, a T = 16 decode) against the native coder's."""
    from rpcc_tpu_torch.codec import rans_codec, rans_native
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import rans_device as rd
    from rpcc_tpu_torch.ops.projection_host import build_transform_map
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    counted = {"launches": 0, "calls": 0}  # over every counted run below: kernel launches and batch calls

    def count(launches, calls):
        counted["launches"] += launches
        counted["calls"] += calls

    # Single-frame blobs of phases 4 (the main path) and 4b (DBSCAN mode).
    tm = build_transform_map(lidar)
    for tag, cfg, clouds in (("default", CodecConfig(), {s: frames[s] for s in SEEDS}),
                             ("DBSCAN", CodecConfig(segment_method="DBSCAN"),
                              {s: scene_cloud(np, tm, s) for s in MODE_SEEDS})):
        c = codec if tag == "default" else RPCCCodec(lidar, cfg, dev)
        for s, pc in clouds.items():
            with coder_on(c, None):
                c0 = launch_counts()
                want, fields, _ = c.compress(pc)
                check(launches_since(c0)["rans"] == 0, f"{tag} seed {s}: the host coder launched the rANS kernel")
            c0 = launch_counts()
            got = c.compress(pc)[0]
            launches = launches_since(c0)["rans"]
            check(got == want, f"{tag} seed {s}: the card's blob differs from the host coder's")
            check(launches == rans_encode_calls(np, fields), f"{tag} seed {s}: {launches} rANS launches for "
                  f"{rans_encode_calls(np, fields)} coded fields")
            count(launches, rans_encode_calls(np, fields))
            print(f"[phase 3g] {tag} seed {s} blob coded on the card == the host coder's, sha256 "
                  f"{hashlib.sha256(got).hexdigest()}, {launches} rANS launches (one a field)")

    codec_turns = codec_in_turns(codec, frames[SEEDS[0]], dev, 2 * RATE_PASSES)
    print(f"[phase 3g] [{card}] RPCCCodec single-frame encode and decode of seed {SEEDS[0]}, its coder on the card "
          f"and on the host (device=None), in turns (median of {2 * RATE_PASSES} each, ms): "
          + json.dumps({k: {d: round(v, 4) for d, v in row.items()} for k, row in codec_turns.items()}))

    # The engine's host-entropy path on phase 6's first batch.
    seeds8 = BATCH_SEEDS[:8]
    clouds8 = [synth_cloud_for(lidar, s) for s in seeds8]
    engine = BatchEngine(lidar, CodecConfig(device_entropy=False), dev, batch_size=8)
    try:
        with coder_on(engine, None):
            want = engine.encode_frames(clouds8, seeds8)
        c0 = launch_counts()
        got = engine.encode_frames(clouds8, seeds8)
        launches = launches_since(c0)["rans"]
    finally:
        engine.close()
    check([b for b, _ in got] == [b for b, _ in want], "the engine's host-entropy blobs differ between the coders")
    groups = len({rans_codec._geometry(f["residual_quantized"].size) for _, f in want})
    check(launches == groups + 1 + len(seeds8), f"{launches} rANS launches for the engine's batch, expected "
          f"{groups} residual groups + 1 contour batch + {len(seeds8)} sequences")
    count(launches, groups + 1 + len(seeds8))
    print(f"[phase 3g] engine (B=8, --no-device_entropy) on the card: blobs == the host coder's, "
          f"{launches} rANS launches ({groups} residual lane geometries, 1 contour batch, {len(seeds8)} sequence fields)")

    # The tests' edge fields, and the mixed small / big batch.
    for what, arrays, lanes in host_edge_fields(np):
        want = rans_codec.compress_delta_batch(arrays, lanes=lanes, device=None)
        want_c = [rans_codec.compress(a, lanes=lanes, device=None) for a in arrays]
        c0 = launch_counts()
        got = rans_codec.compress_delta_batch(arrays, lanes=lanes, device=dev)
        got_c = [rans_codec.compress(a, lanes=lanes, device=dev) for a in arrays]
        launches = launches_since(c0)["rans"]
        check(launches == 1 + len(arrays), f"{what}: {launches} launches for {1 + len(arrays)} calls")
        count(launches, 1 + len(arrays))
        check(got == want and got_c == want_c, f"the card's containers differ from the host coder's on {what}")
        check([rans_codec.decompress(b, dev) for b in got_c] == [a.tobytes() for a in arrays],
              f"the card's decode of the card's containers on {what}")
        print(f"[phase 3g] card == host coder on {what}: {[chr(b[0]) for b in got]}, {[len(b) for b in got]} bytes")
    # Divergence 33: a batch mixing frames of at most and of more than 32,768
    # symbols takes one geometry on the card (the reference's default bytes).
    mixed = [walk(np, 20000, 7, step=1), walk(np, 40000, 8)]
    cpu_mixed = rans_codec.compress_delta_batch(mixed, device=None)
    one_geometry = rans_codec._compress_delta_batch_np(mixed)  # the reference's default recipe, native coder
    got = rans_codec.compress_delta_batch(mixed, device=dev)
    check(got == one_geometry and got != cpu_mixed, "the mixed batch: the card's bytes differ from the native "
          "coder's at one geometry, or equal the host path's")
    for blobs in (got, cpu_mixed):
        for d in (None, dev):
            check(rans_codec.decompress_delta_batch(blobs, d) == [a.tobytes() for a in mixed],
                  f"divergence 33: a mixed batch's containers do not decode on {d}")
    rel = abs(sum(map(len, got)) - sum(map(len, cpu_mixed))) / sum(map(len, cpu_mixed))
    check(rel <= BPP_TOL, f"divergence 33: the two sides' sizes differ by {rel:.4%}")
    print(f"[phase 3g] divergence 33, mixed batch (20000 + 40000): card == the native coder at one geometry (the "
          f"reference's default bytes), {[len(b) for b in got]} vs the host path's {[len(b) for b in cpu_mixed]} "
          f"bytes (rel {rel:.5f}); both decode on both")
    tall = np.packbits(np.zeros(rd.MAX_CONTOUR_ROWS + 1, np.uint8))
    try:
        rans_codec.compress_contour(tall, rd.MAX_CONTOUR_ROWS + 1, 1, dev)
    except ValueError as e:
        print(f"[phase 3g] the card raises on a contour of {rd.MAX_CONTOUR_ROWS + 1} rows: {e}")
    else:
        raise RuntimeError("the card coded a contour past the kernel's rows")

    # Times on phase 6's first batch: the kernel at the host geometry, the
    # encode calls on both backends, the native host encode of the batch.
    fields8 = [codec.compress(pc, seed=s)[1] for pc, s in zip(clouds8, seeds8)]
    streams = [f["residual_quantized"] for f in fields8]
    packed = [f["contour_map"] for f in fields8]
    H, W = lidar.height, lidar.width
    T_c = rd.contour_T(H, W)
    out = dict(counted, codec=codec_turns)
    print(f"[phase 3g] {counted['launches']} rANS launches over {counted['calls']} batch calls on the card")
    for B in (1, 8):
        sb, pb = streams[:B], packed[:B]
        L, T = rans_codec._geometry(max(a.size for a in sb))
        q, n = rd.upload_streams(sb, dev)
        cont = rd.upload_contours(np.stack(pb), H, W, dev)
        got = rd.encode_fields_cuda(q, n, None, lanes=L, T=T)[0]
        want = rd.encode_streams_plain(q, n, L, T)
        got_c, want_c = rd.encode_fields_cuda(None, None, cont)[1], rd.encode_contour_field_plain(cont)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(list(got) + list(got_c), list(want) + list(want_c)))
        check(err == 0, f"the rANS kernel at the host geometry (B={B}, L={L}, T={T}) differs from the plain version")
        res_ms = median_ms(torch, lambda: rd.encode_fields_cuda(q, n, None, lanes=L, T=T)[0])
        res_b2b = median_ms(torch, lambda: rd.encode_fields_cuda(q, n, None, lanes=L, T=T)[0], BACK_TO_BACK)
        cnt_ms = median_ms(torch, lambda: rd.encode_fields_cuda(None, None, cont))
        both_ms = median_ms(torch, lambda: rd.encode_fields_cuda(q, n, cont, lanes=L, T=T))
        both_b2b = median_ms(torch, lambda: rd.encode_fields_cuda(q, n, cont, lanes=L, T=T), BACK_TO_BACK)
        plain_ms = median_ms(torch, lambda: (rd.encode_streams_plain(q, n, L, T), rd.encode_contour_field_plain(cont)),
                             runs=PLAIN_RANS_RUNS)
        cpu_res, call_res = in_turns(lambda: rans_codec.compress_delta_batch(sb, device=None),
                                     lambda: rans_codec.compress_delta_batch(sb, device=dev), 2 * RATE_PASSES)
        cpu_cnt, call_cnt = in_turns(lambda: rans_codec.compress_contour_batch(pb, H, W, None),
                                     lambda: rans_codec.compress_contour_batch(pb, H, W, dev), 2 * RATE_PASSES)
        # The staged wrapper (one upload, one launch, one download) gives the
        # kernel's pieces on tensors uploaded one at a time; the card call's
        # residual half split: those pieces, the rest being the assembly.
        staged = rd.encode_streams_host(sb, L, T, dev)
        check(all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(staged, got)),
              f"the staged encode wrapper's pieces differ from the kernel's on uploaded tensors (B={B})")
        pieces_ms = host_median_ms(lambda: rd.encode_streams_host(sb, L, T, dev), RATE_PASSES)
        native_res = host_median_ms(lambda: rans_native.delta_encode_frames(sb, L, T, rd.ALPHABET, rd.NUM_CTX))
        native_cnt = host_median_ms(lambda: rans_native.contour_encode_frames(np.stack(pb), H, W, T_c))
        b_ms, b_by = host_rans_bound([a.size for a in sb], L, T, B, H, W)
        out[B] = dict(shape=f"B={B} residual L={L} T={T} (n {[a.size for a in sb]}) + contour {H}x{W} T={T_c}",
                      err=err, ms=both_ms, b2b=both_b2b, residual_ms=res_ms, residual_b2b=res_b2b, contour_ms=cnt_ms,
                      plain_ms=plain_ms, bound=(b_ms, b_by), call_ms=call_res + call_cnt, call_residual_ms=call_res,
                      call_contour_ms=call_cnt, pieces_ms=pieces_ms,
                      cpu_call_ms=cpu_res + cpu_cnt, native_ms=native_res + native_cnt,
                      native_residual_ms=native_res, native_contour_ms=native_cnt)
        r = out[B]
        print(f"[phase 3g] [{card}] rans host path {r['shape']}: kernel == plain; median of {TIMED_RUNS}: both fields "
              f"in one launch {both_ms:.4f} ms ({both_b2b:.4f} ms over {BACK_TO_BACK} back to back), residual launch "
              f"{res_ms:.4f} ms ({res_b2b:.4f} back to back), contour launch {cnt_ms:.4f} ms; plain {plain_ms:.4f} ms "
              f"(median of {PLAIN_RANS_RUNS}); bound {b_ms:.6f} ms ({b_by})")
        print(f"[phase 3g] [{card}] B={B} encode calls (median of {2 * RATE_PASSES} in turns; upload, launch, "
              f"download, assembly): card compress_delta_batch {call_res:.3f} ms + compress_contour_batch "
              f"{call_cnt:.3f} ms; host coder (device=None) {cpu_res:.3f} + {cpu_cnt:.3f} ms; native "
              f"delta_encode_frames {native_res:.3f} ms + contour_encode_frames {native_cnt:.3f} ms (median of "
              f"{HOST_RUNS}); the card's residual call: staged upload + launch + download {pieces_ms:.3f} ms, "
              f"assembly the rest ({call_res - pieces_ms:.3f} ms)")
    # A small field: 1,000 symbols take 16 lanes of 64 steps.
    small = [streams[0][:1000]]
    L, T = rans_codec._geometry(1000)
    check(L == 16, f"a 1,000-symbol field takes {L} lanes")
    q, n = rd.upload_streams(small, dev)
    got, want = rd.encode_fields_cuda(q, n, None, lanes=L, T=T)[0], rd.encode_streams_plain(q, n, L, T)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "the rANS kernel differs from the plain version at L = 16")
    s_ms = median_ms(torch, lambda: rd.encode_fields_cuda(q, n, None, lanes=L, T=T)[0])
    s_cpu, s_call = in_turns(lambda: rans_codec.compress_delta_batch(small, device=None),
                             lambda: rans_codec.compress_delta_batch(small, device=dev), HOST_RUNS)
    s_native = host_median_ms(lambda: rans_native.delta_encode_frames(small, L, T, rd.ALPHABET, rd.NUM_CTX))
    seq = fields8[0]["idx_sequence"]
    seq_cpu, seq_call = in_turns(lambda: rans_codec.compress(seq, device=None),
                                 lambda: rans_codec.compress(seq, device=dev), HOST_RUNS)
    # Its 'C' container's decode call (one field group), and a T = 16 decode
    # call of phase 6's frame 0's two big fields cut to 16 steps (the
    # tables, the launch and the wrapper), each against the native coder.
    w, nw, cts, sts, fqs, esc, n_esc, q0 = rans_native.delta_encode_frames(small, L, T, rd.ALPHABET, rd.NUM_CTX)
    c_blob = rans_codec.build_ctx_container(L, T, 1000, q0[0], esc[0, :n_esc[0]], fqs[0], sts[0], cts[0],
                                            w[0, :nw[0]], small[0].dtype)
    lanes_small = rans_codec.delta_lanes([c_blob])
    check(rans_codec.decompress_delta_batch([c_blob], dev) == [small[0].tobytes()], "the 1,000-symbol field's decode")
    d_cpu, d_call = in_turns(lambda: rans_codec.decode_lanes(lanes_small, None),
                             lambda: rans_codec.decode_lanes(lanes_small, dev), HOST_RUNS)
    main1 = [unpack_bitstream(b, uniform=True) for b in eng_blobs[:1]]
    rl = rans_codec.delta_lanes([main1[0]["residual_quantized"]])
    cl = rans_codec.contour_lanes([main1[0]["contour_map"]])[0]
    short = [g._replace(words=np.ascontiguousarray(g.words[:, :, :16]), lives=np.minimum(g.lives, 16)) for g in (rl, cl)]
    # (the cut lanes are not a valid stream: the plain version is the oracle there, as for corrupt lanes)
    want16 = [rd.decode_streams_plain(*rd.upload_decode_lanes(*g[:5], dev), g.mode).cpu().numpy() for g in short]
    got16 = rd.decode_fields_host(short[0][:5], short[1][:5], rl.mode, dev)
    check(all(np.array_equal(a, b) for a, b in zip(got16, want16)), "the T = 16 decode call differs from the plain "
          "version")
    t16_cpu, t16_call = in_turns(
        lambda: [rans_native.decode_ctx_batch(g.words, g.counts, g.states, g.freqs, 16, g.mode, lives=g.lives)
                 for g in short],
        lambda: rd.decode_fields_host(short[0][:5], short[1][:5], rl.mode, dev), HOST_RUNS)
    out["small"] = dict(shape=f"B=1 n=1000 L={L} T={T}", ms=s_ms, call_ms=s_call, cpu_call_ms=s_cpu, native_ms=s_native,
                        bound=host_rans_bound([1000], L, T, 0, H, W), seq_n=int(seq.size), seq_call_ms=seq_call,
                        seq_cpu_call_ms=seq_cpu, decode_call_ms=d_call, decode_cpu_call_ms=d_cpu,
                        t16_shape=f"residual {short[0].words.shape} + contour {short[1].words.shape}",
                        t16_call_ms=t16_call, t16_native_ms=t16_cpu)
    print(f"[phase 3g] [{card}] 1,000-symbol field (L={L}, T={T}): kernel {s_ms:.4f} ms (median of {TIMED_RUNS}); "
          f"in turns (median of {HOST_RUNS} each): compress_delta_batch card {s_call:.4f} ms, host coder "
          f"(device=None) {s_cpu:.4f} ms; native delta_encode_frames {s_native:.4f} ms (host calls include their "
          f"'Z' comparison); its 'C' container's decode_lanes card {d_call:.4f} ms, host coder {d_cpu:.4f} ms")
    print(f"[phase 3g] [{card}] frame 0's sequence field ({seq.size} symbols): rans_codec.compress card "
          f"{seq_call:.4f} ms, host coder {seq_cpu:.4f} ms (in turns, median of {HOST_RUNS})")
    print(f"[phase 3g] [{card}] T = 16 decode call ({out['small']['t16_shape']}): decode_fields_host (one staged "
          f"upload, one launch, one download) {t16_call:.4f} ms, the native decode of both groups {t16_cpu:.4f} ms "
          f"(in turns, median of {HOST_RUNS})")
    return out


def codec_in_turns(codec, pc, dev, passes: int):
    """The single-frame codec's encode and decode of ``pc`` with its coder
    on the host (asked for with None) and on ``dev``, in turns: medians (ms)
    of the whole call and of its ``entropy`` stage (the codec's own timer)."""
    blob = codec.compress(pc)[0]
    rows = {k: {"host": [], "card": []} for k in ("encode", "encode_entropy", "decode", "decode_entropy")}
    for i in range(passes + 1):
        for side in (("host", "card") if i % 2 == 0 else ("card", "host")):
            with coder_on(codec, None if side == "host" else dev):
                t = time.perf_counter()
                got, _, enc_t = codec.compress(pc)
                t1 = time.perf_counter()
                _, _, dec_t = codec.decompress(blob)
                t2 = time.perf_counter()
            check(got == blob, f"the codec's {side} encode gave other bytes")
            if i:  # the first pass warms both up
                rows["encode"][side].append((t1 - t) * 1e3)
                rows["encode_entropy"][side].append(enc_t["entropy"] * 1e3)
                rows["decode"][side].append((t2 - t1) * 1e3)
                rows["decode_entropy"][side].append(dec_t["entropy"] * 1e3)
    return {k: {side: statistics.median(v) for side, v in row.items()} for k, row in rows.items()}


def drive_mode(torch, np, dev, card, lidar, tag, cfg, frames, phase):
    """One codec mode through ``RPCCCodec(lidar, cfg, "cuda")``: each frame
    encoded, decoded and encoded again with the launches counted (one FPS
    or DBSCAN wrapper call per encode), the error bound, exact zero pixels,
    byte-identical repeats, and the CPU codec's bpp (within BPP_TOL) and
    decode of the card's blob.  -> (launch counts, encode_frames results)"""
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    n_enc = 2 * len(frames)
    bound = (cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)) + 1e-5
    codec = RPCCCodec(lidar, cfg, dev)
    codec.decompress(codec.compress(next(iter(frames.values())))[0])  # warm-up
    torch.cuda.synchronize()
    c0 = launch_counts()
    results = encode_frames(codec, frames)
    counts = launches_since(c0)
    want = {"fps": 0, "dbscan": n_enc} if cfg.segment_method == "DBSCAN" else {"fps": n_enc, "dbscan": 0}
    # the containers are coded on the card: one launch a coded field, both big fields decoded in one
    want["rans"] = sum(2 * rans_encode_calls(np, r[3]) for r in results.values())
    want["rans_decode"] = sum(big_rans_decodes([r[1]], cfg.uniform) + small_rans_fields(r[1], cfg.uniform)
                              for r in results.values())
    check(counts == want and counts["rans"] > 0 and counts["rans_decode"] > 0,
          f"{tag}: kernel launches {counts} over {n_enc} encodes, expected {want}")
    print(f"[phase {phase}] {tag} ({lidar.height}x{lidar.width}): launches {counts} for {n_enc} encodes")
    bpps = check_frames(np, codec, results, bound, card, tag, phase)

    cpu_codec = RPCCCodec(lidar, cfg, "cpu")
    c0 = launch_counts()
    for s, pc in frames.items():
        blob_cpu, fields_cpu, _ = cpu_codec.compress(pc)
        bpp_cpu = len(blob_cpu) * 8 / fields_cpu["residual_quantized"].size
        rel = abs(bpps[s] - bpp_cpu) / bpp_cpu
        _, ri_x, _ = cpu_codec.decompress(results[s][1])  # GPU blob, CPU decoder
        q, d = codec.project(pc)
        x_err = float(np.abs(ri_x - q.astype(np.float32) * d).max())
        print(f"[phase {phase}] {tag} seed {s} cuda vs cpu: bpp {bpps[s]:.5f} vs {bpp_cpu:.5f} "
              f"(rel diff {rel:.5f}), cpu decode of the cuda blob max_err {x_err:.6f}, "
              f"blobs identical {blob_cpu == results[s][1]}")
        check(rel <= BPP_TOL, f"{tag} seed {s}: cuda vs cpu bpp differ by {rel:.4%}")
        check(x_err <= bound, f"{tag} seed {s}: cpu decode of the cuda blob: max_err {x_err} > {bound}")
    n = launches_since(c0, ("rans", "rans_decode"))
    check(n["rans"] == n["rans_decode"] == 0, f"{tag}: the codec on device='cpu' launched the rANS kernels ({n})")
    return counts, results


def phase_modes(torch, np, dev, card, lidar):
    """4b: the DBSCAN, plane and non-uniform paths; returns DBSCAN's
    launches per encode."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    tm = build_transform_map(lidar)
    frames = {s: scene_cloud(np, tm, s) for s in MODE_SEEDS}
    dbscan_launches = None
    for tag, cfg in (
        ("DBSCAN", CodecConfig(segment_method="DBSCAN")),
        ("plane", CodecConfig(modeling_method="plane")),
        ("non-uniform", CodecConfig(compress_framework="non-uniform")),
    ):
        counts, results = drive_mode(torch, np, dev, card, lidar, tag, cfg, frames, "4b")
        if tag == "DBSCAN":
            dbscan_launches = counts["dbscan"] / (2 * len(frames))
            for s, res in results.items():
                print(f"[phase 4b] DBSCAN seed {s} blob sha256 {hashlib.sha256(res[1]).hexdigest()}")
    return dbscan_launches


def phase_new_modes(torch, np, dev, card, lidar):
    """4c: ``cpu_fps`` and ``f32`` on the 64E, the 32E channel table in FPS
    and DBSCAN mode; returns each mode's launches per encode."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    per_encode = {}
    for tag, lid, cfg in (
        ("cpu_fps", lidar, CodecConfig(cpu_fps=True)),
        ("f32", lidar, CodecConfig(transfer_precision="f32")),
        ("32E CSV", lidar32, CodecConfig()),
        ("32E CSV DBSCAN", lidar32, CodecConfig(segment_method="DBSCAN")),
    ):
        tm = build_transform_map(lid)
        frames = {s: scene_cloud(np, tm, s) for s in MODE_SEEDS}
        counts, _ = drive_mode(torch, np, dev, card, lid, tag, cfg, frames, "4c")
        per_encode[tag] = {k: v / (2 * len(frames)) for k, v in counts.items()}
    return per_encode


# ------------------------------------------------------- 4d: raw points
def random_fov_cloud(np, lidar, n: int, seed: int):
    """``n`` points uniformly random in the LiDAR's field of view (any
    azimuth, an elevation between its lowest and highest rows, 3-70 m): off
    the scan grid, many sharing a pixel."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(lidar.vertical_min, lidar.vertical_max, n)
    r = rng.uniform(3.0, 70.0, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1).astype(np.float32)


def projection_agreement(np, ri, ref, what: str):
    """The in-graph range image ``ri`` against ``ref`` at the JAX package's
    device-vs-host bounds (tests/test_host_projection.py:127-139): support
    agreement >= 0.9999 and, where both have a return, >= 0.999 of the
    depths within rtol 2e-6.  -> (differing pixels, support agreement,
    share of close depths)."""
    support = float(((ri > 0) == (ref > 0)).mean())
    both = (ri > 0) & (ref > 0)
    close = float(np.isclose(ri[both], ref[both], rtol=2e-6, atol=0).mean()) if both.any() else 1.0
    check(support >= 0.9999 and close >= 0.999,
          f"{what}: support agreement {support}, close depths {close} (bounds 0.9999, 0.999)")
    return int((ri != ref).sum()), support, close


def assemble_blobs(torch, engine, out, batched: bool = False):
    """The ``.rpcc`` payloads of encoder outputs on the engine's device, put
    together as the batch engine puts together its device-entropy
    containers (``BatchEngine.finalize_encoded``)."""
    from rpcc_tpu_torch.parallel.engine import _Dispatched

    if not batched:
        out = out.map(lambda x: x[None])
    done = None
    if engine.device.type == "cuda":
        done = torch.cuda.Event()
        done.record()
    return [b for b, _ in engine.finalize_encoded(_Dispatched(out, out.range_image.shape[0], done))]


def outputs_equal(torch, a, b) -> bool:
    def same(x, y):
        if isinstance(x, tuple):  # a piece tuple
            return all(torch.equal(u, v) for u, v in zip(x, y))
        return (x is None) == (y is None) and (x is None or torch.equal(x, y))

    return all(same(x, y) for x, y in zip(a, b))


def drive_points(torch, np, dev, card, tag, lid, cfg, clouds, seeds):
    """4d: ``make_encoder(lid, cfg, from_ri=False)`` on each cloud: the
    in-graph range image against the host's f32 projection and the CPU's
    in-graph one; one segmentation (FPS or DBSCAN wrapper) call and one
    rANS launch per encode; repeat encodes byte-identical; blobs, assembled
    as the engine assembles device-entropy containers, decoded by the host
    decoder within step + 1e-5 of the in-graph range image; bpp within
    BPP_TOL of the CPU's encode and of the engine's f32 host-projected
    encode of the same frame.  -> (device encoder, {name: (outputs, blob)})"""
    from rpcc_tpu_torch.models.encoder import make_encoder
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.ops.projection import project_points
    from rpcc_tpu_torch.ops.projection_host import project_points_host
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    seg = "dbscan" if cfg.segment_method == "DBSCAN" else "fps"
    want = {"fps": 0, "dbscan": 0, "rans": 1, "rans_decode": 0, seg: 1}
    bound = cfg.step + 1e-5
    encode = make_encoder(lid, cfg, from_ri=False, device=dev)
    encode_cpu = make_encoder(lid, cfg, from_ri=False, device="cpu")
    va, va_cpu = encode.__self__.v_angles, encode_cpu.__self__.v_angles
    check(lid.even_dist == (va is None), f"{tag}: the channel table's rows need the encoder's angle table")
    engine = BatchEngine(lid, cfg, dev, batch_size=8, workers=2)
    cpu_engine = BatchEngine(lid, cfg, "cpu", batch_size=8, workers=2)
    f32_engine = BatchEngine(lid, cfg.replace(transfer_precision="f32"), dev, batch_size=8, workers=2)
    host = HostDecoder(lid, cfg)
    results = {}
    try:
        f32 = f32_engine.encode_frames(list(clouds.values()), seeds)
        encode(next(iter(clouds.values())), seeds[0], cfg.step)  # warm-up
        torch.cuda.synchronize()
        for i, ((name, pc), seed) in enumerate(zip(clouds.items(), seeds)):
            ri = project_points(torch.from_numpy(pc).to(dev), lid, va).cpu().numpy()
            agree = {k: projection_agreement(np, ri, r, f"{tag} {name}: card vs {k} projection") for k, r in (
                ("host f32", project_points_host(pc, lid)),
                ("cpu in-graph", project_points(torch.from_numpy(pc), lid, va_cpu).numpy()))}

            c0 = launch_counts()
            out = encode(pc, seed, cfg.step)
            torch.cuda.synchronize()
            launches = launches_since(c0)
            check(launches == want, f"{tag} {name}: launches {launches} for one encode, expected {want}")
            check(bool((out.range_image.cpu().numpy() == ri).all()), f"{tag} {name}: the encoder's range image "
                  "differs from the projection's")
            blob = assemble_blobs(torch, engine, out)[0]
            again = encode(pc, seed, cfg.step)
            check(outputs_equal(torch, out, again) and assemble_blobs(torch, engine, again)[0] == blob,
                  f"{tag} {name}: a repeat encode gave different outputs or bytes")
            rec = host.decode_blobs([blob])[0]
            err = float(np.abs(rec - ri).max())
            check(err <= bound and bool((rec[ri == 0] == 0).all()),
                  f"{tag} {name}: host decode max_err {err} > {bound}, or a zero pixel decoded nonzero")
            out_cpu = encode_cpu(pc, seed, cfg.step)
            blob_cpu = assemble_blobs(torch, cpu_engine, out_cpu)[0]
            n = int(out.stream_len)
            bpp = {"card": len(blob) * 8 / n, "cpu": len(blob_cpu) * 8 / int(out_cpu.stream_len),
                   "f32 host-projected": len(f32[i][0]) * 8 / int(f32.stream_len[i])}
            rel = {k: (v - bpp["card"]) / v for k, v in bpp.items() if k != "card"}
            check(all(abs(r) <= BPP_TOL for r in rel.values()), f"{tag} {name}: bpp {bpp} differ by more than {BPP_TOL}")
            print(f"[phase 4d] [{card}] {tag} {name} ({pc.shape[0]} points, {lid.height}x{lid.width}): projection "
                  + ", ".join(f"vs {k}: {d} px differ, support {s:.6f}, close {c:.6f}" for k, (d, s, c) in agree.items())
                  + f"; launches {launches}; {n} returns, bpp card {bpp['card']:.5f} cpu {bpp['cpu']:.5f} f32 "
                  f"host-projected {bpp['f32 host-projected']:.5f}; host decode max_err {err:.6f} "
                  f"(bound {bound:.5f}); repeat encode byte-identical True")
            results[name] = (out, blob)
    finally:
        for e in (engine, cpu_engine, f32_engine):
            e.close()
    return encode, results


def time_points(torch, np, dev, card, lidar, cfg):
    """4d timings: the in-graph projection (one call, and BACK_TO_BACK back
    to back, CUDA events; its device time and launches a call under
    torch.profiler) at (1, 128000) and (8, 128000) points beside the host's
    native f32 projection of the same frames, with its byte bound;
    the from-points encode's wall time (median of RATE_PASSES) and its device
    time under torch.profiler, at B = 1 and 8 (printed)."""
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.encoder import make_batch_encoder, make_encoder
    from rpcc_tpu_torch.ops.projection import project_points
    from rpcc_tpu_torch.ops.projection_host import project_points_host

    frames = [synth_cloud_for(lidar, s) for s in range(8)]
    n = frames[0].shape[0]
    check(all(f.shape == (128000, 3) for f in frames), "the 64E synthetic frames are not 128,000 points each")
    encode = make_encoder(lidar, cfg, from_ri=False, device=dev)
    encode_b = make_batch_encoder(lidar, cfg, from_ri=False, device=dev)
    for B in (1, 8):
        pts = torch.from_numpy(np.stack(frames[:B])).to(dev)
        one = median_ms(torch, lambda: project_points(pts, lidar))
        b2b = median_ms(torch, lambda: project_points(pts, lidar), BACK_TO_BACK)
        host = []
        for _ in range(TIMED_RUNS):
            t = time.perf_counter()
            for f in frames[:B]:
                project_points_host(f, lidar)
            host.append((time.perf_counter() - t) * 1e3)
        bound_ms, bound_by = bound(0.0, 12.0 * B * n + 4.0 * B * lidar.height * lidar.width)
        p_ev, p_calls, p_dev, p_wall = _device_profile(
            torch, lambda: [project_points(pts, lidar) for _ in range(BACK_TO_BACK)])

        def run():
            if B == 1:
                return encode(frames[0], 0, cfg.step)
            return encode_b(np.stack(frames), list(range(8)), cfg.step)

        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(RATE_PASSES):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        n_ev, calls, dev_ms, prof_wall = _device_profile(torch, run)
        print(f"[phase 4d] [{card}] in-graph projection ({B}, {n}) median of {TIMED_RUNS}: {one:.4f} ms one call, "
              f"{b2b:.4f} ms over {BACK_TO_BACK} back to back; host native f32 projection of the same "
              f"{B} frame(s) {statistics.median(host):.4f} ms; bound {bound_ms:.6f} ms ({bound_by}); under "
              f"torch.profiler, a call: {p_ev / BACK_TO_BACK:.1f} device events, {p_calls / BACK_TO_BACK:.1f} launch "
              f"calls, device time {p_dev / BACK_TO_BACK:.4f} ms of {p_wall / BACK_TO_BACK:.4f} ms wall")
        print(f"[phase 4d] [{card}] from-points encode B={B}: wall median {statistics.median(walls):.3f} ms "
              f"(min {min(walls):.3f}, max {max(walls):.3f}, {RATE_PASSES} passes); under torch.profiler "
              f"{n_ev} device events, {calls} launch calls, device time {dev_ms:.3f} ms of {prof_wall:.3f} ms "
              f"wall (idle {1 - dev_ms / prof_wall:.3f})")


def phase_points(torch, np, dev, card, lidar, frames):
    """4d: the point-cloud entry on the card (``make_encoder`` /
    ``make_batch_encoder`` with ``from_ri=False``), the dataset layer and
    the codec API.  -> kernel launches per from-points encode"""
    from rpcc_tpu_torch.codec import api
    from rpcc_tpu_torch.codec.entropy import BasicCompressor
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, build_dataset, lidar_config
    from rpcc_tpu_torch.data.dataset import DatasetTemplate, spot_check_datalist
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.encoder import make_batch_encoder, num_model_rows
    from rpcc_tpu_torch.ops.projection_host import build_transform_map, project_points_host
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    cfg = CodecConfig()
    tm = build_transform_map(lidar)
    clouds = {f"synth {s}": frames[s] for s in SEEDS}
    clouds.update({f"street {s}": scene_cloud(np, tm, s) for s in MODE_SEEDS})
    clouds["random"] = random_fov_cloud(np, lidar, 120000, 7)
    seeds = list(range(len(clouds)))
    encode, results = drive_points(torch, np, dev, card, "default", lidar, cfg, clouds, seeds)
    streets = {k: v for k, v in clouds.items() if k.startswith("street")}
    drive_points(torch, np, dev, card, "DBSCAN", lidar, CodecConfig(segment_method="DBSCAN"), streets, seeds[:2])
    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    tm32 = build_transform_map(lidar32)
    drive_points(torch, np, dev, card, "32E CSV (argmin rows)", lidar32, cfg,
                 {f"street {s}": scene_cloud(np, tm32, s) for s in MODE_SEEDS}, seeds[:2])

    # A zero-padded B = 8 batch of uneven clouds equals its B = 1 encodes.
    batch_clouds = list(clouds.values()) + [synth_cloud_for(lidar, 4)[::3]]
    seeds8 = list(range(100, 108))
    batch = np.zeros((8, max(c.shape[0] for c in batch_clouds), 3), np.float32)
    for b, c in enumerate(batch_clouds):
        batch[b, : c.shape[0]] = c
    encode_b = make_batch_encoder(lidar, cfg, from_ri=False, device=dev)
    c0 = launch_counts()
    out_b = encode_b(torch.from_numpy(batch).to(dev), seeds8, cfg.step)
    torch.cuda.synchronize()
    launches_b = launches_since(c0, ("fps", "dbscan", "rans"))
    check(launches_b == {"fps": 1, "dbscan": 0, "rans": 1}, f"B = 8 from-points batch launches {launches_b}")
    engine = BatchEngine(lidar, cfg, dev, batch_size=8, workers=2)
    try:
        blobs_b = assemble_blobs(torch, engine, out_b, batched=True)
        for b, (c, s) in enumerate(zip(batch_clouds, seeds8)):
            single = encode(c, s, cfg.step)
            check(outputs_equal(torch, out_b.map(lambda x, b=b: x[b]), single),
                  f"B = 8 from-points frame {b} differs from its B = 1 encode")
            check(assemble_blobs(torch, engine, single)[0] == blobs_b[b], f"B = 8 from-points blob {b} differs")
    finally:
        engine.close()
    print(f"[phase 4d] from-points batch (8, {batch.shape[1]}, 3), zero-padded, {[c.shape[0] for c in batch_clouds]} "
          f"points: launches {launches_b}; every output and blob == its B = 1 encode")

    # The dataset layer and the codec API on the card.
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        paths = []
        for s in SEEDS:
            paths.append(os.path.join(work, f"{s:06d}.bin"))
            write_bin(np, paths[-1], frames[s])
        datalist = os.path.join(work, "list.txt")
        with open(datalist, "w") as f:
            f.write("\n".join(paths) + "\n")
        ds = build_dataset(datalist, lidar_type=LIDAR)
        check(ds.device.type == "cuda" and len(ds) == len(SEEDS), f"build_dataset: device {ds.device}, {len(ds)} frames")
        ds_lidar = ds.PCTransformer.lidar
        for i, path in enumerate(paths):
            pc, ri, original, name = ds[i]
            check(name == path and ri.shape == (ds_lidar.height, ds_lidar.width, 1) and pc.shape == ri.shape[:2] + (3,),
                  f"dataset item {i}: {name}, {ri.shape}, {pc.shape}")
            projection_agreement(np, ri[..., 0], project_points_host(original, ds_lidar), f"dataset item {i}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            spot_check_datalist(DatasetTemplate, datalist, LIDAR, max_frames=len(SEEDS))
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) == len(SEEDS) and all("chamfer" in ln and "F1" in ln for ln in lines),
              f"spot_check_datalist printed {lines}")
        for ln in lines:
            print(f"[phase 4d] [{card}] spot_check_datalist: {os.path.basename(ln)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out0 = results[f"synth {SEEDS[0]}"][0]
    n0 = int(out0.stream_len)
    seg0, models0, stream0 = out0.seg_idx.cpu().numpy(), out0.model_param.cpu().numpy(), out0.stream[:n0].cpu().numpy()
    bc = BasicCompressor(method_name=cfg.basic_compressor, contour_shape=(lidar.height, lidar.width))
    _, compressed = api.compress_point_cloud(bc, models0, seg0, None, stream0)
    resid, idx_map, sal, plane = api.decompress_point_cloud(compressed, bc, num_model_rows(cfg), lidar.height, lidar.width)
    check(np.array_equal(idx_map, seg0) and np.array_equal(resid, stream0) and np.array_equal(plane, models0)
          and sal is None, "codec api round trip on the card changed a field")
    print(f"[phase 4d] dataset: {len(ds)} frames through build_dataset(lidar_type={LIDAR!r}) on {ds.device}; codec "
          f"api round trip of synth {SEEDS[0]}'s fields on the card: {sum(map(len, compressed.values()))} bytes, "
          "seg map, residuals and models equal")
    time_points(torch, np, dev, card, lidar, cfg)
    return {"fps": 1, "dbscan": LAUNCHES_PER_CALL["dbscan"], "rans": 1, "rans_decode": 0}


def run_cli(mod, args, phase):
    """``python -m rpcc_tpu_torch.cli.<mod> <args>`` in a subprocess; -> its
    standard output (raises on a nonzero exit)."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"rpcc_tpu_torch.cli.{mod}", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cli.{mod} {' '.join(args)} failed:\n{proc.stdout}\n{proc.stderr}")
    print(f"[phase {phase}] cli.{mod} ({time.perf_counter() - t:.1f} s with start-up): "
          + " | ".join(ln.strip() for ln in proc.stdout.strip().splitlines()))
    return proc.stdout


def cpu_fps_yaml(path: str) -> str:
    """The package's codec YAML with ``cpu_fps: true``, written to ``path``."""
    from rpcc_tpu_torch.config import DEFAULT_CODEC_YAML

    with open(DEFAULT_CODEC_YAML) as f:
        text = f.read()
    check("cpu_fps: false" in text, "the codec YAML has no cpu_fps key")
    with open(path, "w") as f:
        f.write(text.replace("cpu_fps: false", "cpu_fps: true"))
    return path


def eval_number(stdout: str, label: str) -> float:
    return float(next(ln for ln in stdout.splitlines() if ln.strip().startswith(label)).split()[-1])


def write_bin(np, path, pc):
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).astype(np.float32).tofile(path)


def phase_cli(np, codec, frames):
    """5: the single-frame CLIs on the card, in subprocesses."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    bound = CodecConfig().step + 1e-5
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        pc = frames[SEEDS[-1]]
        src = os.path.join(work, "frame.bin")
        out = os.path.join(work, "frame.rpcc")
        rec = os.path.join(work, "rec.bin")
        write_bin(np, src, pc)
        common = ["--lidar", LIDAR, "--device", "cuda"]
        prof = run_cli("compress", ["--input", src, "--output", out, *common, "--profile"], 5)
        check("Top device operations" in prof and "fps_cluster_kernel" in prof,
              "compress --profile printed no table naming the FPS kernel")
        print("[phase 5] compress --profile names the FPS kernel: "
              + next(ln.strip() for ln in prof.splitlines() if "fps_cluster_kernel" in ln)[:120])
        run_cli("decompress", ["--input", out, "--output", rec, *common, "--decode_backend", "device"], 5)
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
        host_rec = os.path.join(work, "host_rec.bin")
        run_cli("decompress", ["--input", out, "--output", host_rec, *common, "--decode_backend", "host"], 5)
        check(np.array_equal(np.fromfile(host_rec, np.float32), np.fromfile(rec, np.float32)),
              "decompress --decode_backend host wrote other floats than the card's decode")
        print(f"[phase 5] CLI roundtrip ok: max_err {err:.6f}, {cli_pts.shape[0]} points; "
              f"--decode_backend host wrote the same floats as device")
        counted = counted_cli_runs(src, out, rec, common, work)

        # A self-describing stream: decompress takes no codec flag and no --lidar.
        sd, sd_rec = os.path.join(work, "sd.rpcc"), os.path.join(work, "sd.bin")
        enc_out = run_cli("compress", ["--input", src, "--output", sd, *common, "--self_describing", "--eval"], 5)
        with open(sd, "rb") as f:
            sd_blob = f.read()
        check(sd_blob.startswith(b"RPC1") and sd_blob.endswith(blob), "the self-describing stream is not header + blob")
        run_cli("decompress", ["--input", sd, "--output", sd_rec, "--decode_backend", "device"], 5)
        check(np.array_equal(np.fromfile(sd_rec, np.float32), np.fromfile(rec, np.float32)),
              "the flagless decode of the self-describing stream differs")
        dec_out = run_cli("decompress", ["--input", sd, "--output", sd_rec, "--decode_backend", "device", "--eval",
                                         "--original_point_cloud", src], 5)
        for label in ("Depth Error (max)", "Chamfer Distance (mean)", "F1 score", "Point-to-Point PSNR", "Point-to-Plane PSNR"):
            check(eval_number(enc_out, label) == eval_number(dec_out, label), f"compress and decompress --eval differ: {label}")
        check(eval_number(enc_out, "Depth Error (max)") <= bound, "--eval: depth error past the bound")
        print(f"[phase 5] self-describing stream decoded with no codec flags; --eval on both CLIs: max_err "
              f"{eval_number(enc_out, 'Depth Error (max)'):.6f}, chamfer {eval_number(enc_out, 'Chamfer Distance (mean)'):.6f}, "
              f"F1 {eval_number(enc_out, 'F1 score'):.4f}, p2p {eval_number(enc_out, 'Point-to-Point PSNR'):.3f}, "
              f"p2plane {eval_number(enc_out, 'Point-to-Plane PSNR'):.3f}")

        # The 32E channel table, f32 transfer and cpu_fps (from a YAML) through both CLIs.
        lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
        pc32 = scene_cloud(np, build_transform_map(lidar32), MODE_SEEDS[0])
        src32, out32, rec32 = (os.path.join(work, f) for f in ("f32.bin", "f32.rpcc", "f32rec.bin"))
        write_bin(np, src32, pc32)
        flags32 = ["--lidar", CSV_LIDAR, "--channel_distribute_csv", VELODYNE_32E_CSV, "--transfer_precision", "f32",
                   "--compressor_yaml", cpu_fps_yaml(os.path.join(work, "cpu_fps.yaml")), "--device", "cuda"]
        run_cli("compress", ["--input", src32, "--output", out32, *flags32], 5)
        run_cli("decompress", ["--input", out32, "--output", rec32, *flags32, "--decode_backend", "device"], 5)
        codec32 = RPCCCodec(lidar32, CodecConfig(cpu_fps=True, transfer_precision="f32"), "cuda")
        with open(out32, "rb") as f:
            blob32 = f.read()
        check(blob32 == codec32.compress(pc32)[0], "32E f32 cpu_fps CLI blob != RPCCCodec blob")
        pc32_dec, ri32_rec, _ = codec32.decompress(blob32)
        q32, d32 = codec32.project(pc32)
        err32 = float(np.abs(ri32_rec - q32 * d32).max())
        check(err32 <= bound, f"32E f32 cpu_fps CLI: max_err {err32} > {bound}")
        pts32 = pc32_dec.reshape(-1, 3)
        check(np.array_equal(np.fromfile(rec32, np.float32).reshape(-1, 4)[:, :3], pts32[pts32.sum(-1) != 0]),
              "32E CLI decode differs from the in-process decode")
        print(f"[phase 5] 32E channel table, f32, cpu_fps through both CLIs: blob == RPCCCodec, max_err {err32:.6f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counted


def counted_cli_runs(src, blob_path, rec_path, common, work):
    """5, in this process: ``cli.compress`` and ``cli.decompress`` (both
    backends) with ``--device cuda``, every launch count set to 0 just
    before each run and read just after: the compress codes its containers
    on the card, the device backend decodes them there, the host backend
    launches neither kernel.  Each writes what its subprocess run wrote.
    -> {run: (encode launches, decode launches)}."""
    import numpy as np

    from rpcc_tpu_torch.cli import compress, decompress

    out, rec = os.path.join(work, "counted.rpcc"), os.path.join(work, "counted.bin")
    counted = {}
    for tag, mod, args in (
        ("compress", compress, ["--input", src, "--output", out, *common]),
        ("decompress device", decompress, ["--input", blob_path, "--output", rec, *common, "--decode_backend", "device"]),
        ("decompress host", decompress, ["--input", blob_path, "--output", rec, *common, "--decode_backend", "host"]),
    ):
        c0 = launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(args)
        n = launches_since(c0, ("rans", "rans_decode"))
        counted[tag] = (n["rans"], n["rans_decode"])
        if tag == "compress":
            with open(out, "rb") as f, open(blob_path, "rb") as g:
                check(f.read() == g.read(), "the in-process compress wrote other bytes than the subprocess")
        else:
            check(np.array_equal(np.fromfile(rec, np.float32), np.fromfile(rec_path, np.float32)),
                  f"the in-process {tag} wrote other floats than the subprocess")
    check(counted["compress"][0] > 0 and counted["compress"][1] == 0, f"cli.compress --device cuda: launches "
          f"{counted['compress']} (encode, decode); its containers are coded on the card")
    check(counted["decompress device"][1] > 0 and counted["decompress device"][0] == 0,
          f"cli.decompress --decode_backend device: launches {counted['decompress device']}")
    check(counted["decompress host"] == (0, 0), f"cli.decompress --decode_backend host: launches "
          f"{counted['decompress host']}; the host backend must launch neither rANS kernel")
    print(f"[phase 5] in-process CLI runs, rANS launches (encode, decode): " + json.dumps(counted))
    return counted


def street_active(np, segment, torch, tm, r):
    """Active pixels of a street scene: off the z = -1.8 ground plane's depth
    by more than 0.5 m, and nonzero."""
    res = segment.ground_depth_residual(
        torch.from_numpy(r), torch.tensor([0.0, 0.0, 1.0, 1.8]),
        torch.from_numpy(np.ascontiguousarray(np.transpose(tm, (2, 0, 1)))),
    ).numpy()
    return (np.abs(res) > 0.5) & (r > 0)


def phase_dbscan_batch(torch, np, dev, card, lidar, seeds):
    """3c: the kernel on a (B, 64, 2000) batch of street scenes against the
    batched plain version and B single-frame launches."""
    from rpcc_tpu_torch.ops import dbscan, segment
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    tm = build_transform_map(lidar)
    frames = [street_frame(np, segment, torch, tm, s) for s in seeds]
    planes = np.stack([f[0] for f in frames])
    active = np.stack([f[1] for f in frames])
    p = torch.from_numpy(np.ascontiguousarray(planes)).to(dev)
    a = torch.from_numpy(active).to(dev)
    B = len(seeds)
    eps = 1.5
    got = dbscan.dbscan_labels_cuda(p, a, eps)
    ref = dbscan.dbscan_labels_planar(p, a, eps)
    single = torch.stack([dbscan.dbscan_labels_cuda(p[i].contiguous(), a[i], eps) for i in range(B)])
    torch.cuda.synchronize()
    err = max(int((got.long() - ref.long()).abs().max()), int((got.long() - single.long()).abs().max()))
    check(err == 0, f"batched DBSCAN kernel labels differ from the plain version or the per-frame kernel at B={B}")
    ids = dbscan._compact_labels(got, a, 1 << 20)
    n_cl = [int(ids[i].max()) - dbscan.FIRST_CLUSTER_ID + 1 for i in range(B)]
    plan = dbscan_plan(torch, dbscan, B, 64, 2000)
    print(f"[phase 3c] dbscan kernel (B={B}, 64, 2000) == batched plain == per-frame kernel: "
          f"{[int(x) for x in a.sum((1, 2))]} active px, {n_cl} clusters; plan: clusters of {plan.cluster}, "
          f"{plan.band} columns and {plan.smem_bytes} B shared per CTA")
    ms = median_ms(torch, lambda: dbscan.dbscan_labels_cuda(p, a, eps))
    b2b = median_ms(torch, lambda: dbscan.dbscan_labels_cuda(p, a, eps), BACK_TO_BACK)
    plain_ms = median_ms(torch, lambda: dbscan.dbscan_labels_planar(p, a, eps))
    split = dbscan_split(torch, dbscan, p, a, eps)
    bound_ms, bound_by = dbscan_bound(active, *active.shape)
    print(f"[phase 3c] [{card}] dbscan (B={B}, 64, 2000) median of {TIMED_RUNS}: kernel {ms:.4f} ms "
          f"({b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}); frame 0 phase split (us): "
          + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return dict(err=err, ms=ms, b2b=b2b, plain_ms=plain_ms, bound=(bound_ms, bound_by), cluster=plan.cluster)


def _frames_per_s(engine, run, n_frames):
    """frames/s of RATE_PASSES timed pipeline runs after a warm-up run ->
    (median, min, max)."""
    import torch

    run(engine)
    torch.cuda.synchronize()
    rates = []
    for _ in range(RATE_PASSES):
        t = time.perf_counter()
        run(engine)
        torch.cuda.synchronize()
        rates.append(n_frames / (time.perf_counter() - t))
    rates.sort()
    return rates[len(rates) // 2], rates[0], rates[-1]


def _batches(items, size):
    return [items[i : i + size] for i in range(0, len(items), size)]


def _device_profile(torch, fn):
    """One torch.profiler window around ``fn``: (device events (kernels and
    copies), host kernel-launch calls, summed device ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.events()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    calls = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return len(kernels), calls, sum(e.time_range.elapsed_us() for e in kernels) / 1e3, wall


def phase_engine(torch, np, dev, card, lidar, codec):
    """6: the batch engine on the main path at full width."""
    from rpcc_tpu_torch.codec.rans_codec import _geometry
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import fps
    from rpcc_tpu_torch.ops.projection_host import build_transform_map
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    cfg = CodecConfig()
    bound = cfg.step + 1e-5
    B = 8
    frames = [synth_cloud_for(lidar, s) for s in BATCH_SEEDS]
    singles = [codec.compress(pc, seed=s)[0] for pc, s in zip(frames, BATCH_SEEDS)]
    lens = [int(codec.encode_device(pc).stream_len.item()) for pc in frames]

    # The FPS kernel at the engine's shape, against its plain version.
    rng = np.random.default_rng(1)
    xs, ys, zs = (torch.from_numpy(rng.uniform(-40, 40, (B, lidar.height * lidar.width)).astype(np.float32)).to(dev)
                  for _ in range(3))
    got = fps.furthest_point_sample_cuda(xs, ys, zs, cfg.cluster_num)
    ref = fps.furthest_point_sample_planar(xs, ys, zs, cfg.cluster_num)
    torch.cuda.synchronize()
    fps_err = int((got.long() - ref.long()).abs().max())
    check(fps_err == 0, f"FPS kernel differs from the plain version at (B={B}, 128000, 100)")
    fps_ms = median_ms(torch, lambda: fps.furthest_point_sample_cuda(xs, ys, zs, cfg.cluster_num))
    fps_b2b = median_ms(torch, lambda: fps.furthest_point_sample_cuda(xs, ys, zs, cfg.cluster_num), BACK_TO_BACK)
    fps_plain_ms = median_ms(torch, lambda: fps.furthest_point_sample_planar(xs, ys, zs, cfg.cluster_num))
    fps_bound_ms, fps_bound_by = fps_bound(B, xs.shape[1], cfg.cluster_num)
    print(f"[phase 6] [{card}] fps (B={B}, 128000, 100) kernel == plain (clusters of "
          f"{fps_plan(torch, fps, B, xs.shape[1]).cluster}); median of {TIMED_RUNS}: kernel {fps_ms:.4f} ms "
          f"({fps_b2b:.4f} ms over {BACK_TO_BACK} back to back), plain {fps_plain_ms:.4f} ms, "
          f"bound {fps_bound_ms:.6f} ms ({fps_bound_by})")

    work = [(b, range(i * B, i * B + len(b))) for i, b in enumerate(_batches(frames, B))]
    work1 = [(b, range(i, i + 1)) for i, b in enumerate(_batches(frames, 1))]
    tm = build_transform_map(lidar)

    def counted_run(engine, w):
        """A warm-up pipeline run, then one with every launch count (and the
        i16 stream downloads) read just before it and just after."""
        list(engine.encode_pipeline(w))
        torch.cuda.synchronize()
        c0, d0 = launch_counts(), counter("engine.stream_downloads")
        stats = {}
        blobs = [b for res in engine.encode_pipeline(w, stats=stats) for b, _ in res]
        launches = launches_since(c0, ("fps", "dbscan", "rans"))
        return blobs, stats, launches, counter("engine.stream_downloads") - d0

    def counted_decode(engine, eblobs, b):
        """The engine's decode pipeline of ``eblobs`` in batches of ``b``
        with the decode launches read just before it and just after,
        checked: one a batch for both big fields, one per small rANS field,
        no encode launch."""
        c0 = launch_counts()
        points = [p for pts in engine.decode_pipeline(_batches(eblobs, b)) for p in pts]
        n = launches_since(c0, ("rans", "rans_decode"))
        want = sum(big_rans_decodes(x) for x in _batches(eblobs, b)) + sum(map(small_rans_fields, eblobs))
        check(n["rans_decode"] == want > 0 and n["rans"] == 0,
              f"engine decode of {len(eblobs)} blobs at B = {b}: {n['rans_decode']} decode launches "
              f"(expected {want}) and {n['rans']} encode launches")
        return points, want

    def host_entropy_launches(idx_batches, lengths):
        """The encode launches of a --no-device_entropy engine on the card:
        per batch one for each residual lane geometry, one for the contours,
        one for each frame's sequence field."""
        return sum(len({_geometry(lengths[i]) for i in ix}) + 1 + len(ix) for ix in idx_batches)

    def decode_err(decoded_points):
        err_max = 0.0
        for pc, pts in zip(frames, decoded_points):
            q, d = codec.project(pc)
            ri = q.astype(np.float32) * d
            keep = ri.reshape(-1) > 0
            check(pts.shape == (int(keep.sum()), 4), f"decoded {pts.shape[0]} rows for {int(keep.sum())} nonzero pixels")
            rec = np.linalg.norm(pts[:, :3].astype(np.float64), axis=1)
            ray = np.linalg.norm(tm.reshape(-1, 3)[keep].astype(np.float64), axis=1)
            err = float(np.abs(rec / ray - ri.reshape(-1)[keep]).max())
            err_max = max(err_max, err)
            check(err <= bound, f"engine decode: max_err {err} > {bound}")
        return err_max

    # Device entropy (the default): one rANS launch per batch, the blobs of
    # the B = 1 engine, decodes through both decoders.
    engine = BatchEngine(lidar, cfg, dev, batch_size=B)
    engine1 = BatchEngine(lidar, cfg, dev, batch_size=1)
    blobs, stats, launches, downloads = counted_run(engine, work)
    check(launches == {"fps": len(work), "dbscan": 0, "rans": len(work) + downloads},
          f"device-entropy engine launches {launches} for {len(work)} batches, expected one FPS and one rANS launch "
          f"each, and one rANS launch for each of the {downloads} frames the host re-encodes")
    again = [b for res in engine.encode_pipeline(work) for b, _ in res]
    check(again == blobs, "a repeat device-entropy engine run gave different bytes")
    blobs1, _, launches1, downloads1 = counted_run(engine1, work1)
    check(launches1 == {"fps": len(frames), "dbscan": 0, "rans": len(frames) + downloads1},
          f"B = 1 engine launches {launches1}")
    mism = [s for s, a, b in zip(BATCH_SEEDS, blobs, blobs1) if a != b]
    check(not mism, f"B = {B} device-entropy blobs differ from B = 1 blobs for seeds {mism}")
    c0 = launch_counts()
    dec_points, dec_launches = counted_decode(engine, blobs, B)
    dev_err = decode_err(dec_points)
    host_err = decode_err(HostDecoder(lidar, cfg).decode_blobs_points(blobs))
    n = launches_since(c0, ("rans", "rans_decode"))
    check(n["rans"] == 0 and n["rans_decode"] == dec_launches, "the host decoder launched a rANS kernel")
    bpp_dev = sum(len(b) for b in blobs) * 8 / sum(codec.encode_device(pc).stream_len.item() for pc in frames)
    print(f"[phase 6] device-entropy engine (B={B}) encoded {len(blobs)} frames in batches "
          f"{[len(b) for b, _ in work]}: launches {launches}, blobs == B = 1 engine blobs, repeat run byte-identical, "
          f"{downloads} of {len(blobs)} frames downloaded their i16 stream; decode max_err device decoder "
          f"{dev_err:.6f} ({dec_launches} rANS decode launches), host decoder {host_err:.6f} (none) (bound "
          f"{bound:.5f}); bpp {bpp_dev:.5f}")
    print(f"[phase 6] [{card}] device-entropy stage stats (B={B}, {len(blobs)} frames): "
          + json.dumps({k: round(v, 6) if isinstance(v, float) else v for k, v in stats.items()}))

    # Host entropy: blobs == the single-frame codec's, no rANS launch.
    hcfg = CodecConfig(device_entropy=False)
    hengine = BatchEngine(lidar, hcfg, dev, batch_size=B)
    hblobs, hstats, hlaunches, _ = counted_run(hengine, work)
    h_rans = host_entropy_launches([ix for _, ix in work], lens)
    check(hlaunches == {"fps": len(work), "dbscan": 0, "rans": h_rans},
          f"host-entropy engine launches {hlaunches} for {len(work)} batches, expected one FPS launch each and "
          f"{h_rans} rANS launches (its containers coded on the card)")
    mism = [s for s, a, b in zip(BATCH_SEEDS, hblobs, singles) if a != b]
    check(not mism, f"host-entropy engine blobs differ from single-frame RPCCCodec blobs for seeds {mism}")
    again = [b for res in hengine.encode_pipeline(work) for b, _ in res]
    check(again == hblobs, "a repeat host-entropy engine run gave different bytes")
    hdec_points, hdec_launches = counted_decode(hengine, hblobs, B)
    herr = decode_err(hdec_points)
    bpp_host = sum(len(b) for b in hblobs) * 8 / sum(codec.encode_device(pc).stream_len.item() for pc in frames)
    print(f"[phase 6] host-entropy engine (B={B}): launches {hlaunches}, blobs == single-frame RPCCCodec, "
          f"repeat run byte-identical, decode max_err {herr:.6f} ({hdec_launches} rANS decode launches); bpp "
          f"{bpp_host:.5f} (device entropy "
          f"{bpp_dev:.5f}, rel diff {abs(bpp_dev - bpp_host) / bpp_host:.5f})")
    print(f"[phase 6] [{card}] host-entropy stage stats (B={B}, {len(hblobs)} frames): "
          + json.dumps({k: round(v, 6) if isinstance(v, float) else v for k, v in hstats.items()}))
    print(f"[phase 6] [{card}] dispatch-bound encode cap: {len(blobs)} frames / {stats['dispatch_s']:.6f} s "
          f"summed dispatch = {len(blobs) / stats['dispatch_s']:.3f} frames/s (device entropy), "
          f"{len(hblobs) / hstats['dispatch_s']:.3f} (host)")

    hengine1 = BatchEngine(lidar, hcfg, dev, batch_size=1)
    rates = {}
    for tag, engines, eblobs in (("device entropy", {1: engine1, B: engine}, blobs),
                                 ("host entropy", {1: hengine1, B: hengine}, hblobs)):
        for b, eng in engines.items():
            w = work1 if b == 1 else work
            enc = _frames_per_s(eng, lambda e, w=w: [r for r in e.encode_pipeline(w)], len(frames))
            dec_r = _frames_per_s(eng, lambda e, b=b: [r for r in e.decode_pipeline(_batches(eblobs, b))], len(frames))
            rates[tag, b] = enc
            print(f"[phase 6] [{card}] {tag} pipeline B={b}, {len(frames)} frames, median (min-max) of {RATE_PASSES} "
                  f"passes: encode {enc[0]:.3f} ({enc[1]:.3f}-{enc[2]:.3f}) frames/s, "
                  f"decode {dec_r[0]:.3f} ({dec_r[1]:.3f}-{dec_r[2]:.3f}) frames/s")
            # The encoder graph alone: upload + launches + device, projection done before the window.
            prepared = eng._prepare_batch(frames[:b], BATCH_SEEDS[:b])
            n_ev, n_calls, dev_ms, wall_ms = _device_profile(torch, lambda: eng._dispatch_prepared(prepared))
            print(f"[phase 6] [{card}] {tag}: one B={b} encoder graph under torch.profiler: {n_ev} device events, "
                  f"{n_calls} kernel launch calls, summed device time {dev_ms:.3f} ms, wall {wall_ms:.3f} ms, "
                  f"idle share {1.0 - dev_ms / wall_ms:.3f}")
        n_ev, n_calls, dev_ms, wall_ms = _device_profile(
            torch, lambda: engines[B].encode_frames(frames[:B], BATCH_SEEDS[:B]))
        print(f"[phase 6] [{card}] {tag}: one B={B} encode_frames under torch.profiler: {n_ev} device events, "
              f"{n_calls} kernel launch calls, summed device time {dev_ms:.3f} ms, wall {wall_ms:.3f} ms")
    for eng in (engine, engine1, hengine, hengine1):
        eng.close()

    # DBSCAN at B = 4 on the street scenes, host entropy: its blobs are the
    # single-frame codec's.
    dcfg = CodecConfig(segment_method="DBSCAN", device_entropy=False)
    street = [scene_cloud(np, tm, s) for s in STREET_SEEDS]
    dcodec = RPCCCodec(lidar, dcfg, dev)
    dres = [dcodec.compress(pc, seed=s) for pc, s in zip(street, STREET_SEEDS)]
    dsingles = [b for b, _, _ in dres]
    deng = BatchEngine(lidar, dcfg, dev, batch_size=len(street))
    deng.encode_frames(street, STREET_SEEDS)  # warm-up
    torch.cuda.synchronize()
    c0 = launch_counts()
    dblobs = [b for b, _ in deng.encode_frames(street, STREET_SEEDS)]
    db_launches = launches_since(c0, ("fps", "dbscan", "rans"))
    d_rans = host_entropy_launches([range(len(street))], [f["residual_quantized"].size for _, f, _ in dres])
    check(db_launches == {"fps": 0, "dbscan": 1, "rans": d_rans},
          f"DBSCAN engine launches {db_launches} for one batch, expected {d_rans} rANS launches")
    check(dblobs == dsingles, "DBSCAN engine blobs differ from single-frame blobs")
    deng.close()
    print(f"[phase 6] DBSCAN engine (B={len(street)}): launches {db_launches}, blobs == single-frame RPCCCodec; "
          f"sha256 {[hashlib.sha256(b).hexdigest() for b in dblobs]}")

    # The 32E channel table, and f32 transfer (a 4-byte ring), at B = 8,
    # host entropy: blobs equal the single-frame codec's.
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config

    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    tm32 = build_transform_map(lidar32)
    seeds = BATCH_SEEDS[:B]
    for tag, lid, ecfg, clouds in (
        ("32E CSV", lidar32, CodecConfig(device_entropy=False), [scene_cloud(np, tm32, s) for s in seeds]),
        ("f32", lidar, CodecConfig(transfer_precision="f32", device_entropy=False), frames[:B]),
    ):
        ecodec = RPCCCodec(lid, ecfg, dev)
        eres = [ecodec.compress(pc, seed=s) for pc, s in zip(clouds, seeds)]
        esingles = [b for b, _, _ in eres]
        e_rans = host_entropy_launches([range(B)], [f["residual_quantized"].size for _, f, _ in eres])
        eng = BatchEngine(lid, ecfg, dev, batch_size=B)
        try:
            eng.encode_frames(clouds, seeds)  # warm-up
            torch.cuda.synchronize()
            c0 = launch_counts()
            eblobs = [b for b, _ in eng.encode_frames(clouds, seeds)]
            e_launches = launches_since(c0, ("fps", "dbscan", "rans"))
            check(e_launches == {"fps": 1, "dbscan": 0, "rans": e_rans},
                  f"{tag} engine launches {e_launches} for one batch, expected {e_rans} rANS launches")
            check(eblobs == esingles, f"{tag} engine blobs differ from single-frame blobs")
            recs = eng.decode_range_images(eblobs)
            e_err = max(float(np.abs(r - q * d).max()) for r, (q, d) in zip(recs, map(ecodec.project, clouds)))
            check(e_err <= bound, f"{tag} engine decode: max_err {e_err} > {bound}")
        finally:
            eng.close()
        print(f"[phase 6] {tag} engine (B={B}, {lid.height}x{lid.width}, {eng._ring[0].q.dtype} ring): launches "
              f"{e_launches}, blobs == single-frame RPCCCodec, decode max_err {e_err:.6f}")

    engine_dropped_returns(torch, np, dev, lidar, street)
    return dict(fps_err=fps_err, fps_ms=fps_ms, fps_b2b=fps_b2b, fps_plain_ms=fps_plain_ms,
                fps_bound=(fps_bound_ms, fps_bound_by),
                fps_shape=f"B={B} N={lidar.height * lidar.width} K={cfg.cluster_num}",
                fps_launches=launches["fps"], db_launches=db_launches["dbscan"], rans_launches=launches["rans"],
                batches=len(work), blobs=blobs, encode_rate=rates["device entropy", B],
                host_entropy_rans_launches=hlaunches["rans"], decode_launches=dec_launches,
                host_entropy_decode_launches=hdec_launches)


def engine_dropped_returns(torch, np, dev, lidar, street):
    """6, device entropy on frames with dropped returns: the 32E channel
    table at B = 8 (T = resid_T(72000)) and DBSCAN mode at B = 4, each on
    street scenes cut at 26 m (stream_len < HW: the device's T differs from
    the host's), a ground sector (at most 32,768 returns: the host's pick
    between its container and the device's) and random ranges (past 512
    escapes: host-coded)."""
    from rpcc_tpu_torch.codec.rans_codec import BZD_TRY_MAX_SYMBOLS
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops.projection_host import build_transform_map
    from rpcc_tpu_torch.ops.rans_device import ESC_CAP_DEV, resid_T
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    bound = CodecConfig().step + 1e-5
    lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
    tm, tm32 = build_transform_map(lidar), build_transform_map(lidar32)
    seeds = BATCH_SEEDS[:8]

    for tag, lid, ecfg, clouds, eseeds in (
        ("32E CSV", lidar32, CodecConfig(),
         [drop_far(np, scene_cloud(np, tm32, s)) for s in seeds[:6]]
         + [ground_sector(np, scene_cloud(np, tm32, seeds[6])), random_cloud(np, tm32, 20000, seeds[7])], seeds),
        ("DBSCAN", lidar, CodecConfig(segment_method="DBSCAN"),
         [drop_far(np, pc) for pc in street[:2]] + [ground_sector(np, street[2]),
                                                    random_cloud(np, tm, 25000, STREET_SEEDS[3])], STREET_SEEDS),
    ):
        nb, hw = len(clouds), lid.height * lid.width
        engs = [BatchEngine(lid, c, dev, batch_size=b)
                for c, b in ((ecfg, nb), (ecfg, 1), (ecfg.replace(device_entropy=False), nb))]
        eng, eng1, heng = engs
        try:
            eng.encode_frames(clouds, eseeds)  # warm-up
            torch.cuda.synchronize()
            c0, d0 = launch_counts(), counter("engine.stream_downloads")
            st = eng.stage_downloads(eng.encode_batch_device(clouds, eseeds))
            eblobs = [b for b, _ in eng.finish_staged(st)]
            downloads = counter("engine.stream_downloads") - d0
            e_launches = launches_since(c0, ("fps", "dbscan", "rans"))
            seg = "dbscan" if ecfg.segment_method == "DBSCAN" else "fps"
            # one rANS launch in the graph, one for each frame the host re-encodes on the card
            want = {"fps": 0, "dbscan": 0, "rans": 1 + downloads, seg: 1}
            check(e_launches == want, f"{tag} device-entropy engine launches {e_launches} for one batch, expected {want}")
            n, n_esc = st.stream_len[:nb], st.residual.n_esc.numpy()
            small = (n <= BZD_TRY_MAX_SYMBOLS) & (n_esc <= ESC_CAP_DEV)
            check(bool(small.any()) and bool((n_esc > ESC_CAP_DEV).any()),
                  f"{tag}: stream lengths {n.tolist()} and escapes {n_esc.tolist()} miss the small-frame pick "
                  "or the escape overflow")
            check(downloads == int((small | (n_esc > ESC_CAP_DEV)).sum()), f"{tag}: {downloads} i16 stream downloads")
            check([b for b, _ in eng.encode_frames(clouds, eseeds)] == eblobs,
                  f"a repeat {tag} device-entropy run gave different bytes")
            ones = [eng1.encode_frames([pc], [s])[0][0] for pc, s in zip(clouds, eseeds)]
            mism = [s for s, a, b in zip(eseeds, eblobs, ones) if a != b]
            check(not mism, f"{tag}: B = {nb} device-entropy blobs differ from B = 1 blobs for seeds {mism}")
            refs = [q * d for q, d in map(RPCCCodec(lid, ecfg, dev).project, clouds)]
            errs = []
            for decoded in (eng.decode_range_images(eblobs), HostDecoder(lid, ecfg).decode_blobs(eblobs)):
                for rec, ri in zip(decoded, refs):
                    check(bool((rec[ri == 0] == 0).all()), f"{tag}: a zero pixel decoded nonzero")
                errs.append(max(float(np.abs(rec - ri).max()) for rec, ri in zip(decoded, refs)))
                check(errs[-1] <= bound, f"{tag} device-entropy decode: max_err {errs[-1]} > {bound}")
            hblobs = [b for b, _ in heng.encode_frames(clouds, eseeds)]
            rel = [(len(a) - len(b)) / len(b) for a, b in zip(eblobs, hblobs)]
            full = [i for i in range(nb) if not small[i] and n_esc[i] <= ESC_CAP_DEV]
            check(bool(full) and all(n[i] < hw for i in full), f"{tag}: no frame of more than "
                  f"{BZD_TRY_MAX_SYMBOLS} returns with dropped returns (stream lengths {n.tolist()})")
            check(all(abs(rel[i]) <= 0.02 for i in full), f"{tag}: device vs host entropy bytes differ by {rel}")
        finally:
            for e in engs:
                e.close()
        print(f"[phase 6] {tag} device-entropy engine (B={nb}, {lid.height}x{lid.width}, T {resid_T(hw)}): launches "
              f"{e_launches}; stream lengths {n.tolist()} of {hw}, escapes {n_esc.tolist()}; {downloads} "
              f"of {nb} frames downloaded their i16 stream; blobs == B = 1 engine blobs, repeat run byte-identical; "
              f"decode max_err device decoder {errs[0]:.6f}, host decoder {errs[1]:.6f} (bound {bound:.5f}); "
              f"bytes vs host entropy (rel) {[round(r, 5) for r in rel]}")


def phase_datalist(np, codec, lidar):
    """7: the datalist CLIs on the card: on the 64E in this process (their
    ranks' launch counts read), on the 32E channel table in subprocesses.
    -> the launches of each 64E run."""
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.host_decoder import HostDecoder

    cfg = CodecConfig()
    bound = cfg.step + 1e-5
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        src_dir = os.path.join(work, "bin", "seq")
        os.makedirs(src_dir)
        frames = [synth_cloud_for(lidar, i) for i in range(CLI_FRAMES)]
        srcs = []
        for i, pc in enumerate(frames):
            srcs.append(os.path.join(src_dir, f"{i:06d}.bin"))
            write_bin(np, srcs[-1], pc)
        lst = os.path.join(work, "list.txt")
        with open(lst, "w") as f:
            f.write("\n".join(srcs) + "\n")
        common = ["--lidar", LIDAR, "--device", "cuda", "--batch", "4"]
        from rpcc_tpu_torch.cli import compress_datalist, decompress_datalist
        from rpcc_tpu_torch.cli.compress_datalist import _mirror_path

        launches = {}

        def run(tag, mod, *args):
            """``mod.main`` in this process -> its one rank's kernel launches."""
            t = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = mod.main([*args, *common])
            check(len(res) == 1, f"{mod.__name__} ran {len(res)} ranks on one card")
            launches[tag] = res[0]["launches"]
            print(f"[phase 7] {mod.__name__.rsplit('.', 1)[-1]} {tag} ({time.perf_counter() - t:.1f} s): "
                  + " | ".join(ln.strip() for ln in buf.getvalue().strip().splitlines()[-2:])
                  + f"; launches {json.dumps(launches[tag])}")
            return res[0]

        # The default: device entropy.
        dev_dir = os.path.join(work, "rpcc_dev")
        run("device entropy", compress_datalist, "--datalist", lst, "--output_dir", dev_dir)
        dev_outs = [_mirror_path(p, dev_dir, "rpcc") for p in srcs]
        dev_blobs = []
        for path in dev_outs:
            with open(path, "rb") as f:
                dev_blobs.append(f.read())

        out_dir = os.path.join(work, "rpcc")
        run("host entropy", compress_datalist, "--datalist", lst, "--output_dir", out_dir, "--no-device_entropy")
        for tag in ("device entropy", "host entropy"):
            check(launches[tag]["rans"] > 0 and launches[tag]["rans_decode"] == 0,
                  f"compress_datalist ({tag}) launches {launches[tag]}: its rANS containers are coded on the card")
        outs = [_mirror_path(p, out_dir, "rpcc") for p in srcs]
        blobs = []
        for i, (pc, path) in enumerate(zip(frames, outs)):
            with open(path, "rb") as f:
                blobs.append(f.read())
            check(blobs[-1] == codec.compress(pc, seed=i)[0], f"datalist blob {i} != single-frame codec, seed {i}")
        single = os.path.join(work, "single.rpcc")
        run_cli("compress", ["--input", srcs[3], "--output", single, "--lidar", LIDAR, "--device", "cuda",
                             "--seed", "3"], 7)
        with open(single, "rb") as f:
            check(f.read() == blobs[3], "datalist blob 3 != single-frame CLI --seed 3")
        print(f"[phase 7] {len(blobs)} --no-device_entropy datalist blobs == single-frame codec per seed; "
              f"frame 3 == single-frame CLI --seed 3")

        for tag, these_outs, these_blobs in (("device entropy", dev_outs, dev_blobs), ("host entropy", outs, blobs)):
            lst2 = os.path.join(work, "list2.txt")
            with open(lst2, "w") as f:
                f.write("\n".join(these_outs) + "\n")
            pts = {}
            for backend in ("host", "device"):
                rec_dir = os.path.join(work, f"rec_{backend}_{tag[:4]}")
                run(f"{tag}, {backend} backend", decompress_datalist, "--datalist", lst2, "--output_dir", rec_dir,
                    "--decode_backend", backend)
                got = launches[f"{tag}, {backend} backend"]
                check(got["rans"] == 0 and (got["rans_decode"] > 0) == (backend == "device"),
                      f"decompress_datalist --decode_backend {backend} ({tag}) launches {got}")
                pts[backend] = [np.fromfile(_mirror_path(p, rec_dir, "bin"), np.float32).reshape(-1, 4)
                                for p in these_outs]
            ref = HostDecoder(lidar, cfg).decode_blobs(these_blobs)
            diff = err_max = 0.0
            for i, pc in enumerate(frames):
                q, d = codec.project(pc)
                ri = q.astype(np.float32) * d
                err = float(np.abs(ref[i] - ri).max())
                err_max = max(err_max, err)
                check(err <= bound, f"host decode of {tag} datalist blob {i}: max_err {err} > {bound}")
                h, g = pts["host"][i], pts["device"][i]
                check(h.shape == g.shape == (int((ri > 0).sum()), 4), f"{tag} frame {i}: row counts differ")
                diff = max(diff, float(np.abs(h - g).max()))
            check(diff <= 1e-5, f"{tag}: host and device backends differ by {diff}")
            print(f"[phase 7] {tag}: {len(these_blobs)} blobs ({sum(map(len, these_blobs))} bytes), both backends "
                  f"within bound (max_err {err_max:.6f}); host vs device max |diff| {diff:.3g} (identical: "
                  f"{all(np.array_equal(a, b) for a, b in zip(pts['host'], pts['device']))})")

        # The 32E channel table in f32 with cpu_fps from a YAML, and --eval.
        from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
        from rpcc_tpu_torch.models.pipeline import RPCCCodec
        from rpcc_tpu_torch.ops.projection_host import build_transform_map

        lidar32 = lidar_config(CSV_LIDAR, VELODYNE_32E_CSV)
        tm32 = build_transform_map(lidar32)
        frames32 = [scene_cloud(np, tm32, s) for s in STREET_SEEDS]
        srcs32 = [os.path.join(src_dir, f"csv{i:06d}.bin") for i in range(len(frames32))]
        for path, pc in zip(srcs32, frames32):
            write_bin(np, path, pc)
        lst32 = os.path.join(work, "list32.txt")
        with open(lst32, "w") as f:
            f.write("\n".join(srcs32) + "\n")
        flags32 = ["--lidar", CSV_LIDAR, "--channel_distribute_csv", VELODYNE_32E_CSV, "--transfer_precision", "f32",
                   "--compressor_yaml", cpu_fps_yaml(os.path.join(work, "cpu_fps.yaml")), "--device", "cuda", "--batch", "4",
                   "--no-device_entropy"]
        out32 = os.path.join(work, "rpcc32")
        stdout = run_cli("compress_datalist", ["--datalist", lst32, "--output_dir", out32, "--eval", *flags32], 7)
        evals = [ln for ln in stdout.splitlines() if ln.startswith("eval ")]
        check(len(evals) == len(frames32) and all(ln.endswith(" OK") for ln in evals),
              f"compress_datalist --eval: {len(evals)} lines, not all OK")
        codec32 = RPCCCodec(lidar32, CodecConfig(cpu_fps=True, transfer_precision="f32"), "cuda")
        outs32 = [_mirror_path(p, out32, "rpcc") for p in srcs32]
        for i, (pc, path) in enumerate(zip(frames32, outs32)):
            with open(path, "rb") as f:
                check(f.read() == codec32.compress(pc, seed=i)[0], f"32E datalist blob {i} != RPCCCodec, seed {i}")
        lst32b = os.path.join(work, "list32b.txt")
        with open(lst32b, "w") as f:
            f.write("\n".join(outs32) + "\n")
        rec32 = os.path.join(work, "rec32")
        run_cli("decompress_datalist", ["--datalist", lst32b, "--output_dir", rec32, *flags32], 7)
        err32 = 0.0
        for pc, path in zip(frames32, outs32):
            ri = codec32.project(pc)[0]
            keep = ri.reshape(-1) > 0
            rows = np.fromfile(_mirror_path(path, rec32, "bin"), np.float32).reshape(-1, 4)
            check(rows.shape[0] == int(keep.sum()), "32E datalist decode: rows != nonzero pixels")
            rec = np.linalg.norm(rows[:, :3].astype(np.float64), axis=1)
            ray = np.linalg.norm(tm32.reshape(-1, 3)[keep].astype(np.float64), axis=1)
            err32 = max(err32, float(np.abs(rec / ray - ri.reshape(-1)[keep]).max()))
        check(err32 <= bound, f"32E datalist decode: max_err {err32} > {bound}")
        print(f"[phase 7] 32E channel table, f32, cpu_fps: {len(outs32)} datalist blobs == RPCCCodec per seed, "
              f"{len(evals)} eval lines OK, decode max_err {err32:.6f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


@contextlib.contextmanager
def rank_watchdog(seconds: float):
    """Stop this process's child processes (the ranks of a launch) if the
    block outlasts ``seconds``: the launcher then raises, and the phase
    fails instead of hanging."""
    import multiprocessing

    def stop():
        for child in multiprocessing.active_children():
            child.kill()

    timer = threading.Timer(seconds, stop)
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def launch_ranks(fn, devices, args, file_list, want_backend: str):
    """``run_data_parallel(fn, devices, args, file_list, t_launch)`` under
    the watchdog; checks the backend it printed.  -> the ranks' results."""
    from rpcc_tpu_torch.parallel.mesh import run_data_parallel

    buf = io.StringIO()
    with rank_watchdog(DP_TIMEOUT_S), contextlib.redirect_stdout(buf):
        results = run_data_parallel(fn, devices, args, file_list, time.time())
    said = buf.getvalue().strip()
    print(f"[phase 8] {said}")
    check(said.endswith(f"backend {want_backend}"), f"launcher printed {said!r}; the rule names {want_backend}")
    return results


def steady_rate(results) -> float:
    """frames/s of the ranks together, after their first calls: frames
    written inside the window from the last rank's first batch to the first
    rank's last, over its length."""
    marks = [rr["marks"] for rr in results if len(rr["marks"]) > 1]
    t0 = max(m[0][0] for m in marks)
    t1 = min(m[-1][0] for m in marks)
    check(t1 > t0, f"no window in which every rank was past its first batch: {marks}")
    return sum(f for m in marks for t, f in m if t0 < t <= t1) / (t1 - t0)


def phase_data_parallel(torch, np, card, lidar, codec, eng):
    """8: the data-parallel layer on the one card: the datalist CLI's rank
    function over NCCL with one rank and over gloo with two ranks on the
    card, phase 6's blobs and host sums, the 2-rank decode, and the CLI at
    its default ``--num_devices``."""
    from rpcc_tpu_torch.cli import compress_datalist, decompress_datalist
    from rpcc_tpu_torch.cli.compress_datalist import _mirror_path
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.parallel.aggregate import batch_report, batch_totals
    from rpcc_tpu_torch.parallel.mesh import rank_frames

    B = 8
    cuda0 = torch.device("cuda", 0)
    frames = [synth_cloud_for(lidar, s) for s in BATCH_SEEDS]
    points = [max(int(codec.encode_device(pc).stream_len.item()), 1) for pc in frames]
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        srcs = []
        for c in range(DP_COPIES):
            os.makedirs(os.path.join(work, "bin", f"copy{c}"))
            for i, pc in enumerate(frames):
                srcs.append(os.path.join(work, "bin", f"copy{c}", f"{i:06d}.bin"))
                write_bin(np, srcs[-1], pc)
        common = ["--lidar", LIDAR, "--device", "cuda", "--batch", str(B)]
        runs = {}
        for world, devices, backend in ((1, [cuda0], "nccl"), (2, [cuda0, cuda0], "gloo")):
            out = os.path.join(work, f"rpcc{world}")
            args = compress_datalist.build_parser().parse_args(["--datalist", "-", "--output_dir", out, *common])
            res = launch_ranks(compress_datalist.compress_rank, devices, args, srcs, backend)
            blobs = []
            for path in srcs:
                with open(_mirror_path(path, out, "rpcc"), "rb") as f:
                    blobs.append(f.read())
            check(blobs[: len(frames)] == eng["blobs"],
                  f"{world}-rank ({backend}) blobs of copy 0 differ from phase 6's B = {B} engine blobs")
            want = {**batch_report(batch_totals(points * DP_COPIES, [len(b) for b in blobs])), "errors": 0}
            for r, rr in enumerate(res):
                check(rr["report"] == want, f"{world}-rank rank {r}: sharded_stats {rr['report']} != host sums {want}")
                b, idx = rank_frames(len(srcs), B, r, world)
                n_batches = -(-len(idx) // b)
                got = {k: rr["launches"][k] for k in ("fps", "rans")}
                check(got == {"fps": n_batches, "rans": n_batches},
                      f"{world}-rank rank {r}: launches {rr['launches']}, expected one FPS and one rANS launch for "
                      f"each of its {n_batches} batches")
            enter = max(rr["reduce"][0] for rr in res)
            reduce_ms = (min(rr["reduce"][1] for rr in res) - enter) * 1e3
            rate = want["frames"] / res[0]["seconds"]
            steady = steady_rate(res)
            runs[world] = (blobs, steady, [rr["launches"] for rr in res])
            print(f"[phase 8] [{card}] {world} rank(s), {backend}, global B={B}, {len(srcs)} frames ({DP_COPIES} copies "
                  f"of phase 6's 20): blobs of copy 0 == phase 6's (sha256 {hashlib.sha256(b''.join(blobs[:20])).hexdigest()[:16]}), "
                  f"sharded_stats == host sums {json.dumps(want)}, launches per rank "
                  f"{[{k: rr['launches'][k] for k in ('fps', 'rans')} for rr in res]}")
            print(f"[phase 8] [{card}] {world} rank(s), {backend}: {rate:.3f} frames/s from the start barrier to the "
                  f"reduce ({res[0]['seconds']:.4f} s), {steady:.3f} frames/s after every rank's first batch; "
                  f"start-up per rank {[round(rr['startup_s'], 4) for rr in res]} s, of which spawn, imports, CUDA "
                  f"context and the group {[round(rr['entry_s'], 4) for rr in res]} s (the rest: the engine build); "
                  f"all_reduce {reduce_ms:.4f} ms after the last rank entered it")
        check(runs[1][0] == runs[2][0], "2-rank blobs differ from 1-rank blobs")
        print(f"[phase 8] [{card}] encode rate after the first batches, 2 ranks / 1 rank on one card: "
              f"{runs[2][1]:.3f} / {runs[1][1]:.3f} = {runs[2][1] / runs[1][1]:.3f}x; phase 6's warm single engine "
              f"at B={B}: {eng['encode_rate'][0]:.3f} frames/s (2 ranks: {runs[2][1] / eng['encode_rate'][0]:.3f}x)")

        # The 2-rank decode of copy 0 on the device backend == the host decoder.
        outs = [_mirror_path(p, os.path.join(work, "rpcc2"), "rpcc") for p in srcs[: len(frames)]]
        rec = os.path.join(work, "rec2")
        args = decompress_datalist.build_parser().parse_args(["--datalist", "-", "--output_dir", rec, *common])
        check(args.decode_backend == "device", f"decompress_datalist defaults to {args.decode_backend}")
        res = launch_ranks(decompress_datalist.decompress_rank, [cuda0, cuda0], args, outs, "gloo")
        want = HostDecoder(lidar, CodecConfig()).decode_blobs_points(runs[2][0][: len(frames)])
        diff = 0.0
        for path, w in zip(outs, want):
            got = np.fromfile(_mirror_path(path, rec, "bin"), np.float32).reshape(-1, 4)
            check(got.shape == w.shape, f"2-rank decode of {path}: {got.shape[0]} rows, host decoder {w.shape[0]}")
            diff = max(diff, float(np.abs(got - w).max()))
        check(diff <= 1e-5, f"2-rank device decode differs from the host decoder by {diff}")
        check(res[0]["report"]["frames"] == len(frames), f"2-rank decode report {res[0]['report']}")
        dec_launches = [rr["launches"] for rr in res]
        for r, rr in enumerate(res):
            n_batches = -(-len(rank_frames(len(outs), B, r, 2)[1]) // rank_frames(len(outs), B, r, 2)[0])
            check(rr["launches"]["rans_decode"] >= n_batches > 0 and rr["launches"]["rans"] == 0,
                  f"2-rank decode rank {r}: launches {rr['launches']}, expected a rANS decode launch for each of its "
                  f"{n_batches} batches")
        print(f"[phase 8] [{card}] 2-rank device decode of {len(outs)} blobs: host decoder's points "
              f"(max |diff| {diff:.3g}), {res[0]['report']['frames'] / res[0]['seconds']:.3f} frames/s, first calls "
              f"included; rANS decode launches per rank {[d['rans_decode'] for d in dec_launches]}")

        # The CLI at its default --num_devices (every visible card).
        lst = os.path.join(work, "list.txt")
        with open(lst, "w") as f:
            f.write("\n".join(srcs[: len(frames)]) + "\n")
        out = os.path.join(work, "rpcc_cli")
        stdout = run_cli("compress_datalist", ["--datalist", lst, "--output_dir", out, *common], 8)
        n_cards = torch.cuda.device_count()
        check(("data parallel:" in stdout) == (n_cards > 1), f"{n_cards} card(s), yet the CLI printed:\n{stdout}")
        for path, blob in zip(srcs, eng["blobs"]):
            with open(_mirror_path(path, out, "rpcc"), "rb") as f:
                check(f.read() == blob, f"compress_datalist at its default --num_devices: {path} != phase 6's blob")
        print(f"[phase 8] compress_datalist at the default --num_devices ({n_cards} card(s)): blobs == phase 6's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs[2][2], dec_launches


def decode_device_us(torch, fn, runs: int = TIMED_RUNS, name: str = "rans_decode"):
    """Median device time (us) of the launches of the kernel ``name`` (the
    rANS decode's) in ``runs`` calls of ``fn`` (one launch each), from
    ``torch.profiler``'s kernel events: the wrapper's host time left out;
    None where the profiler recorded no such event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA") and name in e.name]
    return statistics.median(us) if us else None


def against_decode(torch, np, rd, dev, card, root: str, blobs) -> None:
    """``--against``: the rANS decode kernel of ``root``'s package on the
    device containers of phase 6's first batch at B = 1 and 8: the two field
    groups as two launches, and in one launch with both blocks' phase split
    (``decode_fields_cuda``, in every checkout with the one-launch decode); each launch's device
    time under the profiler, at full length and at T = 16 (the tables)."""
    from rpcc_tpu_torch.codec import rans_codec
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream
    from rpcc_tpu_torch.config import CodecConfig

    fields = [unpack_bitstream(b, uniform=CodecConfig().uniform) for b in blobs]
    for B in (1, 8):
        rl = rans_codec.delta_lanes([f["residual_quantized"] for f in fields[:B]])
        cl = rans_codec.contour_lanes([f["contour_map"] for f in fields[:B]])[0]
        ar, ac = rd.upload_decode_lanes(*rl[:5], dev), rd.upload_decode_lanes(*cl[:5], dev)
        # the same lanes cut to 16 steps: the tables and the launch
        sr, sc = (rd.upload_decode_lanes(g.words[:, :, :16], g.counts, g.states, np.minimum(g.lives, 16), g.freqs, dev)
                  for g in (rl, cl))
        two = lambda: (decode_group_cuda(rd, ar, rl.mode), decode_group_cuda(rd, ac, cl.mode))  # noqa: E731
        two16 = lambda: (decode_group_cuda(rd, sr, rl.mode), decode_group_cuda(rd, sc, cl.mode))  # noqa: E731
        line = (f"two launches {median_ms(torch, two):.4f} ms one call, {median_ms(torch, two, BACK_TO_BACK):.4f} ms "
                f"over {BACK_TO_BACK} back to back, each alone {median_ms(torch, lambda: decode_group_cuda(rd, ar, rl.mode)):.4f} + "
                f"{median_ms(torch, lambda: decode_group_cuda(rd, ac, cl.mode)):.4f} ms; at T = 16 "
                f"{median_ms(torch, two16):.4f} ms")
        runs = {"residual": lambda: decode_group_cuda(rd, ar, rl.mode),
                "contour": lambda: decode_group_cuda(rd, ac, cl.mode),
                "residual_T16": lambda: decode_group_cuda(rd, sr, rl.mode),
                "contour_T16": lambda: decode_group_cuda(rd, sc, cl.mode)}
        one = lambda: rd.decode_fields_cuda(ar, ac, rl.mode)  # noqa: E731
        line += (f"; one launch {median_ms(torch, one):.4f} ms one call, "
                 f"{median_ms(torch, one, BACK_TO_BACK):.4f} ms over {BACK_TO_BACK} back to back, at T = 16 "
                 f"{median_ms(torch, lambda: rd.decode_fields_cuda(sr, sc, rl.mode)):.4f} ms; phase split (us) "
                 + json.dumps({b: {k: round(v, 3) for k, v in sp.items()}
                               for b, sp in decode_split(torch, rd, ar, ac, rl.mode).items()}))
        runs.update(both=one, both_T16=lambda: rd.decode_fields_cuda(sr, sc, rl.mode))
        device = {k: decode_device_us(torch, fn) for k, fn in runs.items()}
        line += ("; device time a launch (us, torch.profiler, median of "
                 f"{TIMED_RUNS}): " + json.dumps({k: None if v is None else round(v, 3) for k, v in device.items()}))
        print(f"[against] [{card}] rans decode (B={B}, residual {tuple(rl.words.shape)} + contour "
              f"{tuple(cl.words.shape)}) of {root} median of {TIMED_RUNS}: {line}")


def against_calls(np, dev, card, root: str, codec, lidar, frames) -> None:
    """``--against``: the rANS coder's calls on the card for ``root``'s
    package, wrapper host time included (host clock, median of HOST_RUNS,
    the calls in turns): a 1,000-symbol field's encode call and its 'C'
    container's decode call, a T = 16 decode call of frame 0's two big
    fields, and the big fields' encode and decode calls of phase 6's first
    batch at B = 1 and 8.  A checkout whose coder takes no ``device=``
    codes its encodes on the card only when its process was started with
    the reference's device variable set to ``default``; the launch count
    (the ``launch.rans_encode`` counter, which a checkout has from its
    counters on) checks that it was."""
    import inspect

    from rpcc_tpu_torch.codec import rans_codec, rans_native
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream
    from rpcc_tpu_torch.ops import rans_device as rd

    kw = {"device": dev} if "device" in inspect.signature(rans_codec.compress_delta_batch).parameters else {}
    fields = [codec.compress(pc, seed=s)[1] for pc, s in zip(frames[:8], BATCH_SEEDS[:8])]
    small = [fields[0]["residual_quantized"][:1000]]
    L, T = rans_codec._geometry(1000)
    before = counter("launch.rans_encode")
    rans_codec.compress_delta_batch(small, **kw)
    check(counter("launch.rans_encode") == before + 1, f"{root}: the encode call did not launch the kernel (a checkout without "
          "device= codes on the card only under the reference's device variable set to default)")
    w, nw, cts, sts, fqs, esc, n_esc, q0 = rans_native.delta_encode_frames(small, L, T, rd.ALPHABET, rd.NUM_CTX)
    lanes_small = rans_codec.delta_lanes([rans_codec.build_ctx_container(
        L, T, 1000, q0[0], esc[0, :n_esc[0]], fqs[0], sts[0], cts[0], w[0, :nw[0]], small[0].dtype)])
    blobs = [codec.compress(pc, seed=s)[0] for pc, s in zip(frames[:1], BATCH_SEEDS[:1])]
    main1 = unpack_bitstream(blobs[0], uniform=True)
    rl = rans_codec.delta_lanes([main1["residual_quantized"]])
    cl = rans_codec.contour_lanes([main1["contour_map"]])[0]
    short = [g._replace(words=np.ascontiguousarray(g.words[:, :, :16]), lives=np.minimum(g.lives, 16))[:5]
             for g in (rl, cl)]
    t16 = lambda: rd.decode_fields_host(*short, rl.mode, dev)  # noqa: E731
    calls = {
        "small_encode": lambda: rans_codec.compress_delta_batch(small, **kw),
        "small_decode": lambda: rans_codec.decode_lanes(lanes_small, dev),
        "t16_decode": t16,
    }
    H, W = lidar.height, lidar.width
    for B in (1, 8):
        sb, pb = [f["residual_quantized"] for f in fields[:B]], [f["contour_map"] for f in fields[:B]]
        packed = [{"residual_quantized": r, "contour_map": c}
                  for r, c in zip(rans_codec.compress_batch(sb), rans_codec.compress_contour_batch(pb, H, W))]
        calls[f"big_encode_B{B}"] = lambda sb=sb, pb=pb: (rans_codec.compress_delta_batch(sb, **kw),
                                                          rans_codec.compress_contour_batch(pb, H, W, **kw))
        calls[f"big_decode_B{B}"] = lambda packed=packed: rans_codec.batch_decode_big_fields(packed, dev)
    times = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    for i in range(HOST_RUNS):
        for k in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            t = time.perf_counter()
            calls[k]()
            times[k].append((time.perf_counter() - t) * 1e3)
    print(f"[against] [{card}] rans coder calls on the card of {root} (ms, host clock, median of {HOST_RUNS} in "
          "turns): " + json.dumps({k: round(statistics.median(v), 4) for k, v in times.items()}))


def phase_against(torch, np, dev, card, lidar, root: str) -> None:
    """``--against``: the FPS, DBSCAN and (where the checkout has it) rANS
    kernels of ``root``'s package timed as in phases 3/3b/3c/3e, and the
    sha256 of the main path's blobs of phase 4 and of the DBSCAN-mode blobs
    of phases 4b/6."""
    import importlib.util

    import rpcc_tpu_torch
    from rpcc_tpu_torch.config import CodecConfig
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.ops import dbscan, segment
    from rpcc_tpu_torch.ops.projection_host import build_transform_map
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    from rpcc_tpu_torch.ops import fps

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(rpcc_tpu_torch.__file__)))
    check(pkg == root, f"imported the package of {pkg}, not of {root}")
    for B in (1, 8):  # the unmasked FPS kernel of the main path, as in phases 3 and 6
        pts = np.random.default_rng(B).uniform(-40.0, 40.0, (3, B, 128000)).astype(np.float32)
        pts[:, :, 20000:60000] = 0.0
        xs, ys, zs = (torch.from_numpy(p).to(dev) for p in pts)
        run = lambda: fps.furthest_point_sample_cuda(xs, ys, zs, 100)  # noqa: E731
        print(f"[against] [{card}] fps ({B}, 128000, 100) of {root} median of {TIMED_RUNS}: "
              f"{median_ms(torch, run):.4f} ms one call, {median_ms(torch, run, BACK_TO_BACK):.4f} ms "
              f"over {BACK_TO_BACK} back to back")
    tm = build_transform_map(lidar)
    for seeds in ((0,), STREET_SEEDS, STREET_SEEDS_8):
        frames = [street_frame(np, segment, torch, tm, s) for s in seeds]
        p = torch.from_numpy(np.ascontiguousarray(np.stack([f[0] for f in frames]))).to(dev)
        a = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
        run = lambda: dbscan.dbscan_labels_cuda(p, a, 1.5)  # noqa: E731
        print(f"[against] [{card}] dbscan ({len(seeds)}, 64, 2000) of {root} median of {TIMED_RUNS}: "
              f"{median_ms(torch, run):.4f} ms one call, {median_ms(torch, run, BACK_TO_BACK):.4f} ms "
              f"over {BACK_TO_BACK} back to back")
        if hasattr(dbscan, "PHASES"):  # a kernel with phase stamps
            print(f"[against] [{card}] dbscan ({len(seeds)}, 64, 2000) frame 0 phase split (us): "
                  + json.dumps({k: round(v, 3) for k, v in dbscan_split(torch, dbscan, p, a, 1.5).items()}))
    from rpcc_tpu_torch.data.synth import synth_cloud_for

    codec = RPCCCodec(lidar, CodecConfig(), dev)
    for s in SEEDS:
        print(f"[phase 4] default seed {s} blob sha256 "
              f"{hashlib.sha256(codec.compress(synth_cloud_for(lidar, s))[0]).hexdigest()}")
    if importlib.util.find_spec("rpcc_tpu_torch.ops.rans_device") is not None:
        from rpcc_tpu_torch.ops import rans_device as rd

        frames = [synth_cloud_for(lidar, s) for s in BATCH_SEEDS]
        q, n, c = rans_inputs(torch, codec, frames[:8])
        for B in (1, 8):
            qb, nb, cb = (t[:B].contiguous() for t in (q, n, c))
            run = lambda qb=qb, nb=nb, cb=cb: rd.encode_fields_cuda(qb, nb, cb)  # noqa: E731
            print(f"[against] [{card}] rans (B={B}, 64x2000) of {root} median of {TIMED_RUNS}: "
                  f"{median_ms(torch, run):.4f} ms one call, {median_ms(torch, run, BACK_TO_BACK):.4f} ms "
                  f"over {BACK_TO_BACK} back to back")
            if hasattr(rd, "STAMP_BLOCKS"):  # a kernel that stamps both blocks
                print(f"[against] [{card}] rans (B={B}, 64x2000) phase split (us): "
                      + json.dumps({b: {k: round(v, 3) for k, v in sp.items()}
                                    for b, sp in rans_split(torch, rd, qb, nb, cb).items()}))
        # Phase 6's main-path run: the device-entropy engine at B = 8 on 20 frames.
        engine = BatchEngine(lidar, CodecConfig(), dev, batch_size=8)
        try:
            work = [(b, range(i * 8, i * 8 + len(b))) for i, b in enumerate(_batches(frames, 8))]
            blobs = [b for res in engine.encode_pipeline(work) for b, _ in res]
        finally:
            engine.close()
        print(f"[phase 6] device-entropy engine (B=8) sha256 {[hashlib.sha256(b).hexdigest() for b in blobs]}")
        if hasattr(rd, "decode_fields_cuda"):  # a checkout with the rANS decode kernel: phase 3f's shapes
            against_decode(torch, np, rd, dev, card, root, blobs[:8])
            against_calls(np, dev, card, root, codec, lidar, frames)
    cfg = CodecConfig(segment_method="DBSCAN", device_entropy=False)
    codec = RPCCCodec(lidar, cfg, dev)
    for s in MODE_SEEDS:
        print(f"[phase 4b] DBSCAN seed {s} blob sha256 "
              f"{hashlib.sha256(codec.compress(scene_cloud(np, tm, s))[0]).hexdigest()}")
    engine = BatchEngine(lidar, cfg, dev, batch_size=len(STREET_SEEDS))
    try:
        blobs = engine.encode_frames([scene_cloud(np, tm, s) for s in STREET_SEEDS], STREET_SEEDS)
    finally:
        engine.close()
    print(f"[phase 6] DBSCAN engine (B={len(STREET_SEEDS)}) sha256 {[hashlib.sha256(b).hexdigest() for b, _ in blobs]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="CHECKOUT",
                    help="time the FPS and DBSCAN kernels and hash the main-path and DBSCAN blobs of this "
                    "checkout's package only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = ROOT if args.against is None else os.path.abspath(args.against)
    sys.path.insert(0, root)
    import numpy as np

    from rpcc_tpu_torch.data import lidar_config

    if args.against is not None:
        card = card_line()
        print(card)
        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        phase_against(torch, np, dev, card, lidar_config(LIDAR), root)
        return 0

    # ---------------------------------------------------------------- 0
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    try:
        import yaml  # noqa: F401

        print("yaml: ok")
    except ImportError:
        print("yaml: absent")
    check_isolated()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    lidar = lidar_config(LIDAR)

    phase_build()  # 1
    phase_prng(torch, dev)  # 2
    fps_err, fps_ms, fps_b2b, fps_plain_ms = phase_fps(torch, np, dev, card)  # 3
    masked = phase_fps_masked(torch, np, dev, card)  # 3d
    db_err, db_ms, db_b2b, db_plain_ms, db_bound, db_split = phase_dbscan(torch, np, dev, card, lidar)  # 3b
    db4 = phase_dbscan_batch(torch, np, dev, card, lidar, STREET_SEEDS)  # 3c
    db8 = phase_dbscan_batch(torch, np, dev, card, lidar, STREET_SEEDS_8)
    proj = phase_projection(torch, np, dev, card, lidar)  # 3h
    codec, frames, codec_launches = phase_main(torch, np, dev, card, lidar)  # 4
    fps_per_encode = codec_launches["fps"]
    rans = phase_rans(torch, np, dev, card, lidar, codec, frames)  # 3e
    db_per_encode = phase_modes(torch, np, dev, card, lidar)  # 4b
    new_modes = phase_new_modes(torch, np, dev, card, lidar)  # 4c
    points_launches = phase_points(torch, np, dev, card, lidar, frames)  # 4d
    cli_launches = phase_cli(np, codec, frames)  # 5
    eng = phase_engine(torch, np, dev, card, lidar, codec)  # 6
    dec = phase_rans_decode(torch, np, dev, card, lidar, codec, frames, eng)  # 3f
    host = phase_rans_host(torch, np, dev, card, lidar, codec, frames, eng["blobs"])  # 3g
    datalist_launches = phase_datalist(np, codec, lidar)  # 7
    rank_launches, rank_decode_launches = phase_data_parallel(torch, np, card, lidar, codec, eng)  # 8
    check_isolated()
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")

    # ``ms``/``plain_ms``/``bound_ms`` are at the engine's shape (``shape``),
    # ``launches`` is the engine's count of wrapper calls over phase 6's
    # main-path run; the single-frame times and bound of phases 3 and 3b
    # stand beside them (DBSCAN's B = 8 times of phase 3c too), and
    # ``launches_per_encode`` is the kernel launches of one single-frame
    # encode (phases 4, 4b): wrapper calls times LAUNCHES_PER_CALL.  The
    # ``masked_*`` keys are the FPS kernel masked by per-frame counts
    # (phase 3d; its launches per ``cpu_fps`` encode from phase 4c).  No
    # single PyTorch call computes FPS or DBSCAN labels, so ``library_ms``
    # is null.  The rANS kernel's ``ms`` are at the engine's B = 8 on phase
    # 6's first batch (phase 3e), its ``launches`` phase 6's main-path
    # device-entropy run (one per batch);
    # no PyTorch call computes a rANS encode.  ``launches_per_points_encode``
    # is each kernel's launches in one from-points encode (phase 4d: FPS in
    # the default mode, DBSCAN in its mode, rANS in both, no decode).  The
    # decode kernel's ``ms`` are one launch of both field groups of phase
    # 6's first batch at B = 8 (phase 3f; ``fields_alone`` each group in a
    # launch of its own), its ``launches`` the engine's decode of phase 6's
    # blobs on the card, the default (one per batch and one per small rANS
    # field); no PyTorch call decodes rANS.  The rANS entry's ``host_path``
    # is the same kernel at the host containers' geometry, which every card
    # encode's containers take (phase 3g, on phase 6's first batch at B = 1
    # and 8, and a 1,000-symbol field): kernel times, the encode calls on
    # the card and on the host coder and the native host encode.  The
    # ``launches_*`` keys count each default path's launches: the
    # single-frame codec's encode and decode (phase 4), the host-entropy
    # engine (phase 6), the CLIs (phase 5) and the datalist CLIs (phase 7),
    # in this process; ``launches_per_rank_two_ranks`` is each rank's count
    # in phase 8's 2-rank encode or decode (its own process, counted by
    # itself).
    print(json.dumps({"kernels": [
        {
            "name": "fps",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/fps.cu",
            "replaces": "rpcc_tpu/ops/fps_pallas.py:31",
            "launches": eng["fps_launches"],
            "launches_per_encode": fps_per_encode * LAUNCHES_PER_CALL["fps"],
            "launches_per_points_encode": points_launches["fps"],
            "launches_per_rank_two_ranks": [r["fps"] for r in rank_launches],
            "max_abs_err": max(fps_err, eng["fps_err"]),
            "shape": eng["fps_shape"],
            "ms": eng["fps_ms"],
            "ms_10_back_to_back": eng["fps_b2b"],
            "plain_ms": eng["fps_plain_ms"],
            "bound_ms": eng["fps_bound"][0],
            "bound_by": eng["fps_bound"][1],
            "library_ms": None,
            "single_frame_shape": "B=1 N=128000 K=100",
            "single_frame_ms": fps_ms,
            "single_frame_ms_10_back_to_back": fps_b2b,
            "single_frame_plain_ms": fps_plain_ms,
            "single_frame_bound_ms": fps_bound(1, 128000, 100)[0],
            "masked_launches_per_encode": new_modes["cpu_fps"]["fps"] * LAUNCHES_PER_CALL["fps"],
            "masked_shape": masked[1]["shape"],
            "masked_ms": masked[1]["ms"],
            "masked_ms_10_back_to_back": masked[1]["b2b"],
            "masked_plain_ms": masked[1]["plain_ms"],
            "masked_bound_ms": masked[1]["bound"][0],
            "masked_bound_by": masked[1]["bound"][1],
            "masked_batch8_shape": masked[8]["shape"],
            "masked_batch8_ms": masked[8]["ms"],
            "masked_batch8_ms_10_back_to_back": masked[8]["b2b"],
            "masked_batch8_plain_ms": masked[8]["plain_ms"],
            "masked_batch8_bound_ms": masked[8]["bound"][0],
        },
        {
            "name": "dbscan",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/dbscan.cu",
            "replaces": "rpcc_tpu/ops/dbscan_pallas.py:42",
            "launches": eng["db_launches"],
            "launches_per_encode": db_per_encode * LAUNCHES_PER_CALL["dbscan"],
            "launches_per_points_encode": points_launches["dbscan"],
            "max_abs_err": max(db_err, db4["err"], db8["err"]),
            "shape": f"B={len(STREET_SEEDS)} H=64 W=2000",
            "ms": db4["ms"],
            "ms_10_back_to_back": db4["b2b"],
            "plain_ms": db4["plain_ms"],
            "bound_ms": db4["bound"][0],
            "bound_by": db4["bound"][1],
            "library_ms": None,
            "single_frame_shape": "B=1 H=64 W=2000",
            "single_frame_ms": db_ms,
            "single_frame_ms_10_back_to_back": db_b2b,
            "single_frame_plain_ms": db_plain_ms,
            "single_frame_bound_ms": db_bound[0],
            "single_frame_phase_us": {k: round(v, 3) for k, v in db_split.items()},
            "batch8_ms": db8["ms"],
            "batch8_ms_10_back_to_back": db8["b2b"],
            "batch8_plain_ms": db8["plain_ms"],
            "batch8_bound_ms": db8["bound"][0],
        },
        {
            "name": "rans",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/rans.cu",
            "replaces": "rpcc_tpu/ops/rans_device.py:151 (encode_field_device, XLA, not Pallas)",
            "launches": eng["rans_launches"],
            "launches_per_batch": eng["rans_launches"] / eng["batches"],
            "launches_per_points_encode": points_launches["rans"],
            "launches_per_codec_encode": codec_launches["rans"],
            "launches_host_entropy_engine_20_frames": eng["host_entropy_rans_launches"],
            "launches_cli_compress": cli_launches["compress"][0],
            "launches_datalist_10_frames": {k: v["rans"] for k, v in datalist_launches.items() if "backend" not in k},
            "launches_per_rank_two_ranks": [r["rans"] for r in rank_launches],
            "max_abs_err": rans["err"],
            "shape": rans[8]["shape"],
            "ms": rans[8]["ms"],
            "ms_10_back_to_back": rans[8]["b2b"],
            "plain_ms": rans[8]["plain_ms"],
            "bound_ms": rans[8]["bound"][0],
            "bound_by": rans[8]["bound"][1],
            "library_ms": None,
            "single_frame_shape": rans[1]["shape"],
            "single_frame_ms": rans[1]["ms"],
            "single_frame_ms_10_back_to_back": rans[1]["b2b"],
            "single_frame_plain_ms": rans[1]["plain_ms"],
            "single_frame_bound_ms": rans[1]["bound"][0],
            "single_frame_phase_us": {b: {k: round(v, 3) for k, v in sp.items()} for b, sp in rans[1]["split"].items()},
            "phase_us": {b: {k: round(v, 3) for k, v in sp.items()} for b, sp in rans[8]["split"].items()},
            "single_frame_ns_per_step": rans[1]["ns_step"],
            "ns_per_step": rans[8]["ns_step"],
            "host_path": {
                "replaces": "rpcc_tpu/ops/rans.py:345 (encode_streams_batch_ctx) and :379 "
                            "(encode_streams_batch_ctx_explicit), XLA, not Pallas",
                "launches": host["launches"],
                "batch_calls": host["calls"],
                "launches_per_batch_call": host["launches"] / host["calls"],
                **{f"batch{B}": {
                    "shape": host[B]["shape"],
                    "ms": host[B]["ms"],
                    "ms_10_back_to_back": host[B]["b2b"],
                    "residual_ms": host[B]["residual_ms"],
                    "residual_ms_10_back_to_back": host[B]["residual_b2b"],
                    "contour_ms": host[B]["contour_ms"],
                    "plain_ms": host[B]["plain_ms"],
                    "bound_ms": host[B]["bound"][0],
                    "bound_by": host[B]["bound"][1],
                    "call_ms_card": host[B]["call_ms"],
                    "call_residual_staged_upload_launch_download_ms": host[B]["pieces_ms"],
                    "call_ms_host_coder": host[B]["cpu_call_ms"],
                    "native_host_encode_ms": host[B]["native_ms"],
                } for B in (1, 8)},
                "codec_single_frame_ms": host["codec"],
                "small_field": {
                    "shape": host["small"]["shape"],
                    "ms": host["small"]["ms"],
                    "bound_ms": host["small"]["bound"][0],
                    "call_ms_card": host["small"]["call_ms"],
                    "call_ms_host_coder": host["small"]["cpu_call_ms"],
                    "native_host_encode_ms": host["small"]["native_ms"],
                    "sequence_field_symbols": host["small"]["seq_n"],
                    "sequence_compress_ms_card": host["small"]["seq_call_ms"],
                    "sequence_compress_ms_host_coder": host["small"]["seq_cpu_call_ms"],
                },
            },
        },
        {
            "name": "rans_decode",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/rans_decode.cu",
            "replaces": "rpcc_tpu/ops/rans.py:224 (rans_decode_ctx, through decode_streams_batch_ctx :399; XLA, "
                        "not Pallas)",
            "launches": dec["launches"],
            "launches_per_batch": dec["launches"] / dec["batches"],
            "launches_per_points_encode": points_launches["rans_decode"],
            "launches_per_codec_decode": codec_launches["rans_decode"],
            "launches_engine_decode_20_blobs": eng["decode_launches"],
            "launches_host_entropy_engine_decode_20_blobs": eng["host_entropy_decode_launches"],
            "launches_cli_decompress": {"device": cli_launches["decompress device"][1],
                                        "host": cli_launches["decompress host"][1]},
            "launches_datalist_10_blobs": {k: v["rans_decode"] for k, v in datalist_launches.items() if "backend" in k},
            "launches_per_rank_two_ranks": [r["rans_decode"] for r in rank_decode_launches],
            "max_abs_err": dec["err"],
            "shape": dec[8]["shape"],
            "ms": dec[8]["ms"],
            "ms_10_back_to_back": dec[8]["b2b"],
            "plain_ms": dec[8]["plain_ms"],
            "bound_ms": dec[8]["bound"][0],
            "bound_by": dec[8]["bound"][1],
            "library_ms": None,
            "host_native_ms": dec[8]["host_ms"],
            "tables_and_launch_ms": dec[8]["tables_ms"],
            "phase_us": {b: {k: round(v, 3) for k, v in sp.items()} for b, sp in dec[8]["split"].items()},
            "ns_per_step": dec[8]["ns_step"],
            "chain_floor_ms": dec[8]["floor_ms"],
            "fields_alone": {f: {k: dec[8][f][k] for k in ("ms", "b2b", "plain_ms", "host_ms")}
                             for f in ("residual", "contour")},
            "single_frame_shape": dec[1]["shape"],
            "single_frame_ms": dec[1]["ms"],
            "single_frame_ms_10_back_to_back": dec[1]["b2b"],
            "single_frame_plain_ms": dec[1]["plain_ms"],
            "single_frame_bound_ms": dec[1]["bound"][0],
            "single_frame_host_native_ms": dec[1]["host_ms"],
            "single_frame_tables_and_launch_ms": dec[1]["tables_ms"],
            "single_frame_phase_us": {b: {k: round(v, 3) for k, v in sp.items()} for b, sp in dec[1]["split"].items()},
            "single_frame_ns_per_step": dec[1]["ns_step"],
            "single_frame_fields_alone": {f: {k: dec[1][f][k] for k in ("ms", "b2b", "plain_ms", "host_ms")}
                                          for f in ("residual", "contour")},
            "renormalizations_per_step": dec["renorm"],
            "chain_probe_cycles": {k: round(v, 3) for k, v in dec["probe"]["cycles"].items()},
            "chain_probe_mhz": dec["probe"]["mhz"],
            "engine_decode_ms": {"host_coder": dec["engine_cpu_ms"], "card": dec["engine_default_ms"]},
            "engine_decode_split_ms": dec["engine_split"],
            "codec_decode_big_fields_ms": {f"batch{B}": {"host_coder": dec[B]["codec_cpu_ms"],
                                                         "card": dec[B]["codec_default_ms"]} for B in (1, 8)},
            "small_field_decode_call_ms": {"card": host["small"]["decode_call_ms"],
                                           "host_coder": host["small"]["decode_cpu_call_ms"]},
            "t16_decode_call_ms": {"shape": host["small"]["t16_shape"], "card": host["small"]["t16_call_ms"],
                                   "native": host["small"]["t16_native_ms"]},
        },
        {
            "name": "project",
            "route": "cuda",
            "source": "rpcc_tpu_torch/csrc/raster.cu",
            "replaces": "none: rpcc_tpu_torch/csrc/host/raster.cpp on the host (the reference's jnp in rpcc_tpu/ops/projection.py)",
            "launches_per_codec_encode": codec_launches["project"] * LAUNCHES_PER_CALL["project"],
            "shape": proj["full"]["shape"],
            "ms": proj["full"]["ms"],
            "ms_10_back_to_back": proj["full"]["b2b"],
            "plain_ms": proj["full"]["plain_ms"],
            "bound_ms": proj["full"]["bound"][0],
            "bound_by": proj["full"]["bound"][1],
            "library_ms": None,
            "device_us": proj["full"]["device_us"],
            "host_projection_ms": proj["full"]["host_ms"],
            "upload_ms": proj["full"]["upload_ms"],
            "dropped_shape": proj["dropped"]["shape"],
            "dropped_ms": proj["dropped"]["ms"],
            "dropped_ms_10_back_to_back": proj["dropped"]["b2b"],
            "dropped_plain_ms": proj["dropped"]["plain_ms"],
            "dropped_bound_ms": proj["dropped"]["bound"][0],
            "dropped_device_us": proj["dropped"]["device_us"],
            "dropped_host_projection_ms": proj["dropped"]["host_ms"],
            "dropped_upload_ms": proj["dropped"]["upload_ms"],
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
