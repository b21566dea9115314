"""Farthest point sampling: plain PyTorch version + the CUDA kernel's wrapper.

Semantics of ``rpcc_tpu/ops/fps.py`` and of the TPU kernel
``rpcc_tpu/ops/fps_pallas.py::_fps_kernel``: the first pick is index 0,
the running min squared distance starts at 1e10, and each of the K-1
steps takes the argmax of the running minimum, the lowest index winning
ties.  The masked version (``rpcc_tpu/ops/fps.py::
furthest_point_sample_planar_masked``, the ``cpu_fps`` mode) runs over the
first ``num_valid`` points of each frame: slots at or past the count pin
their running minimum at -1, so they never win.

:func:`furthest_point_sample` dispatches on the tensors' device: the plain
version for CPU tensors, the hand-written kernel (``csrc/fps.cu``, one
thread-block cluster per frame) for CUDA tensors.  A CUDA tensor never
falls back to the plain version: if the kernel cannot build or launch, the
call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from rpcc_tpu_torch.utils import timer


def _planar_loop(xs, ys, zs, num_samples: int, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The K-step loop over (B, N) planes; ``valid`` (B, N) masks the
    points that may win, or None for all.  ``last`` stays a tensor, so a
    device run never waits on the host between steps."""
    B, n = xs.shape
    idxs = torch.zeros((B, num_samples), dtype=torch.int32, device=xs.device)
    min_d2 = torch.full((B, n), 1e10, dtype=torch.float32, device=xs.device)
    if valid is not None:
        min_d2 = torch.where(valid, min_d2, -1.0)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xs.device)
    for i in range(1, num_samples):
        dx = xs - xs.gather(1, last)
        dy = ys - ys.gather(1, last)
        dz = zs - zs.gather(1, last)
        d2 = dx * dx + dy * dy + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        if valid is not None:
            min_d2 = torch.where(valid, min_d2, -1.0)
        last = torch.argmax(min_d2, dim=1, keepdim=True)  # first of equal maxima
        idxs[:, i] = last[:, 0].to(torch.int32)
    return idxs


def furthest_point_sample_planar(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, num_samples: int
) -> torch.Tensor:
    """Plain FPS over planar (B, N) or (N,) coordinates -> (B, K) or (K,)
    int32 indices."""
    if xs.ndim == 1:
        return _planar_loop(xs[None], ys[None], zs[None], num_samples, None)[0]
    return _planar_loop(xs, ys, zs, num_samples, None)


def furthest_point_sample_planar_masked(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, num_valid: torch.Tensor, num_samples: int
) -> torch.Tensor:
    """Plain masked FPS over the first ``num_valid`` points of each frame:
    (B, N) planes and (B,) counts, or (N,) planes and a 0-d or (1,) count
    -> (B, K) or (K,) int32 indices.  The seed is index 0 whatever the
    count; with a count of 0 every pick is index 0."""
    squeeze = xs.ndim == 1
    x2, y2, z2 = (t.reshape(1, -1) if squeeze else t for t in (xs, ys, zs))
    valid = torch.arange(x2.shape[1], device=xs.device) < num_valid.reshape(-1, 1)
    out = _planar_loop(x2, y2, z2, num_samples, valid)
    return out[0] if squeeze else out


def _check(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, num_samples: int,
           num_valid: Optional[torch.Tensor] = None) -> None:
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != xs.shape or t.device != xs.device:
            raise ValueError("xs, ys and zs must share shape and device")
    if xs.ndim not in (1, 2) or xs.shape[-1] < 1:
        raise ValueError(f"expected (N,) or (B, N) coordinates, got {tuple(xs.shape)}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if num_valid is not None:
        if num_valid.dtype != torch.int32:
            raise TypeError(f"num_valid must be int32, got {num_valid.dtype}")
        if num_valid.device != xs.device or num_valid.numel() != (1 if xs.ndim == 1 else xs.shape[0]):
            raise ValueError("num_valid must hold one count per frame, on the coordinates' device")


# The cluster kernel's shape (csrc/fps.cu: kThreads, kRegPts): a CTA keeps
# up to ONCHIP_PTS points on chip, x/y/z in shared memory and min-d2 in
# registers; points past that stream from device memory ("spill").
THREADS = 1024
REG_PTS = 16
ONCHIP_PTS = THREADS * REG_PTS


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs per frame
    chunk: int  # points per CTA, ceil(N / cluster); the last CTAs may hold fewer
    onchip: int  # points a CTA holds on chip
    spill: int  # points a CTA streams from device memory
    smem_bytes: int  # dynamic shared memory per CTA (x/y/z of the on-chip points)


def plan_for(n: int, cluster: int) -> LaunchPlan:
    """The split of an N-point frame over a cluster of ``cluster`` CTAs."""
    chunk = -(-n // cluster)
    onchip = min(chunk, ONCHIP_PTS)
    return LaunchPlan(cluster, chunk, onchip, chunk - onchip, 12 * onchip)


def launch_plan(batch: int, n: int, max_active: Callable[[LaunchPlan], int]) -> LaunchPlan:
    """Clusters of 16 CTAs where ``max_active(plan)`` says B of them run on
    the card at once, else clusters of 8.  Both give the same indices."""
    big = plan_for(n, 16)
    return big if max_active(big) >= batch else plan_for(n, 8)


@functools.lru_cache(maxsize=None)
def _library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("fps.cu")
    lib.rpcc_fps_launch.restype = ctypes.c_int
    lib.rpcc_fps_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    )
    lib.rpcc_fps_max_active_clusters.restype = ctypes.c_int
    lib.rpcc_fps_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _kernel():
    return _library().rpcc_fps_launch


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, cluster: int, smem_bytes: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel on one card: how many
    clusters of ``cluster`` CTAs with ``smem_bytes`` each run at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().rpcc_fps_max_active_clusters(cluster, smem_bytes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"FPS occupancy query failed: cudaError_t {err}")
    return out.value


def furthest_point_sample_cuda(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, num_samples: int,
    num_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The CUDA kernel on (B, N) or (N,) f32 CUDA tensors, masked by the
    int32 per-frame counts ``num_valid`` (read on the device) when given;
    raises on any other input.  Launches on the current stream and does not
    synchronize.  Counts the launch under ``launch.fps``."""
    _check(xs, ys, zs, num_samples, num_valid)
    if xs.device.type != "cuda":
        raise ValueError(f"furthest_point_sample_cuda needs CUDA tensors, got {xs.device}")
    if not (xs.is_contiguous() and ys.is_contiguous() and zs.is_contiguous()):
        raise ValueError("xs, ys and zs must be contiguous")
    squeeze = xs.ndim == 1
    x2, y2, z2 = (t.reshape(1, -1) if squeeze else t for t in (xs, ys, zs))
    B, n = x2.shape
    if B * n >= 2**31:
        raise ValueError("FPS input exceeds 2^31 elements")
    fn = _kernel()
    dev = xs.device.index if xs.device.index is not None else torch.cuda.current_device()
    plan = launch_plan(B, n, lambda p: max_active_clusters(dev, p.cluster, p.smem_bytes))
    with torch.cuda.device(xs.device):
        out = torch.empty((B, num_samples), dtype=torch.int32, device=xs.device)
        scratch = torch.empty(max(B * plan.cluster * plan.spill, 1), dtype=torch.float32, device=xs.device)
        counts = None if num_valid is None else num_valid.contiguous()
        err = fn(
            x2.data_ptr(), y2.data_ptr(), z2.data_ptr(), None if counts is None else counts.data_ptr(),
            B, n, num_samples,
            plan.cluster, plan.chunk, plan.smem_bytes,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"FPS kernel launch failed: cudaError_t {err}")
    timer.count("launch.fps")
    return out[0] if squeeze else out


def furthest_point_sample(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, num_samples: int,
    num_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FPS on the tensors' own device, masked by the per-frame counts
    ``num_valid`` when given: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if xs.device.type == "cuda":
        return furthest_point_sample_cuda(xs, ys, zs, num_samples, num_valid)
    if xs.device.type != "cpu":
        raise ValueError(f"unsupported device {xs.device}")
    _check(xs, ys, zs, num_samples, num_valid)
    if num_valid is None:
        return furthest_point_sample_planar(xs, ys, zs, num_samples)
    return furthest_point_sample_planar_masked(xs, ys, zs, num_valid, num_samples)
