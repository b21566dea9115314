"""Range-image DBSCAN: plain PyTorch version + the CUDA kernel's wrapper.

Semantics of ``rpcc_tpu/ops/dbscan.py`` (the spec) and of the TPU kernel
``rpcc_tpu/ops/dbscan_pallas.py::_dbscan_label_kernel``, per (H, W) frame:

  1. eps-connectivity between active pixels over the 48 shifts of a
     window-3 neighbourhood, columns circular (the image wraps in azimuth),
     rows clamped; ``d2 = dx*dx + dy*dy + dz*dz < eps2`` in f32;
  2. core pixels: active and ``count + 1 >= min_points``;
  3. connected components over core-core edges, each labelled by its
     minimum flat pixel index;
  4. a non-core active pixel takes the minimum label over its eps-connected
     core neighbours; every other pixel is unlabelled (``hw``).

Discovery-order compaction (:func:`_compact_labels`) turns those raw labels
into the codec's ids: 2 = noise, 3.. = clusters by ascending root index.

:func:`dbscan_labels` dispatches on the tensors' device: the plain version
for CPU tensors, the hand-written kernels (``csrc/dbscan.cu``: a grid-wide
mask pass, then one thread-block cluster per frame; two launches per batch)
for CUDA tensors.  A CUDA tensor never falls back to the plain version: if
the kernels cannot build or launch, the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from rpcc_tpu_torch.utils import timer

MIN_POINTS = 10  # utils/segment_utils.py:152
NOISE_ID = 2  # final id of DBSCAN noise
FIRST_CLUSTER_ID = 3  # final id of the first cluster
WINDOW = 3  # pixel window for eps-connectivity

# The cluster kernel's layout (csrc/dbscan.cu): a CTA keeps a u64 mask word
# and an i32 parent per owned pixel (12 B) in shared memory, up to the
# card's opt-in limit per CTA (the kernel has no static shared memory);
# slots past that stay in device memory ("spill").  This module owns the
# plan; the launcher checks only that it is safe.
SMEM_LIMIT = 232448  # 227 KB, cudaDevAttrMaxSharedMemoryPerBlockOptin on Hopper
BYTES_PER_PX = 12
MAX_ONCHIP = SMEM_LIMIT // BYTES_PER_PX
# Spans timed by ``phase_stamps`` (csrc/dbscan.cu): the mask launch until
# the cluster kernel starts, then the cluster kernel's five phases ("load":
# the mask words into shared memory).
PHASES = ("mask", "load", "local_union", "cross_union", "resolve", "label")


def _neighbor_shifts(window: int) -> Tuple[Tuple[int, int], ...]:
    """(dr, dc) over the (2w+1)^2 window without (0, 0), row-major; bit i of
    the kernel's connectivity mask is shift i."""
    return tuple(
        (dr, dc)
        for dr in range(-window, window + 1)
        for dc in range(-window, window + 1)
        if (dr, dc) != (0, 0)
    )


def _shift(arr: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Value of the (r+dr, c+dc) neighbour at each pixel of (..., H, W):
    column-circular, row-clamped with ``fill``; never across frames.  Rows
    are clamped for every ``dr``, as in the TPU kernel; the jnp spec's
    ``_shift`` keeps a wrapped row when ``dr > H`` (H = 2, dr = 3)."""
    H = arr.shape[-2]
    out = torch.roll(arr, (-dr, -dc), (-2, -1))
    if dr > 0:
        out[..., max(H - dr, 0) :, :] = fill
    elif dr < 0:
        out[..., :-dr, :] = fill
    return out


def _run_min(lab: torch.Tensor, linked_prev: torch.Tensor, hw: int) -> torch.Tensor:
    """Min label over maximal linked runs along the last dim: forward and
    backward segmented doubling floods (``dbscan_pallas.py:149-179``).
    ``linked_prev[..., r, c]``: pixel (r, c) is linked to (r, c-1)."""
    n = lab.shape[-1]

    def shifted(x, d, fill, forward):
        out = torch.full_like(x, fill)
        if forward:
            out[..., d:] = x[..., :-d]
        else:
            out[..., :-d] = x[..., d:]
        return out

    linked_next = shifted(linked_prev, 1, False, forward=False)
    result = []
    for reach, forward in ((linked_prev, True), (linked_next, False)):
        f = lab
        d = 1
        while d < n:
            f = torch.where(reach, torch.minimum(f, shifted(f, d, hw, forward)), f)
            reach = reach & shifted(reach, d, False, forward)
            d *= 2
        result.append(f)
    return torch.minimum(*result)


def dbscan_labels_planar(
    point_planes: torch.Tensor,  # (3, H, W) or (B, 3, H, W) f32 planar x/y/z
    active: torch.Tensor,  # (H, W) or (B, H, W) bool
    eps: float,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """Plain version: (..., H, W) int32 raw labels (component minimum
    in-frame flat index; ``hw`` = unlabelled).  Components by min-label
    hooks, row and column floods and pointer jumping until a sweep changes
    nothing in any frame; the loop reads its convergence flag on the host,
    once per sweep.  A converged frame no longer changes, so a batch gives
    each frame its single-frame labels."""
    H, W = active.shape[-2:]
    lead = active.shape[:-2]
    hw = H * W
    dev = active.device
    eps2 = torch.tensor(float(eps) * float(eps), dtype=torch.float32, device=dev)
    shifts = _neighbor_shifts(window)
    px, py, pz = point_planes[..., 0, :, :], point_planes[..., 1, :, :], point_planes[..., 2, :, :]
    conn = torch.empty((len(shifts), *active.shape), dtype=torch.bool, device=dev)
    for i, (dr, dc) in enumerate(shifts):
        dx = px - _shift(px, dr, dc, float("inf"))
        dy = py - _shift(py, dr, dc, 0.0)
        dz = pz - _shift(pz, dr, dc, 0.0)
        d2 = dx * dx + dy * dy + dz * dz
        conn[i] = active & _shift(active, dr, dc, False) & (d2 < eps2)
    core = active & (conn.sum(0) + 1 >= min_points)
    nb_core = torch.stack([_shift(core, dr, dc, False) for dr, dc in shifts])
    core_edge = conn & core & nb_core

    i01, i10 = shifts.index((0, 1)), shifts.index((1, 0))
    lp_col = torch.zeros_like(core)
    lp_col[..., :, 1:] = core_edge[i01][..., :, :-1]  # (r, c) linked to (r, c-1)
    lp_row = torch.zeros_like(core)
    lp_row[..., 1:, :] = core_edge[i10][..., :-1, :]  # (r, c) linked to (r-1, c)

    iota = torch.arange(hw, dtype=torch.int32, device=dev).reshape(H, W)
    lab = torch.where(core, iota, hw)
    while True:
        new = lab
        for i, (dr, dc) in enumerate(shifts):
            new = torch.where(core_edge[i], torch.minimum(new, _shift(lab, dr, dc, hw)), new)
        new = _run_min(new, lp_col, hw)
        new = _run_min(new.transpose(-1, -2), lp_row.transpose(-1, -2), hw).transpose(-1, -2)
        for _ in range(2):  # pointer jumping: every label is a core pixel's
            flat = new.reshape(*lead, hw)
            jumped = flat.gather(-1, flat.clamp(max=hw - 1).long())
            new = torch.where(flat < hw, jumped, hw).reshape(*lead, H, W)
        if torch.equal(new, lab):
            break
        lab = new

    border = torch.full(active.shape, hw, dtype=torch.int32, device=dev)
    for i, (dr, dc) in enumerate(shifts):
        attach = conn[i] & nb_core[i]
        border = torch.where(attach, torch.minimum(border, _shift(lab, dr, dc, hw)), border)
    return torch.where(core, lab, torch.where(active, border, hw)).to(torch.int32)


def _compact_labels(labels: torch.Tensor, active: torch.Tensor, max_clusters: int) -> torch.Tensor:
    """Discovery-order compaction per frame: roots ascending (= row-major
    first pixel) become FIRST_CLUSTER_ID + rank; components past
    ``max_clusters`` and unlabelled active pixels become NOISE_ID;
    inactive pixels 0.  The rank is an integer cumsum along each frame's
    row-major pixels, exact on every device."""
    H, W = active.shape[-2:]
    lead = active.shape[:-2]
    hw = H * W
    flat = labels.reshape(*lead, hw).to(torch.int64)
    iota = torch.arange(hw, dtype=torch.int64, device=flat.device)
    is_root = (flat == iota) & (flat < hw)
    rank = torch.cumsum(is_root.to(torch.int32), -1) - 1
    r = rank.gather(-1, flat.clamp(max=hw - 1))
    noise = torch.where(active.reshape(*lead, hw), NOISE_ID, 0)
    cluster_id = torch.where((flat < hw) & (r < max_clusters), FIRST_CLUSTER_ID + r, noise)
    return cluster_id.reshape(active.shape).to(torch.int32)


def _check(point_planes: torch.Tensor, active: torch.Tensor) -> None:
    if point_planes.dtype != torch.float32:
        raise TypeError(f"point_planes must be float32, got {point_planes.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    if active.ndim not in (2, 3) or point_planes.shape != (*active.shape[:-2], 3, *active.shape[-2:]):
        raise ValueError(
            f"expected (3, H, W) planes and an (H, W) mask, or (B, 3, H, W) and (B, H, W), got "
            f"{tuple(point_planes.shape)} and {tuple(active.shape)}"
        )
    if point_planes.device != active.device:
        raise ValueError("point_planes and active must share a device")


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs per frame
    band: int  # columns per CTA, ceil(W / cluster); the last bands may be narrower or empty
    onchip: int  # pixel slots a CTA keeps in shared memory
    spill: int  # pixel slots a CTA keeps in device memory
    smem_bytes: int  # dynamic shared memory per CTA


def plan_for(H: int, W: int, cluster: int) -> LaunchPlan:
    """The split of an (H, W) frame over a cluster of ``cluster`` CTAs:
    CTA r owns columns [r * band, (r + 1) * band) of every row."""
    band = -(-W // cluster)
    slots = H * band
    onchip = min(slots, MAX_ONCHIP)
    return LaunchPlan(cluster, band, onchip, slots - onchip, BYTES_PER_PX * onchip)


def launch_plan(batch: int, H: int, W: int, max_active: Callable[[LaunchPlan], int]) -> LaunchPlan:
    """Clusters of 16 CTAs where ``max_active(plan)`` says B of them run on
    the card at once, else clusters of 8.  Both give the same labels."""
    big = plan_for(H, W, 16)
    return big if max_active(big) >= batch else plan_for(H, W, 8)


@functools.lru_cache(maxsize=None)
def _library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("dbscan.cu")
    lib.rpcc_dbscan_labels_launch.restype = ctypes.c_int
    lib.rpcc_dbscan_labels_launch.argtypes = (
        [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 5
    )
    lib.rpcc_dbscan_max_active_clusters.restype = ctypes.c_int
    lib.rpcc_dbscan_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _kernel():
    return _library().rpcc_dbscan_labels_launch


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, cluster: int, smem_bytes: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel on one card: how many
    clusters of ``cluster`` CTAs with ``smem_bytes`` each run at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().rpcc_dbscan_max_active_clusters(cluster, smem_bytes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"DBSCAN occupancy query failed: cudaError_t {err}")
    return out.value


def dbscan_labels_cuda(
    point_planes: torch.Tensor,
    active: torch.Tensor,
    eps: float,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
    phase_stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The CUDA kernels on CUDA tensors, one frame or a batch in two
    launches; raises on any other input.  Launches on the current stream and
    does not synchronize.  ``phase_stamps``, an int64 CUDA tensor of
    ``len(PHASES) + 1`` elements, receives frame 0's ``%globaltimer`` (ns)
    at the start of each launch and after each phase of the second.
    Counts the call under ``launch.dbscan``: one per call, whatever the
    batch size, for its two launches (the mask pass, then the cluster
    kernel)."""
    _check(point_planes, active)
    if active.device.type != "cuda":
        raise ValueError(f"dbscan_labels_cuda needs CUDA tensors, got {active.device}")
    if window != WINDOW:
        raise ValueError(f"the kernel is built for window {WINDOW}, got {window}")
    if not (point_planes.is_contiguous() and active.is_contiguous()):
        raise ValueError("point_planes and active must be contiguous")
    if phase_stamps is not None and (
        phase_stamps.device != active.device or phase_stamps.dtype != torch.int64
        or phase_stamps.numel() != len(PHASES) + 1 or not phase_stamps.is_contiguous()
    ):
        raise ValueError(f"phase_stamps must be a contiguous int64 tensor of {len(PHASES) + 1} on {active.device}")
    H, W = active.shape[-2:]
    B = active.shape[0] if active.ndim == 3 else 1
    if B * H * W >= 2**31 - 1 or B > 65535:
        raise ValueError("DBSCAN batch exceeds 2^31 pixels or 65535 frames")
    fn = _kernel()
    dev = active.device.index if active.device.index is not None else torch.cuda.current_device()
    plan = launch_plan(B, H, W, lambda p: max_active_clusters(dev, p.cluster, p.smem_bytes))
    with torch.cuda.device(active.device):
        out = torch.empty(active.shape, dtype=torch.int32, device=active.device)
        mask = torch.empty(active.shape, dtype=torch.int64, device=active.device)  # u64 mask words
        parent = None
        if plan.spill:  # parents of the slots past a CTA's shared memory: (B, cluster, spill)
            parent = torch.empty(B * plan.cluster * plan.spill, dtype=torch.int32, device=active.device)
        err = fn(
            point_planes.data_ptr(), active.data_ptr(), B, H, W, float(eps) * float(eps),
            int(min_points), plan.cluster, plan.band, plan.onchip, plan.smem_bytes,
            mask.data_ptr(), None if parent is None else parent.data_ptr(),
            out.data_ptr(), None if phase_stamps is None else phase_stamps.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"DBSCAN kernel launch failed: cudaError_t {err}")
    timer.count("launch.dbscan")
    return out


def dbscan_labels(
    point_planes: torch.Tensor,
    active: torch.Tensor,
    eps: float,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """Raw labels on the tensors' own device: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if active.device.type == "cuda":
        return dbscan_labels_cuda(point_planes, active, eps, min_points, window)
    if active.device.type != "cpu":
        raise ValueError(f"unsupported device {active.device}")
    _check(point_planes, active)
    return dbscan_labels_planar(point_planes, active, eps, min_points, window)


def dbscan_range_image(
    point_planes: torch.Tensor,  # (..., 3, H, W) planar x/y/z
    active: torch.Tensor,  # (..., H, W) bool: non-ground, non-zero pixels
    eps: float,
    max_clusters: int,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """Cluster ids for active pixels: NOISE_ID or FIRST_CLUSTER_ID + k
    (k < max_clusters, by row-major discovery); inactive pixels 0."""
    labels = dbscan_labels(point_planes, active, eps, min_points, window)
    return _compact_labels(labels, active, max_clusters)
