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
for CPU tensors, the hand-written kernel (``csrc/dbscan.cu``) for CUDA
tensors.  A CUDA tensor never falls back to the plain version: if the
kernel cannot build or launch, the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

MIN_POINTS = 10  # utils/segment_utils.py:152
NOISE_ID = 2  # final id of DBSCAN noise
FIRST_CLUSTER_ID = 3  # final id of the first cluster
WINDOW = 3  # pixel window for eps-connectivity

# Launches of the CUDA kernel since the count was last reset (one per call
# of :func:`dbscan_labels_cuda`).
LAUNCHES = 0


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
    """Value of the (r+dr, c+dc) neighbour at each pixel: column-circular,
    row-clamped with ``fill``."""
    H = arr.shape[0]
    out = torch.roll(arr, (-dr, -dc), (0, 1))
    if dr > 0:
        out[H - dr :] = fill
    elif dr < 0:
        out[:-dr] = fill
    return out


def _run_min(lab: torch.Tensor, linked_prev: torch.Tensor, hw: int) -> torch.Tensor:
    """Min label over maximal linked runs along dim 1: forward and backward
    segmented doubling floods (``dbscan_pallas.py:149-179``).
    ``linked_prev[r, c]``: pixel (r, c) is linked to (r, c-1)."""
    n = lab.shape[1]

    def shifted(x, d, fill, forward):
        out = torch.full_like(x, fill)
        if forward:
            out[:, d:] = x[:, :-d]
        else:
            out[:, :-d] = x[:, d:]
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
    point_planes: torch.Tensor,  # (3, H, W) f32 planar x/y/z
    active: torch.Tensor,  # (H, W) bool
    eps: float,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """Plain version: (H, W) int32 raw labels (component minimum flat index;
    ``hw`` = unlabelled).  Components by min-label hooks, row and column
    floods and pointer jumping until a sweep changes nothing; the loop
    reads its convergence flag on the host, once per sweep."""
    H, W = active.shape
    hw = H * W
    dev = active.device
    eps2 = torch.tensor(float(eps) * float(eps), dtype=torch.float32, device=dev)
    shifts = _neighbor_shifts(window)
    px, py, pz = point_planes[0], point_planes[1], point_planes[2]
    conn = torch.empty((len(shifts), H, W), dtype=torch.bool, device=dev)
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
    lp_col[:, 1:] = core_edge[i01][:, :-1]  # (r, c) linked to (r, c-1)
    lp_row = torch.zeros_like(core)
    lp_row[1:] = core_edge[i10][:-1]  # (r, c) linked to (r-1, c)

    iota = torch.arange(hw, dtype=torch.int32, device=dev).reshape(H, W)
    lab = torch.where(core, iota, hw)
    while True:
        new = lab
        for i, (dr, dc) in enumerate(shifts):
            new = torch.where(core_edge[i], torch.minimum(new, _shift(lab, dr, dc, hw)), new)
        new = _run_min(new, lp_col, hw)
        new = _run_min(new.T, lp_row.T, hw).T
        for _ in range(2):  # pointer jumping: every label is a core pixel's
            flat = new.reshape(-1)
            new = torch.where(flat < hw, flat[flat.clamp(max=hw - 1).long()], hw).reshape(H, W)
        if torch.equal(new, lab):
            break
        lab = new

    border = torch.full((H, W), hw, dtype=torch.int32, device=dev)
    for i, (dr, dc) in enumerate(shifts):
        attach = conn[i] & nb_core[i]
        border = torch.where(attach, torch.minimum(border, _shift(lab, dr, dc, hw)), border)
    return torch.where(core, lab, torch.where(active, border, hw)).to(torch.int32)


def _compact_labels(labels: torch.Tensor, active: torch.Tensor, max_clusters: int) -> torch.Tensor:
    """Discovery-order compaction: roots ascending (= row-major first pixel)
    become FIRST_CLUSTER_ID + rank; components past ``max_clusters`` and
    unlabelled active pixels become NOISE_ID; inactive pixels 0.  The rank
    is an integer cumsum, exact on every device."""
    H, W = active.shape
    hw = H * W
    flat = labels.reshape(-1).to(torch.int64)
    iota = torch.arange(hw, dtype=torch.int64, device=flat.device)
    is_root = (flat == iota) & (flat < hw)
    rank = torch.cumsum(is_root.to(torch.int32), 0) - 1
    r = rank[flat.clamp(max=hw - 1)]
    noise = torch.where(active.reshape(-1), NOISE_ID, 0)
    cluster_id = torch.where((flat < hw) & (r < max_clusters), FIRST_CLUSTER_ID + r, noise)
    return cluster_id.reshape(H, W).to(torch.int32)


def _check(point_planes: torch.Tensor, active: torch.Tensor) -> None:
    if point_planes.dtype != torch.float32:
        raise TypeError(f"point_planes must be float32, got {point_planes.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    if active.ndim != 2 or point_planes.shape != (3, *active.shape):
        raise ValueError(
            f"expected (3, H, W) planes and an (H, W) mask, got {tuple(point_planes.shape)} "
            f"and {tuple(active.shape)}"
        )
    if point_planes.device != active.device:
        raise ValueError("point_planes and active must share a device")


def _kernel():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("dbscan.cu")
    fn = lib.rpcc_dbscan_labels_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 5
    )
    return fn


def dbscan_labels_cuda(
    point_planes: torch.Tensor,
    active: torch.Tensor,
    eps: float,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; raises on any other input.  Launches
    on the current stream and does not synchronize."""
    global LAUNCHES
    _check(point_planes, active)
    if active.device.type != "cuda":
        raise ValueError(f"dbscan_labels_cuda needs CUDA tensors, got {active.device}")
    if window != WINDOW:
        raise ValueError(f"the kernel is built for window {WINDOW}, got {window}")
    if not point_planes.is_contiguous():
        raise ValueError("point_planes must be contiguous")
    H, W = active.shape
    hw = H * W
    if hw >= 2**31 - 1:
        raise ValueError("DBSCAN frame exceeds 2^31 pixels")
    fn = _kernel()
    dev = active.device
    with torch.cuda.device(dev):
        act_u8 = active.to(torch.uint8).contiguous()
        mask = torch.empty(hw, dtype=torch.int64, device=dev)  # u64 bits
        parent = torch.empty(hw, dtype=torch.int32, device=dev)
        core = torch.empty(hw, dtype=torch.uint8, device=dev)
        out = torch.empty((H, W), dtype=torch.int32, device=dev)
        err = fn(
            point_planes[0].data_ptr(), point_planes[1].data_ptr(), point_planes[2].data_ptr(),
            act_u8.data_ptr(), H, W, float(eps) * float(eps), int(min_points),
            mask.data_ptr(), parent.data_ptr(), core.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"DBSCAN kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
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
    point_planes: torch.Tensor,  # (3, H, W) planar x/y/z
    active: torch.Tensor,  # (H, W) bool: non-ground, non-zero pixels
    eps: float,
    max_clusters: int,
    min_points: int = MIN_POINTS,
    window: int = WINDOW,
) -> torch.Tensor:
    """Cluster ids for active pixels: NOISE_ID or FIRST_CLUSTER_ID + k
    (k < max_clusters, by row-major discovery); inactive pixels 0."""
    labels = dbscan_labels(point_planes, active, eps, min_points, window)
    return _compact_labels(labels, active, max_clusters)
