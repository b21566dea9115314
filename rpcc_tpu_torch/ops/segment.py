"""Ground + cluster segmentation of a range image (port of
``rpcc_tpu/ops/segment.py``: FPS mode over the zero-masked grid, and
DBSCAN mode).

  * ground plane: z < -1.5 filter, random <= 5000 subsample, seeded RANSAC;
  * FPS mode: cluster centres over the non-ground pixels (ground and zero
    pixels zeroed), through :func:`rpcc_tpu_torch.ops.fps.furthest_point_sample`;
    per-pixel argmin over |ground depth residual| and the Euclidean
    distances to the K centres; ids 0 = ground, 1 = zero pixels,
    2..K+1 = clusters;
  * DBSCAN mode: range-image DBSCAN (:mod:`rpcc_tpu_torch.ops.dbscan`) over
    the pixels more than 0.5 m off the ground plane's depth; ids 0 =
    ground, 1 = zero pixels, 2 = noise, 3..K+2 = clusters.

The (K, HW) centre-pixel inner product is written elementwise
(``cx*x + cy*y + cz*z``), not as a matmul: the same three f32 products
and two adds on every device, and no TF32 path to guard against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.dbscan import dbscan_range_image
from rpcc_tpu_torch.ops.fps import furthest_point_sample
from rpcc_tpu_torch.ops.ransac import (
    compact_random_subset_planar,
    point_plane_distance_planar,
    ransac_plane,
)

GROUND_Z_CUT = -1.5
GROUND_FIT_CAPACITY = 5000
GROUND_FIT_MIN = 800
GROUND_RANSAC_THRESHOLD = 0.1
GROUND_RANSAC_N = 10
GROUND_RANSAC_ITERS = 100


class SegmentResult(NamedTuple):
    seg_idx: torch.Tensor  # (H, W) int32: 0 ground, 1 zero pixels, 2.. clusters
    ground_model: torch.Tensor  # (4,) normalized plane
    centers: torch.Tensor  # (K, 3) FPS cluster centres


def fit_ground_plane_planar(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, key: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Seeded RANSAC ground plane from low-z points (fallback: all live
    points when fewer than 800 lie below the z cut)."""
    k = prng.split(key)
    low = zs < GROUND_Z_CUT
    if valid is not None:
        low = low & valid
    n_low = low.sum()
    fallback = torch.ones_like(low) if valid is None else valid
    mask = torch.where(n_low < GROUND_FIT_MIN, fallback, low)
    subset, count = compact_random_subset_planar(xs, ys, zs, mask, k[0], GROUND_FIT_CAPACITY)
    return ransac_plane(
        subset, count, k[1],
        threshold=GROUND_RANSAC_THRESHOLD,
        ransac_n=GROUND_RANSAC_N,
        num_hypotheses=GROUND_RANSAC_ITERS,
    )


def ground_depth_residual(
    range_image: torch.Tensor, plane: torch.Tensor, tm_planes: torch.Tensor
) -> torch.Tensor:
    """Signed depth residual r - r_plane with r_plane = -d / (n . ray)."""
    denom = plane[0] * tm_planes[0] + plane[1] * tm_planes[1] + plane[2] * tm_planes[2]
    return range_image - (-plane[3] / denom)


def center_distances(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """(K, HW) Euclidean distances ``sqrt(max(|p|^2 + |c|^2 - 2 c.p, 0))``."""
    p2 = xs * xs + ys * ys + zs * zs  # (HW,)
    cx, cy, cz = (centers[:, i : i + 1] for i in range(3))
    c2 = cx * cx + cy * cy + cz * cz  # (K, 1)
    dots = cx * xs + cy * ys + cz * zs  # (K, HW)
    return torch.sqrt(torch.clamp(p2 + c2 - 2.0 * dots, min=0.0))


def segment_range_image(
    point_planes: torch.Tensor,  # (3, H, W) planar x/y/z
    range_image: torch.Tensor,  # (H, W)
    tm_planes: torch.Tensor,  # (3, H, W)
    key: torch.Tensor,
    ground_threshold: float,
    cluster_num: int,
) -> SegmentResult:
    xs, ys, zs = (point_planes[i].reshape(-1) for i in range(3))
    ri = range_image.reshape(-1)

    ground_model = fit_ground_plane_planar(xs, ys, zs, key, valid=ri > 0.0)

    # Non-ground mask by vertical (point-to-plane) distance; FPS runs over
    # the zero-masked full grid.
    vert = point_plane_distance_planar(xs, ys, zs, ground_model)
    nonground = ((vert > ground_threshold) & (ri > 0.0)).to(ri.dtype)
    ngx, ngy, ngz = xs * nonground, ys * nonground, zs * nonground
    center_idx = furthest_point_sample(ngx, ngy, ngz, cluster_num).to(torch.int64)
    centers = torch.stack([ngx[center_idx], ngy[center_idx], ngz[center_idx]], -1)
    seg = assign_clusters(point_planes, range_image, tm_planes, ground_model, centers)
    return SegmentResult(seg, ground_model, centers)


def segment_range_image_dbscan(
    point_planes: torch.Tensor,  # (3, H, W)
    range_image: torch.Tensor,  # (H, W)
    tm_planes: torch.Tensor,  # (3, H, W)
    key: torch.Tensor,
    eps: float,
    max_clusters: int,
) -> SegmentResult:
    """DBSCAN-mode segmentation: the seeded ground plane, then
    :func:`dbscan_segment`.  ``centers`` is all zeros, as in the reference."""
    xs, ys, zs = (point_planes[i].reshape(-1) for i in range(3))
    ground_model = fit_ground_plane_planar(xs, ys, zs, key, valid=range_image.reshape(-1) > 0.0)
    seg = dbscan_segment(point_planes, range_image, tm_planes, ground_model, eps, max_clusters)
    centers = torch.zeros((max_clusters, 3), dtype=range_image.dtype, device=range_image.device)
    return SegmentResult(seg, ground_model, centers)


def dbscan_segment(
    point_planes: torch.Tensor,  # (3, H, W)
    range_image: torch.Tensor,  # (H, W)
    tm_planes: torch.Tensor,  # (3, H, W)
    ground_model: torch.Tensor,  # (4,)
    eps: float,
    max_clusters: int,
) -> torch.Tensor:
    """(H, W) int32 ids from a ground plane: pixels within 0.5 m of the
    plane's depth are ground (0), zero pixels 1, DBSCAN noise 2 and
    clusters 3.. over the rest."""
    g_res = ground_depth_residual(range_image, ground_model, tm_planes)
    nonzero = range_image > 0.0
    active = (torch.abs(g_res) > 0.5) & nonzero
    seg = dbscan_range_image(point_planes, active, eps, max_clusters)
    seg = torch.where(nonzero, seg, 1)
    return torch.where(nonzero & ~active, 0, seg).to(torch.int32)


def assign_clusters(
    point_planes: torch.Tensor,  # (3, H, W)
    range_image: torch.Tensor,  # (H, W)
    tm_planes: torch.Tensor,  # (3, H, W)
    ground_model: torch.Tensor,  # (4,)
    centers: torch.Tensor,  # (K, 3)
) -> torch.Tensor:
    """(H, W) int32 seg ids: argmin over the distance stack (row 0 =
    |ground depth residual|, rows 1..K = |p - c|), ties to the lowest id;
    zero pixels get id 1."""
    H, W = range_image.shape
    xs, ys, zs = (point_planes[i].reshape(-1) for i in range(3))
    g_res = torch.abs(ground_depth_residual(range_image, ground_model, tm_planes).reshape(-1))
    dist = torch.cat([g_res[None, :], center_distances(xs, ys, zs, centers)], 0)
    seg = torch.argmin(dist, dim=0).to(torch.int32)
    seg = torch.where(seg > 0, seg + 1, seg)  # room for the zero-pixel class 1
    seg = torch.where(range_image.reshape(-1) == 0.0, 1, seg).to(torch.int32)
    return seg.reshape(H, W)
