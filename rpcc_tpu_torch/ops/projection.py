"""Spherical projection on the device: point cloud <-> range image (port of
the in-graph half of ``rpcc_tpu/ops/projection.py``, ``:76-163``).

The forward projection bins each point to ``row * W + col`` and keeps the
nearest depth per pixel: one ``scatter_reduce_(..., "amin")``.  That is
what the reference's two sorts compute (``_scatter_min_image``, which works
around a TPU scatter that runs on the scalar core); equal depths are
indistinguishable, so the keep-nearest minimum is the whole result.
Invalid points (depth 0, e.g. padding rows, or NaN) land in a dump slot
and never win; empty pixels decode to 0.

Binning follows the reference: C ``round`` (half away from zero) and the
``2*3.14159265`` azimuth wrap of its C++ kernel for evenly spaced rows;
half-even columns and the nearest channel angle (first index on ties) for
a LiDAR with a channel table.  Depth is ``sqrt(x*x + y*y + z*z)`` without
FMA contraction (XLA's CPU code contracts it: ROADMAP 3.2), so depths may
differ from the reference's by an ulp or two.

Every constant enters as a 0-d tensor filled on the points' device:
PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
which rounds differently from the reference's division, and a tensor
copied from the host would stall the call on a blocking copy.

The host projection and the ray tables stay in ``ops/projection_host.py``;
``build_transform_map`` and ``build_transform_planes`` are re-exported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rpcc_tpu_torch.config import LidarConfig
from rpcc_tpu_torch.ops.projection_host import build_transform_map, build_transform_planes  # noqa: F401  (re-export)
from rpcc_tpu_torch.ops.rounding import round_half_away

# The C++ kernel wraps azimuth with the literal 2*3.14159265
# (cpp_modules.cpp:449); the same constant keeps the bins.
_TWO_PI_REF = 2.0 * 3.14159265


def project_points(
    points: torch.Tensor, lidar: LidarConfig, vertical_angles: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Project an (N, >=3) or zero-padded (B, N, >=3) f32 cloud to an (H, W)
    or (B, H, W) range image on the points' device.

    Points with depth 0 (padding) or a NaN coordinate never project.  For a
    LiDAR with a channel table pass its (H,) f32 angle table in radians as
    ``vertical_angles``."""
    H, W = lidar.height, lidar.width
    dev = points.device

    def c(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    x, y, z = (points[..., i].to(torch.float32) for i in range(3))
    h2 = x * x + y * y
    depth = torch.sqrt(h2 + z * z)
    az = torch.atan2(y, x)
    az = torch.where(az < 0, az + c(_TWO_PI_REF), az)
    v_ang = torch.atan2(z, torch.sqrt(h2))
    col_f = az / c(lidar.horizontal_fov) * c(W)
    if lidar.even_dist:
        col = round_half_away(col_f).to(torch.int32) % W
        vres = c((lidar.vertical_max - lidar.vertical_min) / (H - 1))
        row = round_half_away((v_ang - c(lidar.vertical_min)) / vres).to(torch.int32).clamp(0, H - 1)
    else:
        if vertical_angles is None or vertical_angles.shape != (H,):
            raise ValueError(f"a channel-table LiDAR needs its ({H},) angle table")
        col = torch.round(col_f).to(torch.int32) % W
        diff = (vertical_angles.to(device=dev, dtype=torch.float32) - v_ang[..., None]).abs()  # (..., N, H)
        row = torch.argmin(diff, dim=-1).to(torch.int32)
    return scatter_min_image(row * W + col, depth, depth > 0, H, W)


def scatter_min_image(
    flat_idx: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor, H: int, W: int
) -> torch.Tensor:
    """Keep-nearest rasterization: (..., N) pixel indices in [0, H*W),
    depths and a validity mask -> (..., H, W) images of each pixel's least
    valid depth, 0 where no valid point lands.  Each leading index is its
    own frame (its indices are offset by ``b * H * W``)."""
    lead = flat_idx.shape[:-1]
    n = flat_idx.shape[-1]
    hw = H * W
    B = math.prod(lead)
    dev = depth.device
    offset = (torch.arange(B, device=dev, dtype=torch.int64) * hw)[:, None]
    idx = torch.where(valid.reshape(B, n), flat_idx.reshape(B, n).to(torch.int64) + offset, B * hw)
    src = torch.where(valid.reshape(B, n), depth.reshape(B, n).to(torch.float32), torch.inf)
    img = torch.full((B * hw + 1,), torch.inf, dtype=torch.float32, device=dev)  # the last slot is the dump
    img.scatter_reduce_(0, idx.reshape(-1), src.reshape(-1), "amin")
    img = img[: B * hw]
    return torch.where(torch.isinf(img), 0.0, img).reshape(*lead, H, W)


def range_image_to_points(range_image: torch.Tensor, transform_map: torch.Tensor) -> torch.Tensor:
    """(..., H, W) range image -> (..., H, W, 3) points: one broadcast multiply."""
    return range_image[..., None] * transform_map
