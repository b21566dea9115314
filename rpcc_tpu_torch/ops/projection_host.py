"""Host spherical projection: point cloud -> range image, exact (f32) or on
the u16 snap grid.

JAX-free copy of the host half of ``rpcc_tpu/ops/projection.py`` (that
module imports jax at the top): the ray tables and the projections the
encoder uploads.  The projection is the native fused pass
(``csrc/host/raster.cpp``, a copy of the reference's): evenly spaced rows
by half-away rounding, or for a LiDAR with a channel table (CSV) the
nearest channel angle and half-even columns.
"""

from __future__ import annotations

import ctypes as ct

import numpy as np

from rpcc_tpu_torch.codec.native import native_lib
from rpcc_tpu_torch.config import CodecConfig, LidarConfig


def build_transform_map(lidar: LidarConfig) -> np.ndarray:
    """(H, W, 3) unit-ray table, ``point = depth * ray`` (float64 math, f32
    result)."""
    H, W = lidar.height, lidar.width
    if lidar.even_dist:
        vfov = lidar.vertical_max - lidar.vertical_min
        altitude = vfov * (np.arange(H) / (H - 1)) + lidar.vertical_min
    else:
        altitude = np.radians(np.asarray(lidar.vertical_angles_deg, dtype=np.float64))
        if altitude.shape[0] != H:
            raise ValueError("channel table must have H entries")
    azimuth = lidar.horizontal_fov * (np.arange(W) / W)
    cos_alt = np.cos(altitude)[:, None]
    tm = np.stack(
        [
            cos_alt * np.cos(azimuth)[None, :],
            cos_alt * np.sin(azimuth)[None, :],
            np.broadcast_to(np.sin(altitude)[:, None], (H, W)),
        ],
        axis=-1,
    )
    return tm.astype(np.float32)


def build_transform_planes(lidar: LidarConfig) -> np.ndarray:
    """(3, H, W) planar unit-ray table."""
    return np.transpose(build_transform_map(lidar), (2, 0, 1)).copy()


def projection_constants(lidar: LidarConfig):
    """``(hfov, vmin, vres, va)``: the f32 constants the projection bins
    with (radians) and the f32 channel table, or None for evenly spaced
    rows (``vres`` is then the row pitch, else 0)."""
    H = lidar.height
    if lidar.even_dist:
        vres = np.float32((lidar.vertical_max - lidar.vertical_min) / (H - 1))
        va = None
    else:
        vres = np.float32(0.0)
        va = np.ascontiguousarray(np.radians(np.asarray(lidar.vertical_angles_deg, np.float64)).astype(np.float32))
        if va.shape[0] != H:
            raise ValueError(f"channel table has {va.shape[0]} entries for {H} rows")
    return np.float32(lidar.horizontal_fov), np.float32(lidar.vertical_min), vres, va


def cloud_rows(points: np.ndarray) -> np.ndarray:
    """An (N, >=3) cloud as f32 rows of adjacent columns, x, y, z leading:
    the cloud itself where it is one (an xyzi cloud keeps its stride of 4),
    else a copy of its x, y, z."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be (N, >=3), got {pts.shape}")
    return pts if pts.strides[1] == 4 else np.ascontiguousarray(pts[:, :3])


def _native_proj_head(points: np.ndarray, lidar: LidarConfig):
    """``(pts, va, head)``: the cloud as f32 rows, the channel table (or
    None) and the leading ctypes argument tuple shared by the native
    projections, ``(pts_ptr, n, stride, H, W, even, hfov, vmin, vres,
    va_ptr, n_chan)``.  The caller keeps ``pts`` and ``va`` alive across
    the call.  c_float wrappers are required: untyped ctypes calls promote
    python floats to double and corrupt the ABI."""
    H, W = lidar.height, lidar.width
    pts = cloud_rows(points)
    hfov, vmin, vres, va = projection_constants(lidar)
    va_ptr = None if va is None else va.ctypes.data_as(ct.c_void_p)
    head = (
        pts.ctypes.data_as(ct.c_void_p),
        ct.c_int64(pts.shape[0]),
        ct.c_int64(pts.strides[0] // 4),
        ct.c_int32(H),
        ct.c_int32(W),
        ct.c_int32(1 if lidar.even_dist else 0),
        ct.c_float(hfov),
        ct.c_float(vmin),
        ct.c_float(vres),
        va_ptr,
        ct.c_int32(0 if va is None else va.shape[0]),
    )
    return pts, va, head


def project_points_host(points: np.ndarray, lidar: LidarConfig) -> np.ndarray:
    """(N, >=3) cloud -> (H, W) f32 range image, the nearest point of each
    pixel (``transfer_precision="f32"``: no snap)."""
    H, W = lidar.height, lidar.width
    pts, va, head = _native_proj_head(points, lidar)
    ri = np.zeros(H * W, np.float32)
    native_lib().project_bin_raster(*head, ri.ctypes.data_as(ct.c_void_p))
    return ri.reshape(H, W)


def project_points_host_u16(points: np.ndarray, lidar: LidarConfig, step_over16):
    """(N, >=3) cloud -> ((H, W) u16 snapped depths, f32 delta).

    delta = max(step/16, depth_max/65535); depths are rint(ri/delta) clamped
    to 65535.  The encoder's range image is exactly ``q * delta`` in f32.
    """
    H, W = lidar.height, lidar.width
    pts, va, head = _native_proj_head(points, lidar)
    floor = np.float32(step_over16)
    scratch = np.zeros(H * W, np.float32)
    out = np.empty(H * W, np.uint16)
    delta = np.zeros(1, np.float32)
    native_lib().project_bin_raster_u16(
        *head,
        ct.c_float(floor),
        scratch.ctypes.data_as(ct.c_void_p),
        out.ctypes.data_as(ct.c_void_p),
        delta.ctypes.data_as(ct.c_void_p),
    )
    return out.reshape(H, W), np.float32(delta[0])


def project_for_encoder(points: np.ndarray, lidar: LidarConfig, cfg: CodecConfig):
    """The encoder's input for ``cfg.transfer_precision``: ``(grid, delta)``
    with range image ``grid * delta`` in f32.  ``u16``, ``i8`` and ``m8``
    give the u16 snap grid (the reference's i8/m8 wire codes rebuild that
    grid exactly); ``f32`` gives the exact range image and delta 1."""
    if cfg.transfer_precision == "f32":
        return project_points_host(points, lidar), np.float32(1.0)
    return project_points_host_u16(points, lidar, np.float32(cfg.step / 16.0))
