"""The benchmark's frames: street scenes ray-cast on a LiDAR's own rays.

Frozen copies, so a later change to the program cannot move the yardstick:

* :func:`transform_map` is ``rpcc_tpu_torch/ops/projection_host.py::
  build_transform_map`` (the unit ray of every pixel);
* :func:`scene_ranges` is ``chip_smoke.py::scene_ranges``, with one change:
  the scene's layout comes from a layout seed and its range noise from a
  generator of its own, both drawn from the run's seed;
* :func:`drop_far` is ``chip_smoke.py::drop_far``.

Only numpy: nothing here imports the program.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple

import numpy as np


def transform_map(lidar: dict) -> np.ndarray:
    """(H, W, 3) f32 unit rays of a configuration's ``lidar`` group:
    evenly spaced rows between the vertical limits, or one row per angle of
    ``vertical_angles_deg``; columns at ``fov * c / W`` (float64 math)."""
    H, W = int(lidar["height"]), int(lidar["width"])
    table = lidar.get("vertical_angles_deg")
    if table is None:
        vmax, vmin = math.radians(lidar["vertical_angle_max_deg"]), math.radians(lidar["vertical_angle_min_deg"])
        altitude = (vmax - vmin) * (np.arange(H) / (H - 1)) + vmin
    else:
        altitude = np.radians(np.asarray(table, dtype=np.float64))
        if altitude.shape[0] != H:
            raise ValueError(f"channel table has {altitude.shape[0]} entries for {H} rows")
    azimuth = math.radians(lidar["horizontal_fov_deg"]) * (np.arange(W) / W)
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


def scene_ranges(tm: np.ndarray, layout_seed: int, noise: np.random.Generator) -> np.ndarray:
    """(H, W) ranges of a street scene ray-cast on the unit rays ``tm``:
    ground at z = -1.8, a surrounding wall at 18-42 m, 12 boxes (cars,
    kiosks) and 12 poles at 4-40 m, some across the column seam (azimuth
    0); 1 cm range noise from ``noise``; 0 where nothing is hit within
    2-80 m."""
    rng = np.random.default_rng(layout_seed)
    dx, dy, dz = tm[..., 0].astype(np.float64), tm[..., 1].astype(np.float64), tm[..., 2].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(dz < -1e-4, -1.8 / dz, np.inf)
        az = np.arctan2(dy, dx)
        horiz = np.hypot(dx, dy)
        wall = 30 + 8 * np.sin(3 * az + layout_seed) + 4 * np.sin(7 * az)
        r = np.minimum(r, np.where(horiz > 1e-4, wall / horiz, np.inf))
        azs = np.concatenate([[0.0, 0.02, -0.03], rng.uniform(-np.pi, np.pi, 9)])
        for a in azs:  # boxes: the first three straddle the seam
            dist = rng.uniform(6, 35)
            cx, cy = dist * np.cos(a), dist * np.sin(a)
            hx, hy, hz = rng.uniform(0.8, 2.5), rng.uniform(0.8, 2.5), rng.uniform(0.7, 1.6)
            lo = np.array([cx - hx, cy - hy, -1.8])
            hi = np.array([cx + hx, cy + hy, -1.8 + 2 * hz])
            tmin = np.full(dx.shape, -np.inf)
            tmax = np.full(dx.shape, np.inf)
            for d, low, high in ((dx, lo[0], hi[0]), (dy, lo[1], hi[1]), (dz, lo[2], hi[2])):
                t1, t2 = low / d, high / d
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
    return (r + noise.normal(0, 0.01, r.shape) * (r > 0)).astype(np.float32)


def drop_far(pc: np.ndarray, max_range: float) -> np.ndarray:
    """A scene's returns nearer than ``max_range``: the far stretches of its
    wall dropped, as a sensor drops weak returns."""
    return pc[np.linalg.norm(pc, axis=1) < max_range]


class FrameSet(NamedTuple):
    """A cell's distinct frames and the order the window cycles them in."""

    clouds: List[np.ndarray]  # (N, 3) f32 point clouds, one per distinct frame
    order: np.ndarray  # permutation of the frame indices, drawn from the seed


def make_frames(lidar: dict, traffic: dict, seed: int) -> FrameSet:
    """The traffic's ``frames`` street scenes on the configuration's rays,
    made from the seed, and the order the seed draws for them.  Scene k has
    the layout seed drawn from ``(seed, k)`` and its noise from ``(seed, k,
    1)``; every ``drop_far_every``-th scene (k % n == n - 1) keeps only its
    returns nearer than ``drop_far_m``.  Every seed gets the same work,
    ``frames`` full sweeps of which the same share drop far returns, on
    scenes of its own."""
    tm = transform_map(lidar)
    n = int(traffic["frames"])
    every = int(traffic.get("drop_far_every", 0))

    def frame(k: int) -> np.ndarray:
        layout = int(np.random.default_rng([seed, k]).integers(1 << 31))
        r = scene_ranges(tm, layout, np.random.default_rng([seed, k, 1]))
        pc = (tm * r[..., None])[r > 0].reshape(-1, 3).astype(np.float32)
        if every and k % every == every - 1:
            pc = drop_far(pc, float(traffic["drop_far_m"]))
        return np.ascontiguousarray(pc)

    with ThreadPoolExecutor(min(8, n)) as pool:  # numpy releases the GIL: set-up in a fraction of the time
        clouds = list(pool.map(frame, range(n)))
    order = np.random.default_rng([seed, n, 1]).permutation(n)
    return FrameSet(clouds, order)
