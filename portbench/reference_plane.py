"""The benchmark's frozen copy of ``tests/plain_plane_reference.py``: a plain
PyTorch reference of R-PCC's per-cluster plane models and their
intra-prediction, for holding ``rpcc_tpu_torch``'s encoder to.  This copy
is the yardstick of ``tools/plane_reference_check.py`` and stays as it is;
the tests' copy may move on.

R-PCC (https://github.com/StevenWang30/R-PCC, arXiv 2109.07717) models each
segmented cluster of a range image by a plane where one fits
(``utils/segment_utils.py:187-216``) and predicts each pixel's range from
its cluster's model (``:219-233`` with ``cpp_modules.cpp:248-285``):

* a cluster with fewer than 30 pixels keeps a point model, its mean range;
* otherwise RANSAC over the cluster's points (``ransac_n`` 4, 10
  iterations, inliers within 0.1 m): each hypothesis is the least-squares
  plane of 4 points drawn from the cluster, and the hypothesis with the
  most inliers wins;
* a plane that any of the cluster's scan rays meets at more than the angle
  threshold (75 degrees: the angle between the ray and the plane's normal)
  falls back to the point model;
* the prediction of a pixel on ray ``(A, B, C)`` is ``-d / (a A + b B + c
  C)`` for a plane ``[a, b, c, d]`` (0 where the ray lies in the plane),
  and ``d`` for a point row ``[0, 0, 0, d]`` (``a + b + c == 0``).

Rows 0 (the ground, fitted elsewhere) and 1 (the pixels with no return)
are point rows and are left 0 here.

Departures from R-PCC, each the codec's and noted where it is made:

1. The draws are seeded: Open3D draws its samples unseeded, so R-PCC's
   planes change from run to run.  Here the 10 x 4 sample positions of
   every cluster come from Threefry-2x32 (Random123's published rounds,
   :func:`threefry2x32`) keyed by the frame's seed, through the codec's
   key split and uniform mapping; a draw ``u`` picks the cluster's pixel
   ``min(floor(u n), n - 1)`` of its ``n``, counted in the bitstream's
   order (row-major within the cluster id).  Samples are drawn with
   replacement.
2. The winner is refitted by least squares on its inliers (when it has at
   least 3), where Open3D keeps the hypothesis.
3. On a tie of inlier counts the first hypothesis wins.
4. The scan rays are the format's, worked out in float32 from each
   pixel's row and column (``alt = vfov row / (H - 1) + vmin``, ``az =
   hfov col / W``): only evenly spaced rows are covered.

Everything runs in float32, one cluster at a time over its own pixels: no
stream sort, no scans, no batching.  TF32 is switched off for the call
(a float32 product on a card may otherwise run in TF32).  This file
imports only ``torch``: nothing of the codec's packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

MIN_PLANE_POINTS = 30
RANSAC_N = 4
RANSAC_ITERS = 10
INLIER_M = 0.1

# What :func:`compare` allows between a codec's table and this one's.  The
# two sum the moments in another order and take the smallest eigenvector
# another way (a closed form with its own arccos and cos against LAPACK's
# solver), both in float32, so rows agree to float32 rounding, not bit for
# bit.  Rounding the covariance by float32's epsilon turns the normal by
# about eps * l3 / (l2 - l1) (l1 <= l2 <= l3 its eigenvalues): ~1e-6 for a
# wall or a car, up to ~2e-5 for a narrow pole, whose l2 is small.  So a
# normal may differ by NORMAL_TOL, or by COND_FACTOR times that bound where
# it is larger (the codecs measured read at most 6.3 times it), and d by
# D_TOL, or by that turn times the centroid's distance where it is larger.
# Two float32 fits of the same 4 sample points differ by that same turn
# (the 4 points' own eigenvalues; ~1e-7 for a well spread sample, far more
# for one that is nearly a line), which moves a pixel's distance from the
# hypothesis by the turn times its distance from the sample's centroid,
# and by INLIER_MARGIN at least (float32 coordinates at 80 m).  A pixel that
# close to the 0.1 m inlier threshold can fall on either side, and one pixel
# more or less among the winner's inliers moves the refitted plane far past
# rounding.  Such a cluster is "fragile": a pixel lies that close to the
# threshold of the winner, or of a hypothesis whose votes and such pixels
# could reach the winner's.  A fragile cluster's
# plane is not compared, and neither is its decision; nor is the decision
# of a cluster whose largest ray angle lies within ANGLE_MARGIN of the
# threshold (the normal's turn can move it that far) or whose two best
# hypotheses tie on votes.  A codec fed bfloat16 inputs (spacing 0.125 m at
# 20 m) misses them by orders of magnitude.
NORMAL_TOL = 1e-5
D_TOL = 1e-4  # metres: a plane's d, a point row's mean range
COND_FACTOR = 32.0
ANGLE_MARGIN = 1e-4  # radians
INLIER_MARGIN = 5e-5  # metres

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------------------------------------------ draws
def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: Sequence[int], x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Random123) of the counter pairs
    ``(x1, x2)`` (int64 tensors holding uint32 words) under the two-word
    ``key``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def _hash(key: Sequence[int], n: int):
    i = torch.arange(n, dtype=torch.int64)
    return threefry2x32(key, i >> 32, i & _MASK)


def model_key(seed: int):
    """The frame's modelling key: the second of two keys split from the
    seed's key ``(0, seed)``."""
    b1, b2 = _hash((0, int(seed) & _MASK), 2)
    return int(b1[1]), int(b2[1])


def uniform(key: Sequence[int], shape: Sequence[int]) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits of ``bits1 ^ bits2`` of each flat
    counter as the mantissa of a float in [1, 2), minus 1."""
    n = math.prod(int(s) for s in shape)
    b1, b2 = _hash(key, n)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(tuple(shape))


# ------------------------------------------------------------------ rays
def scan_rays(lidar: dict, device=None) -> torch.Tensor:
    """(3, H, W) float32 unit rays of evenly spaced rows, worked out from
    each pixel's row and column in float32.  ``lidar``: ``height``,
    ``width``, ``horizontal_fov_deg``, ``vertical_angle_max_deg``,
    ``vertical_angle_min_deg``."""
    if lidar.get("vertical_angles_deg") is not None:
        raise ValueError("the reference covers evenly spaced rows only")
    H, W = int(lidar["height"]), int(lidar["width"])
    vmax = math.radians(lidar["vertical_angle_max_deg"])
    vmin = math.radians(lidar["vertical_angle_min_deg"])
    hfov = math.radians(lidar["horizontal_fov_deg"])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    row = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    col = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    alt = f32(vmax - vmin) * row / f32(H - 1) + f32(vmin)
    az = f32(hfov) * col / f32(W)
    return torch.stack([torch.cos(alt) * torch.cos(az), torch.cos(alt) * torch.sin(az), torch.sin(alt)])


# ------------------------------------------------------------------ planes
class Plane(NamedTuple):
    coef: torch.Tensor  # (4,) [a, b, c, d], unit normal
    eigenvalues: torch.Tensor  # (3,) of the covariance, ascending
    centroid: torch.Tensor  # (3,)


def fit_plane(points: torch.Tensor) -> Plane:
    """Least-squares plane of (n, 3) points: the normal is the eigenvector
    of the smallest eigenvalue of their covariance about the centroid."""
    centroid = points.mean(0)
    centered = points - centroid
    cov = centered.T @ centered / points.shape[0]
    eig = torch.linalg.eigh(cov)
    normal = eig.eigenvectors[:, 0]
    normal = normal / torch.linalg.vector_norm(normal)
    return Plane(torch.cat([normal, -(normal @ centroid).reshape(1)]), eig.eigenvalues, centroid)


def _turn(fit: Plane) -> torch.Tensor:
    """How far float32 rounding may turn a fit's normal (see COND_FACTOR)."""
    l1, l2, l3 = fit.eigenvalues.unbind()
    return COND_FACTOR * torch.finfo(torch.float32).eps * l3 / torch.clamp(l2 - l1, min=1e-30)


def _margin(fit: Plane, points: torch.Tensor) -> torch.Tensor:
    """How far float32 rounding of a fit may move a point's distance from it."""
    reach = torch.linalg.vector_norm(points - fit.centroid, dim=-1).max()
    return torch.clamp(_turn(fit) * reach, min=INLIER_MARGIN)


def distances(plane: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """|a x + b y + c z + d| / |(a, b, c)| of (n, 3) points from a plane."""
    a, b, c, d = plane
    x, y, z = points.unbind(-1)
    return torch.abs(a * x + b * y + c * z + d) / torch.sqrt(a * a + b * b + c * c)


class PlainFit(NamedTuple):
    table: torch.Tensor  # (M, 4) float32 model rows
    use_plane: torch.Tensor  # (M,) bool
    counts: torch.Tensor  # (M,) pixels of each cluster
    normal_tol: torch.Tensor  # (M,) what compare() allows a plane row's normal (0: no refit)
    d_tol: torch.Tensor  # (M,) and its d
    votes: torch.Tensor  # (M, RANSAC_ITERS) inliers of each hypothesis (0 for an empty cluster)
    fragile: torch.Tensor  # (M,) bool: the winner or its inliers turn on a pixel within INLIER_MARGIN of 0.1 m
    max_angle: torch.Tensor  # (M,) largest angle (rad) between a cluster ray and the final plane's normal; nan: none


def plane_models(ri: torch.Tensor, seg: torch.Tensor, seed: int, lidar: dict, num_models: int,
                 angle_threshold_deg: float = 75.0) -> PlainFit:
    """The model table of one frame: ``ri`` (H, W) float32 ranges (the
    range image the codec was given), ``seg`` (H, W) cluster ids, the
    frame's ``seed``; rows 2 .. ``num_models`` - 1 are modelled."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _plane_models(ri, seg, seed, lidar, num_models, angle_threshold_deg)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _plane_models(ri, seg, seed, lidar, num_models, angle_threshold_deg) -> PlainFit:
    dev = ri.device
    r = ri.to(torch.float32).reshape(-1)
    ids = seg.reshape(-1).to(torch.int64)
    rays = scan_rays(lidar, dev).reshape(3, -1).T  # (HW, 3)
    draws = uniform(model_key(seed), (num_models, RANSAC_ITERS * RANSAC_N)).to(dev)
    threshold = torch.tensor(math.pi * (angle_threshold_deg / 180.0), dtype=torch.float32, device=dev)
    table = torch.zeros((num_models, 4), dtype=torch.float32, device=dev)
    use_plane = torch.zeros(num_models, dtype=torch.bool, device=dev)
    votes = torch.zeros((num_models, RANSAC_ITERS), dtype=torch.int64, device=dev)
    counts = torch.zeros(num_models, dtype=torch.int64, device=dev)
    max_angle = torch.full((num_models,), float("nan"), dtype=torch.float32, device=dev)
    normal_tol = torch.zeros(num_models, dtype=torch.float32, device=dev)
    fragile = torch.zeros(num_models, dtype=torch.bool, device=dev)
    d_tol = torch.zeros(num_models, dtype=torch.float32, device=dev)
    for c in range(2, num_models):
        pix = torch.nonzero(ids == c).reshape(-1)  # ascending: row-major
        n = int(pix.numel())
        if n == 0:
            continue
        counts[c] = n
        ranges, cray = r[pix], rays[pix]
        points = ranges[:, None] * cray
        table[c, 3] = ranges.sum() / n
        # Departure 1: seeded draws, with replacement.
        pos = torch.minimum((draws[c] * n).to(torch.int64), torch.tensor(n - 1, device=dev))
        samples = points[pos].reshape(RANSAC_ITERS, RANSAC_N, 3)
        fits = [fit_plane(s) for s in samples]
        hyps = [f.coef for f in fits]
        dists = [distances(h, points) for h in hyps]
        inliers = [dist < INLIER_M for dist in dists]
        votes[c] = torch.stack([i.sum() for i in inliers])
        best = int(torch.argmax(votes[c]))  # departure 3: the first of equal counts
        edge = torch.stack([((dist - INLIER_M).abs() <= _margin(f, points)).sum() for f, dist in zip(fits, dists)])
        # Could another hypothesis overtake the winner, or the first of equal votes change?
        reach, floor = votes[c] + edge, votes[c, best] - edge[best]
        order = torch.arange(RANSAC_ITERS, device=dev)
        fragile[c] = bool(edge[best] > 0) or bool(((reach > floor) | ((reach == floor) & (order < best))).any())
        plane = hyps[best]
        if int(votes[c, best]) >= 3:  # departure 2: refit on the inliers
            fit = fit_plane(points[inliers[best]])
            plane = fit.coef
            normal_tol[c] = torch.clamp(_turn(fit), min=NORMAL_TOL)
            d_tol[c] = torch.clamp(normal_tol[c] * torch.linalg.vector_norm(fit.centroid), min=D_TOL)
        a, b, cc = plane[:3]
        cos = torch.abs(a * cray[:, 0] + b * cray[:, 1] + cc * cray[:, 2]) / torch.sqrt(a * a + b * b + cc * cc)
        angle = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        max_angle[c] = angle.max()
        if n >= MIN_PLANE_POINTS and not bool((angle > threshold).any()):
            table[c] = plane
            use_plane[c] = True
    return PlainFit(table, use_plane, counts, normal_tol, d_tol, votes, fragile, max_angle)


def predict(table: torch.Tensor, seg: torch.Tensor, lidar: dict) -> torch.Tensor:
    """(H, W) intra-prediction of each pixel from its cluster's model row:
    ``-d / (a A + b B + c C)`` on a plane (0 where the ray lies in it),
    ``d`` on a point row."""
    rows = table[seg.to(torch.int64)]  # (H, W, 4)
    a, b, c, d = rows.unbind(-1)
    A, B, C = scan_rays(lidar, table.device)
    denom = a * A + b * B + c * C
    plane = torch.where(denom == 0, torch.zeros_like(d), -d / torch.where(denom == 0, torch.ones_like(d), denom))
    return torch.where(a + b + c == 0, d, plane)


def compare(table: torch.Tensor, fit: PlainFit, angle_threshold_deg: float = 75.0) -> dict:
    """A codec's (M, 4) model table against :func:`plane_models`' ``fit`` of
    the same frame, rows 2 and up: the clusters compared (non-empty in the
    reference), the decisions that agree, those left out (a cluster of 30
    pixels or more whose ray angle lies within ANGLE_MARGIN of the
    threshold, whose two best hypotheses tie on votes, or that is fragile),
    the fragile ones, those that differ, and the largest deviations where
    both sides chose alike (a plane's normal up to its sign and its d with
    the same sign, fragile clusters left out; a point row's mean range),
    each also as a share of what the row allows (``fit.normal_tol``,
    ``fit.d_tol``, D_TOL for a mean); ``ok`` holds every compared decision
    equal and every deviation within what its row allows."""
    got = table.detach().to("cpu", torch.float32)[2:]
    ref = fit.table.detach().to("cpu", torch.float32)[2:]
    counts = fit.counts.detach().cpu()[2:]
    present = counts > 0
    g_plane = (got[:, 0] + got[:, 1] + got[:, 2]) != 0
    r_plane = fit.use_plane.detach().cpu()[2:]
    thr = math.pi * (angle_threshold_deg / 180.0)
    top2 = torch.topk(fit.votes.detach().cpu()[2:], 2, dim=-1).values
    near = (fit.max_angle.detach().cpu()[2:] - thr).abs() <= ANGLE_MARGIN
    fragile = fit.fragile.detach().cpu()[2:] & (counts >= MIN_PLANE_POINTS)
    exempt = (counts >= MIN_PLANE_POINTS) & (near | (top2[:, 0] == top2[:, 1]) | fragile)
    differ = present & ~exempt & (g_plane != r_plane)
    both = present & g_plane & r_plane & ~fragile
    sign = torch.where((got[:, :3] * ref[:, :3]).sum(-1) < 0, -1.0, 1.0)[:, None]
    dn = (got[:, :3] - sign * ref[:, :3]).abs().amax(-1)
    dd = (got[:, 3:] - sign * ref[:, 3:]).abs()[:, 0]
    points = present & ~g_plane & ~r_plane
    dm = (got[:, 3] - ref[:, 3]).abs()
    n_tol, d_tol = fit.normal_tol.detach().cpu()[2:], fit.d_tol.detach().cpu()[2:]
    worst = lambda v, m: float(v[m].max()) if m.any() else 0.0  # noqa: E731
    out = {
        "clusters": int(present.sum()),
        "planes": int((present & r_plane).sum()),
        "decisions_equal": int((present & (g_plane == r_plane)).sum()),
        "exempt": int(exempt.sum()),
        "fragile": int(fragile.sum()),
        "decisions_differ": int(differ.sum()),
        "max_normal_dev": worst(dn, both),
        "max_d_dev": worst(dd, both),
        "max_mean_dev": worst(dm, points),
        "normal_dev_over_tol": worst(dn / n_tol.clamp(min=NORMAL_TOL), both),
        "d_dev_over_tol": max(worst(dd / d_tol.clamp(min=D_TOL), both), worst(dm / D_TOL, points)),
        "widened_rows": int((both & (n_tol > NORMAL_TOL)).sum()),
    }
    out["ok"] = out["decisions_differ"] == 0 and max(out["normal_dev_over_tol"], out["d_dev_over_tol"]) <= 1.0
    return out
