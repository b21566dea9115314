"""Seeded, vectorized RANSAC plane fitting (port of ``rpcc_tpu/ops/ransac.py``).

All hypotheses are drawn at once from the threefry generator
(:mod:`rpcc_tpu_torch.ops.prng`) and scored as one batched computation:
sample (T, n) indices -> gather (T, n, 3) -> weighted least-squares plane
per hypothesis (closed-form 3x3 eigenvector) -> inlier counts over planar
x/y/z -> argmax -> refit on the winner's inliers.  Every function takes an
optional leading batch dimension (one key, one point set per frame).

The 3x3 covariances are written as elementwise products and sums, not
matmuls, so no TF32 path can touch them on the GPU.  Their f32 sums go
through :func:`fixed_order_sum`, whose association depends only on the
length summed: torch's ``.sum`` picks its order from the tensor's shape
on CUDA, which would let a frame's plane depend on its batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.const import device_const
from rpcc_tpu_torch.ops.stream import fixed_order_sum


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` over the last axis (same product order)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis (length 3) in left-to-right order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def smallest_eigvec_3x3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices: trigonometric eigenvalues + cross-product eigenvector."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    scale = torch.clamp(a.abs().amax(dim=(-2, -1)), min=1e-30)
    a = a / scale[..., None, None]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    q = _sum3(diag) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b_diag = diag - q[..., None]
    p2 = _sum3(b_diag * b_diag) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    detb = (
        b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
        - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
        + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0])
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest

    m = a - lam_min[..., None, None] * eye
    c = torch.stack(
        [_cross(m[..., 0, :], m[..., 1, :]),
         _cross(m[..., 0, :], m[..., 2, :]),
         _cross(m[..., 1, :], m[..., 2, :])], -2
    )  # (..., 3 candidates, 3)
    norms = _sum3(c * c)  # (..., 3)
    best = torch.argmax(norms, dim=-1)  # first of equal maxima
    v = torch.gather(c, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    nrm = torch.sqrt(torch.maximum(norms[..., 0], torch.maximum(norms[..., 1], norms[..., 2])))
    # Degenerate (isotropic) covariance: any direction is an eigenvector.
    z = device_const([0.0, 0.0, 1.0], a.dtype, a.device)
    return torch.where(
        (nrm > 1e-20)[..., None], v / torch.clamp(nrm, min=1e-30)[..., None], z
    )


def fit_plane_weighted(points: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Least-squares planes for (..., M, 3) points with (..., M) weights ->
    (..., 4) normalized ``[a, b, c, d]`` (``a*x + b*y + c*z + d = 0``).
    Sums over M in :func:`fixed_order_sum`'s order."""
    wsum = torch.clamp(fixed_order_sum(weights), min=1e-12)
    w = weights / wsum[..., None]
    centroid = fixed_order_sum(points * w[..., None], dim=-2)  # (..., 3)
    centered = (points - centroid[..., None, :]) * torch.sqrt(w)[..., None]
    cov = fixed_order_sum(centered[..., :, :, None] * centered[..., :, None, :], dim=-3)  # (..., 3, 3)
    normal = smallest_eigvec_3x3(cov)
    norm = torch.clamp(torch.sqrt(_sum3(normal * normal)), min=1e-12)
    normal = normal / norm[..., None]
    d = -_sum3(normal * centroid)
    return torch.cat([normal, d[..., None]], -1)


def point_plane_distance_planar(
    xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, plane: torch.Tensor
) -> torch.Tensor:
    """|n.p + d| / ||n|| over planar (M,) coords; plane (..., 4) -> (..., M).
    Batched: (B, 1, M) coords against (B, T, 4) planes -> (B, T, M)."""
    a, b, c, d = (plane[..., i : i + 1] for i in range(4))
    num = torch.abs(a * xs + b * ys + c * zs + d)
    nrm = torch.sqrt(a * a + b * b + c * c)
    return num / torch.clamp(nrm, min=1e-12)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...]]`` for (B, M, C) rows and (B, ...) int indices."""
    flat = idx.reshape(idx.shape[0], -1)
    out = x.gather(1, flat[..., None].expand(*flat.shape, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def ransac_plane(
    points: torch.Tensor,
    num_valid: torch.Tensor,
    key: torch.Tensor,
    threshold: float = 0.1,
    ransac_n: int = 10,
    num_hypotheses: int = 100,
) -> torch.Tensor:
    """RANSAC plane over the first ``num_valid`` rows of a padded (M, 3) set
    -> the normalized (4,) plane; batched, (B, M, 3) rows, (B,) counts and
    (B, 2) keys -> (B, 4)."""
    if points.ndim == 2:
        return ransac_plane(points[None], num_valid[None], key[None], threshold, ransac_n, num_hypotheses)[0]
    B, M, _ = points.shape
    nv = torch.clamp(num_valid, min=1)[:, None, None]
    u = prng.uniform(key, (num_hypotheses, ransac_n))  # (B, T, n)
    samp_idx = torch.minimum((u * nv.to(u.dtype)).to(torch.int64), nv - 1)
    samples = _take_rows(points, samp_idx)  # (B, T, n, 3)
    ones = torch.ones(samples.shape[:-1], dtype=points.dtype, device=points.device)
    planes = fit_plane_weighted(samples, ones)  # (B, T, 4)

    xs, ys, zs = (points[:, None, :, i] for i in range(3))  # (B, 1, M)
    valid = (torch.arange(M, device=points.device) < num_valid[:, None]).to(points.dtype)
    dists = point_plane_distance_planar(xs, ys, zs, planes)  # (B, T, M)
    inlier = (dists < threshold).to(points.dtype) * valid[:, None, :]
    counts = inlier.sum(-1)  # exact in any order: sums of 0/1 below 2^24
    best = torch.argmax(counts, dim=1)  # (B,)
    rows = torch.arange(B, device=points.device)
    refit = fit_plane_weighted(points, inlier[rows, best])
    # If the winner somehow has < 3 inliers fall back to the hypothesis.
    return torch.where((counts[rows, best] >= 3)[:, None], refit, planes[rows, best])


CANDIDATE_FACTOR = 4  # candidate pool = CANDIDATE_FACTOR * capacity


def compact_random_subset_planar(
    xs: torch.Tensor,
    ys: torch.Tensor,
    zs: torch.Tensor,
    mask: torch.Tensor,
    key: torch.Tensor,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random masked subset in a (capacity, 3) set: a random-phase strided
    lattice of ``4 * capacity`` candidates, masked ones front-packed by a
    random priority.  Returns ``(subset, count)``; rows past ``count`` are
    arbitrary.  Batched: (B, n) planes and mask, (B, 2) keys ->
    ((B, capacity, 3), (B,))."""
    if xs.ndim == 1:
        sub, cnt = compact_random_subset_planar(xs[None], ys[None], zs[None], mask[None], key[None], capacity)
        return sub[0], cnt[0]
    n = xs.shape[1]
    pool = min(CANDIDATE_FACTOR * capacity, n)
    stride = n // pool  # >= 1
    k = prng.split(key)
    pos = (torch.arange(pool, device=xs.device) * stride).expand(xs.shape[0], pool)
    if stride > 1:
        # roll(a, -off)[::stride][:pool] as one gather, one phase per frame
        off = prng.randint(k[:, 0], (), 0, stride)  # (B,)
        pos = (pos + off[:, None]) % n
    cm = mask.gather(1, pos)
    u = prng.uniform(k[:, 1], (pool,))  # (B, pool)
    prio = torch.where(cm, u, 2.0)
    order = pos.gather(1, torch.sort(prio, dim=1, stable=True).indices[:, :capacity])
    subset = torch.stack([xs.gather(1, order), ys.gather(1, order), zs.gather(1, order)], -1)
    count = torch.clamp(cm.sum(1), max=capacity)
    return subset, count
