"""Per-cluster point and plane models (port of ``rpcc_tpu/ops/modeling.py``).

Model table layout (M, 4): ``[0, 0, 0, mean_range]`` for a point model,
``[a, b, c, d]`` for a plane.  Plane models follow the reference's RANSAC
per cluster, every cluster at once in stream space: ITERS hypotheses of N
points drawn from the cluster's stream range with the threefry key,
votes over the whole cluster, the winner refitted on its inliers (weighted
covariance from moment sums centred at the cluster mean), and the
scan-angle check over every cluster pixel.  Clusters under 30 pixels,
planes too oblique to the scan rays, and rows 0 (ground) and 1 (zero
pixels) keep the point model.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.ransac import fit_plane_weighted, smallest_eigvec_3x3
from rpcc_tpu_torch.ops.stream import (
    StreamOrder,
    expand_per_cluster_multi,
    per_cluster_sums,
    per_cluster_sums_multi,
    point_means_stream,
)

MIN_PLANE_POINTS = 30  # utils/segment_utils.py:203
CLUSTER_RANSAC_N = 4  # :208
CLUSTER_RANSAC_ITERS = 10  # :209
CLUSTER_RANSAC_THRESHOLD = 0.1  # o3d default used at :75-82


def point_model_table(means: torch.Tensor, num_models: int) -> torch.Tensor:
    """(M,) per-cluster mean ranges -> (M, 4) ``[0, 0, 0, mean]`` table."""
    zeros3 = torch.zeros((num_models, 3), dtype=means.dtype, device=means.device)
    return torch.cat([zeros3, means[:, None]], -1)


class Hypotheses(NamedTuple):
    planes: torch.Tensor  # (M, ITERS, 4) every hypothesis plane
    best: torch.Tensor  # (M,) index of the winner (first of equal votes)


def _select_hypotheses(
    xs: torch.Tensor,  # (HW,) stream-order coordinates
    ys: torch.Tensor,
    zs: torch.Tensor,
    order: StreamOrder,
    key: torch.Tensor,
    num_models: int,
) -> Hypotheses:
    """RANSAC hypotheses per cluster, each voted on by every cluster pixel
    (inliers within 0.1 m)."""
    cnt = torch.clamp(order.counts, min=1)[:, None]
    u = prng.uniform(key, (num_models, CLUSTER_RANSAC_ITERS * CLUSTER_RANSAC_N))
    offs = torch.minimum((u * cnt).to(torch.int32), cnt - 1)
    # (M, ITERS*N) stream positions.  An empty cluster past the last pixel
    # starts at HW; it reads the last pixel, as the reference's clamped
    # gather does, and never uses its planes.
    sidx = torch.clamp(order.starts[:, None] + offs, max=xs.shape[0] - 1).to(torch.int64)
    hyp_pts = torch.stack([xs[sidx], ys[sidx], zs[sidx]], -1).reshape(
        num_models, CLUSTER_RANSAC_ITERS, CLUSTER_RANSAC_N, 3
    )
    ones = torch.ones(hyp_pts.shape[:-1], dtype=xs.dtype, device=xs.device)
    planes = fit_plane_weighted(hyp_pts, ones)  # (M, ITERS, 4)

    ha, hb, hc, hd = expand_per_cluster_multi(planes.permute(2, 1, 0).reshape(-1, num_models), order).reshape(
        4, CLUSTER_RANSAC_ITERS, -1
    )  # (ITERS, HW) each
    hnorm = torch.sqrt(torch.clamp(ha * ha + hb * hb + hc * hc, min=1e-24))
    dist = torch.abs(ha * xs + hb * ys + hc * zs + hd) / hnorm
    votes = per_cluster_sums_multi((dist < CLUSTER_RANSAC_THRESHOLD).to(xs.dtype), order)  # exact 0/1 sums
    return Hypotheses(planes, torch.argmax(votes, dim=0))


class PlaneFit(NamedTuple):
    table: torch.Tensor  # (M, 4) plane rows where use_plane, point rows elsewhere
    use_plane: torch.Tensor  # (M,) bool
    hypotheses: Hypotheses


def plane_models_stream(
    ri_s: torch.Tensor,  # (HW,) range in stream order
    order: StreamOrder,
    key: torch.Tensor,
    num_models: int,
    angle_threshold_deg: float,
    rays_s: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> PlaneFit:
    """Per-cluster RANSAC planes with the reference's fallbacks: the (M, 4)
    model table, and what decided it."""
    counts = order.counts
    tx, ty, tz = rays_s
    xs, ys, zs = ri_s * tx, ri_s * ty, ri_s * tz

    hyps = _select_hypotheses(xs, ys, zs, order, key, num_models)
    hyp = hyps.planes[torch.arange(num_models, device=ri_s.device), hyps.best]  # (M, 4)

    # Inlier weights of the winning hypothesis over the whole cluster.
    ha, hb, hc, hd = expand_per_cluster_multi(hyp.T, order)
    hnorm = torch.sqrt(torch.clamp(ha * ha + hb * hb + hc * hc, min=1e-24))
    dist = torch.abs(ha * xs + hb * ys + hc * zs + hd) / hnorm
    w = (dist < CLUSTER_RANSAC_THRESHOLD).to(ri_s.dtype)

    # Weighted covariance from moment sums centred at the per-cluster mean:
    # squaring raw ~50 m coordinates would lose a few-cm extent in f32.
    mu_sums = per_cluster_sums_multi(torch.stack([xs, ys, zs]), order)  # (3, M)
    cntf = torch.clamp(counts.to(ri_s.dtype), min=1.0)
    mu0 = mu_sums / cntf[None, :]
    m0x, m0y, m0z = expand_per_cluster_multi(mu0, order)
    dx, dy, dz = xs - m0x, ys - m0y, zs - m0z
    moments = per_cluster_sums_multi(
        torch.stack([w, w * dx, w * dy, w * dz,
                     w * dx * dx, w * dy * dy, w * dz * dz,
                     w * dx * dy, w * dx * dz, w * dy * dz]),
        order,
    )  # (10, M)
    wsum = torch.clamp(moments[0], min=1e-12)
    ex, ey, ez = moments[1] / wsum, moments[2] / wsum, moments[3] / wsum
    cxx = moments[4] / wsum - ex * ex
    cyy = moments[5] / wsum - ey * ey
    czz = moments[6] / wsum - ez * ez
    cxy = moments[7] / wsum - ex * ey
    cxz = moments[8] / wsum - ex * ez
    cyz = moments[9] / wsum - ey * ez
    cov = torch.stack(
        [torch.stack([cxx, cxy, cxz], -1),
         torch.stack([cxy, cyy, cyz], -1),
         torch.stack([cxz, cyz, czz], -1)],
        -2,
    )  # (M, 3, 3)
    normals = smallest_eigvec_3x3(cov)  # (M, 3) unit
    centroid = torch.stack([mu0[0] + ex, mu0[1] + ey, mu0[2] + ez], -1)
    dcoef = -(normals[:, 0] * centroid[:, 0] + normals[:, 1] * centroid[:, 1] + normals[:, 2] * centroid[:, 2])
    refit = torch.cat([normals, dcoef[:, None]], -1)
    planes = torch.where((moments[0] >= 3.0)[:, None], refit, hyp)

    # Scan-angle check over every cluster pixel, as a violation count.
    fa, fb, fc = expand_per_cluster_multi(planes[:, :3].T, order)
    fnorm = torch.sqrt(torch.clamp(fa * fa + fb * fb + fc * fc, min=1e-24))
    cosang = torch.abs(fa * tx + fb * ty + fc * tz) / fnorm
    alpha = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    thr = torch.tensor(math.pi * (angle_threshold_deg / 180.0), dtype=ri_s.dtype, device=ri_s.device)
    viol = per_cluster_sums((alpha > thr).to(ri_s.dtype), order)

    use_plane = (viol == 0.0) & (counts >= MIN_PLANE_POINTS)
    use_plane[:2] = False
    pmod = point_model_table(point_means_stream(ri_s, order), num_models)
    return PlaneFit(torch.where(use_plane[:, None], planes, pmod), use_plane, hyps)
