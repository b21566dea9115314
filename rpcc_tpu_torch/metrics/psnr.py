"""Point-to-point / point-to-plane PSNR (a copy of ``rpcc_tpu/metrics/psnr.py``,
host numpy and scipy).

Nearest neighbors via scipy cKDTree (as the reference does); normals via
k-NN covariance eigenvectors (radius 59.7, max 12 neighbors — o3d's
KDTreeSearchParamHybrid equivalents) with the eigendecomposition batched in
numpy; normal transfer between clouds with ``assign_attr``'s
count-and-average scatter semantics, vectorized.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
from scipy.spatial import cKDTree

NORMAL_RADIUS = 59.7
NORMAL_MAX_NN = 12


def psnr(x: float, max_energy: float) -> float:
    return 10 * np.log10(max_energy / x)


def compute_point_cloud_normal(points: np.ndarray) -> np.ndarray:
    """k-NN covariance normals (o3d estimate_normals equivalent)."""
    tree = cKDTree(points, balanced_tree=False)
    dist, idx = tree.query(points, k=NORMAL_MAX_NN, workers=-1)
    valid = dist <= NORMAL_RADIUS  # (N, k)
    nbrs = points[idx]  # (N, k, 3)
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(1), 1.0)
    mean = (nbrs * w).sum(1) / cnt
    centered = (nbrs - mean[:, None, :]) * w
    cov = np.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0]  # smallest eigenvector


def assign_attr(attr1: np.ndarray, idx1: np.ndarray, idx2: np.ndarray) -> np.ndarray:
    """Transfer attributes from cloud 1 to cloud 2 (evaluate_metrics.py:107-123).

    idx1: NN indices of cloud2's points in cloud1 (len N2).
    idx2: NN indices of cloud1's points in cloud2 (len N1).
    Each cloud-2 point averages the attrs of cloud-1 points that chose it;
    orphans fall back to their own NN in cloud 1.
    """
    n2 = idx1.shape[0]
    counts = np.zeros(n2)
    sums = np.zeros((n2, attr1.shape[1]))
    np.add.at(counts, idx2, 1.0)
    np.add.at(sums, idx2, attr1)
    orphan = counts == 0
    counts[orphan] = 1.0
    sums[orphan] = attr1[idx1[orphan]]
    return sums / counts[:, None]


def calc_point_to_point_plane_psnr(
    points1: np.ndarray,
    points2: np.ndarray,
    idx1: np.ndarray = None,
    idx2: np.ndarray = None,
    r: float = 59.7,
    out: bool = True,
) -> Tuple[Dict, Dict]:
    t = time.time()
    pc_1 = points1[np.sum(points1, -1) != 0]
    pc_2 = points2[np.sum(points2, -1) != 0]
    if idx1 is None:
        t1 = cKDTree(pc_1, balanced_tree=False)
        _, idx1 = t1.query(pc_2, workers=-1)
    if idx2 is None:
        t2 = cKDTree(pc_2, balanced_tree=False)
        _, idx2 = t2.query(pc_1, workers=-1)

    max_energy = 3 * r * r
    pc_1_ngb = pc_2[idx2]
    pc_2_ngb = pc_1[idx1]
    mse_1 = np.sum(np.sum((pc_1 - pc_1_ngb) ** 2, axis=1)) / pc_1.shape[0]
    mse_2 = np.sum(np.sum((pc_2 - pc_2_ngb) ** 2, axis=1)) / pc_2.shape[0]
    point_to_point_result = {
        "psnr_1": psnr(mse_1, max_energy),
        "psnr_2": psnr(mse_2, max_energy),
        "mse_1": mse_1,
        "mse_2": mse_2,
        "psnr_mean": (psnr(mse_1, max_energy) + psnr(mse_2, max_energy)) / 2,
        "mse_mean": (mse_1 + mse_2) / 2,
    }

    pc_1_n = compute_point_cloud_normal(pc_1)
    pc_2_n = assign_attr(pc_1_n, idx1, idx2)
    pc_1_ngb_n = pc_2_n[idx2]
    pc_2_ngb_n = pc_1_n[idx1]
    pl_mse_1 = np.sum(np.sum((pc_1 - pc_1_ngb) * pc_1_ngb_n, axis=1) ** 2) / pc_1.shape[0]
    pl_mse_2 = np.sum(np.sum((pc_2 - pc_2_ngb) * pc_2_ngb_n, axis=1) ** 2) / pc_2.shape[0]
    point_to_plane_result = {
        "psnr_1": psnr(pl_mse_1, max_energy),
        "psnr_2": psnr(pl_mse_2, max_energy),
        "mse_1": pl_mse_1,
        "mse_2": pl_mse_2,
        "psnr_mean": (psnr(pl_mse_1, max_energy) + psnr(pl_mse_2, max_energy)) / 2,
        "mse_mean": (pl_mse_1 + pl_mse_2) / 2,
    }
    if out:
        print("point_to_point_result: ")
        for k, v in point_to_point_result.items():
            print(k, v)
        print("point_to_plane_result: ")
        for k, v in point_to_plane_result.items():
            print(k, v)
        print("time cost: ", time.time() - t)
    return point_to_point_result, point_to_plane_result
