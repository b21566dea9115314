"""The batched least-squares plane fit at the 64E ground fit's size: a frame's
plane must not depend on the batch it rides in, on the CPU and on the card.

``fit_plane_weighted`` sums through ``ops/stream.py::fixed_order_sum``, whose
association is set by the summed length alone; torch's CUDA ``.sum`` picks
its order from the whole tensor's shape, so a batch dimension could change a
frame's last bits there.  This file imports no ``tests.*`` module, so the
card's ``python -m pytest -m cuda tests/test_torch_plane_fit.py`` collects it.
"""

import numpy as np
import pytest
import torch

from rpcc_tpu_torch.ops import ransac

torch.set_num_threads(1)

B, M = 8, 128000  # batch of 8 frames of one Velodyne 64E grid (64 x 2000)


def _ground_frames():
    """Noisy tilted ground planes with outliers; weights are an inlier mask."""
    rng = np.random.default_rng(64)
    xy = rng.uniform(-60, 60, (B, M, 2))
    tilt = rng.normal(0, 0.02, (B, 1, 2))
    z = -1.73 + (xy * tilt).sum(-1) + rng.normal(0, 0.03, (B, M))
    pts = np.concatenate([xy, z[..., None]], -1)
    outliers = rng.uniform(size=(B, M)) < 0.2
    pts[outliers, 2] += rng.uniform(0.5, 4.0, int(outliers.sum()))
    w = (~outliers & (rng.uniform(size=(B, M)) < 0.9)).astype(np.float32)
    return torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(w)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_batched_plane_fit_bit_equal_at_64e_size(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_plane_fit.py")
    pts, w = (t.to(device) for t in _ground_frames())
    batched = ransac.fit_plane_weighted(pts, w).cpu().numpy()
    assert batched.shape == (B, 4) and np.isfinite(batched).all()
    for b in range(B):
        single = ransac.fit_plane_weighted(pts[b], w[b]).cpu().numpy()
        np.testing.assert_array_equal(batched[b], single, err_msg=f"frame {b} on {device}")
    # A sound ground plane: normal near +-z, offset near the sensor height.
    assert (np.abs(batched[:, 2]) > 0.99).all()
    np.testing.assert_allclose(np.abs(batched[:, 3]), 1.73, atol=0.05)
