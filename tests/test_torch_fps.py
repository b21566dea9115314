"""FPS port: the plain PyTorch version against ``rpcc_tpu``'s lax version
and its Pallas kernel (interpret mode), and the CUDA kernel against the
plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.ops.fps import furthest_point_sample_planar as jax_fps
from rpcc_tpu.ops.fps_pallas import furthest_point_sample_pallas
from rpcc_tpu_torch.ops import fps

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_fps.py")
    return torch.device("cuda:0")


def _batch_inputs():
    """The inputs of tests/test_fps_pallas.py: 3 x 2048 with a zeroed block."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (3, 2048, 3)).astype(np.float32)
    pts[:, 500:900] = 0.0
    return pts[..., 0], pts[..., 1], pts[..., 2]


def test_plain_matches_lax_and_pallas_batched():
    xs, ys, zs = _batch_inputs()
    lax_idx = np.stack(
        [np.asarray(jax_fps(jnp.asarray(xs[b]), jnp.asarray(ys[b]), jnp.asarray(zs[b]), 32)) for b in range(3)]
    )
    pallas_idx = np.asarray(
        furthest_point_sample_pallas(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs), 32, interpret=True)
    )
    got = fps.furthest_point_sample(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(zs), 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lax_idx)
    np.testing.assert_array_equal(got.numpy(), pallas_idx)


def test_plain_matches_lax_and_pallas_single_frame():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (640, 3)).astype(np.float32)
    cols = [np.ascontiguousarray(pts[:, i]) for i in range(3)]
    lax_idx = np.asarray(jax_fps(*(jnp.asarray(c) for c in cols), 10))
    pallas_idx = np.asarray(furthest_point_sample_pallas(*(jnp.asarray(c) for c in cols), 10, interpret=True))
    got = fps.furthest_point_sample(*(torch.from_numpy(c) for c in cols), 10).numpy()
    np.testing.assert_array_equal(got, lax_idx)
    np.testing.assert_array_equal(got, pallas_idx)


def test_ties_pick_lowest_index():
    # Four corners of a square plus copies: every step has exact ties.
    base = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    pts = np.concatenate([base, base, base])
    xs, ys = torch.from_numpy(pts[:, 0].copy()), torch.from_numpy(pts[:, 1].copy())
    zs = torch.zeros_like(xs)
    got = fps.furthest_point_sample(xs, ys, zs, 6).tolist()
    ref = np.asarray(jax_fps(jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()), jnp.asarray(zs.numpy()), 6))
    assert got == ref.tolist() == [0, 3, 1, 2, 0, 0]


def test_cpu_dispatch_never_counts_a_launch():
    xs, ys, zs = (torch.from_numpy(a) for a in _batch_inputs())
    before = fps.LAUNCHES
    fps.furthest_point_sample(xs, ys, zs, 4)
    assert fps.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(16)
    with pytest.raises(TypeError):
        fps.furthest_point_sample(x.double(), x.double(), x.double(), 4)
    with pytest.raises(ValueError):
        fps.furthest_point_sample(x, x, torch.zeros(15), 4)
    with pytest.raises(ValueError):
        fps.furthest_point_sample(x, x, x, 0)
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        fps.furthest_point_sample_cuda(x, x, x, 4)


@pytest.mark.parametrize(
    "n, cluster, want",
    [
        (128000, 16, fps.LaunchPlan(16, 8000, 8000, 0, 96000)),  # a 64E frame, all on chip
        (128000, 8, fps.LaunchPlan(8, 16000, 16000, 0, 192000)),
        (4133, 16, fps.LaunchPlan(16, 259, 259, 0, 3108)),  # the last CTA holds 248
        (7, 16, fps.LaunchPlan(16, 1, 1, 0, 12)),  # N < C: CTAs 7-15 hold nothing
        (400000, 16, fps.LaunchPlan(16, 25000, 16384, 8616, 196608)),  # above the on-chip capacity
    ],
)
def test_plan_splits_a_frame_over_the_cluster(n, cluster, want):
    plan = fps.plan_for(n, cluster)
    assert plan == want
    assert n <= plan.chunk * cluster < n + cluster  # every point owned, by the smallest chunk
    assert plan.onchip + plan.spill == plan.chunk and plan.onchip <= fps.ONCHIP_PTS
    assert plan.smem_bytes <= 232448  # a CTA's shared memory on Hopper


@pytest.mark.parametrize("batch, active16, want", [(1, 7, 16), (7, 7, 16), (8, 7, 8), (8, 8, 16), (3, 0, 8)])
def test_launch_plan_takes_16_where_the_batch_fits(batch, active16, want):
    asked = []

    def max_active(plan):
        asked.append(plan.cluster)
        return active16

    assert fps.launch_plan(batch, 128000, max_active).cluster == want
    assert asked == [16]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(1, 128000, 100), (8, 128000, 100), (2, 4133, 32), (3, 2048, 32), (1, 7, 5), (1, 400000, 16)],
)
def test_cuda_kernel_matches_plain(cuda_device, shape):
    B, N, K = shape
    rng = np.random.default_rng(B * N + K)
    pts = rng.uniform(-40, 40, (3, B, N)).astype(np.float32)
    pts[:, :, N // 5 : N // 2] = 0.0  # zeroed block: exact ties
    if N == 400000:
        pts[:, :, -1000:] = 300.0  # far points among the ones each CTA streams from device memory
    xs, ys, zs = (torch.from_numpy(p).to(cuda_device) for p in pts)
    before = fps.LAUNCHES
    got = fps.furthest_point_sample(xs, ys, zs, K)
    assert fps.LAUNCHES == before + 1
    ref = fps.furthest_point_sample_planar(xs, ys, zs, K)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
def test_cuda_both_cluster_sizes_give_the_plain_indices(cuda_device, cluster, monkeypatch):
    rng = np.random.default_rng(cluster)
    pts = rng.uniform(-40, 40, (3, 2, 128000)).astype(np.float32)
    pts[:, :, 20000:60000] = 0.0
    xs, ys, zs = (torch.from_numpy(p).to(cuda_device) for p in pts)
    monkeypatch.setattr(fps, "launch_plan", lambda b, n, _: fps.plan_for(n, cluster))
    got = fps.furthest_point_sample(xs, ys, zs, 100)
    ref = fps.furthest_point_sample_planar(xs, ys, zs, 100)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_strided_input(cuda_device):
    strided = torch.zeros(64, device=cuda_device)[::2]
    with pytest.raises(ValueError):
        fps.furthest_point_sample(strided, strided, strided, 4)
