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
from rpcc_tpu_torch.utils import timer

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
    before = timer.counters()
    fps.furthest_point_sample(xs, ys, zs, 4)
    assert timer.counters_since(before).get("launch.fps", 0) == 0


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
    before = timer.counters()
    got = fps.furthest_point_sample(xs, ys, zs, K)
    assert timer.counters_since(before).get("launch.fps", 0) == 1
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


# (shape, per-frame counts): a 64E frame at every edge of the count (none,
# one, fewer than K, K - 1, half, all but one, all), a batch with a
# different count per frame, N not divisible by the cluster, and a frame
# past the on-chip capacity whose valid points reach into the streamed part.
MASKED_CASES = [
    *(((1, 128000, 100), (nv,)) for nv in (0, 1, 50, 99, 64000, 127999, 128000)),
    ((8, 128000, 100), (0, 1, 50, 99, 64000, 100000, 127999, 128000)),
    ((2, 4133, 32), (4000, 3)),
    ((1, 400000, 16), (300000,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, counts", MASKED_CASES, ids=lambda v: "x".join(map(str, v)))
def test_cuda_masked_kernel_matches_plain(cuda_device, shape, counts):
    B, N, K = shape
    rng = np.random.default_rng(N + K + counts[0])
    pts = rng.uniform(-40, 40, (3, B, N)).astype(np.float32)
    pts[:, :, N // 5 : N // 3] = 0.0  # zeroed block: exact ties
    if N == 400000:
        pts[:, :, 266400:267400] = 300.0  # valid far points among those a CTA streams
        pts[:, :, 350000:351000] = 900.0  # farther still, but past the count: never picked
    xs, ys, zs = (torch.from_numpy(p).to(cuda_device) for p in pts)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda_device)
    before = timer.counters()
    got = fps.furthest_point_sample(xs, ys, zs, K, num_valid=cnt)
    assert timer.counters_since(before).get("launch.fps", 0) == 1
    ref = fps.furthest_point_sample_planar_masked(xs, ys, zs, cnt, K)
    single = torch.stack([fps.furthest_point_sample_cuda(xs[b], ys[b], zs[b], K, cnt[b : b + 1]) for b in range(B)])
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)
    assert torch.equal(got, single)  # a frame's indices do not depend on its batch
    assert bool((got < torch.clamp(cnt, min=1)[:, None]).all())


@pytest.mark.cuda
def test_cuda_cpu_fps_raises_without_the_kernel(cuda_device, monkeypatch):
    """cpu_fps on CUDA tensors launches the kernel or raises: it never runs
    the plain masked loop."""
    from rpcc_tpu_torch.config import LidarConfig
    from rpcc_tpu_torch.ops import prng, segment
    from rpcc_tpu_torch.ops.projection_host import build_transform_planes

    def unavailable():
        raise RuntimeError("FPS kernel unavailable")

    lidar = LidarConfig(name="small", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                        vertical_angle_min_deg=-24.9, height=16, width=256)
    tm = torch.from_numpy(build_transform_planes(lidar)).to(cuda_device)
    ri = torch.from_numpy(np.random.default_rng(0).uniform(2, 40, (1, 16, 256)).astype(np.float32)).to(cuda_device)
    monkeypatch.setattr(fps, "_kernel", unavailable)
    with pytest.raises(RuntimeError, match="FPS kernel unavailable"):
        segment.segment_range_image(ri[:, None] * tm, ri, tm, prng.prng_key([0], cuda_device), 0.1, 16, cpu_fps=True)
