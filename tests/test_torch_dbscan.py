"""DBSCAN port: the plain PyTorch version against ``rpcc_tpu``'s jnp spec
and its Pallas kernel (interpret mode), the DBSCAN segmentation against the
reference's, the kernel's launch plan, and the CUDA kernels (a grid-wide
mask pass, then one thread-block cluster per frame) against the plain
version on the card.

Raw labels and compacted ids are element-identical.  Every scene first
checks that no eps-connectivity pair lies within 4 ulps of eps^2 (in
float64): XLA on the CPU contracts ``dx*dx + dy*dy + dz*dz`` into FMAs and
the port does not, so only such a pair could flip an edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.ops import segment as j_segment
from rpcc_tpu.ops.dbscan import _compact_labels as j_compact
from rpcc_tpu.ops.dbscan import _dbscan_range_image_jnp
from rpcc_tpu.ops.dbscan_pallas import dbscan_labels_pallas
from rpcc_tpu.ops.projection import build_transform_planes, project_points_host_u16
from rpcc_tpu_torch.ops import dbscan, prng, segment
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ scenes
# The scenes of tests/test_dbscan_pallas.py, as (pc (H, W, 3), active, eps).
def scene_basic():
    H, W = 16, 64
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in range(2, 6):
        for c in range(5, 16):
            pc[r, c] = [10 + 0.01 * r, 0.01 * c, 0]
            active[r, c] = True
    for r in range(9, 13):
        for c in range(30, 41):
            pc[r, c] = [0.01 * r, 20 + 0.01 * c, 0]
            active[r, c] = True
    for c in range(50, 54):
        pc[14, c] = [5, 5, 3 + 0.01 * c]
        active[14, c] = True
    return pc, active, 1.5


def scene_long_wall():
    H, W = 16, 256
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in (7, 8):
        for c in range(20, 220):
            pc[r, c] = [0.245 * c, 14.0, 0.3 * r]
            active[r, c] = True
    return pc, active, 1.5


def scene_fuzz(t, H=16, W=128, blobs=(2, 6)):
    """Random blobs, some across the column seam, plus far noise pixels."""
    hspace, vspace = 0.245, 0.3
    rng = np.random.default_rng(300 + t)
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    centers = rng.uniform(-30, 30, (rng.integers(*blobs), 3))
    centers[:, 2] = rng.uniform(-1, 2, centers.shape[0])
    for ctr in centers:
        r0 = int(rng.integers(1, H - 5))
        c0 = int(rng.integers(0, W))
        nr = int(rng.integers(2, 5))
        nc = int(rng.integers(4, 13))
        for r in range(r0, r0 + nr):
            for c in range(c0, c0 + nc):
                if rng.random() < 0.85:
                    jitter = rng.normal(0, 0.02, 3)
                    pc[r, c % W] = ctr + [hspace * (c - c0), vspace * (r - r0), 0] + jitter
                    active[r, c % W] = True
    for _ in range(6):
        r, c = int(rng.integers(0, H)), int(rng.integers(0, W))
        if not active[r, c]:
            pc[r, c] = rng.uniform(40, 80, 3)
            active[r, c] = True
    return pc, active, 1.2


def scene_ring(H=16, W=128, radius=3.0, gap=(60, 64)):
    """A wall on a ring around the sensor in rows H/4..3H/4, broken at
    ``gap``: one component that wraps the column seam (the kernel's bands
    C-1 and 0 meet there)."""
    az = 2 * np.pi * np.arange(W) / W
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    for r in range(H // 4, 3 * H // 4):
        pc[r, :, 0], pc[r, :, 1], pc[r, :, 2] = radius * np.cos(az), radius * np.sin(az), 0.3 * r
        active[r] = True
    active[:, gap[0] : gap[1]] = False
    pc[2, 7] = [2.9, 0.6, 0.61]  # an active pixel one eps-neighbour of the ring: a border pixel
    active[2, 7] = True
    return pc, active, 1.5


def scene_narrow(seed=0, H=8, W=20):
    """Jittered points on a small ring, 70% of the pixels active: at W = 20 a
    cluster's bands (2-3 columns) are narrower than the window."""
    rng = np.random.default_rng(seed)
    az = 2 * np.pi * np.arange(W) / W
    pc = np.zeros((H, W, 3), np.float32)
    for r in range(H):
        pc[r, :, 0], pc[r, :, 1], pc[r, :, 2] = 2 * np.cos(az), 2 * np.sin(az), 0.3 * r
    pc += rng.normal(0, 0.05, pc.shape).astype(np.float32)
    return pc, rng.random((H, W)) < 0.7, 1.0


SCENES = {"basic": scene_basic, "long_wall": scene_long_wall}
SCENES.update({f"fuzz{t}": (lambda t=t: scene_fuzz(t)) for t in range(8)})
SCENES.update({"ring": scene_ring, "narrow": scene_narrow})
SCENES["tiny"] = lambda: (*scene_narrow(seed=2, H=3, W=5)[:2], 4.5)  # W < 7: windows wrap past a column twice
# Two rows: the plain version clamps rows as the Pallas kernel does; the jnp
# spec's shift keeps a wrapped row at dr = 3 > H (see the two-row test).
TWO_ROW = {"two_row": lambda: scene_narrow(seed=1, H=2, W=64)}


def assert_no_eps_near_tie(pc, active, eps, ulps=4):
    """No active pair over the 48 window shifts has float64 d^2 within
    ``ulps`` f32 ulps of eps^2."""
    eps2 = np.float32(float(eps) * float(eps))
    tol = ulps * np.spacing(eps2)
    p64 = pc.astype(np.float64)
    H = pc.shape[0]
    for dr, dc in dbscan._neighbor_shifts(dbscan.WINDOW):
        nb = np.roll(p64, (-dr, -dc), (0, 1))
        nb_act = np.roll(active, (-dr, -dc), (0, 1))
        rows = np.arange(H)[:, None] + dr
        pair = active & nb_act & (rows >= 0) & (rows < H)
        d2 = ((p64 - nb) ** 2).sum(-1)
        assert not (pair & (np.abs(d2 - eps2) <= tol)).any(), f"eps near-tie at shift {(dr, dc)}"


def _planes(pc):
    return np.ascontiguousarray(np.transpose(pc, (2, 0, 1)))


def _reference(pc, active, eps, max_clusters):
    planes, act = jnp.asarray(_planes(pc)), jnp.asarray(active)
    ids = np.asarray(_dbscan_range_image_jnp(planes, act, eps, max_clusters))
    raw = dbscan_labels_pallas(planes, act, eps, interpret=True)
    return np.asarray(raw), ids, np.asarray(j_compact(raw, act, max_clusters))


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_jnp_and_pallas(name):
    pc, active, eps = SCENES[name]()
    assert_no_eps_near_tie(pc, active, eps)
    raw_ref, ids_jnp, ids_pallas = _reference(pc, active, eps, 32)
    raw = dbscan.dbscan_labels(T(_planes(pc)), T(active), eps)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), raw_ref)
    ids = dbscan.dbscan_range_image(T(_planes(pc)), T(active), eps, 32).numpy()
    np.testing.assert_array_equal(ids, ids_jnp)
    np.testing.assert_array_equal(ids, ids_pallas)
    if name in ("long_wall", "ring"):
        assert len(set(ids[active].tolist())) == 1  # the ring is joined across the seam
    if name == "basic":
        assert set(ids[14, 50:54].tolist()) == {dbscan.NOISE_ID}


def test_two_row_frame_clamps_rows_like_the_pallas_kernel():
    """At H = 2 the reference's jnp spec keeps a wrapped row for dr = 3 (its
    ``out.at[H - dr:]`` starts at -1), so row 0 counts each row-1 neighbour
    twice; its Pallas kernel and the port clamp every row.  Raw labels equal
    the Pallas kernel's; with min_points = 2, where a doubled count changes
    no core flag, they equal the spec's too."""
    pc, active, eps = TWO_ROW["two_row"]()
    assert_no_eps_near_tie(pc, active, eps)
    planes, act = jnp.asarray(_planes(pc)), jnp.asarray(active)
    raw = dbscan.dbscan_labels(T(_planes(pc)), T(active), eps)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(dbscan_labels_pallas(planes, act, eps, interpret=True)))
    spec = np.asarray(_dbscan_range_image_jnp(planes, act, eps, 32))
    assert not np.array_equal(dbscan.dbscan_range_image(T(_planes(pc)), T(active), eps, 32).numpy(), spec)
    raw2 = dbscan.dbscan_labels(T(_planes(pc)), T(active), eps, min_points=2)
    np.testing.assert_array_equal(raw2.numpy(), np.asarray(dbscan_labels_pallas(planes, act, eps, 2, interpret=True)))
    ids2 = dbscan.dbscan_range_image(T(_planes(pc)), T(active), eps, 32, min_points=2).numpy()
    np.testing.assert_array_equal(ids2, np.asarray(_dbscan_range_image_jnp(planes, act, eps, 32, 2)))


@pytest.mark.parametrize("max_clusters", [0, 1, 2])
def test_max_clusters_overflow_to_noise(max_clusters):
    """Components past ``max_clusters`` collapse to noise, as in the spec."""
    pc, active, eps = scene_fuzz(3)
    assert_no_eps_near_tie(pc, active, eps)
    planes, act = jnp.asarray(_planes(pc)), jnp.asarray(active)
    ref = np.asarray(_dbscan_range_image_jnp(planes, act, eps, max_clusters))
    got = dbscan.dbscan_range_image(T(_planes(pc)), T(active), eps, max_clusters).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.max() < dbscan.FIRST_CLUSTER_ID + max_clusters
    assert (got[active] == dbscan.NOISE_ID).any()


def test_all_inactive_frame():
    pc = np.random.default_rng(0).uniform(-5, 5, (8, 32, 3)).astype(np.float32)
    active = np.zeros((8, 32), bool)
    raw = dbscan.dbscan_labels(T(_planes(pc)), T(active), 1.5)
    assert (raw.numpy() == 8 * 32).all()
    assert (dbscan.dbscan_range_image(T(_planes(pc)), T(active), 1.5, 4).numpy() == 0).all()


def _small_frame(seed):
    # Imported here, not at the top: where another installed package is
    # named ``tests``, this module must still collect for ``-m cuda`` runs.
    from tests.test_roundtrip import SMALL, synth_scene

    cfg = CodecConfig(segment_method="DBSCAN", cluster_num=16)
    q, d = project_points_host_u16(synth_scene(seed=seed), SMALL, np.float32(cfg.step / 16.0))
    ri = q.astype(np.float32) * d
    tm = build_transform_planes(SMALL)
    return cfg, ri, tm, ri[None] * tm


@pytest.mark.parametrize("seed", [0, 7])
def test_segment_dbscan_matches_reference(seed):
    """Seg ids exact when fed the reference's ground plane; the port's own
    ground plane within rtol 1e-5 (f32 sums in another order)."""
    cfg, ri, tm, planes = _small_frame(seed)
    key = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))[0]
    seg, ground, _ = jax.jit(
        lambda p, r, t, k: j_segment.segment_range_image_dbscan(p, r, t, k, cfg.dbscan_eps, cfg.cluster_num)
    )(planes, ri, tm, key)
    seg, ground = np.asarray(seg), np.asarray(ground)
    got = segment.dbscan_segment(T(planes), T(ri), T(tm), T(ground), cfg.dbscan_eps, cfg.cluster_num)
    np.testing.assert_array_equal(got.numpy(), seg)
    assert (seg >= dbscan.FIRST_CLUSTER_ID).any() and (seg == 0).any()

    t_key = prng.split(prng.prng_key(seed, "cpu"))[0]
    res = segment.segment_range_image_dbscan(T(planes), T(ri), T(tm), t_key, cfg.dbscan_eps, cfg.cluster_num)
    np.testing.assert_allclose(res.ground_model.numpy(), ground, rtol=1e-5, atol=1e-6)
    assert res.seg_idx.dtype == torch.int32 and tuple(res.centers.shape) == (cfg.cluster_num, 3)


def test_cpu_dispatch_never_counts_a_launch():
    pc, active, eps = scene_basic()
    before = timer.counters()
    dbscan.dbscan_labels(T(_planes(pc)), T(active), eps)
    assert timer.counters_since(before).get("launch.dbscan", 0) == 0


def test_wrapper_rejects_bad_inputs():
    planes, act = torch.zeros((3, 4, 8)), torch.zeros((4, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        dbscan.dbscan_labels(planes.double(), act, 1.5)
    with pytest.raises(TypeError):
        dbscan.dbscan_labels(planes, act.int(), 1.5)
    with pytest.raises(ValueError):
        dbscan.dbscan_labels(planes[:, :3], act, 1.5)
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        dbscan.dbscan_labels_cuda(planes, act, 1.5)


@pytest.mark.parametrize(
    "H, W, cluster, want",
    [
        (64, 2000, 16, dbscan.LaunchPlan(16, 125, 8000, 0, 96000)),  # a 64E frame, all on chip
        (64, 2000, 8, dbscan.LaunchPlan(8, 250, 16000, 0, 192000)),
        (32, 2250, 8, dbscan.LaunchPlan(8, 282, 9024, 0, 108288)),  # HDL-32E: the last band is narrower
        (16, 1800, 16, dbscan.LaunchPlan(16, 113, 1808, 0, 21696)),  # VLP-16
        (8, 20, 16, dbscan.LaunchPlan(16, 2, 16, 0, 192)),  # bands narrower than the window, 6 empty
        (128, 4000, 16, dbscan.LaunchPlan(16, 250, 19370, 12630, 232440)),  # past the on-chip capacity
    ],
)
def test_plan_splits_a_frame_over_the_cluster(H, W, cluster, want):
    plan = dbscan.plan_for(H, W, cluster)
    assert plan == want
    owner = np.arange(W) // plan.band  # the kernel's owner of column c
    widths = np.clip(W - np.arange(cluster) * plan.band, 0, plan.band)  # columns each CTA walks
    assert owner.max() < cluster and widths.sum() == W
    assert np.array_equal(np.bincount(owner, minlength=cluster), widths)  # every column owned once
    assert plan.onchip + plan.spill == H * plan.band
    assert (plan.spill > 0) == (H * plan.band * dbscan.BYTES_PER_PX > dbscan.SMEM_LIMIT)
    assert dbscan.BYTES_PER_PX * plan.onchip <= plan.smem_bytes <= 232448  # a CTA's shared memory on Hopper


@pytest.mark.parametrize("batch, active16, want", [(1, 7, 16), (7, 7, 16), (8, 7, 8), (8, 8, 16), (3, 0, 8)])
def test_launch_plan_takes_16_where_the_batch_fits(batch, active16, want):
    asked = []

    def max_active(plan):
        asked.append(plan.cluster)
        return active16

    assert dbscan.launch_plan(batch, 64, 2000, max_active).cluster == want
    assert asked == [16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_dbscan.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["basic", "long_wall", "fuzz0", "fuzz5", "ring", "narrow", "tiny", "two_row"])
def test_cuda_kernel_matches_plain(cuda_device, name):
    pc, active, eps = {**SCENES, **TWO_ROW}[name]()
    planes, act = T(_planes(pc)).to(cuda_device), T(active).to(cuda_device)
    before = timer.counters()
    got = dbscan.dbscan_labels(planes, act, eps)
    assert timer.counters_since(before).get("launch.dbscan", 0) == 1
    ref = dbscan.dbscan_labels_planar(planes, act, eps)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernel_batched_matches_plain_and_single(cuda_device):
    """B = 3 in one launch sequence: two blob scenes across the seam and an
    all-inactive frame; labels stay in-frame and equal the batched plain
    version and three single-frame launches."""
    scenes = [scene_fuzz(0), scene_fuzz(5)]
    pc = np.stack([s[0] for s in scenes] + [np.full_like(scenes[0][0], 3.0)])
    active = np.stack([s[1] for s in scenes] + [np.zeros_like(scenes[0][1])])
    planes = T(np.ascontiguousarray(np.transpose(pc, (0, 3, 1, 2)))).to(cuda_device)
    act = T(active).to(cuda_device)
    before = timer.counters()
    got = dbscan.dbscan_labels(planes, act, 1.2)
    assert timer.counters_since(before).get("launch.dbscan", 0) == 1
    ref = dbscan.dbscan_labels_planar(planes, act, 1.2)
    single = torch.stack([dbscan.dbscan_labels(planes[b].contiguous(), act[b], 1.2) for b in range(3)])
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref) and torch.equal(got, single)
    assert bool((got[2] == 16 * 128).all())


@pytest.mark.cuda
def test_cuda_kernel_past_the_on_chip_capacity(cuda_device):
    """(1, 128, 4000): slots past a CTA's shared memory live in device memory,
    in the same kernel."""
    pc, active, eps = scene_fuzz(11, H=128, W=4000, blobs=(300, 400))
    assert dbscan.plan_for(128, 4000, 16).spill > 0
    planes, act = T(_planes(pc)).to(cuda_device), T(active).to(cuda_device)
    got = dbscan.dbscan_labels(planes, act, eps)
    ref = dbscan.dbscan_labels_planar(planes, act, eps)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
def test_cuda_batch8_both_cluster_sizes(cuda_device, cluster, monkeypatch):
    """B = 8 in one launch at either cluster size equals the batched plain
    version and eight single-frame launches."""
    scenes = [scene_fuzz(t) for t in range(8)]
    planes = T(np.ascontiguousarray(np.stack([np.transpose(s[0], (2, 0, 1)) for s in scenes]))).to(cuda_device)
    act = T(np.stack([s[1] for s in scenes])).to(cuda_device)
    monkeypatch.setattr(dbscan, "launch_plan", lambda b, h, w, _: dbscan.plan_for(h, w, cluster))
    before = timer.counters()
    got = dbscan.dbscan_labels(planes, act, 1.2)
    assert timer.counters_since(before).get("launch.dbscan", 0) == 1
    ref = dbscan.dbscan_labels_planar(planes, act, 1.2)
    single = torch.stack([dbscan.dbscan_labels(planes[b].contiguous(), act[b], 1.2) for b in range(8)])
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref) and torch.equal(got, single)


@pytest.mark.cuda
def test_cuda_phase_stamps_leave_the_labels(cuda_device):
    """``phase_stamps`` gets one rising ``%globaltimer`` stamp per span and
    changes no label."""
    pc, active, eps = SCENES["ring"]()
    planes, act = T(_planes(pc)).to(cuda_device), T(active).to(cuda_device)
    stamps = torch.zeros(len(dbscan.PHASES) + 1, dtype=torch.int64, device=cuda_device)
    got = dbscan.dbscan_labels(planes, act, eps)
    timed = dbscan.dbscan_labels_cuda(planes, act, eps, phase_stamps=stamps)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, timed)
    assert bool((stamps > 0).all()) and bool((stamps.diff() >= 0).all())
