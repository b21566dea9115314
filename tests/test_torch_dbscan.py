"""DBSCAN port: the plain PyTorch version against ``rpcc_tpu``'s jnp spec
and its Pallas kernel (interpret mode), the DBSCAN segmentation against the
reference's, and the CUDA kernel against the plain version on the card.

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


def scene_fuzz(t):
    """Random blobs, some across the column seam, plus far noise pixels."""
    H, W = 16, 128
    hspace, vspace = 0.245, 0.3
    rng = np.random.default_rng(300 + t)
    pc = np.zeros((H, W, 3), np.float32)
    active = np.zeros((H, W), bool)
    centers = rng.uniform(-30, 30, (rng.integers(2, 6), 3))
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


SCENES = {"basic": scene_basic, "long_wall": scene_long_wall}
SCENES.update({f"fuzz{t}": (lambda t=t: scene_fuzz(t)) for t in range(8)})


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
    if name == "long_wall":
        assert len(set(ids[active].tolist())) == 1
    if name == "basic":
        assert set(ids[14, 50:54].tolist()) == {dbscan.NOISE_ID}


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
    before = dbscan.LAUNCHES
    dbscan.dbscan_labels(T(_planes(pc)), T(active), eps)
    assert dbscan.LAUNCHES == before


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_dbscan.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["basic", "long_wall", "fuzz0", "fuzz5"])
def test_cuda_kernel_matches_plain(cuda_device, name):
    pc, active, eps = SCENES[name]()
    planes, act = T(_planes(pc)).to(cuda_device), T(active).to(cuda_device)
    before = dbscan.LAUNCHES
    got = dbscan.dbscan_labels(planes, act, eps)
    assert dbscan.LAUNCHES == before + 1
    ref = dbscan.dbscan_labels_planar(planes, act, eps)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, ref)
