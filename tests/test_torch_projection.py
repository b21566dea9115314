"""The port's in-graph projection (``rpcc_tpu_torch/ops/projection.py``)
against ``rpcc_tpu/ops/projection.py`` on the CPU, and on the card against
the port's CPU projection.

Tolerances and why:
  * the keep-nearest rasterization (``scatter_min_image`` against the
    reference's two-sort ``_scatter_min_image``) is exact: the same
    indices, depths and masks give the same image, collisions, exact ties,
    all-invalid frames and padding rows included;
  * ``project_points`` is held to the JAX package's own device-vs-host
    bounds (tests/test_host_projection.py:127-139): support agreement
    >= 0.9999 and, where both sides have a return, >= 0.999 of the depths
    within rtol 2e-6.  XLA's CPU code FMA-contracts ``x*x+y*y+z*z`` and
    has its own atan2, so depths differ by an ulp or two (ROADMAP 3.2);
  * a zero-padded (B, N, 3) batch equals its per-frame projections
    exactly, and ``range_image_to_points`` is exact.

The module imports nothing from ``tests`` (the card's machine has a
site-installed package of that name).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu import config as ref_config
from rpcc_tpu.ops import projection as ref_projection
from rpcc_tpu_torch.config import LidarConfig
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.ops import projection

torch.set_num_threads(1)

EVEN = LidarConfig(name="small64", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                   vertical_angle_min_deg=-24.9, height=16, width=256)
UNEVEN_ANGLES = tuple(float(a) for a in np.linspace(2.0, -24.9, 16) ** 3 / 24.9 ** 2)  # denser near the top
TABLE = dataclasses.replace(EVEN, name="small-table", vertical_angles_deg=UNEVEN_ANGLES)
LIDARS = {"even": EVEN, "table": TABLE}


def ref_lidar(lidar):
    return ref_config.LidarConfig(**dataclasses.asdict(lidar))


def angles_f32(lidar):
    """The channel table as both packages' encoders build it."""
    if lidar.even_dist:
        return None
    return np.asarray([a * np.pi / 180.0 for a in lidar.vertical_angles_deg], np.float32)


def port_project(pc, lidar, device="cpu"):
    va = angles_f32(lidar)
    va = None if va is None else torch.from_numpy(va).to(device)
    return projection.project_points(torch.from_numpy(pc).to(device), lidar, va).cpu().numpy()


def ref_project(pc, lidar):
    va = angles_f32(lidar)
    fn = jax.jit(lambda p: ref_projection.project_points(p, ref_lidar(lidar), None if va is None else jnp.asarray(va)))
    return np.asarray(fn(pc))


def clouds(lidar, seed):
    """A frame of the LiDAR's own scan grid, and a random cloud off the
    grid's rays whose elevations run past its top and bottom rows."""
    rng = np.random.default_rng(seed)
    n = 3000
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(rng.uniform(-28.0, 5.0, n))
    r = rng.uniform(2.0, 60.0, n)
    rand = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1)
    return {"scan": synth_cloud_for(lidar, seed), "random": rand.astype(np.float32)}


def assert_within_host_bounds(mine, ref):
    assert ((mine > 0) == (ref > 0)).mean() >= 0.9999
    both = (mine > 0) & (ref > 0)
    assert both.sum() > 0
    assert np.isclose(mine[both], ref[both], rtol=2e-6, atol=0).mean() >= 0.999


# ------------------------------------------------------ scatter_min_image
def raster_case(kind, H, W, seed=0):
    """(flat_idx, depth, valid) of one frame: ``collide`` puts 5 points on
    each pixel on average, ``ties`` draws depths from four values,
    ``padded`` zero-pads a third of the rows, ``invalid`` has no valid
    point."""
    rng = np.random.default_rng(seed)
    n = 5 * H * W
    idx = rng.integers(0, H * W, n).astype(np.int32)
    depth = rng.uniform(1.0, 50.0, n).astype(np.float32)
    if kind == "ties":
        depth = rng.choice(np.float32([3.5, 7.25, 7.25000048, 9.0]), n)
    if kind == "padded":
        depth[n - n // 3:] = 0.0
        idx[n - n // 3:] = 0
    valid = depth > 0
    if kind == "invalid":
        valid[:] = False
    return idx, depth, valid


@pytest.mark.parametrize("kind", ["collide", "ties", "padded", "invalid"])
def test_scatter_min_image_equals_reference(kind):
    H, W = 8, 64
    idx, depth, valid = raster_case(kind, H, W)
    ref = np.asarray(jax.jit(ref_projection._scatter_min_image, static_argnums=(3, 4))(idx, depth, valid, H, W))
    mine = projection.scatter_min_image(torch.from_numpy(idx), torch.from_numpy(depth),
                                        torch.from_numpy(valid), H, W).numpy()
    np.testing.assert_array_equal(mine, ref)
    if kind == "invalid":
        assert (mine == 0).all()


def test_scatter_min_image_batch_keeps_frames_apart():
    """Each frame of a (B, N) batch equals its own raster; the same pixel
    index in two frames never mixes."""
    H, W = 8, 64
    cases = [raster_case(k, H, W, seed=s) for s, k in enumerate(("collide", "ties", "padded", "invalid"))]
    idx, depth, valid = (torch.from_numpy(np.stack(a)) for a in zip(*cases))
    batch = projection.scatter_min_image(idx, depth, valid, H, W).numpy()
    assert batch.shape == (4, H, W)
    for b, (i, d, v) in enumerate(cases):
        ref = np.asarray(ref_projection._scatter_min_image(i, d, v, H, W))
        np.testing.assert_array_equal(batch[b], ref)


# --------------------------------------------------------- project_points
@pytest.mark.parametrize("lidar_name", list(LIDARS))
@pytest.mark.parametrize("kind", ["scan", "random"])
def test_project_points_within_reference_bounds(lidar_name, kind):
    lidar = LIDARS[lidar_name]
    for seed in (0, 1):
        pc = clouds(lidar, seed)[kind]
        assert_within_host_bounds(port_project(pc, lidar), ref_project(pc, lidar))


def test_channel_table_rows_take_the_nearest_angle():
    """A channel-table row is the nearest channel angle (numpy's first-index
    argmin over the same f32 differences), on the channels, between two of
    them and past both ends; each image equals the reference's."""
    va = angles_f32(TABLE)
    mid = np.float32((va[3] + va[4]) / 2)
    el = np.array([va[0], va[5], mid, va[15] - 0.01, va[0] + 0.05], np.float32)
    r = np.float32(10.0)
    pc = np.stack([r * np.cos(el), np.zeros_like(el), r * np.sin(el)], -1).astype(np.float32)
    for i in range(pc.shape[0]):  # one point a frame: no collisions
        img = port_project(pc[i:i + 1], TABLE)
        row = int(np.argwhere(img > 0)[0, 0])
        v = np.arctan2(pc[i, 2], np.sqrt(pc[i, 0] ** 2 + pc[i, 1] ** 2)).astype(np.float32)
        assert row == int(np.argmin(np.abs(va - v)))
        np.testing.assert_array_equal(img, ref_project(pc[i:i + 1], TABLE))


def test_invalid_points_never_project():
    """Padding rows (all zero) and NaN points land nowhere; a frame of only
    those is all zeros."""
    lidar = EVEN
    pc = clouds(lidar, 3)["random"]
    bad = np.array([[0, 0, 0], [np.nan, 1, 1], [1, np.nan, 0], [0, 0, np.nan]], np.float32)
    np.testing.assert_array_equal(port_project(np.concatenate([pc, bad]), lidar), port_project(pc, lidar))
    assert (port_project(bad, lidar) == 0).all()


@pytest.mark.parametrize("lidar_name", list(LIDARS))
def test_padded_batch_equals_per_frame_projections(lidar_name):
    lidar = LIDARS[lidar_name]
    frames = [clouds(lidar, 4)["scan"], clouds(lidar, 5)["random"], np.zeros((0, 3), np.float32)]
    n = max(f.shape[0] for f in frames) + 17
    batch = np.zeros((len(frames), n, 3), np.float32)
    for b, f in enumerate(frames):
        batch[b, : f.shape[0]] = f
    out = port_project(batch, lidar)
    assert out.shape == (3, lidar.height, lidar.width)
    for b, f in enumerate(frames):
        np.testing.assert_array_equal(out[b], port_project(f, lidar))


def test_range_image_to_points_is_exact():
    rng = np.random.default_rng(7)
    ri = rng.uniform(0, 40, (2, EVEN.height, EVEN.width)).astype(np.float32)
    tm = projection.build_transform_map(EVEN)
    mine = projection.range_image_to_points(torch.from_numpy(ri), torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(ref_projection.range_image_to_points(ri, tm)))


def test_ray_tables_are_the_host_module_s():
    from rpcc_tpu_torch.ops import projection_host

    assert projection.build_transform_map is projection_host.build_transform_map
    assert projection.build_transform_planes is projection_host.build_transform_planes


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_projection.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("lidar_name", list(LIDARS))
def test_cuda_projection_matches_cpu(cuda_device, lidar_name):
    """On the card: within the host bounds of the CPU projection (the
    card's atan2 and sqrt may round differently), a padded batch equal to
    its frames, and repeat calls bit-identical."""
    lidar = LIDARS[lidar_name]
    frames = [clouds(lidar, s)[k] for s in (0, 1) for k in ("scan", "random")]
    n = max(f.shape[0] for f in frames)
    batch = np.zeros((len(frames), n, 3), np.float32)
    for b, f in enumerate(frames):
        batch[b, : f.shape[0]] = f
    out = port_project(batch, lidar, cuda_device)
    np.testing.assert_array_equal(out, port_project(batch, lidar, cuda_device))
    for b, f in enumerate(frames):
        np.testing.assert_array_equal(out[b], port_project(f, lidar, cuda_device))
        assert_within_host_bounds(out[b], port_project(f, lidar))
