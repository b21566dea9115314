"""The single-frame codec's projection on its device
(``rpcc_tpu_torch/ops/projection_device.py``, kernel ``csrc/raster.cu``)
against the host projection (``ops/projection_host.py::
project_for_encoder``, native ``raster.cpp``): bit for bit, no tolerance.

On the CPU the plain version; on the card the kernel, the plain version
there, and ``RPCCCodec(..., "cuda")``'s payloads against the host
projection's through the same encoder and coder.  Inputs: the sensor
cell's 64E street scenes (``portbench/frames.py``), full and with the far
returns dropped; the 32E channel table and the VLP-16 on their own scan
grids; an xyzi cloud (stride 4) with zero and NaN points and azimuths all
round the seam; no points; points past 164 m (delta set by the farthest
depth, not the step); a narrow field of view (columns outside [0, W));
several points on one pixel, equal depths among them.

The module imports neither jax nor anything from ``tests`` (the card's
machine has a site-installed package of that name).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from portbench import frames as bench_frames
from rpcc_tpu_torch.codec.bitstream import pack_bitstream
from rpcc_tpu_torch.config import CodecConfig
from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import projection_device
from rpcc_tpu_torch.ops.projection_host import cloud_rows, project_for_encoder
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L64 = lidar_config("Velodyne64E")
L32 = lidar_config("Velodyne32E", VELODYNE_32E_CSV)
L16 = lidar_config("VelodyneVLP16")
U16 = CodecConfig()
F32 = CodecConfig(transfer_precision="f32")


@functools.lru_cache(maxsize=None)
def street(k: int, dropped: bool) -> np.ndarray:
    """Sensor-cell scene k of seed 3100000001 (``make_frames``' layout and
    noise draws), its returns past 26 m dropped when ``dropped``."""
    with open(os.path.join(ROOT, "portbench", "configs", "hdl64e_kitti_default.json")) as f:
        tm = bench_frames.transform_map(json.load(f)["lidar"])
    seed = 3100000001
    layout = int(np.random.default_rng([seed, k]).integers(1 << 31))
    r = bench_frames.scene_ranges(tm, layout, np.random.default_rng([seed, k, 1]))
    pc = (tm * r[..., None])[r > 0].reshape(-1, 3).astype(np.float32)
    return np.ascontiguousarray(bench_frames.drop_far(pc, 26.0) if dropped else pc)


def xyzi_cloud() -> np.ndarray:
    """20,001 xyzi rows (N not a multiple of a block): azimuths all round
    the seam, every 7th point at the origin, every 11th with a NaN."""
    rng = np.random.default_rng(5)
    pc = rng.uniform(-60, 60, (20001, 4)).astype(np.float32)
    pc[::7, :3] = 0.0
    pc[3::11, 1] = np.nan
    return pc


def seam_cloud() -> np.ndarray:
    """Points a hair either side of azimuth 0 and of +-pi."""
    eps = np.float32(1e-6)
    az = np.concatenate([np.linspace(-0.01, 0.01, 801), np.pi - np.linspace(0, 0.01, 400),
                         -np.pi + np.linspace(0, 0.01, 400), [eps, -eps, 0.0]])
    el = np.radians(np.linspace(-24.0, 1.5, az.size))
    r = np.linspace(3.0, 70.0, az.size)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1).astype(np.float32)


def far_cloud() -> np.ndarray:
    """Depths up to ~520 m: delta = max depth / 65535 (> step / 16)."""
    return np.random.default_rng(6).uniform(-300, 300, (5000, 3)).astype(np.float32)


def shared_pixels() -> np.ndarray:
    """Each of 3,000 scan points five times: twice as it is (equal depths),
    a hair farther, a hair nearer, and once more in reverse order."""
    base = synth_cloud_for(L64, 3)[:3000]
    return np.concatenate([base, base, base * np.float32(1.0001), base * np.float32(0.9999), base[::-1]])


CASES = {
    "64e_street": (L64, U16, lambda: street(0, False)),
    "64e_street_dropped": (L64, U16, lambda: street(3, True)),
    "64e_street_f32": (L64, F32, lambda: street(1, False)),
    "32e_table": (L32, U16, lambda: synth_cloud_for(L32, 0)),
    "32e_table_f32": (L32, F32, lambda: synth_cloud_for(L32, 1)),
    "vlp16": (L16, U16, lambda: synth_cloud_for(L16, 0)),
    "vlp16_f32": (L16, F32, lambda: synth_cloud_for(L16, 1)),
    "xyzi_nan_zero": (L64, U16, xyzi_cloud),
    "xyzi_nan_zero_32e": (L32, U16, xyzi_cloud),
    "seam": (L64, U16, seam_cloud),
    "seam_32e_f32": (L32, F32, seam_cloud),
    "empty": (L64, U16, lambda: np.zeros((0, 3), np.float32)),
    "empty_f32": (L16, F32, lambda: np.zeros((0, 3), np.float32)),
    "far": (L64, U16, far_cloud),
    "far_32e": (L32, U16, far_cloud),
    "narrow_fov": (dataclasses.replace(L64, name="narrow", horizontal_fov_deg=120.0), U16, xyzi_cloud),
    "narrow_fov_32e": (dataclasses.replace(L32, name="narrow32", horizontal_fov_deg=90.0), U16, xyzi_cloud),
    "shared_pixels": (L64, U16, shared_pixels),
}


def assert_bit_equal(grid: torch.Tensor, delta: torch.Tensor, want_grid: np.ndarray, want_delta, cfg) -> None:
    """``(grid, delta)`` against the host's ``(grid, delta)``, bits and all."""
    got = grid.cpu().numpy()
    if cfg.transfer_precision == "f32":
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want_grid.view(np.int32))
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want_grid.astype(np.int32))
    assert delta.shape == () and delta.dtype == torch.float32
    assert np.float32(delta.item()).tobytes() == np.float32(want_delta).tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_host_projection(case):
    lidar, cfg, make = CASES[case]
    pc = make()
    want = project_for_encoder(pc, lidar, cfg)
    assert_bit_equal(*projection_device.project_plain(torch.from_numpy(pc), lidar, cfg), *want, cfg)


def test_cases_reach_every_branch():
    """The far case's delta comes from its farthest depth, the others' from
    the step; the street scenes fill every pixel and the dropped one not."""
    far_d = project_for_encoder(far_cloud(), L64, U16)[1]
    assert far_d > np.float32(U16.step / 16.0)
    assert project_for_encoder(street(3, False), L64, U16)[1] == np.float32(U16.step / 16.0)
    assert street(0, False).shape[0] == L64.height * L64.width
    assert street(3, True).shape[0] < street(3, False).shape[0]
    assert (project_for_encoder(shared_pixels(), L64, U16)[0] != 0).sum() == 3000


def test_cloud_rows_keep_rows_and_strides():
    """The rows the host projection reads and the card's upload copies: an
    f32 cloud of adjacent columns as it is (xyzi keeps its stride, a view
    of its x, y, z keeps the row stride of 4), any other as its x, y, z."""
    pc = xyzi_cloud()
    rows = cloud_rows(pc)
    assert rows is pc
    rows3 = cloud_rows(pc[:, :3])
    assert rows3.shape == (20001, 3) and rows3.strides == (16, 4) and np.shares_memory(rows3, pc)
    f64 = cloud_rows(pc.astype(np.float64))
    assert f64.dtype == np.float32 and f64.flags.c_contiguous
    np.testing.assert_array_equal(f64, pc)
    odd = cloud_rows(pc.astype(np.float64).astype(np.float32, order="F"))  # columns not adjacent: a copy
    assert odd.shape == (20001, 3) and odd.flags.c_contiguous
    np.testing.assert_array_equal(odd, pc[:, :3])
    with pytest.raises(ValueError):
        cloud_rows(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError):
        cloud_rows(np.zeros(12, np.float32))


def test_workspace_and_kernel_refuse_the_cpu():
    with pytest.raises(ValueError):
        projection_device.Workspace(L64, U16, "cpu")
    with pytest.raises(ValueError):
        projection_device.project_cuda(torch.zeros((1, 3)), None)


def host_path_blob(codec: RPCCCodec, pc: np.ndarray, seed: int) -> bytes:
    """The payload the codec made before it projected on its device: the
    host projection, uploaded, through the same encoder and coder."""
    q, d = project_for_encoder(pc, codec.lidar, codec.cfg)
    q_t = torch.from_numpy(q if q.dtype == np.float32 else q.astype(np.int32)).to(codec.device)
    out = codec.encoder(q_t, torch.tensor(d, dtype=torch.float32, device=codec.device), seed, codec._step_arg)
    fields = codec.fields_from_device(out)
    return pack_bitstream(codec.entropy.compress_dict(fields), uniform=codec.cfg.uniform)


@pytest.mark.parametrize("cfg", [U16, F32], ids=["u16", "f32"])
def test_cpu_codec_projects_on_the_host(cfg):
    """A CPU codec launches nothing and its payloads are the host path's."""
    codec = RPCCCodec(L16, cfg, "cpu")
    assert codec._projection is None
    for s in range(2):
        pc = synth_cloud_for(L16, s)
        before = timer.counters()
        blob, _, _ = codec.compress(pc, seed=s)
        assert "launch.project" not in timer.counters_since(before)
        assert blob == host_path_blob(codec, pc, s)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_projection_device.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_host_projection(cuda_device, case):
    """The kernel twice in one workspace (the second call finds the scratch
    as the first left it), and the plain version on the card."""
    lidar, cfg, make = CASES[case]
    pc = make()
    want = project_for_encoder(pc, lidar, cfg)
    ws = projection_device.Workspace(lidar, cfg, cuda_device)
    pts = ws.upload(pc)
    before = timer.counters()
    for _ in range(2):
        grid, delta = projection_device.project_cuda(pts, ws)
        torch.cuda.synchronize(cuda_device)
        assert_bit_equal(grid, delta, *want, cfg)
    assert timer.counters_since(before)["launch.project"] == 2
    assert bool((ws.scratch == -1).all()) and int(ws.ticket.item()) == 0
    assert_bit_equal(*projection_device.project_plain(pts, lidar, cfg), *want, cfg)


@pytest.mark.cuda
def test_kernel_frames_do_not_leak_into_each_other(cuda_device):
    """A small cloud, a full sweep, a dropped one, an empty one and the
    small one again in one workspace: each equals its own host projection."""
    ws = projection_device.Workspace(L64, U16, cuda_device)
    clouds = [far_cloud(), street(0, False), street(3, True), np.zeros((0, 3), np.float32), far_cloud()]
    outs = [projection_device.project_cuda(ws.upload(pc), ws) for pc in clouds]
    torch.cuda.synchronize(cuda_device)
    for pc, (grid, delta) in zip(clouds, outs):
        assert_bit_equal(grid, delta, *project_for_encoder(pc, L64, U16), U16)


@pytest.mark.cuda
def test_upload_sends_the_rows_through_one_staging_buffer(cuda_device):
    """An xyzi cloud, a view of its x, y, z, a larger f64 cloud (the buffers
    grow) and a smaller one: each arrives as its ``cloud_rows``, contiguous;
    the staging buffers are kept between uploads of no larger clouds."""
    ws = projection_device.Workspace(L64, U16, cuda_device)
    pc = xyzi_cloud()
    buffers = []
    for cloud in (pc, pc[:, :3], street(0, False).astype(np.float64), far_cloud()):
        got = ws.upload(cloud)
        assert got.device == ws.device and got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.cpu().numpy(), cloud_rows(cloud))
        buffers.append(ws.staged)
    assert buffers[0] is buffers[1] and buffers[1] is not buffers[2] and buffers[2] is buffers[3]
    assert ws.staged.is_pinned() and ws.staged.numel() == street(0, False).size


@pytest.mark.cuda
def test_codec_makes_its_workspace_at_its_first_encode(cuda_device):
    """A codec that only decodes holds no projection workspace."""
    enc = RPCCCodec(L16, U16, cuda_device)
    blob = enc.compress(synth_cloud_for(L16, 0))[0]
    assert isinstance(enc._projection, projection_device.Workspace)
    dec = RPCCCodec(L16, U16, cuda_device)
    dec.decompress(blob)
    assert dec._projection is None


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    ws = projection_device.Workspace(L64, U16, cuda_device)
    with pytest.raises(ValueError):
        projection_device.project_cuda(torch.zeros((8, 3)), ws)
    with pytest.raises(ValueError):
        projection_device.project_cuda(torch.zeros((8, 3), dtype=torch.float64, device=cuda_device), ws)
    with pytest.raises(ValueError):
        projection_device.project_cuda(torch.zeros((8, 4), device=cuda_device)[:, :3], ws)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [U16, F32], ids=["u16", "f32"])
def test_codec_payloads_equal_the_host_path(cuda_device, cfg):
    """Eight sweeps through ``compress``: each payload equals the host
    projection's through the same encoder and coder; one projection call
    a sweep, and no capture after the warm-up."""
    codec = RPCCCodec(L64, cfg, cuda_device)
    clouds = [street(k, k % 4 == 3) for k in range(8)]
    for pc in clouds[:2]:  # warm-up: the eager call and the capture
        codec.compress(pc, seed=1)
    before = timer.counters()
    blobs = [codec.compress(pc, seed=100 + k)[0] for k, pc in enumerate(clouds)]
    counts = timer.counters_since(before)
    assert counts["launch.project"] == 8
    assert "graph.captures" not in counts
    for k, (pc, blob) in enumerate(zip(clouds, blobs)):
        assert blob == host_path_blob(codec, pc, 100 + k)
