"""``cpu_fps``: FPS over the row-major compacted non-ground set with a
per-frame count, held against ``rpcc_tpu`` on the CPU.

Tolerances and why:
  * masked FPS indices are element-identical to
    ``rpcc_tpu.ops.fps.furthest_point_sample_planar_masked`` (the count at
    every edge: none, one, fewer than K, K - 1, part, all), batched too;
  * fed the reference's ground plane (which sidesteps the ground plane's
    ulp gap, ROADMAP 3.4), the segmentation's centres are equal and its seg
    ids show no flip;
  * end to end, the codec's contract: cross-decode both ways within step +
    1e-5 of the encoder's range image, zero pixels exact, bpp within 0.5%
    of the reference's (tests/test_torch_codec.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rpcc_tpu.config import CodecConfig
from rpcc_tpu.models.pipeline import RPCCCodec as RefCodec
from rpcc_tpu.ops import segment as j_segment
from rpcc_tpu.ops.fps import furthest_point_sample_planar_masked as j_masked
from rpcc_tpu.ops.projection import build_transform_planes, project_points_host_u16
from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import fps, prng, segment
from rpcc_tpu_torch.ops.projection_host import build_transform_map
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

K = 32
N = 2048
BPP_TOL = 0.005
_j_masked = jax.jit(j_masked, static_argnums=4)


def _planes(B: int, seed: int) -> np.ndarray:
    """(3, B, N) coordinates with a zeroed block: exact ties."""
    pts = np.random.default_rng(seed).uniform(-30, 30, (3, B, N)).astype(np.float32)
    pts[:, :, N // 4 : N // 3] = 0.0
    return pts


@pytest.mark.parametrize("num_valid", [0, 1, 7, K - 1, 1000, N], ids=["none", "one", "lt_k", "k_minus_1", "part", "all"])
def test_plain_masked_matches_reference(num_valid):
    xs, ys, zs = _planes(1, num_valid)[:, 0]
    ref = np.asarray(_j_masked(xs, ys, zs, jnp.int32(num_valid), K))
    got = fps.furthest_point_sample(
        *(torch.from_numpy(c) for c in (xs, ys, zs)), K, num_valid=torch.tensor(num_valid, dtype=torch.int32)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if num_valid <= 1:
        assert not got.numpy().any()  # with no other valid point, every pick is index 0


def test_plain_masked_batched_per_frame_counts():
    pts = _planes(4, 11)
    counts = np.asarray([0, 5, 900, N], np.int32)
    got = fps.furthest_point_sample(*(torch.from_numpy(p) for p in pts), K, num_valid=torch.from_numpy(counts))
    for b in range(4):
        ref = np.asarray(_j_masked(pts[0, b], pts[1, b], pts[2, b], jnp.int32(counts[b]), K))
        np.testing.assert_array_equal(got[b].numpy(), ref)


def test_masked_wrapper_rejects_bad_counts():
    x = torch.zeros((2, 16))
    with pytest.raises(TypeError):
        fps.furthest_point_sample(x, x, x, 4, num_valid=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        fps.furthest_point_sample(x, x, x, 4, num_valid=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        fps.furthest_point_sample_cuda(x, x, x, 4, torch.zeros(2, dtype=torch.int32))


def _frame(name):
    if name == "small":
        lidar, pc, k = SMALL, synth_scene(seed=3), 16
    else:
        lidar = lidar_config("Velodyne32E", VELODYNE_32E_CSV)
        pc, k = chip_smoke.scene_cloud(np, build_transform_map(lidar), 10), 100
    cfg = CodecConfig(cluster_num=k, cpu_fps=True)
    q, d = project_points_host_u16(pc, lidar, np.float32(cfg.step / 16.0))
    ri = q.astype(np.float32) * d
    tm = build_transform_planes(lidar)
    key = jax.random.split(jax.random.PRNGKey(np.uint32(0)))[0]
    seg, ground, centers = jax.jit(
        lambda p, r, t, kk: j_segment.segment_range_image(p, r, t, kk, cfg.ground_threshold, k, cpu_fps=True)
    )(ri[None] * tm, ri, tm, key)
    return dict(lidar=lidar, cfg=cfg, pc=pc, ri=ri, tm=tm, seg=np.asarray(seg),
                ground=np.asarray(ground), centers=np.asarray(centers))


@pytest.fixture(scope="module", params=["small", "32e-csv"])
def frame(request):
    return _frame(request.param)


def test_segmentation_on_reference_ground_plane(frame, monkeypatch):
    """Centres equal and no seg id flips: the compaction is the reference's
    stable sort, per frame of a (B, HW) batch (frame 1 of a B = 2 batch is
    held too)."""
    ground = torch.from_numpy(frame["ground"].copy())
    monkeypatch.setattr(segment, "fit_ground_plane_planar", lambda xs, *a, **k: ground.expand(xs.shape[0], 4))
    ri = torch.from_numpy(frame["ri"])
    tm = torch.from_numpy(frame["tm"])
    blank = torch.zeros_like(ri)
    ris = torch.stack([blank, ri])  # an empty frame first: its count is 0
    res = segment.segment_range_image(ris[:, None] * tm, ris, tm, prng.prng_key([0, 0], "cpu"),
                                      frame["cfg"].ground_threshold, frame["cfg"].cluster_num, cpu_fps=True)
    np.testing.assert_array_equal(res.centers[1].numpy(), frame["centers"])
    np.testing.assert_array_equal(res.seg_idx[1].numpy(), frame["seg"])
    assert (res.seg_idx[0] == 1).all()  # all zero pixels


@pytest.fixture(scope="module")
def codecs():
    cfg = CodecConfig(cluster_num=16, cpu_fps=True)
    pc = synth_scene(seed=3)
    port, ref = RPCCCodec(SMALL, cfg, "cpu"), RefCodec(SMALL, cfg)
    blob, fields, _ = port.compress(pc)
    ref_blob, ref_fields, _ = ref.compress(pc)
    q, d = port.project(pc)
    return dict(cfg=cfg, pc=pc, port=port, ref=ref, blob=blob, fields=fields, ref_blob=ref_blob,
                ref_fields=ref_fields, ri=q.astype(np.float32) * d)


@pytest.mark.parametrize("route", ["port->port", "port->ref", "ref->port"])
def test_cpu_fps_cross_decode(codecs, route):
    blob = codecs["ref_blob"] if route == "ref->port" else codecs["blob"]
    decoder = codecs["ref"] if route == "port->ref" else codecs["port"]
    _, ri_rec, _ = decoder.decompress(blob)
    assert np.abs(ri_rec - codecs["ri"]).max() <= codecs["cfg"].step + 1e-5
    assert (ri_rec[codecs["ri"] == 0] == 0).all()


def test_cpu_fps_bpp_close_to_reference(codecs):
    bpp = len(codecs["blob"]) * 8 / codecs["fields"]["residual_quantized"].size
    ref_bpp = len(codecs["ref_blob"]) * 8 / codecs["ref_fields"]["residual_quantized"].size
    assert abs(bpp - ref_bpp) <= BPP_TOL * ref_bpp
    assert codecs["port"].compress(codecs["pc"])[0] == codecs["blob"]

