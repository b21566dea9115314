"""``transfer_precision``: the port's ``f32`` mode (exact depths, no snap
grid) and the mapping of ``u16``/``i8``/``m8`` onto the u16 snap grid,
held against ``rpcc_tpu`` on the CPU.

Tolerances and why:
  * the f32 host projection is bit-equal to the reference's (the same
    native pass); ``u16``, ``i8`` and ``m8`` give the port's u16 snap grid
    and delta, which the reference's i8/m8 wire codes rebuild exactly;
  * the encoder fed the reference's f32-mode range image: the tiers of
    tests/test_torch_uneven.py::assert_encoder_matches;
  * end to end, the codec's contract (cross-decode both ways within the
    bound, zero pixels exact, bpp within 0.5%); the batch engine's f32
    blobs equal the single-frame blobs; the CLIs round-trip in f32.
"""

import functools

import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.models.pipeline import RPCCCodec as RefCodec
from rpcc_tpu.ops import projection as ref_projection
from rpcc_tpu_torch.cli import compress as cli_compress
from rpcc_tpu_torch.cli import decompress as cli_decompress
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import projection_host
from rpcc_tpu_torch.parallel.engine import BatchEngine
from tests.test_roundtrip import SMALL, synth_scene
from tests.test_torch_uneven import assert_encoder_matches, bound

torch.set_num_threads(1)

BPP_TOL = 0.005
MODES = {"uniform": {}, "nonuniform": dict(compress_framework="non-uniform")}


@pytest.mark.parametrize("lidar", ["small", "Velodyne64E"])
def test_f32_projection_bit_equal(lidar):
    lidar = SMALL if lidar == "small" else lidar_config(lidar)
    pc = synth_scene(seed=1) if lidar is SMALL else synth_cloud_for(lidar, 1)
    ri = projection_host.project_points_host(pc, lidar)
    np.testing.assert_array_equal(ri, ref_projection.project_points_host(pc, lidar))
    grid, delta = projection_host.project_for_encoder(pc, lidar, CodecConfig(transfer_precision="f32"))
    assert grid.dtype == np.float32 and delta == 1.0
    np.testing.assert_array_equal(grid * delta, ri)


@pytest.mark.parametrize("precision", ["u16", "i8", "m8"])
def test_snap_modes_give_the_u16_grid(precision):
    pc = synth_scene(seed=2)
    cfg = CodecConfig(transfer_precision=precision)
    q, d = projection_host.project_for_encoder(pc, SMALL, cfg)
    rq, rd = ref_projection.project_points_host_u16(pc, SMALL, np.float32(cfg.step / 16.0))
    np.testing.assert_array_equal(q, rq)
    assert q.dtype == np.uint16 and d == rd


@functools.lru_cache(maxsize=None)
def _run(mode):
    cfg = CodecConfig(cluster_num=16, transfer_precision="f32", **MODES[mode])
    pc = synth_scene(seed=5)
    port, ref = RPCCCodec(SMALL, cfg, "cpu"), RefCodec(SMALL, cfg)
    blob, fields, _ = port.compress(pc)
    ref_blob, ref_fields, _ = ref.compress(pc)
    q, d = port.project(pc)
    return dict(cfg=cfg, pc=pc, port=port, ref=ref, blob=blob, fields=fields, ref_blob=ref_blob,
                ref_fields=ref_fields, ri=q * d)


@pytest.fixture(params=list(MODES))
def run(request):
    return _run(request.param)


def test_f32_encoder_matches_reference_graph(run):
    ref_out = run["ref"].encode_device(run["pc"])
    np.testing.assert_array_equal(np.asarray(ref_out.range_image), run["ri"])  # no snap on either side
    out = run["port"].encode_device(run["pc"], seed=run["cfg"].seed)
    assert_encoder_matches(out, ref_out, run["port"].num_models)


@pytest.mark.parametrize("route", ["port->port", "port->ref", "ref->port"])
def test_f32_cross_decode(run, route):
    blob = run["ref_blob"] if route == "ref->port" else run["blob"]
    decoder = run["ref"] if route == "port->ref" else run["port"]
    _, ri_rec, _ = decoder.decompress(blob)
    assert np.abs(ri_rec - run["ri"]).max() <= bound(run["cfg"])
    assert (ri_rec[run["ri"] == 0] == 0).all()


def test_f32_bpp_close_to_reference(run):
    bpp = len(run["blob"]) * 8 / run["fields"]["residual_quantized"].size
    ref_bpp = len(run["ref_blob"]) * 8 / run["ref_fields"]["residual_quantized"].size
    assert abs(bpp - ref_bpp) <= BPP_TOL * ref_bpp
    assert run["port"].compress(run["pc"])[0] == run["blob"]


def _f32_engine_run(device_entropy: bool):
    """Host entropy: the single-frame codec's bytes; device entropy: the
    batch-1 engine's."""
    cfg = CodecConfig(cluster_num=16, transfer_precision="f32", device_entropy=device_entropy)
    clouds = [synth_scene(seed=s) for s in range(3)]
    codec = RPCCCodec(SMALL, cfg, "cpu")
    engine = BatchEngine(SMALL, cfg, "cpu", batch_size=2, workers=2)
    try:
        assert all(slot.q.dtype == torch.float32 for slot in engine._ring)  # 4 B/px ring
        work = [(clouds[:2], [7, 8]), (clouds[2:], [9])]
        blobs = [b for res in engine.encode_pipeline(work) for b, _ in res]
        if device_entropy:
            one = BatchEngine(SMALL, cfg, "cpu", batch_size=1, workers=1)
            assert blobs == [one.encode_frames([pc], [s])[0][0] for pc, s in zip(clouds, (7, 8, 9))]
            one.close()
        else:
            assert blobs == [codec.compress(pc, seed=s)[0] for pc, s in zip(clouds, (7, 8, 9))]
        recs = np.concatenate([engine.decode_range_images(blobs[:2]), engine.decode_range_images(blobs[2:])])
        for rec, pc in zip(recs, clouds):
            ri = projection_host.project_points_host(pc, SMALL)
            assert np.abs(rec - ri).max() <= bound(cfg)
    finally:
        engine.close()


def test_f32_engine_blobs_equal_single_frame():
    _f32_engine_run(False)


def test_f32_engine_device_entropy_blobs_equal_batch_one():
    _f32_engine_run(True)


def test_f32_cli_roundtrip(tmp_path):
    lidar = lidar_config("VelodyneVLP16")
    pc = synth_cloud_for(lidar, 3)
    src, out, rec = tmp_path / "f.bin", tmp_path / "f.rpcc", tmp_path / "r.bin"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
    common = ["--lidar", "VelodyneVLP16", "--device", "cpu", "--transfer_precision", "f32"]
    cli_compress.main(["--input", str(src), "--output", str(out), *common])
    cli_decompress.main(["--input", str(out), "--output", str(rec), *common])
    codec = RPCCCodec(lidar, CodecConfig(transfer_precision="f32"), "cpu")
    assert out.read_bytes() == codec.compress(pc)[0]
    pts = np.fromfile(rec, np.float32).reshape(-1, 4)[:, :3]
    pc_dec, ri_rec, _ = codec.decompress(out.read_bytes())
    np.testing.assert_array_equal(pts, pc_dec.reshape(-1, 3)[pc_dec.reshape(-1, 3).sum(-1) != 0])
    assert np.abs(ri_rec - projection_host.project_points_host(pc, lidar)).max() <= bound(codec.cfg)
