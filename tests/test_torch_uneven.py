"""Unevenly spaced LiDARs (a channel table from a CSV): the port against
``rpcc_tpu`` on the CPU, on the HDL-32E table the repository ships
(32 channels, 32x2250, not cut).

Tolerances and why:
  * the channel table, the ray table and the host projections (exact f32
    and the u16 snap) are bit-equal: the same CSV, float64 math and native
    binning (nearest channel angle, half-even columns);
  * the encoder fed the reference's own range image, with point models
    (FPS and DBSCAN): seg ids, contour and run values element-identical,
    the model table within rtol 1e-4, a quantized residual within 1 and
    only in a cluster whose model row differs (tests/test_torch_codec.py).
    A seg id may flip where two distances tie within ulps (XLA's FMAs,
    ROADMAP 3.2); the scene used has no such pixel.  Plane fits of the
    jitted reference graph differ by more (its FMAs inside RANSAC,
    tests/test_torch_modeling.py), so plane models are held end to end,
    where the rays that ride the stream sort must agree with the
    decoders' ray table for the decode to stay within the bound;
  * end to end, the codec's contract: cross-decode both ways within the
    bound, zero pixels exact, bpp within 0.5% of the reference's; the batch
    engine's blobs equal the single-frame blobs, and the device decoder
    gives the host decoder's floats.
"""

import dataclasses
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from rpcc_tpu import config as ref_config
from rpcc_tpu.config import CodecConfig
from rpcc_tpu.models.pipeline import RPCCCodec as RefCodec
from rpcc_tpu.ops import projection as ref_projection
from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.models.host_decoder import HostDecoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import projection_host
from rpcc_tpu_torch.ops.stream import stream_sort
from rpcc_tpu_torch.parallel.engine import BatchEngine

torch.set_num_threads(1)

LIDAR = lidar_config("Velodyne32E", VELODYNE_32E_CSV)
TM = projection_host.build_transform_map(LIDAR)
BPP_TOL = 0.005
MODES = {
    "point": {},
    "dbscan": dict(segment_method="DBSCAN"),
    "plane-nonuniform": dict(modeling_method="plane", compress_framework="non-uniform"),
}


def bound(cfg) -> float:
    return (cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)) + 1e-5


def assert_encoder_matches(out, ref, num_models: int) -> None:
    """The port's encoder output against the reference graph's on the same
    range image and seed (the tiers of the module docstring)."""
    n, m = int(ref.stream_len), int(ref.seq_len)
    assert int(out.stream_len) == n and int(out.seq_len) == m
    np.testing.assert_array_equal(out.range_image.numpy(), np.asarray(ref.range_image))
    np.testing.assert_array_equal(out.seg_idx.numpy(), np.asarray(ref.seg_idx))
    np.testing.assert_array_equal(out.contour_packed.numpy(), np.asarray(ref.contour_packed))
    np.testing.assert_array_equal(out.sequence.numpy()[:m], np.asarray(ref.sequence)[:m])
    np.testing.assert_allclose(out.model_param.numpy(), np.asarray(ref.model_param), rtol=1e-4, atol=1e-5)
    dq = out.stream.numpy()[:n].astype(np.int32) - np.asarray(ref.stream)[:n]
    order, _ = stream_sort(out.seg_idx.reshape(-1), [], num_models)
    row_differs = (out.model_param.numpy() != np.asarray(ref.model_param)).any(1)
    assert np.abs(dq).max() <= 1
    assert row_differs[order.seg.numpy()[:n][dq != 0]].all()
    if ref.salience is not None:
        np.testing.assert_array_equal(out.salience.numpy(), np.asarray(ref.salience))


def test_channel_table_equals_reference():
    ref = ref_config.LidarConfig.from_yaml(
        os.path.join(ref_config.LIDAR_CFG_DIR, "Velodyne_HDL_32E.yaml"),
        os.path.join(ref_config.LIDAR_CFG_DIR, "example-Velodyne_HDL_32E_vertical_channel_distribution.csv"),
        name="Velodyne32E",
    )
    assert dataclasses.asdict(LIDAR) == dataclasses.asdict(ref)
    assert not LIDAR.even_dist and len(LIDAR.vertical_angles_deg) == LIDAR.height == 32
    np.testing.assert_array_equal(projection_host.build_transform_planes(LIDAR), ref_projection.build_transform_planes(ref))


def _reference_numpy_raster(pc):
    """The reference's numpy binning (``bin_points_host``) and its stable
    keep-nearest scatter: the native pass's twin."""
    depth, idx = ref_projection.bin_points_host(pc, LIDAR)
    ri = np.zeros(LIDAR.height * LIDAR.width, np.float32)
    o = np.argsort(depth, kind="stable")[::-1]
    live = depth[o] > 0
    ri[idx[o][live]] = depth[o][live]
    return ri.reshape(LIDAR.height, LIDAR.width)


@pytest.mark.parametrize("seed", [10, 11])
def test_projections_bit_equal(seed):
    pc = chip_smoke.scene_cloud(np, TM, seed)
    ri = projection_host.project_points_host(pc, LIDAR)
    np.testing.assert_array_equal(ri, ref_projection.project_points_host(pc, LIDAR))
    np.testing.assert_array_equal(ri, _reference_numpy_raster(pc))
    assert (ri > 0).sum() > 0.5 * ri.size
    q, d = projection_host.project_points_host_u16(pc, LIDAR, np.float32(0.04 / 16))
    rq, rd = ref_projection.project_points_host_u16(pc, LIDAR, np.float32(0.04 / 16))
    np.testing.assert_array_equal(q, rq)
    assert d == rd


@functools.lru_cache(maxsize=None)
def _run(mode):
    cfg = CodecConfig(**MODES[mode])
    pc = chip_smoke.scene_cloud(np, TM, 10)
    port, ref = RPCCCodec(LIDAR, cfg, "cpu"), RefCodec(LIDAR, cfg)
    blob, fields, _ = port.compress(pc)
    ref_blob, ref_fields, _ = ref.compress(pc)
    q, d = port.project(pc)
    return dict(cfg=cfg, pc=pc, port=port, ref=ref, blob=blob, fields=fields, ref_blob=ref_blob,
                ref_fields=ref_fields, ri=q.astype(np.float32) * d)


@pytest.fixture(params=list(MODES))
def run(request):
    return _run(request.param)


@pytest.mark.parametrize("mode", ["point", "dbscan"])
def test_encoder_matches_reference_graph(mode):
    run = _run(mode)
    ref_out = run["ref"].encode_device(run["pc"])
    ri = torch.from_numpy(np.array(ref_out.range_image))
    out = run["port"].encoder(ri, torch.tensor(1.0), run["cfg"].seed, run["port"]._step_arg)
    assert_encoder_matches(out, ref_out, run["port"].num_models)


@pytest.mark.parametrize("route", ["port->port", "port->ref", "ref->port"])
def test_cross_decode(run, route):
    blob = run["ref_blob"] if route == "ref->port" else run["blob"]
    decoder = run["ref"] if route == "port->ref" else run["port"]
    _, ri_rec, _ = decoder.decompress(blob)
    assert np.abs(ri_rec - run["ri"]).max() <= bound(run["cfg"])
    assert (ri_rec[run["ri"] == 0] == 0).all()


def test_bpp_close_to_reference(run):
    bpp = len(run["blob"]) * 8 / run["fields"]["residual_quantized"].size
    ref_bpp = len(run["ref_blob"]) * 8 / run["ref_fields"]["residual_quantized"].size
    assert abs(bpp - ref_bpp) <= BPP_TOL * ref_bpp
    assert run["port"].compress(run["pc"])[0] == run["blob"]


def test_device_decoder_equals_host_decoder(run):
    """Both decoders take their rays from the CSV's ray table."""
    _, ri_dev, _ = run["port"].decompress(run["blob"])
    ri_host = HostDecoder(LIDAR, run["cfg"]).decode_blobs([run["blob"]])[0]
    np.testing.assert_array_equal(ri_dev, ri_host)


def test_engine_blobs_equal_single_frame():
    cfg = CodecConfig()
    clouds = [chip_smoke.scene_cloud(np, TM, s) for s in (13, 14)]
    codec = RPCCCodec(LIDAR, cfg, "cpu")
    engine = BatchEngine(LIDAR, cfg, "cpu", batch_size=2, workers=2)
    try:
        blobs = [b for b, _ in engine.encode_frames(clouds, [3, 4])]
        assert blobs == [codec.compress(pc, seed=s)[0] for pc, s in zip(clouds, (3, 4))]
        recs = engine.decode_range_images(blobs)
        np.testing.assert_array_equal(recs, np.stack(HostDecoder(LIDAR, cfg).decode_blobs(blobs)))
    finally:
        engine.close()


def test_datalist_clis_with_the_channel_table_f32_and_cpu(tmp_path):
    """Both datalist CLIs on the 32E table with ``--transfer_precision f32``
    and ``--cpu`` (cpu_fps): the blobs equal the single-frame codec's per
    seed, and both decode backends write the host decoder's points."""
    from rpcc_tpu_torch.cli import compress_datalist, decompress_datalist

    clouds = [chip_smoke.scene_cloud(np, TM, s) for s in (15, 16, 17)]
    paths = [str(tmp_path / f"{i}.bin") for i in range(len(clouds))]
    for path, pc in zip(paths, clouds):
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(path)
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")
    flags = ["--lidar", "Velodyne32E", "--channel_distribute_csv", VELODYNE_32E_CSV, "--transfer_precision", "f32",
             "--cpu", "--batch", "2", "--workers", "2"]
    compress_datalist.main(["--datalist", str(tmp_path / "list.txt"), "--output_dir", str(tmp_path / "out"), *flags])
    outs = [compress_datalist._mirror_path(p, str(tmp_path / "out"), "rpcc") for p in paths]
    cfg = CodecConfig(cpu_fps=True, transfer_precision="f32")
    codec = RPCCCodec(LIDAR, cfg, "cpu")
    blobs = [Path(o).read_bytes() for o in outs]
    assert blobs == [codec.compress(pc, seed=i)[0] for i, pc in enumerate(clouds)]
    (tmp_path / "list2.txt").write_text("\n".join(outs) + "\n")
    want = HostDecoder(LIDAR, cfg).decode_blobs_points(blobs)
    for backend in ("host", "device"):
        rec = str(tmp_path / backend)
        decompress_datalist.main(["--datalist", str(tmp_path / "list2.txt"), "--output_dir", rec,
                                  "--decode_backend", backend, *flags])
        for o, w in zip(outs, want):
            got = np.fromfile(compress_datalist._mirror_path(o, rec, "bin"), np.float32).reshape(-1, 4)
            np.testing.assert_array_equal(got, w)
