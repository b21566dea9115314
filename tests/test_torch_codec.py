"""The port's single-frame codec against ``rpcc_tpu`` end to end (CPU).

Held to the codec's contract (tests/test_roundtrip.py): max |decoded -
encoder range image| <= step + 1e-5 (step + max(level_delta_acc) + 1e-5 in
non-uniform mode) and zero pixels decode to exactly 0, for port -> port,
port blob -> ``rpcc_tpu`` decoder and ``rpcc_tpu`` blob -> port decoder;
bpp within 0.5% of the reference's.  Byte equality of the blobs is
reported, not asserted: FMA contraction in XLA's CPU code can move an FPS
tie, a plane or a residual's rounding (see tests/test_torch_ops.py).
"""

import argparse
import dataclasses
import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from rpcc_tpu.cli import common as ref_cli
from rpcc_tpu.config import CodecConfig
from rpcc_tpu.models.encoder import build_encode_fn
from rpcc_tpu.models.pipeline import RPCCCodec as RefCodec
from rpcc_tpu.ops.projection import build_transform_planes
from rpcc_tpu_torch.cli import common as cli_common
from rpcc_tpu_torch.cli import compress as cli_compress
from rpcc_tpu_torch.cli import decompress as cli_decompress
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.encoder import Encoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops.stream import stream_sort
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

BPP_TOL = 0.005


MODES = {
    "small": {},
    "small-dbscan": dict(segment_method="DBSCAN"),
    "small-plane": dict(modeling_method="plane"),
    "small-nonuniform": dict(compress_framework="non-uniform"),
    "small-combined": dict(segment_method="DBSCAN", modeling_method="plane", compress_framework="non-uniform"),
}


def _case(name):
    if name in MODES:
        return SMALL, CodecConfig(cluster_num=16, **MODES[name]), synth_scene(seed=0)
    lidar = lidar_config("Velodyne64E")
    return lidar, CodecConfig(), synth_cloud_for(lidar, 2)


def _bound(cfg):
    return (cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)) + 1e-5


@pytest.fixture(scope="module", params=["64e", *MODES])
def case(request):
    lidar, cfg, pc = _case(request.param)
    port, ref = RPCCCodec(lidar, cfg, "cpu"), RefCodec(lidar, cfg)
    blob, fields, _ = port.compress(pc)
    ref_blob, ref_fields, _ = ref.compress(pc)
    q, d = port.project(pc)
    return dict(cfg=cfg, pc=pc, port=port, ref=ref, blob=blob, fields=fields,
                ref_blob=ref_blob, ref_fields=ref_fields, ri=q.astype(np.float32) * d)


@pytest.mark.parametrize("route", ["port->port", "port->ref", "ref->port"])
def test_roundtrip_and_cross_decode(case, route):
    blob = case["ref_blob"] if route == "ref->port" else case["blob"]
    decoder = case["ref"] if route == "port->ref" else case["port"]
    pc_rec, ri_rec, _ = decoder.decompress(blob)
    ri = case["ri"]
    assert np.abs(ri_rec - ri).max() <= _bound(case["cfg"])
    assert (ri_rec[ri == 0] == 0).all()
    assert pc_rec.shape == ri.shape + (3,)


def test_bpp_close_to_reference(case):
    bpp = len(case["blob"]) * 8 / case["fields"]["residual_quantized"].size
    ref_bpp = len(case["ref_blob"]) * 8 / case["ref_fields"]["residual_quantized"].size
    sha = lambda b: hashlib.sha256(b).hexdigest()[:12]  # noqa: E731
    print(f"bpp port {bpp:.5f} ref {ref_bpp:.5f}; sha port {sha(case['blob'])} "
          f"ref {sha(case['ref_blob'])} equal={case['blob'] == case['ref_blob']}")
    assert abs(bpp - ref_bpp) <= BPP_TOL * ref_bpp


def test_repeat_encode_is_byte_identical(case):
    assert case["port"].compress(case["pc"])[0] == case["blob"]


def test_encoder_module_matches_reference_graph():
    """The encoder on the reference's own ray table and range image:
    seg map, contour and run values element-identical, model table within
    f32 tolerance; a residual may differ by 1, and only in a cluster whose
    model row differs (a value within that difference of a .5 boundary)."""
    cfg = CodecConfig(cluster_num=16)
    port = RPCCCodec(SMALL, cfg, "cpu")
    q, d = port.project(synth_scene(seed=5))
    enc = Encoder(SMALL, cfg, build_transform_planes(SMALL))
    out = enc(torch.from_numpy(q.astype(np.int32)), torch.tensor(d), 3, cfg.step)
    ref = jax.jit(build_encode_fn(SMALL, cfg, from_ri=True))(q.astype(np.float32) * d, np.uint32(3), np.float32(cfg.step))
    n, m = int(ref.stream_len), int(ref.seq_len)
    assert int(out.stream_len) == n and int(out.seq_len) == m
    np.testing.assert_array_equal(out.range_image.numpy(), np.asarray(ref.range_image))
    np.testing.assert_array_equal(out.seg_idx.numpy(), np.asarray(ref.seg_idx))
    dq = out.stream.numpy()[:n].astype(np.int32) - np.asarray(ref.stream)[:n]
    order, _ = stream_sort(out.seg_idx.reshape(-1), [], port.num_models)
    row_differs = (out.model_param.numpy() != np.asarray(ref.model_param)).any(1)
    assert np.abs(dq).max() <= 1
    assert row_differs[order.seg.numpy()[:n][dq != 0]].all()
    np.testing.assert_array_equal(out.contour_packed.numpy(), np.asarray(ref.contour_packed))
    np.testing.assert_array_equal(out.sequence.numpy()[:m], np.asarray(ref.sequence)[:m])
    np.testing.assert_allclose(out.model_param.numpy(), np.asarray(ref.model_param), rtol=1e-4, atol=1e-5)
    assert out.stream.dtype == torch.int16 and out.sequence.dtype == torch.uint16


def test_cluster_id_limit():
    with pytest.raises(ValueError):
        RPCCCodec(SMALL, CodecConfig(cluster_num=4094), "cpu")


CSV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rpcc_tpu", "data", "lidar_cfg",
                   "example-Velodyne_HDL_32E_vertical_channel_distribution.csv")
CODEC_YAML = """compress_framework: 'non-uniform'
accuracy: 0.05
segment_method: 'DBSCAN'
cluster_num: 50
cpu_fps: true
transfer_precision: 'u16'
"""


@pytest.mark.parametrize("flags", [
    [],
    ["--segment_method", "DBSCAN", "--cluster_num", "40", "--DBSCAN_eps", "0.8"],
    ["--model_method", "plane", "--angle_threshold", "60", "--accuracy", "0.05"],
    ["--nonuniform", "--basic_compressor", "bzip2", "--seed", "9"],
    ["--cpu"],
    ["--transfer_precision", "f32"],
    ["--compressor_yaml", "{yaml}", "--cluster_num", "30"],
    ["--lidar", "Velodyne32E", "--channel_distribute_csv", CSV],
], ids=["defaults", "dbscan", "plane", "nonuniform", "cpu", "transfer_precision", "compressor_yaml",
        "channel_distribute_csv"])
def test_cli_flags_map_like_reference(flags, tmp_path):
    """The port's flags land on the same CodecConfig knobs and LiDAR as
    the reference's CLI."""
    yaml_path = tmp_path / "codec.yaml"
    yaml_path.write_text(CODEC_YAML)
    flags = [str(yaml_path) if f == "{yaml}" else f for f in flags]
    base = ["--lidar", "Velodyne64E"]
    parser = argparse.ArgumentParser()
    cli_common.add_codec_args(parser)
    args = parser.parse_args(["--input", "a", "--output", "b", "--device", "cuda", *base, *flags])
    cfg = cli_common.config_from_args(args)
    ref_parser = argparse.ArgumentParser()
    ref_cli.add_codec_args(ref_parser)
    ref_args = ref_parser.parse_args([*base, *flags])
    ref = ref_cli.config_from_args(ref_args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cli_common.lidar_from_args(args)) == dataclasses.asdict(ref_cli.lidar_from_args(ref_args))
    assert cli_common.device_from_args(args) == ("cpu" if "--cpu" in flags else "cuda")


def test_cli_roundtrip_cpu(tmp_path, capsys):
    lidar = lidar_config("Velodyne64E")
    pc = synth_cloud_for(lidar, 1)
    src, out, rec = tmp_path / "f.bin", tmp_path / "f.rpcc", tmp_path / "r.bin"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
    common = ["--lidar", "Velodyne64E", "--device", "cpu"]
    cli_compress.main(["--input", str(src), "--output", str(out), *common])
    cli_decompress.main(["--input", str(out), "--output", str(rec), *common])
    assert "BPP:" in capsys.readouterr().out
    codec = RPCCCodec(lidar, CodecConfig(), "cpu")
    pc_dec, ri_rec, _ = codec.decompress(out.read_bytes())
    q, d = codec.project(pc)
    assert np.abs(ri_rec - q.astype(np.float32) * d).max() <= CodecConfig().step + 1e-5
    pts = pc_dec.reshape(-1, 3)
    np.testing.assert_array_equal(np.fromfile(rec, np.float32).reshape(-1, 4)[:, :3], pts[pts.sum(-1) != 0])
