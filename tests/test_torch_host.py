"""Host side of the port: ray tables, u16 projection and rANS containers
against ``rpcc_tpu``, and the port's independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpcc_tpu.codec import rans_codec as ref_rans
from rpcc_tpu.config import CodecConfig
from rpcc_tpu.ops import projection as ref_proj
from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.data import LIDAR_YAML, lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.ops import projection_host
from tests.test_roundtrip import SMALL, synth_scene

import bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(LIDAR_YAML))
def test_transform_tables_bit_equal(name):
    lidar = lidar_config(name)
    np.testing.assert_array_equal(projection_host.build_transform_map(lidar), ref_proj.build_transform_map(lidar))
    np.testing.assert_array_equal(
        projection_host.build_transform_planes(lidar), ref_proj.build_transform_planes(lidar)
    )


def test_synth_cloud_matches_bench():
    lidar = lidar_config("Velodyne64E")
    np.testing.assert_array_equal(synth_cloud_for(lidar, 3), bench.synth_cloud_for(lidar, 3))


@pytest.mark.parametrize("scene", ["small", "64e"])
def test_u16_projection_bit_equal(scene):
    if scene == "small":
        lidar, pc = SMALL, synth_scene(seed=2)
    else:
        lidar = lidar_config("Velodyne64E")
        pc = synth_cloud_for(lidar, 1)
        pc = np.concatenate([pc, np.ones((pc.shape[0], 1), np.float32)], 1)  # (N, 4) stride path
    floor = np.float32(CodecConfig().step / 16.0)
    q_ref, d_ref = ref_proj.project_points_host_u16(pc, lidar, floor)
    q, d = projection_host.project_points_host_u16(pc, lidar, floor)
    assert q.dtype == np.uint16 and d == d_ref
    np.testing.assert_array_equal(q, q_ref)


def _fields(lidar, pc):
    """Bitstream fields of one frame from the reference encoder."""
    from rpcc_tpu.models.pipeline import RPCCCodec

    codec = RPCCCodec(lidar, CodecConfig())
    return codec.fields_from_device(codec.encode_device(pc))


@pytest.fixture(scope="module")
def frame_fields():
    lidar = lidar_config("Velodyne64E")
    return {
        "small": (SMALL, _fields(SMALL, synth_scene(seed=1))),
        "64e": (lidar, _fields(lidar, synth_cloud_for(lidar, 0))),
    }


@pytest.mark.parametrize("scene", ["small", "64e"])
@pytest.mark.parametrize("field", ["residual_quantized", "idx_sequence", "contour_map", "plane_param"])
def test_rans_containers_byte_equal_and_cross_decode(frame_fields, scene, field):
    lidar, fields = frame_fields[scene]
    arr = fields[field]
    if field == "contour_map":
        blob = rans_codec.compress_contour(arr, lidar.height, lidar.width)
        assert blob == ref_rans.compress_contour(arr, lidar.height, lidar.width)
    else:
        blob = rans_codec.compress(arr)
        assert blob == ref_rans.compress(arr)
    assert rans_codec.decompress(blob) == ref_rans.decompress(blob) == arr.tobytes()


@pytest.mark.parametrize("method", ["rans", "bzip2", "lz4", "deflate"])
def test_basic_compressor_dict_roundtrip(frame_fields, method):
    from rpcc_tpu.codec.entropy import BasicCompressor as RefCompressor

    lidar, fields = frame_fields["small"]
    shape = (lidar.height, lidar.width)
    comp = BasicCompressor(method_name=method, contour_shape=shape).compress_dict(fields)
    assert comp == RefCompressor(method_name=method, contour_shape=shape).compress_dict(fields)
    back = BasicCompressor(method_name=method, contour_shape=shape).decompress_dict(comp)
    assert back == {k: v.tobytes() for k, v in fields.items()}


@pytest.fixture(scope="module")
def nonuniform_fields():
    """Fields of one non-uniform frame from the reference encoder."""
    from rpcc_tpu.models.pipeline import RPCCCodec

    codec = RPCCCodec(SMALL, CodecConfig(cluster_num=16, compress_framework="non-uniform"))
    return codec.fields_from_device(codec.encode_device(synth_scene(seed=1)))


@pytest.mark.parametrize("method", ["rans", "bzip2", "lz4", "deflate"])
def test_salience_field_byte_equal(nonuniform_fields, method):
    """The u8 salience_level field is coded as the reference codes it."""
    from rpcc_tpu.codec.entropy import BasicCompressor as RefCompressor

    fields = nonuniform_fields
    assert fields["salience_level"].dtype == np.uint8 and fields["salience_level"].size == 18
    shape = (SMALL.height, SMALL.width)
    comp = BasicCompressor(method_name=method, contour_shape=shape).compress_dict(fields)
    assert comp == RefCompressor(method_name=method, contour_shape=shape).compress_dict(fields)
    back = BasicCompressor(method_name=method, contour_shape=shape).decompress_dict(comp)
    assert back["salience_level"] == fields["salience_level"].tobytes()


def test_escape_heavy_stream_roundtrips():
    rng = np.random.default_rng(5)
    arr = (rng.standard_normal(40000) * 3000).astype(np.int16)  # many |delta| escapes
    blob = rans_codec.compress(arr)
    assert blob == ref_rans.compress(arr)
    assert rans_codec.decompress(blob) == arr.tobytes()


@pytest.mark.parametrize(
    "sizes, hw",
    [((500, 3000, 1200), (16, 128)), ((40000, 90000, 128000), (64, 2000)), ((1000, 60000), (16, 128))],
    ids=["small", "big", "mixed"],
)
def test_batch_coders_byte_equal_to_reference(sizes, hw):
    """The engine's batch entry points give ``rpcc_tpu``'s containers and
    bytes on ragged batches (frames of different lengths)."""
    rng = np.random.default_rng(sum(sizes))
    arrays = [np.cumsum(rng.integers(-40, 41, n)).astype(np.int16) for n in sizes]
    blobs = rans_codec.compress_delta_batch(arrays)
    assert blobs == ref_rans.compress_delta_batch(arrays)
    back = rans_codec.decompress_delta_batch(blobs)
    assert back == ref_rans.decompress_delta_batch(blobs) == [a.tobytes() for a in arrays]

    H, W = hw
    packs = [np.packbits(rng.random(H * W) < p) for p in (0.02, 0.1, 0.3)[: len(sizes)]]
    cblobs = rans_codec.compress_contour_batch(packs, H, W)
    assert cblobs == ref_rans.compress_contour_batch(packs, H, W)
    fields = [{"residual_quantized": b, "contour_map": c} for b, c in zip(blobs, cblobs)]
    got, ref = rans_codec.batch_decode_big_fields(fields), ref_rans.batch_decode_big_fields(fields)
    assert got == ref and got[0] == [a.tobytes() for a in arrays]
    if got[1] is not None:  # every frame took the 'N' container
        assert got[1] == rans_codec.decompress_contour_batch(cblobs) == [p.tobytes() for p in packs]


_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import rpcc_tpu_torch.models.pipeline as pipeline
import rpcc_tpu_torch.cli.compress, rpcc_tpu_torch.cli.decompress
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data.synth import synth_cloud_for
small = LidarConfig(name="small64", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                    vertical_angle_min_deg=-24.9, height=16, width=256)
pc = synth_cloud_for(small, 2)
for mode in ({}, dict(segment_method="DBSCAN"), dict(modeling_method="plane"),
             dict(compress_framework="non-uniform")):
    cfg = CodecConfig(cluster_num=16, **mode)
    codec = pipeline.RPCCCodec(small, cfg, "cpu")
    blob, fields, times = codec.compress(pc)
    _, ri, _ = codec.decompress(blob)
    q, d = codec.project(pc)
    bound = cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)
    assert np.abs(ri - q.astype(np.float32) * d).max() <= bound + 1e-5
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("ok", len(blob))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "rpcc_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, f
