"""The port stands alone: no module of ``rpcc_tpu_torch`` (nor
``chip_smoke.py``) imports ``rpcc_tpu`` or ``jax``, the port runs with both
unimportable, its copies of the reference's configuration, framing and
coders give the reference's values and bytes, and its native host library
builds atomically when several processes race to build it."""

import argparse
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpcc_tpu import config as ref_config
from rpcc_tpu.codec import bitstream as ref_bitstream
from rpcc_tpu.codec import entropy as ref_entropy
from rpcc_tpu_torch import config
from rpcc_tpu_torch.cli import common as cli_common
from rpcc_tpu_torch.codec import bitstream, rans_codec
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.data import LIDAR_YAML, VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "rpcc_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "rpcc_tpu_torch")
    found = [
        os.path.relpath(os.path.join(d, f), ROOT)
        for d, _, files in os.walk(pkg)
        for f in files
        if f.endswith(".py")
    ]
    return sorted(found) + ["chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_scan_covers_every_package():
    dirs = {os.path.dirname(p) for p in _port_sources()}
    for sub in ("cli", "codec", "data", "data/datasets", "metrics", "models", "ops", "parallel", "utils"):
        assert os.path.join("rpcc_tpu_torch", sub) in dirs


@pytest.mark.parametrize("path", _port_sources())
def test_source_imports_neither_rpcc_tpu_nor_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"


def _reads_rans_device(tree) -> list:
    """The nodes of a module that could read the reference's device switch:
    the variable's name as a string of its own (an environment key) or a
    ``_RANS_DEVICE`` name or attribute."""
    return [ast.dump(node) for node in ast.walk(tree)
            if (isinstance(node, ast.Constant) and node.value == "RPCC_RANS_DEVICE")
            or (isinstance(node, ast.Name) and node.id == "_RANS_DEVICE")
            or (isinstance(node, ast.Attribute) and node.attr == "_RANS_DEVICE")]


@pytest.mark.parametrize("path", _port_sources())
def test_source_does_not_read_rpcc_rans_device(path):
    """The coder follows its caller's device: no module of the port (nor
    chip_smoke.py) reads RPCC_RANS_DEVICE."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    assert not _reads_rans_device(tree), f"{path} reads RPCC_RANS_DEVICE"
    assert _reads_rans_device(ast.parse('os.environ.get("RPCC_RANS_DEVICE", "cpu")\nm._RANS_DEVICE'))


# The rANS container format's constants and builders, which codec/rans_codec.py owns.
CONTAINER_NAMES = ("ESC_CAP_DEV", "RESID_LANES", "resid_T", "contour_T", "BZD_TRY_MAX_SYMBOLS",
                   "build_ctx_container", "build_bits_container", "compress_seq_u16")


def test_engine_leaves_the_container_format_to_the_codec():
    """The batch engine imports nothing of ops/rans_device.py and names
    none of the containers' constants or builders: the codec owns them."""
    path = os.path.join(ROOT, "rpcc_tpu_torch", "parallel", "engine.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = set(_imported_modules(tree)) | {f"{n.module}.{a.name}" for n in ast.walk(tree)
                                               if isinstance(n, ast.ImportFrom) and n.module for a in n.names}
    assert "rpcc_tpu_torch.ops.rans_device" not in imported
    named = {getattr(n, "id", None) or getattr(n, "attr", None) for n in ast.walk(tree)}
    named |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
    assert not named & set(CONTAINER_NAMES), sorted(named & set(CONTAINER_NAMES))


_BLOCKED_RUN = r"""
import importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "rpcc_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import torch
import rpcc_tpu_torch

torch.set_num_threads(1)
names = [m.name for m in pkgutil.walk_packages(rpcc_tpu_torch.__path__, "rpcc_tpu_torch.")]
for name in names:
    __import__(name)
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec

small = LidarConfig(name="small64", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                    vertical_angle_min_deg=-24.9, height=16, width=256, vertical_angles_deg=ANGLES)
pc = synth_cloud_for(small, 2)
cfg = CodecConfig(cluster_num=16, **MODE)
codec = RPCCCodec(small, cfg, "cpu")
blob, fields, _ = codec.compress(pc)
_, ri, _ = codec.decompress(blob)
q, d = codec.project(pc)
bound = cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)
err = float(np.abs(ri - q.astype(np.float32) * d).max())
assert err <= bound + 1e-5, err
if not MODE and ANGLES is None:  # the engine's device entropy coding too
    from rpcc_tpu_torch.parallel.engine import BatchEngine
    engine = BatchEngine(small, cfg, "cpu", batch_size=2, workers=1)
    assert cfg.device_entropy and engine.encode_batch_device([pc], [0]).out.residual_pieces is not None
    blobs = [b for b, _ in engine.encode_frames([pc, pc], [0, 1])]
    engine.close()
    _, ri2, _ = codec.decompress(blobs[0])
    assert float(np.abs(ri2 - q.astype(np.float32) * d).max()) <= bound + 1e-5
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "jaxlib", "rpcc_tpu")]
assert not loaded, loaded
print("ok", len(names), len(blob))
"""


UNEVEN_ANGLES = tuple(float(a) for a in np.linspace(2.0, -24.9, 16) ** 3 / 24.9 ** 2)  # denser near the top


@pytest.mark.parametrize(
    "mode, angles",
    [({}, None), ({"segment_method": "DBSCAN"}, None), ({"modeling_method": "plane"}, None),
     ({"compress_framework": "non-uniform"}, None), ({"cpu_fps": True}, None),
     ({"transfer_precision": "f32"}, None), ({}, UNEVEN_ANGLES)],
    ids=["default", "dbscan", "plane", "nonuniform", "cpu_fps", "f32", "uneven"],
)
def test_port_runs_with_rpcc_tpu_and_jax_unimportable(mode, angles):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", f"MODE = {mode!r}\nANGLES = {angles!r}\n" + _BLOCKED_RUN],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, n_modules, _ = proc.stdout.split()
    assert ok == "ok" and int(n_modules) > 30


# ------------------------------------------------------- copies == reference
@pytest.mark.parametrize(
    "overrides",
    [{}, {"segment_method": "DBSCAN", "cluster_num": 40, "dbscan_eps": 1.2},
     {"compress_framework": "non-uniform", "modeling_method": "plane", "accuracy": 0.05}],
    ids=["default", "dbscan", "nonuniform-plane"],
)
def test_codec_config_equals_reference(overrides):
    mine, ref = config.CodecConfig(**overrides), ref_config.CodecConfig(**overrides)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.step, mine.level_acc, mine.num_levels, mine.uniform) == (
        ref.step, ref.level_acc, ref.num_levels, ref.uniform
    )


def test_codec_config_yaml_loader_equals_reference():
    path = os.path.join(ROOT, "rpcc_tpu", "cfgs", "compressor.yaml")
    mine = config.CodecConfig.from_yaml(path, accuracy=0.03)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref_config.CodecConfig.from_yaml(path, accuracy=0.03))
    with pytest.raises(ValueError):
        config.CodecConfig(transfer_precision="f16")


@pytest.mark.parametrize("overrides", [{}, {"cluster_num": 40, "transfer_precision": "f32"}], ids=["default", "overrides"])
def test_codec_yaml_copy_loads_like_reference(overrides):
    """The port's own cfgs/compressor.yaml gives the reference default's
    CodecConfig, and the CLIs' default ``--compressor_yaml`` is that copy."""
    assert config.DEFAULT_CODEC_YAML.startswith(os.path.join(ROOT, "rpcc_tpu_torch") + os.sep)
    mine = config.load_codec_config(**overrides)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref_config.load_codec_config(**overrides))
    parser = argparse.ArgumentParser()
    cli_common.add_codec_args(parser)
    assert parser.parse_args(["--input", "a", "--output", "b"]).compressor_yaml == config.DEFAULT_CODEC_YAML


def test_channel_csv_copy_equals_reference():
    name = os.path.basename(VELODYNE_32E_CSV)
    assert os.path.dirname(VELODYNE_32E_CSV) == config.LIDAR_CFG_DIR
    with open(VELODYNE_32E_CSV, "rb") as a, open(os.path.join(ref_config.LIDAR_CFG_DIR, name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(LIDAR_YAML))
def test_lidar_yaml_copy_equals_reference(name):
    fname = LIDAR_YAML[name]
    with open(os.path.join(config.LIDAR_CFG_DIR, fname), "rb") as a, open(
        os.path.join(ref_config.LIDAR_CFG_DIR, fname), "rb"
    ) as b:
        assert a.read() == b.read()
    ref = ref_config.LidarConfig.from_yaml(os.path.join(ref_config.LIDAR_CFG_DIR, fname), name=name)
    mine = lidar_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.horizontal_fov, mine.vertical_max, mine.vertical_min) == (
        ref.horizontal_fov, ref.vertical_max, ref.vertical_min
    )


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
def test_pack_bitstream_bytes_equal_reference(uniform):
    rng = np.random.default_rng(7)
    fields = {name: rng.bytes(int(rng.integers(0, 300))) for name in bitstream.FIELD_ORDER}
    blob = bitstream.pack_bitstream(fields, uniform)
    assert blob == ref_bitstream.pack_bitstream(fields, uniform)
    assert bitstream.unpack_bitstream(blob, uniform) == ref_bitstream.unpack_bitstream(blob, uniform)
    head = bitstream.pack_header(uniform, 0.02, "FPS", 100, "point", "rans", "Velodyne64E")
    assert head == ref_bitstream.pack_header(uniform, 0.02, "FPS", 100, "point", "rans", "Velodyne64E")
    assert bitstream.unpack_header(head + blob) == ref_bitstream.unpack_header(head + blob)


def _payload(kind):
    rng = np.random.default_rng(11)
    if kind == "residual_i16":
        return np.round(rng.normal(0, 40, (64, 2000))).astype(np.int16)
    if kind == "contour_u8":
        return np.packbits(rng.random(64 * 2000) < 0.05)
    if kind == "random_i8":
        return rng.integers(0, 50, (64, 2000)).astype(np.int8)  # the coder self-test's payload
    return np.zeros(0, np.uint16)


@pytest.mark.parametrize("method", ["lz4", "bzip2", "gzip", "deflate"])
@pytest.mark.parametrize("kind", ["residual_i16", "contour_u8", "random_i8", "empty"])
def test_non_rans_coder_bytes_equal_reference(method, kind):
    data = _payload(kind)
    mine = BasicCompressor(method_name=method)
    ref = ref_entropy.BasicCompressor(method_name=method)
    blob = mine.compress(data)
    assert blob == ref.compress(data)
    assert mine.decompress(blob) == ref.decompress(blob) == data.tobytes()


def test_unknown_coder_raises():
    with pytest.raises(ValueError):
        BasicCompressor(method_name="zstd")


# ----------------------------------------------------------- host library
_BUILD_AND_USE = r"""
import sys
import numpy as np
from rpcc_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = sys.argv[1]
from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.codec.native import native_lib
lib = native_lib()
arr = np.arange(-500, 500, dtype=np.int16)
assert rans_codec.decompress(rans_codec.compress(arr)) == arr.tobytes()
lz4 = BasicCompressor(method_name="lz4")
assert lz4.decompress(lz4.compress(arr)) == arr.tobytes()
print(lib._name)
"""


def test_concurrent_fresh_builds_all_load(tmp_path):
    """Four processes build the host library into one empty directory at
    once; each loads a complete library, and one file is left."""
    build_dir = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE, build_dir], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(build_dir) == [os.path.basename(paths.pop())]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="error"):
        cuda_build.build_library("broken", [str(src)], [["g++", "-shared", "-fPIC"], ["g++", "-shared"]])
    assert sorted(os.listdir(tmp_path)) == ["broken.cpp"]  # no temporary file left behind


def test_rans_containers_on_the_port_library_equal_reference():
    from rpcc_tpu.codec import rans_codec as ref_rans

    rng = np.random.default_rng(3)
    arr = np.round(rng.normal(0, 30, 70000)).astype(np.int16)
    assert rans_codec.compress(arr) == ref_rans.compress(arr)
    packed = np.packbits(rng.random(64 * 2000) < 0.03)
    assert rans_codec.compress_contour(packed, 64, 2000) == ref_rans.compress_contour(packed, 64, 2000)


# ------------------------------------------------------ entry-point devices
def test_cli_device_defaults_to_cuda():
    parser = argparse.ArgumentParser()
    cli_common.add_codec_args(parser)
    args = parser.parse_args(["--input", "a", "--output", "b", "--lidar", "Velodyne64E"])
    assert args.device == "cuda"


@pytest.mark.parametrize("entry", ["codec", "engine"])
def test_entry_points_default_to_the_card(entry):
    """Without a card the default raises instead of falling back to the CPU."""
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    small = config.LidarConfig(name="small64", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                               vertical_angle_min_deg=-24.9, height=16, width=256)
    make = (lambda: RPCCCodec(small, config.CodecConfig())) if entry == "codec" else (
        lambda: BatchEngine(small, config.CodecConfig(), batch_size=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        return
    obj = make()
    assert obj.device.type == "cuda"
    if entry == "engine":
        obj.close()
