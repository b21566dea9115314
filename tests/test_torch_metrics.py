"""Quality metrics, ``--eval`` and self-describing streams, held against
``rpcc_tpu`` on the CPU.

Tolerances and why:
  * chamfer distance within 1e-6 relative of ``rpcc_tpu.metrics`` and F1
    equal: the nearest neighbour is selected by the same centred expansion
    (its f32 sums may round in another order, which can only swap a
    near-tied neighbour) and its distance recomputed exactly;
  * point-to-point and point-to-plane PSNR within 1e-6 relative (the same
    numpy and scipy code);
  * ``--eval`` on compress and decompress prints the same numbers (the
    decode is exact), within the codec's bound; ``compress_datalist
    --eval`` prints one OK line per frame;
  * a ``--self_describing`` stream of either package decodes in the other's
    decompress CLI with no codec flags and no ``--lidar``, to the same
    points as a decode with the matching flags.
"""

import re
import sys

import numpy as np
import pytest
import torch

from rpcc_tpu import metrics as ref_metrics
from rpcc_tpu.cli import compress as ref_compress
from rpcc_tpu.cli import decompress as ref_decompress
from rpcc_tpu_torch import metrics
from rpcc_tpu_torch.cli import compress, compress_datalist, decompress
from rpcc_tpu_torch.config import CodecConfig
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

LIDAR = "VelodyneVLP16"


def _sparse_frame(seed: int) -> np.ndarray:
    """Every 12th point of a VLP-16 frame: ~2,400 points, so the brute-force
    nearest neighbours of ``--eval`` stay quick on the CPU."""
    return synth_cloud_for(lidar_config(LIDAR), seed)[::12]


def _decoded_pair(seed: int):
    """A frame's encoder range image and its decode as (HW, 3) clouds: the
    near-duplicate clouds ``--eval`` compares."""
    codec = RPCCCodec(SMALL, CodecConfig(cluster_num=16), "cpu")
    pc = synth_scene(seed=seed)
    q, d = codec.project(pc)
    _, ri_rec, _ = codec.decompress(codec.compress(pc)[0])
    tm = codec.transform_map
    return ((q.astype(np.float32) * d)[..., None] * tm).reshape(-1, 3), (ri_rec[..., None] * tm).reshape(-1, 3)


def _random_pair(seed: int):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-40, 40, (3000, 3)).astype(np.float32)
    b = np.concatenate([a[:2500] + rng.normal(0, 0.01, (2500, 3)), rng.uniform(-40, 40, (400, 3))]).astype(np.float32)
    return a, b


PAIRS = {"decoded-0": lambda: _decoded_pair(0), "decoded-4": lambda: _decoded_pair(4), "random": lambda: _random_pair(1)}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_chamfer_matches_reference(pair):
    a, b = PAIRS[pair]()
    got = metrics.calc_chamfer_distance(a, b, out=False, device="cpu")
    ref = ref_metrics.calc_chamfer_distance(a, b, out=False)
    for key in ("mean", "max", "cd1", "cd2"):
        assert got[key] == pytest.approx(ref[key], rel=1e-6, abs=0)
    assert got["f_score"] == ref["f_score"]
    assert (got["precision"], got["recall"]) == (ref["precision"], ref["recall"])


@pytest.mark.parametrize("pair", list(PAIRS))
def test_psnr_matches_reference(pair):
    a, b = PAIRS[pair]()
    got = metrics.calc_point_to_point_plane_psnr(a, b, out=False)
    ref = ref_metrics.calc_point_to_point_plane_psnr(a, b, out=False)
    for g, r in zip(got, ref):
        for key in ("psnr_1", "psnr_2", "psnr_mean", "mse_mean"):
            assert g[key] == pytest.approx(r[key], rel=1e-6, abs=0)


def test_chamfer_chunks_give_the_same_neighbours(monkeypatch):
    a, b = _random_pair(2)
    whole = metrics.nn_distances(a, b, "cpu")
    monkeypatch.setattr(metrics.chamfer, "_BLOCK_ELEMS", 7 * b.shape[0])  # chunks of 7 rows
    for x, y in zip(metrics.nn_distances(a, b, "cpu"), whole):
        np.testing.assert_array_equal(x, y)


def _write_frame(path, pc):
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(path)


_QUALITY = re.compile(r"^\s+(Depth Error \(max\)|Chamfer Distance \(mean\)|F1 score[^:]*|Point-to-Point PSNR[^:]*"
                      r"|Point-to-Plane PSNR[^:]*):\s+(\S+)$", re.M)


def test_eval_on_compress_and_decompress(tmp_path, capsys):
    pc = _sparse_frame(2)
    src, out, rec = tmp_path / "f.bin", tmp_path / "f.rpcc", tmp_path / "r.bin"
    _write_frame(src, pc)
    compress.main(["--input", str(src), "--output", str(out), "--lidar", LIDAR, "--cpu", "--eval"])
    enc = dict(_QUALITY.findall(capsys.readouterr().out))
    decompress.main(["--input", str(out), "--output", str(rec), "--lidar", LIDAR, "--cpu", "--eval",
                     "--original_point_cloud", str(src)])
    dec_out = capsys.readouterr().out
    assert dict(_QUALITY.findall(dec_out)) == enc
    assert len(enc) == 5
    assert float(enc["Depth Error (max)"]) <= CodecConfig().step + 1e-5
    assert float(enc["F1 score (threshold=0.02)"]) > 0.99
    assert "BPP:" in dec_out


def test_decompress_eval_needs_the_original(tmp_path):
    with pytest.raises(SystemExit):
        decompress.main(["--input", str(tmp_path / "f.rpcc"), "--output", str(tmp_path / "r.bin"), "--eval"])


def test_compress_datalist_eval_prints_a_line_per_frame(tmp_path, capsys):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.bin"))
        _write_frame(paths[-1], _sparse_frame(i))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    compress_datalist.main(["--datalist", str(lst), "--output_dir", str(tmp_path / "out"), "--lidar", LIDAR,
                            "--device", "cpu", "--batch", "2", "--workers", "2", "--eval"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("eval ")]
    assert len(lines) == 3 and all(ln.endswith(" OK") for ln in lines)
    assert [ln.split()[1].rstrip(":") for ln in lines] == paths


def _run_reference_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["rpcc", *argv])
    module.main()


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    pc = synth_cloud_for(lidar_config(LIDAR), 4)
    _write_frame(root / "f.bin", pc)
    return root


def test_reference_self_describing_stream_decodes_in_the_port(frame, monkeypatch, capsys):
    blob = frame / "ref.rpcc"
    _run_reference_cli(monkeypatch, ref_compress, ["--input", str(frame / "f.bin"), "--output", str(blob),
                                                   "--lidar", LIDAR, "--self_describing", "--accuracy", "0.03",
                                                   "--model_method", "plane", "--nonuniform"])
    decompress.main(["--input", str(blob), "--output", str(frame / "a.bin"), "--device", "cpu"])
    assert "self-describing bitstream" in capsys.readouterr().out
    _run_reference_cli(monkeypatch, ref_decompress, ["--input", str(blob), "--output", str(frame / "b.bin")])
    np.testing.assert_array_equal(np.fromfile(frame / "a.bin", np.float32), np.fromfile(frame / "b.bin", np.float32))


def test_port_self_describing_stream_decodes_in_the_reference(frame, monkeypatch):
    blob = frame / "port.rpcc"
    compress.main(["--input", str(frame / "f.bin"), "--output", str(blob), "--lidar", LIDAR, "--device", "cpu",
                   "--self_describing", "--segment_method", "DBSCAN", "--cluster_num", "40"])
    _run_reference_cli(monkeypatch, ref_decompress, ["--input", str(blob), "--output", str(frame / "c.bin")])
    decompress.main(["--input", str(blob), "--output", str(frame / "d.bin"), "--device", "cpu"])
    flags = ["--lidar", LIDAR, "--device", "cpu", "--segment_method", "DBSCAN", "--cluster_num", "40"]
    bare = frame / "bare.rpcc"
    compress.main(["--input", str(frame / "f.bin"), "--output", str(bare), *flags])
    assert blob.read_bytes().endswith(bare.read_bytes()) and blob.read_bytes().startswith(b"RPC1")
    decompress.main(["--input", str(bare), "--output", str(frame / "e.bin"), *flags])
    ref_pts = np.fromfile(frame / "c.bin", np.float32)
    np.testing.assert_array_equal(np.fromfile(frame / "d.bin", np.float32), ref_pts)
    np.testing.assert_array_equal(np.fromfile(frame / "e.bin", np.float32), ref_pts)
