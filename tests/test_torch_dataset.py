"""The port's dataset layer (``rpcc_tpu_torch/data``) against
``rpcc_tpu/data`` on the CPU: registries and their YAMLs, ``build_dataset``,
``DatasetTemplate`` items, radius outlier removal, the converters and the
spot check.

Tolerances: the registries, LiDAR values, outlier removal and converter
outputs are exact (byte for byte); a dataset item's range image is held to
the JAX package's device-vs-host projection bounds
(tests/test_host_projection.py:127-139; see tests/test_torch_projection.py),
its points are that range image times the ray table exactly, and the
original cloud and file name are equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import rpcc_tpu.data as ref_data
from rpcc_tpu import config as ref_config
from rpcc_tpu.data import dataset as ref_dataset
from rpcc_tpu.data.pointcloud_io import _write_pcd
from rpcc_tpu_torch import data
from rpcc_tpu_torch.config import LidarConfig
from rpcc_tpu_torch.data import dataset
from rpcc_tpu_torch.data.datasets import (
    faro_focus_dataset,
    hkust_dataset,
    kitti_dataset,
    nclt_dataset,
    oxford_dataset,
)
from rpcc_tpu_torch.data.synth import synth_cloud_for

torch.set_num_threads(1)

REGISTRIES = ("__lidar_cfg__", "__lidar_csv__", "__dataset_cfg__", "__dataset_csv__")


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registries_equal_reference(registry):
    mine, ref = getattr(data, registry), getattr(ref_data, registry)
    assert list(mine) == list(ref)
    for key, path in mine.items():
        if path is None:
            assert ref[key] is None
            continue
        assert os.path.basename(path) == os.path.basename(ref[key]) and os.path.isfile(path)
        got = dataclasses.asdict(LidarConfig.from_yaml(path))
        assert got == dataclasses.asdict(ref_config.LidarConfig.from_yaml(ref[key]))
        with open(path, "rb") as a, open(ref[key], "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize(
    "kwargs, cls, height",
    [
        (dict(dataset_name="KITTI"), kitti_dataset.KittiDataset, 64),
        (dict(dataset_name="KITTI_test"), kitti_dataset.KittiDataset, 80),
        (dict(dataset_name="NCLT"), nclt_dataset.NcltDataset, 32),
        (dict(dataset_name="Oxford"), oxford_dataset.OxfordCampusDataset, 32),
        (dict(dataset_name="HKUSTCampus"), hkust_dataset.HkustCampusDataset, 16),
        (dict(lidar_type="Velodyne64E"), dataset.DatasetTemplate, 64),
        (dict(lidar_type="VelodyneVLP16"), dataset.DatasetTemplate, 16),
        ({}, dataset.DatasetTemplate, None),
    ],
    ids=["KITTI", "KITTI_test", "NCLT", "Oxford", "HKUSTCampus", "64E", "VLP16", "bare"],
)
def test_build_dataset_by_name_and_lidar(kwargs, cls, height):
    ds = data.build_dataset(device="cpu", **kwargs)
    ref = ref_data.build_dataset(**kwargs)
    assert type(ds) is cls and type(ref).__name__ == cls.__name__
    assert len(ds) == 0 and ds.device == torch.device("cpu")
    if height is None:
        assert not hasattr(ds, "PCTransformer") and not hasattr(ref, "PCTransformer")
        return
    assert ds.PCTransformer.H == height == ref.PCTransformer.H
    assert dataclasses.asdict(ds.PCTransformer.lidar) == dataclasses.asdict(ref.PCTransformer.lidar)
    np.testing.assert_array_equal(ds.transform_map, ref.transform_map)


def test_faro_focus_dataset_is_a_template():
    assert issubclass(faro_focus_dataset.FaroFocusDataset, dataset.DatasetTemplate)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: data.build_dataset(lidar_type="Velodyne64E"),
                 lambda: dataset.PCTransformer(data.__lidar_cfg__["Velodyne64E"]),
                 lambda: dataset.DatasetTemplate()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _write_frames(tmp_path, clouds):
    paths = []
    for i, pc in enumerate(clouds):
        p = tmp_path / f"{i:06d}.bin"
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], -1).astype(np.float32).tofile(p)
        paths.append(str(p))
    dl = tmp_path / "list.txt"
    dl.write_text("\n".join(paths) + "\n\n")
    return str(dl), paths


def _noisy(pc, seed):
    """Scan-grid points moved off their rays (binning is then not trivial)."""
    rng = np.random.default_rng(seed)
    return (pc + rng.normal(0, 0.05, pc.shape)).astype(np.float32)


@pytest.mark.parametrize("lidar_type", ["VelodyneVLP16", "Velodyne32E"])
def test_dataset_items_match_reference(tmp_path, lidar_type):
    lidar = data.lidar_config(lidar_type)
    dl, paths = _write_frames(tmp_path, [_noisy(synth_cloud_for(lidar, s), s) for s in (0, 1)])
    ds = data.build_dataset(dl, lidar_type=lidar_type, device="cpu")
    ref = ref_data.build_dataset(dl, lidar_type=lidar_type)
    assert len(ds) == len(ref) == 2 and ds.data_list == ref.data_list == paths
    for i in range(len(ds)):
        pc, ri, original, name = ds[i]
        rpc, rri, roriginal, rname = ref[i]
        assert name == rname and ri.shape == rri.shape == (lidar.height, lidar.width, 1)
        np.testing.assert_array_equal(original, roriginal)
        mine, theirs = ri[..., 0], np.asarray(rri)[..., 0]
        assert ((mine > 0) == (theirs > 0)).mean() >= 0.9999
        both = (mine > 0) & (theirs > 0)
        assert np.isclose(mine[both], theirs[both], rtol=2e-6, atol=0).mean() >= 0.999
        np.testing.assert_array_equal(pc, ri * ds.transform_map)
        assert pc.shape == np.asarray(rpc).shape
    pc2, ri2, original2 = ds.load_range_image_points_from_file(paths[0])
    np.testing.assert_array_equal(ri2, ds[0][1])
    np.testing.assert_array_equal(pc2, ds[0][0])


def test_dataset_with_outlier_removal_and_save(tmp_path):
    """With the option, two isolated far returns are removed before the
    projection (they show in the image without it)."""
    lidar = data.lidar_config("VelodyneVLP16")
    pc = synth_cloud_for(lidar, 2)[::5]
    far = np.array([[70.0, 70.0, 1.0], [-75.0, 60.0, 2.0]], np.float32)
    dl, _ = _write_frames(tmp_path, [np.concatenate([pc, far])])
    ds = data.build_dataset(dl, lidar_type="VelodyneVLP16", use_radius_outlier_removal=True, device="cpu")
    ref = ref_data.build_dataset(dl, lidar_type="VelodyneVLP16", use_radius_outlier_removal=True)
    _, ri, original, _ = ds[0]
    _, rri, _, _ = ref[0]
    assert original.shape[0] == pc.shape[0] + 2
    assert ((ri > 0) == (np.asarray(rri) > 0)).mean() >= 0.9999
    without = ds.PCTransformer.point_cloud_to_range_image(pc)[..., None]
    np.testing.assert_array_equal(ri, without)
    plain = data.build_dataset(dl, lidar_type="VelodyneVLP16", device="cpu")[0][1]
    assert (plain > 0).sum() > (without > 0).sum()
    out = tmp_path / "out.bin"
    ds.save_point_cloud_to_file(str(out), ds[0][0])
    ref.save_point_cloud_to_file(str(tmp_path / "ref.bin"), ds[0][0])
    assert out.read_bytes() == (tmp_path / "ref.bin").read_bytes()


# -------------------------------------------------------- outlier removal
@pytest.mark.parametrize("nb_points, radius", [(3, 1.0), (1, 1.0), (5, 0.4)])
def test_radius_outlier_removal_equals_reference_and_naive(nb_points, radius):
    rng = np.random.default_rng(2)
    pc = np.concatenate([rng.normal(0, 0.5, (300, 3)), rng.uniform(20, 40, (20, 3))])
    fast = dataset.radius_outlier_removal(pc, nb_points, radius)
    np.testing.assert_array_equal(fast, ref_dataset.radius_outlier_removal(pc, nb_points, radius))
    np.testing.assert_array_equal(fast, dataset._radius_outlier_removal_naive(pc, nb_points, radius))
    np.testing.assert_array_equal(dataset.radius_outlier_removal(pc[:0]), pc[:0])


# ------------------------------------------------------------- converters
@pytest.fixture()
def cloud():
    rng = np.random.default_rng(0)
    return rng.uniform(-50, 50, (257, 3)).astype(np.float32)


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_nclt_converter_writes_reference_bytes(tmp_path):
    """tests/test_data_io.py::test_nclt_converter's records, through both."""
    from rpcc_tpu.data.datasets.nclt_dataset import NcltDataset as RefNclt

    rng = np.random.default_rng(1)
    xyz_u16 = rng.integers(0, 65535, (100, 3)).astype("<u2")
    rec = np.zeros(100, dtype=[("x", "<u2"), ("y", "<u2"), ("z", "<u2"), ("i", "u1"), ("l", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz_u16.T
    trees = {}
    for tag, cls in (("port", nclt_dataset.NcltDataset), ("ref", RefNclt)):
        root = tmp_path / tag / "nclt_vel" / "2012-01-08" / "velodyne_sync"
        os.makedirs(root)
        (root / "1326030463.bin").write_bytes(rec.tobytes())
        ds = cls(device="cpu") if tag == "port" else cls()
        np.testing.assert_array_equal(ds.load_original_utf8_data(str(root / "1326030463.bin")),
                                      RefNclt().load_original_utf8_data(str(root / "1326030463.bin")))
        ds.preprocess_original_utf8_to_bin_file(str(tmp_path / tag))
        trees[tag] = _tree_bytes(tmp_path / tag)
    assert len(trees["port"]) == 2 and trees["port"] == trees["ref"]
    assert nclt_dataset.NcltDataset.convert(1, 2, 3) == RefNclt.convert(1, 2, 3)


@pytest.mark.parametrize("name, subdir", [
    ("OxfordCampusDataset", "velodyne_points/right"),
    ("HkustCampusDataset", "velodyne_points/data"),
])
def test_pcd_converters_write_reference_bytes(tmp_path, cloud, name, subdir):
    import rpcc_tpu.data.datasets.hkust_dataset as ref_hk
    import rpcc_tpu.data.datasets.oxford_dataset as ref_ox

    trees = {}
    for tag, mods in (("port", (oxford_dataset, hkust_dataset)), ("ref", (ref_ox, ref_hk))):
        cls = getattr(mods[0], name, None) or getattr(mods[1], name)
        d = tmp_path / tag / "seq0" / subdir
        os.makedirs(d)
        _write_pcd(str(d / "scan.pcd"), cloud)
        (cls(device="cpu") if tag == "port" else cls()).preprocess_pcd_to_bin(str(tmp_path / tag))
        trees[tag] = _tree_bytes(tmp_path / tag)
    assert len(trees["port"]) == 2 and trees["port"] == trees["ref"]


def test_kitti_txt_converter_writes_reference_bytes(tmp_path, cloud):
    from rpcc_tpu.data.datasets.kitti_dataset import KittiDataset as RefKitti

    trees = {}
    for tag, ds in (("port", kitti_dataset.KittiDataset(device="cpu")), ("ref", RefKitti())):
        d = tmp_path / tag / "2011_09_26" / "drive" / "sync" / "velodyne_points" / "data"
        os.makedirs(d)
        np.savetxt(str(d / "0000000000.txt"), np.concatenate([cloud, np.full((cloud.shape[0], 1), 0.25)], -1))
        ds.preprocess_txt_to_bin(str(tmp_path / tag), workers=2)
        trees[tag] = _tree_bytes(tmp_path / tag)
    assert len(trees["port"]) == 2 and trees["port"] == trees["ref"]


# -------------------------------------------------------------- spot check
def test_spot_check_datalist_prints_chamfer_and_f1(tmp_path, capsys):
    lidar = data.lidar_config("VelodyneVLP16")
    clouds = [synth_cloud_for(lidar, s)[::7] for s in (0, 1, 2)]
    dl, paths = _write_frames(tmp_path, clouds)
    dataset.spot_check_datalist(dataset.DatasetTemplate, dl, "VelodyneVLP16", max_frames=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line, path, pc in zip(lines, paths, clouds):
        assert line.startswith(f"{path}: {pc.shape[0]} pts") and "chamfer" in line and "F1" in line
