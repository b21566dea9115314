"""LiDAR geometry lookup by name, the dataset and LiDAR registries, and the
datalist reader (port of ``rpcc_tpu/data/__init__.py``).

The same names and YAML files as the JAX package's registries; the YAML
files are the port's own copies (``data/lidar_cfg/``).  A channel table
(CSV of ``channel,vertical_angle`` rows, as in the reference's
``dataset/transformer.py``) turns a LiDAR's evenly spaced rows into one
row per listed channel angle; ``VELODYNE_32E_CSV`` is the HDL-32E's.
"""

from __future__ import annotations

import os
from typing import Optional

from rpcc_tpu_torch.config import LIDAR_CFG_DIR, LidarConfig
from rpcc_tpu_torch.data.dataset import DatasetTemplate, PCTransformer, read_datalist  # noqa: F401  (re-export)

LIDAR_YAML = {
    "VelodyneVLP16": "Velodyne_VLP_16.yaml",
    "Velodyne32E": "Velodyne_HDL_32E.yaml",
    "Velodyne64E": "Velodyne_HDL_64E.yaml",
}


VELODYNE_32E_CSV = os.path.join(LIDAR_CFG_DIR, "example-Velodyne_HDL_32E_vertical_channel_distribution.csv")


def _cfg(name: str) -> str:
    return os.path.join(LIDAR_CFG_DIR, name)


__lidar_cfg__ = {name: _cfg(yaml) for name, yaml in LIDAR_YAML.items()}

__lidar_csv__ = {name: None for name in LIDAR_YAML}

__dataset_cfg__ = {
    "KITTI": _cfg("Velodyne_HDL_64E.yaml"),
    "KITTI_test": _cfg("Velodyne_HDL_64E_unofficial.yaml"),
    "NCLT": _cfg("Velodyne_HDL_32E.yaml"),
    "Oxford": _cfg("Velodyne_HDL_32E.yaml"),
    "HKUSTCampus": _cfg("Velodyne_VLP_16.yaml"),
}

__dataset_csv__ = {name: None for name in __dataset_cfg__}


def lidar_config(name: str, csv: Optional[str] = None) -> LidarConfig:
    """``Velodyne64E`` -> the :class:`LidarConfig` of its YAML file, with
    the channel table of the CSV file ``csv`` when given."""
    if name not in LIDAR_YAML:
        raise ValueError(f"unknown lidar {name!r}; choose from {sorted(LIDAR_YAML)}")
    return LidarConfig.from_yaml(__lidar_cfg__[name], csv, name=name)


def _dataset_classes():
    from rpcc_tpu_torch.data.datasets.hkust_dataset import HkustCampusDataset
    from rpcc_tpu_torch.data.datasets.kitti_dataset import KittiDataset
    from rpcc_tpu_torch.data.datasets.nclt_dataset import NcltDataset
    from rpcc_tpu_torch.data.datasets.oxford_dataset import OxfordCampusDataset

    return {
        "KITTI": KittiDataset,
        "KITTI_test": KittiDataset,
        "NCLT": NcltDataset,
        "HKUSTCampus": HkustCampusDataset,
        "Oxford": OxfordCampusDataset,
    }


def build_dataset(
    datalist: Optional[str] = None,
    dataset_name: Optional[str] = None,
    lidar_type: Optional[str] = None,
    use_radius_outlier_removal: bool = False,
    device="cuda",
) -> DatasetTemplate:
    """Name- or LiDAR-keyed factory (reference ``dataset/__init__.py:52-69``)
    of a dataset projected on ``device`` (the card unless the CPU is asked
    for)."""
    if dataset_name is not None:
        cls = _dataset_classes()[dataset_name]
        return cls(datalist, __dataset_cfg__[dataset_name], __dataset_csv__[dataset_name],
                   use_radius_outlier_removal, device)
    if lidar_type is not None:
        return DatasetTemplate(datalist, __lidar_cfg__[lidar_type], __lidar_csv__[lidar_type],
                               use_radius_outlier_removal, device)
    return DatasetTemplate(datalist, dataset_cfg=None, use_radius_outlier_removal=use_radius_outlier_removal,
                           device=device)
