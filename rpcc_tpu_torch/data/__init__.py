"""LiDAR geometry lookup by name, and the datalist reader.

The same names and YAML files as ``rpcc_tpu.data.__lidar_cfg__``; the
YAML files are the port's own copies (``data/lidar_cfg/``).  A channel
table (CSV of ``channel,vertical_angle`` rows, as in the reference's
``dataset/transformer.py``) turns a LiDAR's evenly spaced rows into one
row per listed channel angle; ``VELODYNE_32E_CSV`` is the HDL-32E's.
"""

from __future__ import annotations

import os
from typing import List, Optional

from rpcc_tpu_torch.config import LIDAR_CFG_DIR, LidarConfig

LIDAR_YAML = {
    "VelodyneVLP16": "Velodyne_VLP_16.yaml",
    "Velodyne32E": "Velodyne_HDL_32E.yaml",
    "Velodyne64E": "Velodyne_HDL_64E.yaml",
}


VELODYNE_32E_CSV = os.path.join(LIDAR_CFG_DIR, "example-Velodyne_HDL_32E_vertical_channel_distribution.csv")


def lidar_config(name: str, csv: Optional[str] = None) -> LidarConfig:
    """``Velodyne64E`` -> the :class:`LidarConfig` of its YAML file, with
    the channel table of the CSV file ``csv`` when given."""
    if name not in LIDAR_YAML:
        raise ValueError(f"unknown lidar {name!r}; choose from {sorted(LIDAR_YAML)}")
    return LidarConfig.from_yaml(os.path.join(LIDAR_CFG_DIR, LIDAR_YAML[name]), csv, name=name)


def read_datalist(path: str) -> List[str]:
    """The frames of a datalist file: its stripped, non-empty lines
    (``rpcc_tpu/data/dataset.py:121-124``)."""
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]
