"""Dataset template: datalist iteration + projection round-trip (port of
``rpcc_tpu/data/dataset.py``).

Items are ``(point_cloud (H, W, 3), range_image (H, W, 1),
original_point_cloud (N, 3), file_name)``, the point cloud being the
back-projection of the range image.  The projection runs on the dataset's
device (``ops/projection.py``: the card unless the CPU is asked for); the
radius-outlier-removal option is a k-d tree neighbour count (the reference
shells out to open3d, ``dataset.py:29-35``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rpcc_tpu_torch.config import LidarConfig
from rpcc_tpu_torch.data.pointcloud_io import load_point_cloud, save_point_cloud
from rpcc_tpu_torch.models.pipeline import resolve_device
from rpcc_tpu_torch.ops.projection import build_transform_map, project_points, range_image_to_points


def read_datalist(path: str) -> List[str]:
    """The frames of a datalist file: its stripped, non-empty lines."""
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


class PCTransformer:
    """A LidarConfig with its ray table on one device; both methods take
    and return numpy arrays."""

    def __init__(self, lidar_cfg_yaml: Optional[str] = None, channel_distribute_csv: Optional[str] = None,
                 lidar: Optional[LidarConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        if lidar is None:
            lidar = LidarConfig.from_yaml(lidar_cfg_yaml, channel_distribute_csv)
        self.lidar = lidar
        self.H, self.W = lidar.height, lidar.width
        self.transform_map = build_transform_map(lidar)
        self._tm = torch.from_numpy(self.transform_map).to(self.device)
        # The channel table as the reference's dataset builds it (np.radians
        # in float64, then f32).
        self._v_angles = (
            None
            if lidar.even_dist
            else torch.from_numpy(np.radians(np.asarray(lidar.vertical_angles_deg)).astype(np.float32)).to(self.device)
        )

    def point_cloud_to_range_image(self, point_cloud: np.ndarray) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(point_cloud)[:, :3], dtype=torch.float32, device=self.device)
        return project_points(pts, self.lidar, self._v_angles).cpu().numpy()

    def range_image_to_point_cloud(self, range_image: np.ndarray) -> np.ndarray:
        ri = np.asarray(range_image, np.float32)
        if ri.ndim == 3:
            ri = ri[..., 0]
        return range_image_to_points(torch.from_numpy(ri).to(self.device), self._tm).cpu().numpy()


def radius_outlier_removal(pc: np.ndarray, nb_points: int = 3, radius: float = 1.0) -> np.ndarray:
    """Keep points with >= nb_points neighbors within radius (self included,
    open3d ``remove_radius_outlier`` semantics, reference dataset.py:29-35).

    A point has >= k neighbors within r iff its k-th nearest neighbor
    (counting itself) lies within r: one k-NN query with a small k instead
    of a full ball count."""
    pc = np.asarray(pc)
    if pc.shape[0] == 0 or nb_points <= 1:
        return pc
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        return _radius_outlier_removal_naive(pc, nb_points, radius)
    tree = cKDTree(pc[:, :3])
    d, _ = tree.query(pc[:, :3], k=nb_points, distance_upper_bound=np.inf)
    return pc[d[:, nb_points - 1] <= radius]


def _radius_outlier_removal_naive(pc: np.ndarray, nb_points: int = 3, radius: float = 1.0) -> np.ndarray:
    """Grid-hash oracle (quadratic within cells): the tests' reference."""
    from collections import defaultdict

    keys = np.floor(pc[:, :3] / radius).astype(np.int64)
    grid = defaultdict(list)
    for i, k in enumerate(map(tuple, keys)):
        grid[k].append(i)
    keep = np.zeros(pc.shape[0], bool)
    r2 = radius * radius
    for i, k in enumerate(map(tuple, keys)):
        cnt = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((k[0] + dx, k[1] + dy, k[2] + dz), ()):
                        if np.sum((pc[i, :3] - pc[j, :3]) ** 2) <= r2:
                            cnt += 1
                            if cnt >= nb_points:
                                break
                    if cnt >= nb_points:
                        break
                if cnt >= nb_points:
                    break
            if cnt >= nb_points:
                break
        keep[i] = cnt >= nb_points
    return pc[keep]


class DatasetTemplate:
    """A datalist of point-cloud files projected on ``device`` (the card
    unless the CPU is asked for)."""

    def __init__(
        self,
        datalist: Optional[str] = None,
        dataset_cfg: Optional[str] = None,
        channel_distribute_csv: Optional[str] = None,
        use_radius_outlier_removal: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.data_list: List[str] = [] if datalist is None else read_datalist(datalist)
        if dataset_cfg is not None:
            self.dataset_cfg = dataset_cfg
            self.PCTransformer = PCTransformer(dataset_cfg, channel_distribute_csv, device=self.device)
            self.transform_map = self.PCTransformer.transform_map
        self.use_radius_outlier_removal = use_radius_outlier_removal

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int):
        file_name = self.data_list[index]
        original = self.load_data(file_name)
        pc_in = radius_outlier_removal(original) if self.use_radius_outlier_removal else original
        return (*self._round_trip(pc_in), original, file_name)

    def _round_trip(self, pc: np.ndarray):
        range_image = np.expand_dims(self.PCTransformer.point_cloud_to_range_image(pc), -1)
        return self.PCTransformer.range_image_to_point_cloud(range_image), range_image

    def load_data(self, file: str) -> np.ndarray:
        return load_point_cloud(file)

    def load_range_image_points_from_file(self, file: str):
        original = self.load_data(file)
        return (*self._round_trip(original), original)

    def save_point_cloud_to_file(self, file: str, point_cloud: np.ndarray, color=None) -> None:
        save_point_cloud(file, point_cloud.reshape(-1, point_cloud.shape[-1]))


def spot_check_datalist(dataset_cls, datalist: str, lidar_name: str, max_frames: int = 5, device="cuda") -> None:
    """Headless twin of the reference's per-dataset ``__main__`` visual
    checks (``dataset/datasets/kitti_dataset.py:35-55`` and siblings):
    iterate the datalist and print each frame's projection round-trip
    chamfer distance and F1, computed on the dataset's device."""
    from rpcc_tpu_torch.data import __lidar_cfg__, __lidar_csv__
    from rpcc_tpu_torch.metrics import calc_chamfer_distance

    ds = dataset_cls(
        datalist=datalist,
        dataset_cfg=__lidar_cfg__[lidar_name],
        channel_distribute_csv=__lidar_csv__.get(lidar_name),
        device=device,
    )
    for i in range(min(len(ds), max_frames)):
        point_cloud, _ri, original, file_name = ds[i]
        cd = calc_chamfer_distance(point_cloud.reshape(-1, 3), original[:, :3], out=False, device=ds.device)
        print(
            f"{file_name}: {original.shape[0]} pts -> projection round-trip "
            f"chamfer {cd['mean']:.6f}, F1 {cd['f_score']:.4f}"
        )
