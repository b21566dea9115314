"""KITTI dataset (Velodyne HDL-64E) + raw-txt preprocessing.

Equivalent of reference ``dataset/datasets/kitti_dataset.py``: a thin
DatasetTemplate plus a txt->bin converter for unsynced KITTI raw dumps.
"""

import concurrent.futures as futures
import glob
import os

import numpy as np

from rpcc_tpu_torch.data.dataset import DatasetTemplate


class KittiDataset(DatasetTemplate):
    def preprocess_txt_to_bin(self, data_root: str, workers: int = 4) -> None:
        """Convert slow-loading raw txt scans to float32 Nx4 .bin files."""
        file_list = sorted(
            glob.glob(os.path.join(data_root, "*/*/*/velodyne_points/data/*.txt"))
        )

        def save_txt_to_bin(file):
            save_path = file.replace(
                "/velodyne_points/data/", "/velodyne_points/data_bin/"
            ).replace(".txt", ".bin")
            os.makedirs(os.path.dirname(save_path), exist_ok=True)
            np.loadtxt(file).astype(np.float32).tofile(save_path)

        with futures.ThreadPoolExecutor(workers) as ex:
            list(ex.map(save_txt_to_bin, file_list))


if __name__ == "__main__":
    # Spot-check harness (reference dataset/datasets/kitti_dataset.py:35-55):
    # iterate a datalist, print the projection round-trip chamfer distance
    # per frame (headless: numbers in place of the open3d viewer).
    import argparse

    from rpcc_tpu_torch.data.dataset import spot_check_datalist

    p = argparse.ArgumentParser()
    p.add_argument("--datalist", required=True)
    p.add_argument("--lidar", default="Velodyne64E")
    p.add_argument("--max_frames", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    spot_check_datalist(KittiDataset, a.datalist, a.lidar, a.max_frames, a.device)
