"""The port's host utilities (``rpcc_tpu_torch/utils``): the size helpers
and config loader (against ``rpcc_tpu``'s), and the headless renderers
(the spans and counters of ``utils/timer.py``: ``test_torch_tracing.py``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rpcc_tpu.utils import helpers as ref_helpers
from rpcc_tpu_torch.config import DEFAULT_CODEC_YAML
from rpcc_tpu_torch.utils import helpers

torch.set_num_threads(1)


def test_helpers_equal_reference(tmp_path):
    blob, arr = b"abcdef", np.zeros((3, 5), np.float32)
    for fn, x in (("sys_size", blob), ("bit_size", blob), ("np_size", arr)):
        assert getattr(helpers, fn)(x) == getattr(ref_helpers, fn)(x)
    mine = helpers.load_compressor_cfg(DEFAULT_CODEC_YAML)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref_helpers.load_compressor_cfg(DEFAULT_CODEC_YAML))


def _scene():
    rng = np.random.default_rng(0)
    pc = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    ri = rng.uniform(0, 40, (16, 64)).astype(np.float32)
    return pc, ri


@pytest.mark.parametrize("renderer", ["compare", "range", "keypoints", "segmap", "vangles", "error"])
def test_renderers_write_files(tmp_path, renderer):
    pytest.importorskip("matplotlib")
    from rpcc_tpu_torch.utils import visualize

    pc, ri = _scene()
    path = str(tmp_path / f"{renderer}.png")
    calls = {
        "compare": lambda: visualize.compare_point_clouds(pc, pc + 0.1, save_path=path),
        "range": lambda: visualize.visualize_range_image(ri[..., None], save_path=path),
        "keypoints": lambda: visualize.visualize_key_point_map(ri, (ri > 30).astype(np.int32) * 3, save_path=path),
        "segmap": lambda: visualize.visualize_seg_map((ri // 10).astype(np.int32), save_path=path),
        "vangles": lambda: visualize.visualize_points_vertical_angle_distribution(pc, save_path=path),
        "error": lambda: visualize.visualize_error_colored(pc, pc + 0.05, save_path=path, device="cpu"),
    }
    assert calls[renderer]() == path
    assert os.path.getsize(path) > 0


def test_save_point_cloud_to_pcd(tmp_path):
    from rpcc_tpu.utils import visualize as ref_visualize
    from rpcc_tpu_torch.utils import visualize

    pc, _ = _scene()
    visualize.save_point_cloud_to_pcd(pc.reshape(50, 10, 3), str(tmp_path / "a.pcd"))
    ref_visualize.save_point_cloud_to_pcd(pc.reshape(50, 10, 3), str(tmp_path / "b.pcd"))
    assert (tmp_path / "a.pcd").read_bytes() == (tmp_path / "b.pcd").read_bytes()
