"""The frames: the same for the same seed, different across seeds (scenes
and order), the same amount of work for every seed, on the program's own
rays."""

import numpy as np
import pytest

from portbench import bench, frames

SPEC = bench.load_benchmark()
CONFIGS = [bench.load_config(SPEC, c["name"]) for c in SPEC["configs"]]
TRAFFIC = {"frames": 4, "drop_far_every": 4, "drop_far_m": 26.0}


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_frames_are_the_same_for_a_seed_and_differ_across_seeds(cfg):
    a = frames.make_frames(cfg["lidar"], TRAFFIC, 2**31 + 5)
    b = frames.make_frames(cfg["lidar"], TRAFFIC, 2**31 + 5)
    c = frames.make_frames(cfg["lidar"], {**TRAFFIC, "frames": 32}, 2**31 + 6)
    d = frames.make_frames(cfg["lidar"], {**TRAFFIC, "frames": 32}, 2**31 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(a.clouds, b.clouds))
    assert np.array_equal(a.order, b.order) and sorted(a.order.tolist()) == list(range(4))
    assert all(not np.array_equal(x[: y.shape[0]], y[: x.shape[0]]) for x, y in zip(c.clouds, d.clouds))
    assert not np.array_equal(c.order, d.order) and sorted(d.order.tolist()) == list(range(32))
    assert all(not np.array_equal(x[: y.shape[0]], y[: x.shape[0]]) for x, y in zip(a.clouds, a.clouds[1:]))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_every_seed_gets_the_same_work(cfg):
    hw = cfg["lidar"]["height"] * cfg["lidar"]["width"]
    for seed in (1, 2**31 + 11, 2**33 + 3):
        fs = frames.make_frames(cfg["lidar"], {**TRAFFIC, "frames": 8}, seed)
        full = [c.shape[0] for k, c in enumerate(fs.clouds) if k % 4 != 3]
        assert min(full) > 0.9 * hw  # a street scene returns nearly every ray
        assert all(fs.clouds[k].shape[0] < min(full) for k in (3, 7))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_one_frame_in_four_drops_far_returns(cfg):
    fs = frames.make_frames(cfg["lidar"], TRAFFIC, 7)
    hw = cfg["lidar"]["height"] * cfg["lidar"]["width"]
    sizes = [c.shape[0] for c in fs.clouds]
    assert sizes[3] < hw and sizes[3] < min(sizes[:3])
    assert np.linalg.norm(fs.clouds[3], axis=1).max() < 26.0
    assert all(c.dtype == np.float32 and c.shape[1] == 3 for c in fs.clouds)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_rays_are_the_programs(cfg):
    pytest.importorskip("rpcc_tpu_torch")
    from portbench.runners import program_config
    from rpcc_tpu_torch.ops.projection_host import build_transform_map

    lidar, _ = program_config(cfg)
    assert np.array_equal(frames.transform_map(cfg["lidar"]), build_transform_map(lidar))
