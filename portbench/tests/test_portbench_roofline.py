"""The frozen roofline arithmetic against hand-worked shapes."""

import pytest

from portbench import roofline


def test_fps_bound_at_the_engine_batch():
    ms, by = roofline.fps_bound(8, 128000, 100)
    # 9 operations x 99 steps x 8 x 128,000 points = 912,384,000 f32 operations
    assert by == "operations"
    assert ms == pytest.approx(912_384_000 / 67e12 * 1e3)
    assert ms == pytest.approx(0.013618, abs=5e-7)


def test_fps_bound_of_one_frame_is_an_eighth():
    assert roofline.fps_bound(1, 128000, 100)[0] == pytest.approx(roofline.fps_bound(8, 128000, 100)[0] / 8)


def test_dbscan_bound_bytes_and_operations():
    ms, by = roofline.dbscan_bound(0, 1, 64, 2000)
    assert by == "bytes" and ms == pytest.approx(17 * 128000 / 3.35e12 * 1e3)  # 0.000650 ms
    ms, by = roofline.dbscan_bound(8 * 72000, 8, 32, 2250)
    assert by == "operations" and ms == pytest.approx(9 * 48 * 8 * 72000 / 67e12 * 1e3)


def test_lane_lengths():
    assert roofline.resid_T(128000) == 4000
    assert roofline.resid_T(72000) == 2256
    assert roofline.contour_T(64, 2000) == 2064
    assert roofline.contour_T(32, 2250) == 2288


def test_rans_bound_of_a_full_64e_frame():
    ms, by = roofline.rans_bound([128000], 64, 2000)
    assert by == "bytes" and ms == pytest.approx(1_557_684 / 3.35e12 * 1e3)  # chip_smoke's 1,557,684 B a frame
    fewer = roofline.rans_bound([100000], 64, 2000)[0]
    assert ms - fewer == pytest.approx(4 * 28000 / 3.35e12 * 1e3)


def test_lane_lengths_match_the_program():
    rans_device = pytest.importorskip("rpcc_tpu_torch.ops.rans_device")
    for hw in (128000, 72000, 28800, 1000):
        assert roofline.resid_T(hw) == rans_device.resid_T(hw)
    for H, W in ((64, 2000), (32, 2250), (16, 1800)):
        assert roofline.contour_T(H, W) == rans_device.contour_T(H, W)
