"""The plane-model deployment (``hdl64e_kitti_plane``) on the CPU: its
configuration in the program, a small run and its bfloat16 control, the
reader of ``models.plane_share.plane``, and the benchmark's frozen copy of
the plain plane reference against the tests' copy."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from portbench import bench, reference_plane, run, runners

SPEC = bench.load_benchmark()
CELL = "hdl64e_kitti_plane.archive_encode"
SMALL = {"traffic": {"frames": 2, "batch_size": 2}}


def test_the_configuration_is_the_64e_default_with_plane_models():
    plane = bench.load_config(SPEC, "hdl64e_kitti_plane")
    default = bench.load_config(SPEC, "hdl64e_kitti_default")
    assert plane["lidar"] == default["lidar"] and plane["guarantee"] == default["guarantee"]
    changed = {k for k in set(plane["codec"]) | set(default["codec"]) if plane["codec"].get(k) != default["codec"].get(k)}
    assert changed == {"modeling_method", "plane_angle_threshold"}
    lidar, cfg = runners.program_config(plane)
    assert (lidar.height, lidar.width, cfg.cluster_num) == (64, 2000, 100)
    assert cfg.modeling_method == "plane" and cfg.plane_angle_threshold == 75.0
    assert bench.workload(SPEC, CELL)["chips"] == 1 and bench.config_entry(SPEC, "hdl64e_kitti_plane")["reduced"] == []


@pytest.fixture(scope="module")
def small_run():
    return run.run_cell(CELL, 2**33 + 21, 3.0, False, device="cpu", overrides=SMALL)


def test_a_small_run_is_correct_and_counts_its_plane_rows(small_run):
    assert small_run["correct"] and small_run["failed"] == 0
    st = small_run["window"]["stages"]
    assert 0 < st["plane_rows"] <= st["model_rows"]
    assert st["plane_rows"] >= st["model_rows"] // 2  # planes do most of the modelling


def test_the_bf16_control_of_a_small_run_is_refused():
    out = run.run_cell(CELL, 2**33 + 21, 2.0, False, device="cpu", overrides=SMALL, control="bf16")
    assert not out["correct"]


def _reading(stats, outputs):
    record = types.SimpleNamespace(stats=stats, outputs=outputs)
    return bench.Reading(record, bench.workload(SPEC, CELL), bench.load_config(SPEC, "hdl64e_kitti_plane"), {}, [])


def test_the_plane_share_reads_the_stats_then_the_payloads():
    read = bench.reader("models.plane_share.plane")
    assert read(_reading({"model_rows": 200, "plane_rows": 150}, [])) == 75.0
    assert read(_reading({"batches": 3}, [])) is None
    assert read(_reading(None, [])) is None
    # A program that keeps no such counts: the share of the payloads' tables.
    from rpcc_tpu_torch.data.synth import synth_cloud_for
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    lidar, cfg = runners.program_config(bench.load_config(SPEC, "hdl64e_kitti_plane"))
    eng = BatchEngine(lidar, cfg, "cpu", batch_size=2)
    try:
        res = eng.encode_frames([synth_cloud_for(lidar, s) for s in (1, 2)])
    finally:
        eng.close()
    share = read(_reading({"batches": 1}, [(k, blob) for k, (blob, _) in enumerate(res)]))
    assert share == pytest.approx(100.0 * res.counts["plane_rows"] / res.counts["model_rows"])
    assert read(_reading({"batches": 1}, [(0, b"\x00\x01")])) is None


def test_the_frozen_reference_equals_the_tests_copy():
    path = os.path.join(bench.ROOT, "tests", "plain_plane_reference.py")
    spec = importlib.util.spec_from_file_location("plain_plane_reference_of_the_tests", path)
    tests_copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_copy)
    lidar = {"height": 16, "width": 256, "horizontal_fov_deg": 360.0, "vertical_angle_max_deg": 2.0,
             "vertical_angle_min_deg": -24.9}
    rng = np.random.default_rng(5)
    seg = torch.from_numpy(rng.integers(0, 8, (16, 256)))
    rays = reference_plane.scan_rays(lidar)
    # Planes of ranges: each cluster a wall at its own distance, 1 cm noise.
    ri = (4.0 + seg.to(torch.float32) * 3.0) / torch.clamp(rays[0].abs() + rays[1].abs(), min=0.3)
    ri = ri + torch.from_numpy(rng.normal(0, 0.01, (16, 256)).astype(np.float32))
    got = reference_plane.plane_models(ri, seg, 77, lidar, 8)
    want = tests_copy.plane_models(ri, seg, 77, lidar, 8)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)), name
    assert reference_plane.compare(want.table, got) == tests_copy.compare(want.table, want)
