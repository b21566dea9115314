"""``encode_p50_ms``: the median of an open-loop window's latencies, read
from the same list as the per-layer ``encode_p95_ms.sensor``; nothing in a
closed loop."""

import pytest

from portbench import bench, run
from portbench.runners import Record

SENSOR = "hdl64e_kitti_default.sensor_10hz"


def _reading(loop, latencies):
    record = Record(loop, 1.0, 1.0, 0, 0, [], [], latencies, latencies, None, None, None, 0)
    return bench.Reading(record, {}, {}, {}, [])


@pytest.mark.parametrize("latencies_s,median_ms", [
    ([0.012, 0.019, 0.011], 12.0),
    ([0.010, 0.040, 0.020, 0.030], 25.0),  # an even count: halfway between the middle two
    ([0.013, 0.013, 0.014, 0.250, 0.012], 13.0),  # a frame unfinished at the close counts with its time
])
def test_the_reader_gives_the_median_of_the_latencies(latencies_s, median_ms):
    assert bench.reader("encode_p50_ms")(_reading("open", latencies_s)) == pytest.approx(median_ms, rel=1e-12)


def test_a_closed_loop_has_no_median_latency():
    assert bench.reader("encode_p50_ms")(_reading("closed", None)) is None


def test_only_the_sensor_cell_reports_it():
    spec = bench.load_benchmark()
    cells = [w["name"] for w in spec["workloads"]
             if "encode_p50_ms" in {m["name"] for m in bench.metrics_for(spec, w["name"], "end_to_end")}]
    assert cells == [SENSOR]


def test_a_sensor_rehearsal_reports_the_median_beside_the_tail():
    out = run.run_cell(SENSOR, 2**31 + 97, 3.0, False, device="cpu", overrides={"traffic": {"frames": 4}})
    assert out["correct"]
    p50, latency = out["metrics"]["encode_p50_ms"], out["generator"]["latency_ms"]
    assert p50["unit"] == "ms" and 0 < p50["value"] <= latency["p95"]
    assert p50["value"] == latency["p50"]


def test_the_tail_is_read_per_layer_from_the_same_latencies():
    latencies_s = [0.010 + 0.001 * k for k in range(20)]
    reading = _reading("open", latencies_s)
    assert bench.reader("encode_p95_ms.sensor")(reading) == pytest.approx(28.05, rel=1e-12)
    assert bench.reader("encode_p50_ms")(reading) == pytest.approx(19.5, rel=1e-12)
    assert bench.reader("encode_p95_ms.sensor")(_reading("closed", None)) is None


def test_the_tail_and_the_rate_are_per_layer_metrics():
    spec = bench.load_benchmark()
    e2e = {m["name"] for m in spec["end_to_end"]}
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    assert not {"encode_fps", "encode_p95_ms"} & e2e
    assert per_layer["encode_p95_ms.sensor"]["moves"] == "encode_p50_ms"
    assert per_layer["encode_fps.default"]["moves"] == "bpp"
