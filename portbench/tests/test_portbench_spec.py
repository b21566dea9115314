"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os

import pytest

from portbench import bench

SPEC = bench.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(bench.ROOT, "BENCHMARK.json")) <= 64 * 1024


def _one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert bench.NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert bench.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    all_metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(all_metrics)) == len(all_metrics)


def test_entries_have_exactly_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _one_line(w["why"]) and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _one_line(m["layer"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in SPEC["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in SPEC["workloads"]])
        for cell in cells:
            reported = {e["name"] for e in bench.metrics_for(SPEC, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        mine = {m["name"] for m in bench.metrics_for(SPEC, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        assert bench.metrics_for(SPEC, w["name"], "per_layer")


def test_roofline_shares_are_named_for_their_kernel():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_named_file_exists_and_configs_state_what_they_cut(w):
    entry = bench.config_entry(SPEC, w["config"])
    assert entry["file"].startswith("portbench/configs/")
    cfg = bench.load_config(SPEC, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    assert {"lidar", "codec", "source", "guarantee"} <= set(cfg)
    traffic = bench.load_traffic(w["traffic"])
    from portbench import runners

    assert traffic["runner"] in runners.RUNNERS
    for kind in ("end_to_end", "per_layer"):
        for m in bench.metrics_for(SPEC, w["name"], kind):
            assert callable(bench.reader(m["name"]))


def test_limits_have_reasons():
    with open(os.path.join(bench.HERE, "limits.json")) as f:
        limits = json.load(f)
    assert set(limits) == {"missing", "undecodable", "occupancy_px", "depth_err_over_bound"}
    assert all(v["why"] for v in limits.values())
