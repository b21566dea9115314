"""The benchmark's description and what it names: ``BENCHMARK.json`` at the
root of the checkout, a configuration file, a traffic file and a metric
reader for each name it uses.  The harness finds every one of them by the
name ``BENCHMARK.json`` gives, so a configuration, a traffic mix or a
metric is added as files alone:

* ``portbench/configs/<config>.json``: the deployment (the LiDAR's
  geometry under ``lidar``, the codec's settings under ``codec``);
* ``portbench/traffic/<traffic>.json``: the mix (which runner of
  ``portbench/runners.py`` runs it and its parameters);
* ``portbench/metrics/<metric>.py``: ``read(reading)`` -> the metric's
  value, or None where the run has nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, config_entry(bench, name)["file"])) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def load_limits() -> Dict[str, float]:
    with open(os.path.join(HERE, "limits.json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, or list no workloads."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(metric: str) -> Callable:
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Reading(NamedTuple):
    """What a metric reader reads: the run's record (``runners.Record``:
    its window, outputs, the engine's or codec's timings, the trace), the
    cell, its configuration and traffic, and each distinct frame's
    returned points (the reference's projection of the input)."""

    record: object
    cell: dict
    config: dict
    traffic: dict
    valid_points: List[int]


def read_metrics(specs: List[dict], reading) -> Dict[str, Optional[dict]]:
    """Each metric's ``{"value", "unit"}``, or None where its reader found
    nothing to read."""
    out = {}
    for m in specs:
        v = reader(m["name"])(reading)
        out[m["name"]] = None if v is None else {"value": float(v), "unit": m["unit"]}
    return out
