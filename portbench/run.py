"""Run one cell of the benchmark of ``rpcc_tpu_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic and
its metrics come from ``BENCHMARK.json`` and the files it names
(``portbench/bench.py``).  Set-up makes the frames from the seed, builds
the program's engine or codec on the card and warms it over every batch
the window sends; the window then runs ``--seconds``; after it the
program is freed and the plain reference (``portbench/reference.py``)
judges what the window produced.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard error).

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; so it does if the program, or after the window
``jax``, ``jaxlib``, ``flax`` or ``rpcc_tpu``, is found in the process.
``--control bf16`` (not part of the benchmark's runs) holds the program's
inputs in bfloat16: the control that ``correct`` has to refuse.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import bench  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rpcc_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole (``rpcc_tpu_torch`` is not ``rpcc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
        return lines[0] if lines else "nvidia-smi: no card line"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", control=None,
             t_start: float = T_START, overrides=None) -> dict:
    """One run of cell ``name`` on ``device`` -> the result line's object.
    ``overrides`` (tests only) replaces keys of the configuration's and the
    traffic's files, ``{"config": {...}, "traffic": {...}}``."""
    from portbench import frames, judge, runners
    from portbench.trace import Spans

    spec = bench.load_benchmark()
    overrides = overrides or {}
    cell = bench.workload(spec, name)
    config = bench.load_config(spec, cell["config"])
    traffic = bench.load_traffic(cell["traffic"])
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    seed = int(seed) % (1 << 63)
    fs = frames.make_frames(config["lidar"], traffic, seed)
    ctx = runners.Context(config, traffic, fs, float(seconds), bool(trace), device, seed, control, t_start)
    spans = Spans()
    record = runners.RUNNERS[traffic["runner"]](ctx, spans)
    import gc

    import torch

    gc.collect()  # the program's engine or codec, freed before the reference runs
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {found} after the window; the benchmark runs the port alone")
    verdict = judge.judge(record, fs.clouds, config, bench.load_limits())
    reading = bench.Reading(record, cell, config, traffic, verdict.valid_points)
    kind = "per_layer" if trace else "end_to_end"
    metrics = bench.read_metrics(bench.metrics_for(spec, name, kind), reading)
    absent = [k for k, v in metrics.items() if v is None]
    if absent:
        raise SystemExit(f"no reading for {absent} in cell {name}")
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": record.memory_peak_bytes}
    out = {"correct": verdict.correct, "attempted": verdict.attempted, "failed": verdict.failed,
           "metrics": metrics, "device": dev}
    if trace:
        t = record.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        print(f"trace: {len(t.ops)} device operations, {t.launches} launches, {len(t.spans)} spans, "
              f"window {t.window_s:.3f} s, busy {t.busy_s:.3f} s", file=sys.stderr)
        out["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    if record.lateness_s:
        import numpy as np

        lat = 1e3 * np.asarray(record.latencies_s)
        half = len(lat) // 2
        out["generator"] = {
            "frames_due": len(lat) + record.missing,
            "late_p95_ms": float(np.percentile(1e3 * np.asarray(record.lateness_s), 95)),
            "late_max_ms": 1e3 * max(record.lateness_s),
            "latency_ms": {f"p{q}": float(np.percentile(lat, q)) for q in (50, 90, 95, 99, 100)},
            "latency_p95_ms_by_half": [float(np.percentile(lat[:half], 95)), float(np.percentile(lat[half:], 95))],
        }
    if record.cpu_s is not None:
        out["window"] = {"frames": record.frames_done, "seconds": record.window_s, "cpu_s": record.cpu_s,
                         "stages": record.stats}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict.checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    args = p.parse_args(argv)
    cell = bench.workload(bench.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), control=args.control)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
