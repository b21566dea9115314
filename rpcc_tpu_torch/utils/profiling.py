"""Per-operation device timings of one call (port of
``rpcc_tpu/utils/profiling.py``, which summarizes a ``jax.profiler`` trace).

:func:`op_table` runs a function once under ``torch.profiler`` and sums the
time of each operation by name: the CUDA kernels and copies on the card
for a CUDA device, the CPU operators (self time) for the CPU.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Tuple

import torch


def op_table(fn: Callable[[], object], device: torch.device, top: int = 15) -> List[Tuple[float, int, str]]:
    """``fn()`` once under the profiler -> [(milliseconds, calls, name)] of
    the ``top`` operations with the most summed time, biggest first."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    us: collections.Counter = collections.Counter()
    calls: collections.Counter = collections.Counter()
    if cuda:
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                us[e.name] += e.time_range.elapsed_us()
                calls[e.name] += 1
    else:
        for e in prof.key_averages():
            us[e.key] += e.self_cpu_time_total
            calls[e.key] += e.count
    return [(t / 1e3, calls[name], name) for name, t in us.most_common(top)]


def print_op_table(fn: Callable[[], object], device: torch.device, top: int = 15) -> None:
    rows = op_table(fn, device, top)
    if not rows:
        print("(no operations captured)")
        return
    kind = "device kernels and copies" if device.type == "cuda" else "CPU operators, self time"
    print(f"\nTop device operations by summed time ({kind}; one encode on {device}):")
    for ms, n, name in rows:
        print(f"    {ms:9.3f} ms  {n:5d}x  {name[:100]}")
