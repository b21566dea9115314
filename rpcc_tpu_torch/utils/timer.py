"""Stage timing and trace capture (port of ``rpcc_tpu/utils/timer.py``).

The reference prints per-stage ``time.time()`` deltas (tools/compress.py:
141-150): :class:`StageTimer` keeps the same report.  :func:`device_trace`
records a ``torch.profiler`` trace of a region, the card's kernels with it
when there is one, and writes it into ``log_dir`` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    def __init__(self):
        self.durations: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, stage: str) -> float:
        now = time.perf_counter()
        dt = now - self._t
        self.durations[stage] = self.durations.get(stage, 0.0) + dt
        self._t = now
        return dt

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - t0

    def report(self, prefix: str = "    ") -> str:
        lines = [f"{prefix}{k}: {v:.6f}s" for k, v in self.durations.items()]
        total = sum(self.durations.values())
        lines.append(f"{prefix}total: {total:.6f}s")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the region (CPU operators, and
    the card's kernels and copies when a CUDA device is present) and write
    it to ``log_dir/trace.json`` (Chrome trace format; open it in Perfetto
    or chrome://tracing).  With no ``log_dir`` nothing is recorded."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
