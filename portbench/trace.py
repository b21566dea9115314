"""The benchmark's own spans, and the device trace of a traced window.

:class:`Spans` records a span around each call the benchmark makes into a
layer of the program (an engine stage, the codec's compress and its
entropy stage): name, thread, start and end on the host's wall clock in
nanoseconds, the clock ``torch.profiler`` stamps its events with.

:class:`DeviceTrace` runs ``torch.profiler`` over the card's activity only
(kernels, copies, sets: no host operators, so the program's launch rate is
not slowed by the profiler's per-operator records) for part of a window,
and reduces a window of it to what the per-layer metrics read: each device operation's
name and interval, the union of those intervals (busy time), and the idle
gaps between them, each named by the benchmark's spans that were open on
the host at its middle.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


class Span(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int


class Spans:
    """Thread-safe record of the benchmark's spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Span] = []

    def wrap(self, name: str, fn):
        """``fn`` with a span named ``name`` around each call."""

        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                span = Span(name, threading.get_ident(), t0, time.time_ns())
                with self._lock:
                    self.items.append(span)

        return spanned

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.items)


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(", 1)[0].strip() or name


def _is_launch(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


class TraceResult(NamedTuple):
    ops: List[DeviceOp]  # device operations that overlap the window, by start
    start_ns: int
    end_ns: int
    spans: List[Span]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Union of the device operations' intervals, clipped to the window."""
        out: List[Tuple[int, int]] = []
        for op in self.ops:
            a, b = max(op.start_ns, self.start_ns), min(op.end_ns, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_times_s(self, needle: str) -> List[float]:
        """Durations of the kernels whose name holds ``needle``."""
        return [(op.end_ns - op.start_ns) / 1e9 for op in self.ops if needle in op.name]

    @property
    def launches(self) -> int:
        """Kernels (not copies or sets) that started in the window."""
        return sum(1 for op in self.ops if _is_launch(op.name) and self.start_ns <= op.start_ns < self.end_ns)

    def spans_started(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name and self.start_ns <= s.start_ns < self.end_ns)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = collections.Counter()
        for op in self.ops:
            total[short_name(op.name)] += (op.end_ns - op.start_ns) / 1e9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps of the device in the window, each
        named by the innermost benchmark span open on each host thread at
        the gap's middle (threads joined by '+'; 'none' if no span was
        open)."""
        gaps, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._open_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:n]]

    def _open_at(self, t: int) -> str:
        inner: Dict[int, Span] = {}
        for s in self.spans:
            if s.start_ns <= t < s.end_ns:
                cur = inner.get(s.thread)
                if cur is None or s.end_ns - s.start_ns < cur.end_ns - cur.start_ns:
                    inner[s.thread] = s
        return "+".join(sorted(s.name for s in inner.values())) or "none"


class DeviceTrace:
    """``torch.profiler`` over the card's activity between :meth:`start` and
    :meth:`stop` (which synchronizes the device first)."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._cuda = True
        self.start_ns = self.end_ns = 0
        self.result: Optional[TraceResult] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.device(self.device).type == "cuda"
        # On the CPU (the tests' rehearsal) the host's operators stand in for the card's.
        self._prof = profile(activities=[ProfilerActivity.CUDA if self._cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def stop(self, spans: Sequence[Span], window_ns: Optional[Tuple[int, int]] = None) -> TraceResult:
        """Stop, and reduce the trace to ``window_ns`` (wall-clock ns; by
        default from start to stop)."""
        import torch

        if self._cuda:
            torch.cuda.synchronize(self.device)
        self.end_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        a, b = window_ns or (self.start_ns, self.end_ns)
        ops = sorted((op for op in _device_ops(self._prof, self._cuda) if op.end_ns > a and op.start_ns < b),
                     key=lambda op: op.start_ns)
        self._prof = None
        keep = [s for s in spans if s.end_ns > a and s.start_ns < b]
        self.result = TraceResult(ops, a, b, keep)
        return self.result


def _device_ops(prof, cuda: bool) -> List[DeviceOp]:
    """The profiler's device events (or, without a card, its host
    operators) as (name, start, end) in ns of the host's wall clock."""
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == kind:
            s = int(e.start_ns())
            out.append(DeviceOp(e.name(), s, s + int(e.duration_ns())))
    return out
