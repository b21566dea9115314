"""The package's timing: spans inside the program, and its counters.

:func:`span` marks a region of the program: an engine stage, a wait, a
part of the encoder graph's issue, a step of the codec.  Tracing is off
by default, and a span then costs one global read: it returns a shared
no-op object and reads no clock.  Inside :func:`recording` every span is
kept, with its parent (the innermost span open on the same thread), its
batch (the engine's batch number or the codec's frame number, inherited
from the parent), its thread, its start and end on ``time.time_ns()``
(the clock ``torch.profiler`` stamps host and device events with) and the
thread's CPU time inside it.  Spans go into per-thread buffers, merged
when the recording ends; nothing is written to disk.  A span asked for
with ``stamp=True`` reads its clocks whether or not tracing is on, for
callers that keep their own totals (the engine's ``stats``, the codec's
timing dicts) from the same stamps.

:func:`count` adds to a process-wide counter that is always on (kernel
launches, the engine's stream downloads, the encoder's eager calls,
captures and replays); :func:`counters` reads them all, and
:func:`counters_since` the differences since an earlier read.  Nothing
resets a counter: callers read differences.  :func:`holding_counts` holds
one thread's counts back, for a CUDA graph's capture.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

_RECORDING: Optional["Recording"] = None  # the open recording; None: tracing is off
_local = threading.local()  # per thread: the open spans, and this recording's buffer
_ids = itertools.count(1)
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


class Span:
    """One timed region.  ``start_ns`` / ``end_ns`` on ``time.time_ns()``;
    ``cpu_ns`` the thread's CPU time inside it; ``parent`` the ``id`` of
    the span it opened in (None at the top of its thread); ``thread``
    ``threading.get_ident()``."""

    __slots__ = ("name", "id", "parent", "batch", "thread", "start_ns", "end_ns", "cpu_ns", "_buf", "_stack")

    def __init__(self, name: str, batch: Optional[int], buf: Optional[list] = None, stack: Optional[list] = None):
        self.name = name
        self.batch = batch
        self.parent = None
        self.id = self.thread = self.start_ns = self.end_ns = self.cpu_ns = 0
        self._buf, self._stack = buf, stack

    def __enter__(self) -> "Span":
        if self._buf is not None:
            stack = self._stack
            if stack:
                top = stack[-1]
                self.parent = top.id
                if self.batch is None:
                    self.batch = top.batch
            stack.append(self)
            self.id = next(_ids)
            self.thread = threading.get_ident()
        self.cpu_ns = time.thread_time_ns()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        if self._buf is not None:
            if self._stack and self._stack[-1] is self:
                self._stack.pop()
            self._buf.append(self)
        return False

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class _NoSpan:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class Recording:
    """What :func:`recording` yields: once it has ended, ``spans`` (every
    thread's, by start) and ``counters`` (each counter's rise over it)."""

    def __init__(self):
        self._buffers: List[list] = []
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    def _span(self, name: str, batch: Optional[int]) -> Span:
        """A span kept in this thread's buffer (made, with the thread's
        stack of open spans, at its first span of the recording)."""
        if getattr(_local, "recording", None) is not self:
            _local.recording, _local.buf, _local.stack = self, [], []
            with self._lock:
                self._buffers.append(_local.buf)
        return Span(name, batch, _local.buf, _local.stack)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def span(name: str, batch: Optional[int] = None, stamp: bool = False):
    """A context manager around a region named ``name``: a :class:`Span`
    kept by the open recording, or with tracing off the shared
    :data:`NO_SPAN` (or, with ``stamp``, a span that reads its clocks and
    is kept nowhere)."""
    rec = _RECORDING
    if rec is None:
        return Span(name, batch) if stamp else NO_SPAN
    return rec._span(name, batch)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn tracing on for the body.  The yielded :class:`Recording` holds
    the spans and the counters' differences once the body has ended."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    before = counters()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = None
        with rec._lock:
            rec.spans = sorted(itertools.chain.from_iterable(list(b) for b in rec._buffers),
                               key=lambda s: (s.start_ns, s.id))
        rec.counters = counters_since(before)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (inside :func:`holding_counts` on
    this thread, to the held counts instead)."""
    held = getattr(_local, "held", None)
    if held is not None:
        held[name] = held.get(name, 0) + n
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def holding_counts() -> Iterator[Dict[str, int]]:
    """Hold back this thread's counts for the body: they go into the yielded
    dict, not the process's counters.  A CUDA graph's capture runs nothing,
    so its launches are held and counted at each replay."""
    held: Dict[str, int] = {}
    outer = getattr(_local, "held", None)
    _local.held = held
    try:
        yield held
    finally:
        _local.held = outer


def counters() -> Dict[str, int]:
    """Every counter's value since the process started."""
    with _counts_lock:
        return dict(_counts)


def counters_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each counter's rise since ``before`` (an earlier :func:`counters`),
    counters that did not move left out."""
    now = counters()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
