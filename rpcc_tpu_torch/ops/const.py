"""Small constant tensors for the encoder graph, made without a wait.

``torch.tensor(values, device="cuda")`` copies from pageable host memory
and synchronises the current stream, so in the middle of the graph it
holds the host until the device has run everything queued before it.
:func:`upload` sends the values up from pinned memory on the current
stream instead (the caching host allocator keeps the buffer until the
copy has run), and the graph's issue never waits for the device.

:func:`device_const` is for the graph's fixed constants (steps,
thresholds, weights, ray constants): on a card each (values, dtype,
device) is uploaded once and kept for the life of the process, so a CUDA
graph captured over the encoder (``models/encoder.py``) reads device
memory only.  A pinned upload captured into a graph would instead be
replayed from a host buffer that the caching host allocator has long
since handed to another caller.  Values that change from call to call,
such as seeds, go through :func:`upload`.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

_kept: Dict[tuple, Tuple[torch.Tensor, torch.cuda.Event]] = {}
_kept_lock = threading.Lock()


def upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, the same values
    and dtype, without synchronising a card's stream."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`upload` of a fixed constant; on a card the same tensor for the
    same (values, dtype, device), which its callers must not write to.  The
    first caller's stream uploads it; a later caller's stream waits for that
    upload (outside a capture: a capture runs after the device has drained).
    Raises if a capture would be the first to ask for it."""
    t = torch.tensor(values, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, t.dtype, tuple(t.shape), t.numpy().tobytes())
    capturing = torch.cuda.is_current_stream_capturing()
    with _kept_lock:
        kept = _kept.get(key)
        if kept is None:
            if capturing:
                raise RuntimeError(f"constant {values!r} first asked for inside a CUDA graph capture: "
                                   "its upload would be replayed from a released host buffer")
            made = t.pin_memory().to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            _kept[key] = (made, ready)
            return made
    made, ready = kept
    if not capturing:
        torch.cuda.current_stream(dev).wait_event(ready)
    return made
