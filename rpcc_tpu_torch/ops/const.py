"""Small constant tensors for the encoder graph, made without a wait.

``torch.tensor(values, device="cuda")`` copies from pageable host memory
and synchronises the current stream, so in the middle of the graph it
holds the host until the device has run everything queued before it.
:func:`device_const` sends the same values up from pinned memory on the
current stream instead (the caching host allocator keeps the buffer until
the copy has run), and the graph's issue never waits for the device.
"""

from __future__ import annotations

import torch


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, the same values
    and dtype, without synchronising a card's stream."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
