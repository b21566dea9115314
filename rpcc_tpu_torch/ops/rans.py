"""The encode-side spec of the interleaved-lane rANS coder (port of the
encode half of ``rpcc_tpu/ops/rans.py``).

Scheme: one model per context and frame; 32-bit state, 16-bit
renormalized output, ``PROB_BITS = 14``.  Encoding walks each lane's
symbols in reverse so decoding streams forward; at most one word is
emitted per symbol.  :func:`normalize_freqs` is bit-exact to the
reference's (f32 ``floor(count * (M / total))``, present symbols bumped to
1, the correction on the first argmax, and the repair pass for a top
symbol that cannot absorb a negative correction), as is the port's C++
twin ``csrc/host/rans.cpp::normalize_freqs_row`` and the CUDA kernel's
warp version in ``csrc/rans.cu``.
"""

from __future__ import annotations

import torch

PROB_BITS = 14
M = 1 << PROB_BITS  # total frequency
RANS_L = 1 << 16  # state lower bound


def normalize_freqs(counts: torch.Tensor) -> torch.Tensor:
    """Normalize histograms along the last axis to sum exactly M -> int32.

    Every present symbol keeps freq >= 1 and the correction lands on the
    first most frequent symbol.  When the bump-to-1 of many rare symbols
    overdraws the budget so far that the top symbol cannot absorb the
    correction, the row is re-floored with 1 reserved per present symbol
    (``floor(c * (M - A_pos) / total) + 1``), whose correction is >= 0."""
    counts = counts.to(torch.int32)
    present = counts > 0
    total = counts.sum(-1, keepdim=True).clamp_min(1)
    total_f = total.to(torch.float32)
    scale = torch.tensor(float(M), dtype=torch.float32, device=counts.device) / total_f
    f = torch.floor(counts.to(torch.float32) * scale).to(torch.int32)
    f = torch.where(present & (f == 0), 1, f)
    delta = M - f.sum(-1, keepdim=True, dtype=torch.int32)
    top = torch.argmax(f, -1, keepdim=True)  # the first of equal maxima
    ok = f.gather(-1, top) + delta >= 1
    a_pos = present.sum(-1, keepdim=True, dtype=torch.int32)
    scale2 = (M - a_pos).to(torch.float32) / total_f
    f2 = torch.floor(counts.to(torch.float32) * scale2).to(torch.int32) + present.to(torch.int32)
    delta2 = M - f2.sum(-1, keepdim=True, dtype=torch.int32)
    top2 = torch.argmax(f2, -1, keepdim=True)
    f = f.scatter_add(-1, top, delta)
    f2 = f2.scatter_add(-1, top2, delta2)
    return torch.where(ok, f, f2)


def cumulative(freqs: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums along the last axis (int32)."""
    c = torch.cumsum(freqs.to(torch.int64), -1).to(torch.int32)
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def zigzag_magnitude_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """Context of a residual symbol: the bucket of the previous delta's
    magnitude, edges [1, 3, 8] (``|d| = (sym + 1) // 2``; ESCAPE maps to
    the largest bucket)."""
    mag = (prev_sym + 1) // 2
    return (mag >= 1).to(torch.int32) + (mag >= 3).to(torch.int32) + (mag >= 8).to(torch.int32)


def wavefront_bit_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """4-context binary model of the diagonal-wavefront contour layout, over
    previous symbols with the lanes on the last axis: lane r's own previous
    symbol is the LEFT neighbour and lane r-1's is the one ABOVE;
    ctx = 2 * above + left."""
    above = torch.nn.functional.pad(prev_sym[..., :-1], (1, 0))
    return 2 * above + prev_sym
