"""Lossless contour coding of the segmentation map (port of
``rpcc_tpu/ops/contour.py``).

contour = 1 at column 0 of every row and wherever the id differs from its
left neighbour; the id at each contour pixel, in row-major order, is the
run-value sequence.  The decoder places the run deltas at the run starts
and integrates with one cumsum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rpcc_tpu_torch.ops.const import device_const
from rpcc_tpu_torch.ops.stream import compact_flagged_positions, compact_flagged_small


class ContourCode(NamedTuple):
    contour: torch.Tensor  # (..., H, W) int32 {0, 1}
    sequence: torch.Tensor  # (..., HW) int32, first ``seq_len`` entries valid
    seq_len: torch.Tensor  # (...) int32


def extract_contour(seg: torch.Tensor) -> ContourCode:
    """Contour code of an (H, W) or (B, H, W) seg map."""
    H, W = seg.shape[-2:]
    lead = seg.shape[:-2]
    contour = torch.ones(seg.shape, dtype=torch.int32, device=seg.device)
    contour[..., :, 1:] = (seg[..., :, 1:] != seg[..., :, :-1]).to(torch.int32)
    sequence, seq_len = compact_flagged_small(contour.reshape(*lead, -1), seg.reshape(*lead, -1))  # ids < 2^12
    live = torch.arange(H * W, device=seg.device) < seq_len[..., None]
    return ContourCode(contour, torch.where(live, sequence, 0), seq_len)


_MSB_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits_msb(bits: torch.Tensor, start_dim: int = 0) -> torch.Tensor:
    """``np.packbits`` of the dims from ``start_dim`` on, flattened: (..., N)
    {0,1} -> (..., ceil(N/8)) uint8, a ragged tail zero-padded.  With the
    default every dim is packed into one row."""
    flat = bits.flatten(start_dim).to(torch.int32)
    pad = (-flat.shape[-1]) % 8
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    w = device_const(_MSB_WEIGHTS, torch.int32, bits.device)
    return (flat.reshape(*flat.shape[:-1], -1, 8) * w).sum(-1).to(torch.uint8)


def unpack_bits_msb(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_msb` along the last dim -> (..., n_bits)
    int32 {0,1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n_bits]


def recover_map(contour: torch.Tensor, sequence: torch.Tensor) -> torch.Tensor:
    """Invert :func:`extract_contour` for (H, W) or (B, H, W) contours;
    ``sequence`` (..., L) may be tail-padded (each frame reads only as many
    run values as its contour has runs)."""
    H, W = contour.shape[-2:]
    lead = contour.shape[:-2]
    hw = H * W
    pos, n = compact_flagged_positions(contour.reshape(*lead, hw))  # run starts first
    seq = sequence.to(torch.int32)
    diffs = torch.zeros((*lead, hw), dtype=torch.int32, device=contour.device)
    m = min(seq.shape[-1], hw)
    diffs[..., :m] = seq[..., :m]
    diffs[..., 1:] -= diffs[..., :-1].clone()
    live = torch.arange(hw, device=contour.device) < n[..., None]
    base = torch.zeros((*lead, hw), dtype=torch.int32, device=contour.device)
    base.scatter_(-1, pos.to(torch.int64), torch.where(live, diffs, 0))
    return torch.cumsum(base, -1, dtype=torch.int32).reshape(contour.shape)
