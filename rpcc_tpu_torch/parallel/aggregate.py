"""Throughput and rate totals of encoded batches (port of
``rpcc_tpu/parallel/aggregate.py``).

The JAX package sums frames, points and bits across its mesh with one
``psum``.  Here each rank's totals are host sums of what its engine already
holds (each frame's point count, its residual stream length, and blob
size), and :func:`all_reduce_totals` sums them over the ranks' process
group with one ``all_reduce``.  The totals are int64: the reference's int32
lanes wrap past 2^31 bits in one call.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def batch_totals(points: Sequence[int], blob_bytes: Sequence[int]) -> np.ndarray:
    """(3,) int64 [frames, points, bits] of one or more encoded batches."""
    pts = np.asarray(points, np.int64)
    bits = np.asarray(blob_bytes, np.int64) * 8
    return np.asarray([int((bits > 0).sum()), int(pts.sum()), int(bits.sum())], np.int64)


def all_reduce_totals(totals: np.ndarray, group=None) -> np.ndarray:
    """This rank's int64 totals (the (3,) ``[frames, points, bits]`` of
    :func:`batch_totals`, and any counts after them) summed over ``group``
    (default: the default group) with one ``all_reduce``; the sum lands on
    every rank.  The tensor goes on the rank's current card for NCCL and on
    the CPU for gloo."""
    import torch.distributed as dist

    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.as_tensor(np.asarray(totals, np.int64), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()


def batch_report(totals: np.ndarray) -> dict:
    """(3,) [frames, points, bits] -> report dict (bpp, ratio)."""
    frames, points, bits = (int(x) for x in np.asarray(totals))
    points = max(points, 1)
    return {
        "frames": frames,
        "points": points,
        "bits": bits,
        "bpp": bits / points,
        "ratio": (points * 96) / max(bits, 1),
    }
