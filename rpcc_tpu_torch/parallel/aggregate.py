"""Throughput and rate totals of encoded batches (port of
``rpcc_tpu/parallel/aggregate.py``).

The JAX package sums frames, points and bits across its mesh with one
``psum``.  An engine here drives one card, so the totals are host sums of
what the engine already holds: each frame's point count (its residual
stream length) and blob size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def batch_totals(points: Sequence[int], blob_bytes: Sequence[int]) -> np.ndarray:
    """(3,) int64 [frames, points, bits] of one or more encoded batches."""
    pts = np.asarray(points, np.int64)
    bits = np.asarray(blob_bytes, np.int64) * 8
    return np.asarray([int((bits > 0).sum()), int(pts.sum()), int(bits.sum())], np.int64)


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
