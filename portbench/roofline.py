"""Roofline arithmetic of the port's hand kernels, frozen with the
benchmark: the least time one H100 could take for the work the cell's
inputs need, the larger of its f32 operations over the f32 peak and its
bytes (inputs read once, outputs written once) over the memory rate.

Copied from ``chip_smoke.py`` (``bound``, ``fps_bound``, ``dbscan_bound``,
``rans_bound``), with ``resid_T`` / ``contour_T`` worked out here (they
are ``rpcc_tpu_torch/ops/rans_device.py``'s lane lengths) and one change
that counts what the inputs need rather than the program's buffers:
``rans_bound`` reads each frame's live residuals (its returned points),
not the padded H x W stream.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# The card's published peaks (H100 SXM, NVIDIA's data sheet, at its full
# 700 W): f32 outside the tensor cores, and device memory.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
RESID_LANES = 32
T_BUCKET = 16


def bound(ops: float, nbytes: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of the operations over the f32 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fps_bound(B: int, N: int, K: int) -> Tuple[float, str]:
    """FPS: (K - 1) steps over B * N points of 9 f32 operations (3 sub,
    3 mul, 2 add, 1 min); x/y/z read once, the indices written once."""
    return bound(9.0 * (K - 1) * B * N, 12.0 * B * N + 4.0 * B * K)


def dbscan_bound(active: int, B: int, H: int, W: int) -> Tuple[float, str]:
    """DBSCAN labels: the 48 window shifts of each active pixel at 9 f32
    operations (3 sub, 3 mul, 2 add, 1 compare); x/y/z and the mask read
    once, the labels written once (17 B a pixel)."""
    return bound(9.0 * 48 * int(active), 17.0 * B * H * W)


def stream_T(width: int, lanes: int) -> int:
    """Steps per lane of ``lanes`` lanes over ``width`` symbols, in
    multiples of 16."""
    return -(-max(1, -(-width // lanes)) // T_BUCKET) * T_BUCKET


def resid_T(hw: int) -> int:
    return stream_T(hw, RESID_LANES)


def contour_T(H: int, W: int) -> int:
    return -(-(W + H - 1) // T_BUCKET) * T_BUCKET


def rans_bound(stream_lens: Iterable[int], H: int, W: int) -> Tuple[float, str]:
    """rANS encode of a batch's residual streams (each frame's ``n`` int32
    residuals and its length) and contours (H x W int32): those read once,
    the container pieces written once (u16 words over 32 lanes x resid_T
    and H lanes x contour_T, lane counts and u64-held states, 4 x 512 + 8
    i32 tables, 512 u64-held escapes, 4 scalars).  Bytes only: its integer
    operations, tens a symbol, would take less time than its bytes at the
    f32 rate."""
    hw = H * W
    per_frame = (4 + 2 * 32 * resid_T(hw) + 12 * 32 + 4 * 4 * 512 + 8 * 512 + 12
                 + 4 * H * W + 2 * H * contour_T(H, W) + 12 * H + 4 * 8 + 4)
    return bound(0.0, float(sum(4 * int(n) + per_frame for n in stream_lens)))

