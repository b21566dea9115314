"""Residual quantization and the cluster-ordered stream layout: the
readable spec (port of ``rpcc_tpu/ops/quantize.py``).

The reference C++ (``cpp_modules.cpp:288-424``) buckets quantized
residuals per cluster id (row-major within each cluster), skips id 1 (zero
pixels) and concatenates the buckets in id order: one **stable sort** by
cluster id gives the permutation whose contiguous ranges are the clusters,
and the stream is that permutation with the id-1 range skipped.
Dequantization inverts the same permutation with one scatter.  Rounding is
C ``round()`` (half away from zero).

The encoder and decoders use the stream-space formulation of
``ops/stream.py``; this module is the spec the tests pin it against.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from rpcc_tpu_torch.ops.rounding import round_half_away


class ClusterOrder(NamedTuple):
    perm: torch.Tensor  # (HW,) int64 pixel index sorted by (cluster id, row-major)
    counts: torch.Tensor  # (num_models,) int32 per-id pixel counts
    starts: torch.Tensor  # (num_models,) int32 exclusive cumsum of counts
    stream_len: torch.Tensor  # () int32 HW - counts[1]


def cluster_sort(seg_flat: torch.Tensor, num_models: int) -> ClusterOrder:
    """The stable cluster order of an (HW,) seg map; ids outside
    [0, num_models) sort by value and are not counted."""
    hw = seg_flat.shape[0]
    seg = seg_flat.to(torch.int32)
    perm = torch.sort(seg, stable=True).indices
    ok = (seg >= 0) & (seg < num_models)
    counts = torch.zeros(num_models, dtype=torch.int32, device=seg.device)
    counts.index_add_(0, seg[ok].to(torch.int64), torch.ones_like(seg[ok]))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)[:-1]])
    return ClusterOrder(perm, counts, starts, hw - counts[1])


def _stream_src(order: ClusterOrder, hw: int) -> torch.Tensor:
    """Index into ``perm`` of each stream slot, skipping the id-1 range."""
    i = torch.arange(hw, dtype=torch.int64, device=order.perm.device)
    return i + torch.where(i >= order.starts[1], order.counts[1], 0)


def _step(step_flat, like: torch.Tensor) -> torch.Tensor:
    """The step as a tensor on ``like``'s device: a division by a host scalar
    on the card multiplies by its reciprocal, which rounds differently."""
    return torch.as_tensor(step_flat, dtype=torch.float32, device=like.device)


def quantize_stream(
    residual_flat: torch.Tensor, order: ClusterOrder, step_flat: Union[torch.Tensor, float]
) -> torch.Tensor:
    """Quantize and lay out the residual stream: ``step_flat`` is a scalar
    (uniform mode) or an (HW,) per-pixel step.  -> (HW,) int32, the first
    ``order.stream_len`` entries live and the tail 0."""
    hw = residual_flat.shape[0]
    q = round_half_away(residual_flat / _step(step_flat, residual_flat)).to(torch.int32)
    stream = q[order.perm[torch.clamp(_stream_src(order, hw), max=hw - 1)]]
    live = torch.arange(hw, device=q.device) < order.stream_len
    return torch.where(live, stream, 0)


def dequantize_stream(
    stream: torch.Tensor, order: ClusterOrder, step_flat: Union[torch.Tensor, float]
) -> torch.Tensor:
    """Scatter an (HW,) tail-padded stream back to per-pixel residuals
    (id-1 pixels get 0), times the step."""
    hw = stream.shape[0]
    live = torch.arange(hw, device=stream.device) < order.stream_len
    dest = torch.where(live, order.perm[torch.clamp(_stream_src(order, hw), max=hw - 1)], hw)
    resid = torch.zeros(hw + 1, dtype=torch.float32, device=stream.device)
    resid[dest] = stream.to(torch.float32)  # live destinations are distinct; the rest land in the dump slot
    return resid[:hw] * _step(step_flat, stream)
