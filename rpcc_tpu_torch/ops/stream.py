"""Stream-space codec math (port of ``rpcc_tpu/ops/stream.py``).

One stable sort carries every pixel into *stream order*: cluster-id major,
row-major within a cluster, the zero-pixel class (id 1) last — the
reference bitstream order.  Per-cluster sums come from one cumsum and
boundary differences; per-cluster values reach the stream slots by a plain
gather ``values[order.seg]`` (the JAX package avoids that gather on the
TPU; on a GPU it is cheap and bit-exact by construction).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

_IOTA_BITS = 18  # position field width; covers range images up to 2^18 px


class StreamOrder(NamedTuple):
    perm: torch.Tensor  # (HW,) int64 pixel index of each stream slot
    seg: torch.Tensor  # (HW,) int64 cluster id of each stream slot
    starts: torch.Tensor  # (M,) stream start offset per cluster id
    counts: torch.Tensor  # (M,) per-cluster pixel counts
    stream_len: torch.Tensor  # () HW - counts[1]


def stream_sort(
    seg_flat: torch.Tensor, payloads: Sequence[torch.Tensor], num_models: int
) -> Tuple[StreamOrder, Tuple[torch.Tensor, ...]]:
    """Sort pixels into stream order by the packed int32 key
    ``(stream_key << 18) | pixel_index`` (unique keys, so the order is the
    stable one) and carry ``payloads`` along."""
    hw = seg_flat.shape[0]
    if hw >= (1 << _IOTA_BITS) or num_models >= (1 << (31 - _IOTA_BITS)):
        raise ValueError(f"stream key overflows int32 (hw={hw}, num_models={num_models})")
    dev = seg_flat.device
    iota = torch.arange(hw, dtype=torch.int32, device=dev)
    key = torch.where(seg_flat == 1, num_models, seg_flat).to(torch.int32)
    packed_s = torch.sort((key << _IOTA_BITS) | iota).values
    perm = (packed_s & ((1 << _IOTA_BITS) - 1)).to(torch.int64)
    key_s = (packed_s >> _IOTA_BITS).contiguous()
    seg_s = torch.where(key_s == num_models, 1, key_s).to(torch.int64)

    ids = torch.arange(num_models, dtype=torch.int32, device=dev)
    ckeys = torch.where(ids == 1, num_models, ids).to(torch.int32)
    starts = torch.searchsorted(key_s, ckeys, right=False).to(torch.int32)
    ends = torch.searchsorted(key_s, ckeys, right=True).to(torch.int32)
    counts = ends - starts
    order = StreamOrder(perm, seg_s, starts, counts, hw - counts[1])
    return order, tuple(p[perm] for p in payloads)


_SCAN_BLOCK = 16  # XLA's CPU cumsum scans 16-element blocks, recursively


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive left-to-right scan along a short last dim, one f32 add at a
    time."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, -1)


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim of a float tensor, in the
    association of XLA's CPU cumsum, so a CPU run equals ``rpcc_tpu``'s
    ``jnp.cumsum`` bit for bit and a GPU run repeats bit for bit.

    XLA rewrites a cumsum as 16-element blocks, each scanned left to right,
    plus the exclusive scan of the block totals (the same rewrite, one
    level up) added to every element.  Neither torch scan gives that: the
    CPU one accumulates in double, and the CUDA one of a 1-D tensor is a
    decoupled look-back scan whose f32 result changes run to run.  Here
    every step is an elementwise f32 add, ~20 launches per level and
    log16(n) levels.
    """
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(x)
    lead = x.shape[:-1]
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(*lead, nb, _SCAN_BLOCK)
    inner = _sequential_scan(blocks)
    totals = fixed_order_cumsum(inner[..., -1])
    carry = torch.cat([torch.zeros((*lead, 1), dtype=x.dtype, device=x.device), totals[..., :-1]], -1)
    return (carry[..., None] + inner).reshape(*lead, nb * _SCAN_BLOCK)[..., :n]


def per_cluster_sums(values_s: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """(M,) per-cluster sums: one cumsum and boundary differences (no float
    atomics, and a fixed-order scan, so a GPU run repeats bit for bit)."""
    return per_cluster_sums_multi(values_s[None], order)[0]


def per_cluster_sums_multi(values_s: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """(C, HW) stream-order rows -> (C, M) per-cluster sums, through one
    fixed-order scan along the rows."""
    zero = torch.zeros((values_s.shape[0], 1), dtype=values_s.dtype, device=values_s.device)
    csum = torch.cat([zero, fixed_order_cumsum(values_s)], -1)
    starts = order.starts.to(torch.int64)
    return csum[:, starts + order.counts] - csum[:, starts]


def expand_per_cluster(values: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """(M,) per-cluster values -> (HW,) per stream slot: a plain gather, so
    every slot holds its cluster's value bit for bit."""
    return values[order.seg]


def expand_per_cluster_multi(values: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """(C, M) -> (C, HW): the row-stacked :func:`expand_per_cluster`."""
    return values[:, order.seg]


def point_means_stream(ri_s: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """Per-cluster mean range; rows 0 (ground) and 1 (zero pixels) are 0."""
    sums = per_cluster_sums(ri_s, order)
    cnt = torch.clamp(order.counts.to(ri_s.dtype), min=1.0)
    mean = torch.where(order.counts > 0, sums / cnt, 0.0)
    mean[:2] = 0.0
    return mean


def predict_stream(
    model_param: torch.Tensor,  # (M, 4)
    order: StreamOrder,
    rays_s: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Intra-prediction per stream slot: the slot's model row, gathered.
    A point model (a+b+c == 0 exactly) predicts d; a plane predicts
    -d / (n . ray), and 0 where the ray lies in the plane."""
    a, b, c, d = model_param[order.seg].unbind(-1)
    tx, ty, tz = rays_s
    is_point = (a + b + c) == 0.0
    denom = a * tx + b * ty + c * tz
    safe = torch.where(denom == 0.0, 1.0, denom)
    plane_pred = torch.where(denom == 0.0, 0.0, -d / safe)
    return torch.where(is_point, d, plane_pred)


def rays_from_perm(order: StreamOrder, lidar) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan-ray planes of each stream slot, computed from (row, col) in f32
    (even-distribution LiDARs), the formula of the reference's device
    graph."""
    W, H = lidar.width, lidar.height
    row = (order.perm // W).to(torch.float32)
    col = (order.perm % W).to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=row.device)  # noqa: E731
    vfov = lidar.vertical_max - lidar.vertical_min
    alt = f32(vfov) * row / f32(H - 1) + f32(lidar.vertical_min)
    az = f32(lidar.horizontal_fov) * col / f32(W)
    cos_alt = torch.cos(alt)
    return cos_alt * torch.cos(az), cos_alt * torch.sin(az), torch.sin(alt)


def stream_to_pixel(values_s: torch.Tensor, order: StreamOrder) -> torch.Tensor:
    """Invert the stream permutation: one scatter by the pixel index."""
    out = torch.empty_like(values_s)
    out[order.perm] = values_s
    return out


def compact_flagged_small(
    flags_flat: torch.Tensor, values_flat: torch.Tensor, value_bits: int = 12
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-pack ``values[flags]`` (small non-negative values < 2^value_bits)
    in position order, tail-padded; returns ``(values, count)``.  One sort
    of the packed int32 ``(1 - flag | position | value)``."""
    hw = flags_flat.shape[0]
    if hw >= (1 << _IOTA_BITS) or value_bits + _IOTA_BITS + 1 > 31:
        raise ValueError("packed compaction key overflows int32")
    iota = torch.arange(hw, dtype=torch.int32, device=flags_flat.device)
    inv = 1 - flags_flat.to(torch.int32)
    packed = (inv << (_IOTA_BITS + value_bits)) | (iota << value_bits) | values_flat.to(torch.int32)
    pk = torch.sort(packed).values
    return pk & ((1 << value_bits) - 1), flags_flat.to(torch.int32).sum()


def compact_flagged_positions(flags_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions of set flags first (ascending), then the rest (ascending):
    a full permutation, plus the count of set flags."""
    hw = flags_flat.shape[0]
    if hw >= (1 << _IOTA_BITS):
        raise ValueError("packed compaction key overflows int32")
    iota = torch.arange(hw, dtype=torch.int32, device=flags_flat.device)
    inv = 1 - flags_flat.to(torch.int32)
    pk = torch.sort((inv << _IOTA_BITS) | iota).values
    return pk & ((1 << _IOTA_BITS) - 1), flags_flat.to(torch.int32).sum()
