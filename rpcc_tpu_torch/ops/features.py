"""LOAM-style key points and salience levels for non-uniform quantization
(port of ``rpcc_tpu/ops/features.py``).

Per row, the valid pixels are compacted and each gets the curvature
``(sum_{|k|<=r}(v[s+k] - v[s]))^2 / (2r * v[s])``.  Per sector the reference
labels, in (curvature desc, entry desc) order, the gap-passing entries
ranked 1..sharp-1 as 3 ("sharp") and sharp..less_sharp-1 as 2, and stops
at the less_sharp-th; among the entries never visited, with nonzero
curvature, in (curvature asc, entry asc) order, those ranked 1..flat-1 as
1 ("flat").  One global sort by (group, curvature desc, entry desc) and
segmented integer cumsums give every rank at once.  A pixel fails the gap
check when it lies more than 0.3 m behind a neighbour within +-r in the
flat buffer (rows wrap; clamped at the image ends).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rpcc_tpu_torch.ops.stream import fixed_order_cumsum

NEAR_THRESHOLD = 0.2  # cpp_modules.cpp:11 (inert, see rpcc_tpu/ops/features.py)
GAP_THRESHOLD = 0.3  # cpp_modules.cpp:11


def _shift_clamp_axis1(x: torch.Tensor, i: int) -> torch.Tensor:
    """``x[:, clip(j + i, 0, W - 1)]``."""
    idx = torch.clamp(torch.arange(x.shape[1], device=x.device) + i, 0, x.shape[1] - 1)
    return x[:, idx]


def _gap_ok(range_image: torch.Tensor, feature_region: int) -> torch.Tensor:
    """Occlusion check per pixel on the flat buffer, clamped at its ends."""
    flat = range_image.reshape(-1)
    n = flat.shape[0]
    pos = torch.arange(n, device=flat.device)
    ok = torch.ones_like(flat, dtype=torch.bool)
    for i in range(-feature_region, feature_region + 1):
        ok = ok & ((flat - flat[torch.clamp(pos + i, 0, n - 1)]) <= GAP_THRESHOLD)
    return ok.reshape(range_image.shape)


def _row_compact(values: torch.Tensor, cols_payload: torch.Tensor, valid: torch.Tensor):
    """Per-row compaction of valid pixels in column order, carrying a
    payload.  Returns (compacted values, compacted payload, original column
    per slot, per-row valid count)."""
    H, W = values.shape
    col_iota = torch.arange(W, dtype=torch.int32, device=values.device).expand(H, W)
    key = torch.where(valid, col_iota, W + col_iota)  # unique per row
    cols = torch.argsort(key, dim=1)
    counts = valid.to(torch.int32).sum(1)
    comp = torch.where(col_iota < counts[:, None], values.gather(1, cols), 0.0)
    return comp, cols_payload.gather(1, cols), cols.to(torch.int32), counts


def _extract(
    range_image: torch.Tensor,
    valid: torch.Tensor,
    feature_region: int,
    segments: int,
    sharp_num: int,
    less_sharp_num: int,
    flat_num: int,
    want_feature_map: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    H, W = range_image.shape
    hw = H * W
    r = feature_region
    dev = range_image.device
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]

    gap = _gap_ok(range_image, r)
    vri, vgap, vcol, counts = _row_compact(range_image, gap.to(torch.int32), valid)
    row_ok = counts >= segments + 2 * r + 1

    # Curvature over compacted slots: win(s) = sum v[s-r..s+r] by prefix
    # sums, in the reference's summation order (the window cancels to a few
    # cm of sums of thousands of metres, so the order decides near-ties).
    pad = torch.zeros((H, r), dtype=vri.dtype, device=dev)
    csum = fixed_order_cumsum(torch.cat([pad, vri, pad], 1))
    csum = torch.cat([torch.zeros((H, 1), dtype=vri.dtype, device=dev), csum], 1)
    win = csum[:, 2 * r + 1 :] - csum[:, :W]
    safe_v = torch.where(vri != 0, vri, 1.0)
    diff = win - (2 * r + 1) * vri
    feat = diff * diff / (2.0 * r) / safe_v

    # Entries t = s - r for slots s in [r, L - r): n = L - 2r per row.
    n = torch.clamp(counts - 2 * r, min=0)
    sector_w = n // segments
    t = torch.arange(W, dtype=torch.int32, device=dev).expand(H, W)
    entry_valid = (t < (sector_w * segments)[:, None]) & (sector_w > 0)[:, None] & row_ok[:, None]
    entry_exists = (t < n[:, None]) & row_ok[:, None]
    sec = torch.where(entry_valid, t // torch.clamp(sector_w, min=1)[:, None], segments)

    efeat = _shift_clamp_axis1(feat, r)
    ecol = _shift_clamp_axis1(vcol, r)  # original column of the entry
    epass = (_shift_clamp_axis1(vgap, r) > 0) & entry_valid
    pix = (rows * W + ecol).reshape(-1).to(torch.int64)

    feat_map = None
    if want_feature_map:
        dest = torch.where(entry_exists.reshape(-1), pix, hw)
        feat_map = torch.zeros(hw + 1, dtype=torch.float32, device=dev)
        feat_map = feat_map.scatter(0, dest, efeat.reshape(-1))[:hw].reshape(H, W)

    # Group = row * segments + sector; invalid entries form a trailing group.
    grp = torch.where(entry_valid, rows * segments + sec, H * segments).reshape(-1)
    num_groups = H * segments + 1
    f = efeat.reshape(-1)
    # Order by (group asc, curvature desc, entry desc): stable sorts in
    # reverse key order.  Entries are unique within a row, so every valid
    # group is totally ordered; ties only occur in the invalid group.
    perm = torch.argsort(-t.reshape(-1), stable=True)
    perm = perm[torch.argsort(-f[perm], stable=True)]
    perm = perm[torch.argsort(grp[perm], stable=True)]
    g_s, f_s = grp[perm], f[perm]
    p_s, ev_s, pix_s = epass.reshape(-1)[perm], entry_valid.reshape(-1)[perm], pix[perm]

    gids = torch.arange(num_groups, dtype=g_s.dtype, device=dev)
    grp_start = torch.searchsorted(g_s, gids, right=False)

    def group_base(csum_i: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """csum_i just before each group boundary ``at`` (0 at the start)."""
        return torch.where(at > 0, csum_i[torch.clamp(at - 1, min=0)], 0)

    # Rank of each passing entry within its group, sharp (desc) order.
    pass_i = p_s.to(torch.int32)
    csum_p = torch.cumsum(pass_i, 0)
    cum_in_grp = csum_p - group_base(csum_p, grp_start)[g_s]
    label3 = p_s & (cum_in_grp <= sharp_num - 1)
    label2 = p_s & (cum_in_grp >= sharp_num) & (cum_in_grp <= less_sharp_num - 1)
    visited = (cum_in_grp - pass_i) < less_sharp_num  # reached before the break

    # Flat phase: ascending ranks among unvisited nonzero-curvature entries.
    cand = (~visited) & (f_s != 0) & ev_s
    fc = (cand & p_s).to(torch.int32)
    csum_f = torch.cumsum(fc, 0)
    base_f = group_base(csum_f, grp_start)
    end_f = torch.cat([grp_start[1:], torch.full((1,), hw, dtype=grp_start.dtype, device=dev)])
    total_f = (group_base(csum_f, end_f) - base_f)[g_s]
    asc_rank = total_f - (csum_f - base_f[g_s]) + fc
    label1 = cand & p_s & (asc_rank <= flat_num - 1)

    kp_val = torch.where(label3, 3, torch.where(label2, 2, torch.where(label1, 1, 0))).to(torch.int32)
    dest = torch.where((kp_val > 0) & ev_s, pix_s, hw)
    kp = torch.zeros(hw + 1, dtype=torch.int32, device=dev).scatter(0, dest, kp_val)
    return feat_map, kp[:hw].reshape(H, W)


def extract_features_with_segment(
    range_image: torch.Tensor,
    seg_idx: torch.Tensor,
    feature_region: int = 3,
    segments: int = 8,
    sharp_num: int = 4,
    less_sharp_num: int = 8,
    flat_num: int = 6,
    want_feature_map: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(curvature map or None, (H, W) int32 key-point labels 0-3) over the
    non-ground, non-zero pixels (seg ids other than 0 and 1)."""
    valid = (seg_idx != 0) & (seg_idx != 1)
    return _extract(
        range_image, valid, feature_region, segments, sharp_num,
        less_sharp_num, flat_num, want_feature_map,
    )


def salience_levels_from_counts(
    kp_cnt: torch.Tensor,  # (M,) per-cluster key-point counts
    counts: torch.Tensor,  # (M,) per-cluster pixel counts
    level_kp_num: Tuple[int, ...],
    ground_level: int,
) -> torch.Tensor:
    """Per-cluster salience level: ground -> ``ground_level``; the zero
    class and clusters under 30 pixels -> the last level; otherwise the
    first level whose key-point threshold is met (the last is 0)."""
    num_levels = len(level_kp_num)
    thresholds = torch.tensor(level_kp_num, dtype=torch.int32, device=kp_cnt.device)
    meets = (kp_cnt[:, None] >= thresholds[None, :]).to(torch.int32)
    first = torch.argmax(meets, dim=1).to(torch.int32)  # first met, or 0
    lvl = torch.where(counts < 30, num_levels - 1, first).to(torch.int32)
    lvl[0] = ground_level
    lvl[1] = num_levels - 1
    return lvl
