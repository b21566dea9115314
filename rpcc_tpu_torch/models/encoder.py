"""The encoder graph (port of ``rpcc_tpu/models/encoder.py``, the u16-snap
``from_ri`` path): FPS or DBSCAN segmentation, point or plane models,
uniform or non-uniform (salience) quantization.

Input: the (H, W) u16 snap grid ``q`` and its per-frame ``delta``
(``ri = q * delta``, projected on the host).  Output: every codec artefact
the host entropy-codes — segmentation, model table, the cluster-ordered
quantized residual stream, the contour code and, in non-uniform mode, the
per-cluster salience levels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from rpcc_tpu.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.contour import extract_contour, pack_bits_msb
from rpcc_tpu_torch.ops.features import extract_features_with_segment, salience_levels_from_counts
from rpcc_tpu_torch.ops.modeling import plane_models_stream, point_model_table
from rpcc_tpu_torch.ops.projection_host import build_transform_planes
from rpcc_tpu_torch.ops.rounding import round_half_away
from rpcc_tpu_torch.ops.segment import segment_range_image, segment_range_image_dbscan
from rpcc_tpu_torch.ops.stream import (
    expand_per_cluster,
    per_cluster_sums,
    point_means_stream,
    predict_stream,
    rays_from_perm,
    stream_sort,
)


def num_model_rows(cfg: CodecConfig) -> int:
    """Model-table rows: FPS = ground + zero-class + K clusters (DBSCAN adds
    a noise class).  Seg ids ride a 12-bit field of the packed contour
    sort, so more than 4095 ids would corrupt the idx_sequence field."""
    rows = cfg.cluster_num + (3 if cfg.segment_method == "DBSCAN" else 2)
    if rows >= (1 << 12):
        raise ValueError(
            f"cluster_num={cfg.cluster_num} needs {rows} model ids, over the "
            f"codec's 4095-id limit"
        )
    return rows


def check_supported(lidar: LidarConfig, cfg: CodecConfig) -> None:
    """Raise for the modes of ``rpcc_tpu`` this port does not carry yet."""
    unsupported = []
    if not lidar.even_dist:
        unsupported.append("uneven (CSV) lidar")
    if cfg.cpu_fps:
        unsupported.append("cpu_fps")
    if cfg.transfer_precision == "f32":
        unsupported.append("transfer_precision=f32")
    if unsupported:
        raise NotImplementedError("not ported yet: " + ", ".join(unsupported))


class EncoderOutput(NamedTuple):
    range_image: torch.Tensor  # (H, W) f32
    seg_idx: torch.Tensor  # (H, W) i32
    model_param: torch.Tensor  # (M, 4) f32; row 0 = ground plane
    stream: torch.Tensor  # (HW,) i16 quantized residuals, tail-padded
    stream_len: torch.Tensor  # () number of live residuals
    contour_packed: torch.Tensor  # (ceil(HW/8),) u8, np.packbits layout
    sequence: torch.Tensor  # (HW,) u16 run values, tail-padded
    seq_len: torch.Tensor  # () number of live run values
    salience: Optional[torch.Tensor] = None  # (M,) u8 levels; non-uniform mode only


class Encoder(nn.Module):
    """Single-frame encoder over a (3, H, W) ray table (e.g. the JAX
    package's ``build_transform_planes`` output); ``.to(device)`` moves the
    table."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig, tm_planes: np.ndarray):
        super().__init__()
        check_supported(lidar, cfg)
        self.lidar, self.cfg = lidar, cfg
        self.num_models = num_model_rows(cfg)
        self.register_buffer("tm_planes", torch.from_numpy(np.asarray(tm_planes, np.float32)))

    @classmethod
    def for_lidar(cls, lidar: LidarConfig, cfg: CodecConfig) -> "Encoder":
        return cls(lidar, cfg, build_transform_planes(lidar))

    @torch.no_grad()
    def forward(
        self, q: torch.Tensor, delta: torch.Tensor, seed: int, step: Union[float, Sequence[float]]
    ) -> EncoderOutput:
        """``q``: (H, W) integer snap grid on this module's device; ``delta``:
        0-d f32 tensor; ``seed``: uint32; ``step``: the quantization step, or
        in non-uniform mode the step of each salience level."""
        cfg = self.cfg
        dev = self.tm_planes.device
        H, W = q.shape
        hw = H * W
        k_seg, k_model = prng.split(prng.prng_key(seed, dev))

        ri = q.to(torch.float32) * delta
        pc_planes = ri[None] * self.tm_planes
        if cfg.segment_method == "DBSCAN":
            seg, ground_model, _ = segment_range_image_dbscan(
                pc_planes, ri, self.tm_planes, k_seg, cfg.dbscan_eps, cfg.cluster_num
            )
        else:
            seg, ground_model, _ = segment_range_image(
                pc_planes, ri, self.tm_planes, k_seg, cfg.ground_threshold, cfg.cluster_num
            )

        payloads = [ri.reshape(-1)]
        if not cfg.uniform:
            _, kp_map = extract_features_with_segment(
                ri, seg, feature_region=cfg.feature_region, segments=cfg.segments,
                sharp_num=cfg.sharp_num, less_sharp_num=cfg.less_sharp_num,
                flat_num=cfg.flat_num, want_feature_map=False,
            )
            payloads.append((kp_map.reshape(-1) > 0).to(torch.float32))
        order, carried = stream_sort(seg.reshape(-1), payloads, self.num_models)
        ri_s = carried[0]
        rays_s = rays_from_perm(order, self.lidar)
        if cfg.modeling_method == "point":
            model_param = point_model_table(point_means_stream(ri_s, order), self.num_models)
        else:
            model_param = plane_models_stream(
                ri_s, order, k_model, self.num_models, cfg.plane_angle_threshold, rays_s
            ).table
        model_param[0] = ground_model

        resid_s = ri_s - predict_stream(model_param, order, rays_s)
        salience = None
        if cfg.uniform:
            step_s = torch.tensor(step, dtype=torch.float32, device=dev)
        else:
            kp_cnt = per_cluster_sums(carried[1], order).to(torch.int32)  # exact: 0/1 sums
            sal = salience_levels_from_counts(
                kp_cnt, order.counts, cfg.level_key_point_num, cfg.ground_salience_level
            )
            step_table = torch.tensor(step, dtype=torch.float32, device=dev)
            step_s = expand_per_cluster(step_table[sal.to(torch.int64)], order)
            salience = sal.to(torch.uint8)
        qs = round_half_away(resid_s / step_s).to(torch.int32)
        live = torch.arange(hw, device=dev) < order.stream_len
        qs = torch.where(live, qs, 0)

        code = extract_contour(seg)
        return EncoderOutput(
            range_image=ri,
            seg_idx=seg,
            model_param=model_param,
            stream=qs.to(torch.int16),  # wraps like the reference's int16 cast
            stream_len=order.stream_len,
            contour_packed=pack_bits_msb(code.contour),
            sequence=code.sequence.to(torch.uint16),
            seq_len=code.seq_len,
            salience=salience,
        )
