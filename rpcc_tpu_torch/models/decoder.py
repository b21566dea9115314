"""The decoder graph (port of ``rpcc_tpu/models/decoder.py``, the range-image
path): recover the seg map from the contour code, rebuild the stream
order (a function of the seg map alone), predict, dequantize with the
uniform step or each cluster's salience-level step, and place the stream
back in pixel order."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from rpcc_tpu.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.models.encoder import check_supported, num_model_rows
from rpcc_tpu_torch.ops.contour import recover_map, unpack_bits_msb
from rpcc_tpu_torch.ops.stream import (
    expand_per_cluster,
    predict_stream,
    rays_from_perm,
    stream_sort,
    stream_to_pixel,
)


class DecoderOutput(NamedTuple):
    range_image: torch.Tensor  # (H, W) f32
    seg_idx: torch.Tensor  # (H, W) i32


class Decoder(nn.Module):
    """Single-frame decoder.  Evenly distributed LiDARs compute their rays
    from the stream permutation, so the module holds no table."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig):
        super().__init__()
        check_supported(lidar, cfg)
        self.lidar, self.cfg = lidar, cfg
        self.num_models = num_model_rows(cfg)

    @torch.no_grad()
    def forward(
        self,
        contour_packed: torch.Tensor,  # (ceil(HW/8),) u8
        sequence: torch.Tensor,  # (<= HW,) int run values
        stream: torch.Tensor,  # (<= HW,) int residuals; the tail is the zero class
        model_param: torch.Tensor,  # (M, 4) f32
        step: Union[float, Sequence[float]],  # uniform step, or per-level steps
        salience: Optional[torch.Tensor] = None,  # (M,) int levels; non-uniform mode
    ) -> DecoderOutput:
        H, W = self.lidar.height, self.lidar.width
        hw = H * W
        dev = contour_packed.device
        s32 = torch.zeros(hw, dtype=torch.int32, device=dev)
        s32[: stream.shape[0]] = stream.to(torch.int32)
        contour = unpack_bits_msb(contour_packed, hw).reshape(H, W)
        seg = recover_map(contour, sequence)
        order, _ = stream_sort(seg.reshape(-1), [], self.num_models)
        pred_s = predict_stream(model_param, order, rays_from_perm(order, self.lidar))
        step_t = torch.tensor(step, dtype=torch.float32, device=dev)
        if not self.cfg.uniform:
            # Out-of-range levels clamp, as the reference's gather does.
            level = torch.clamp(salience.to(torch.int64), 0, step_t.shape[0] - 1)
            step_t = expand_per_cluster(step_t[level], order)
        ri_s = pred_s + s32.to(torch.float32) * step_t
        return DecoderOutput(stream_to_pixel(ri_s, order).reshape(H, W), seg)
