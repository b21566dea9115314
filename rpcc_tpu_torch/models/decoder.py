"""The decoder graph (port of ``rpcc_tpu/models/decoder.py``, the range-image
path): recover the seg map from the contour code, rebuild the stream
order (a function of the seg map alone), predict, dequantize with the
uniform step or each cluster's salience-level step, and place the stream
back in pixel order.  A batch runs as one graph over (B, ...) inputs; a
single frame is the B = 1 case."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.models.encoder import num_model_rows
from rpcc_tpu_torch.ops.contour import recover_map, unpack_bits_msb
from rpcc_tpu_torch.ops.projection_host import build_transform_planes
from rpcc_tpu_torch.ops.stream import expand_per_cluster, predict_stream, stream_sort, stream_to_pixel


class DecoderOutput(NamedTuple):
    range_image: torch.Tensor  # (B, H, W) f32
    seg_idx: torch.Tensor  # (B, H, W) i32


class Decoder(nn.Module):
    """Batched decoder.  Plane predictions take the scan rays of the host
    decoder's (3, H, W) table, gathered in stream order, so a decoded range
    image equals the host decoder's (``models/host_decoder.py``, native
    ``decode.cpp``) bit for bit; ``.to(device)`` moves the table.  (The JAX
    device decoder recomputes the rays from (row, col) to avoid that gather
    on the TPU; those rays differ from the table's by f32 ulps.)"""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig):
        super().__init__()
        self.lidar, self.cfg = lidar, cfg
        self.num_models = num_model_rows(cfg)
        tm = build_transform_planes(lidar).reshape(3, -1)
        self.register_buffer("tm_flat", torch.from_numpy(np.ascontiguousarray(tm, np.float32)))

    @torch.no_grad()
    def forward(
        self,
        contour_packed: torch.Tensor,  # (B, ceil(HW/8)) u8
        sequence: torch.Tensor,  # (B, m) int run values, zero-padded
        stream: torch.Tensor,  # (B, n) int residuals, zero-padded; the tail is the zero class
        model_param: torch.Tensor,  # (B, M, 4) f32, zero-padded rows
        step: Union[float, Sequence[float]],  # uniform step, or per-level steps
        salience: Optional[torch.Tensor] = None,  # (B, M) int levels; non-uniform mode
    ) -> DecoderOutput:
        """A single frame's 1-D fields and (M, 4) table give unbatched
        outputs."""
        if contour_packed.ndim == 1:
            out = self(
                contour_packed[None], sequence[None], stream[None], model_param[None], step,
                None if salience is None else salience[None],
            )
            return DecoderOutput(*(f[0] for f in out))
        H, W = self.lidar.height, self.lidar.width
        hw = H * W
        B = contour_packed.shape[0]
        dev = contour_packed.device
        s32 = torch.zeros((B, hw), dtype=torch.int32, device=dev)
        n = min(stream.shape[1], hw)
        s32[:, :n] = stream[:, :n].to(torch.int32)
        contour = unpack_bits_msb(contour_packed, hw).reshape(B, H, W)
        seg = recover_map(contour, sequence)
        order, _ = stream_sort(seg.reshape(B, hw), [], self.num_models)
        rays_s = tuple(self.tm_flat[i][order.perm] for i in range(3))
        pred_s = predict_stream(model_param, order, rays_s)
        step_t = torch.tensor(step, dtype=torch.float32, device=dev)
        if not self.cfg.uniform:
            # Out-of-range levels clamp, as the reference's gather does.
            level = torch.clamp(salience.to(torch.int64), 0, step_t.shape[0] - 1)
            step_t = expand_per_cluster(step_t[level], order)
        ri_s = pred_s + s32.to(torch.float32) * step_t
        return DecoderOutput(stream_to_pixel(ri_s, order).reshape(B, H, W), seg)
