"""Single-frame codec: host projection -> encoder -> entropy -> ``.rpcc``
and back (port of ``rpcc_tpu/models/pipeline.py::RPCCCodec``).

The ``.rpcc`` byte layout (with the u8 ``salience_level`` field first in
non-uniform mode), the field dtypes and the timing keys are the
reference's, so blobs cross-decode between the two packages.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rpcc_tpu.codec.bitstream import pack_bitstream, unpack_bitstream
from rpcc_tpu.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.models.decoder import Decoder
from rpcc_tpu_torch.models.encoder import Encoder, EncoderOutput, num_model_rows
from rpcc_tpu_torch.ops.projection_host import build_transform_map, project_points_host_u16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RPCCCodec:
    """A configured encoder/decoder pair for one LiDAR geometry on one
    explicitly named device."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig, device):
        self.lidar = lidar
        self.cfg = cfg
        self.device = torch.device(device)
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self.num_models = num_model_rows(cfg)
        self.transform_map = build_transform_map(lidar)  # (H, W, 3) np.float32
        self.encoder = Encoder.for_lidar(lidar, cfg).to(self.device)
        self.decoder = Decoder(lidar, cfg).to(self.device)
        self.entropy = BasicCompressor(method_name=cfg.basic_compressor, contour_shape=(self.H, self.W))

    @property
    def _step_arg(self):
        """The uniform step, or in non-uniform mode the step of each
        salience level (the reference's ``_step_arg``)."""
        return self.cfg.step if self.cfg.uniform else self.cfg.level_acc

    # ------------------------------------------------------------- encode
    def project(self, points: np.ndarray) -> Tuple[np.ndarray, np.float32]:
        """Host projection to the u16 snap grid: ``(q (H, W) u16, delta)``;
        the encoder's range image is ``q * delta`` in f32."""
        pts = np.asarray(points, np.float32)[:, :3]
        return project_points_host_u16(pts, self.lidar, np.float32(self.cfg.step / 16.0))

    def encode_device(self, points: np.ndarray, seed: Optional[int] = None) -> EncoderOutput:
        """Host-project, upload, run the encoder; returns device tensors."""
        q, d = self.project(points)
        q_t = torch.from_numpy(q.astype(np.int32)).to(self.device)
        d_t = torch.tensor(d, dtype=torch.float32, device=self.device)
        seed = self.cfg.seed if seed is None else seed
        return self.encoder(q_t, d_t, seed, self._step_arg)

    def fields_from_device(self, out: EncoderOutput) -> Dict[str, np.ndarray]:
        """Trim fixed-shape encoder outputs into bitstream field arrays."""
        stream_len = int(out.stream_len)
        seq_len = int(out.seq_len)
        fields = {
            "residual_quantized": out.stream[:stream_len].cpu().numpy(),
            "contour_map": out.contour_packed.cpu().numpy(),
            "idx_sequence": out.sequence[:seq_len].cpu().numpy(),
            "plane_param": out.model_param.cpu().numpy().astype(np.float32),
        }
        if out.salience is not None:
            fields["salience_level"] = out.salience.cpu().numpy().astype(np.uint8)
        return fields

    def compress(
        self, points: np.ndarray, seed: Optional[int] = None
    ) -> Tuple[bytes, Dict[str, np.ndarray], Dict[str, float]]:
        """points -> (.rpcc payload bytes, raw fields, stage timings)."""
        t0 = time.perf_counter()
        out = self.encode_device(points, seed)
        _sync(self.device)
        t1 = time.perf_counter()
        fields = self.fields_from_device(out)
        t2 = time.perf_counter()
        compressed = self.entropy.compress_dict(fields)
        t3 = time.perf_counter()
        blob = pack_bitstream(compressed, uniform=self.cfg.uniform)
        t4 = time.perf_counter()
        times = {
            "device_encode": t1 - t0,
            "gather_fields": t2 - t1,
            "entropy": t3 - t2,
            "framing": t4 - t3,
        }
        return blob, fields, times

    # ------------------------------------------------------------- decode
    def fields_to_device(self, fields: Dict[str, bytes]):
        """Entropy-decoded field bytes -> decoder input tensors."""
        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        contour = up(np.frombuffer(fields["contour_map"], np.uint8).copy())
        seq = up(np.frombuffer(fields["idx_sequence"], np.uint16).astype(np.int32))
        stream = up(np.frombuffer(fields["residual_quantized"], np.int16).astype(np.int32))
        # True model count from the field length, not cluster_num.
        model_param = up(np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4).copy())
        salience = None
        if "salience_level" in fields:
            salience = up(np.frombuffer(fields["salience_level"], np.uint8).astype(np.int32))
        return contour, seq, stream, model_param, salience

    def decompress(self, blob: bytes) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """.rpcc payload -> ((H, W, 3) cloud, (H, W) range image, timings)."""
        t0 = time.perf_counter()
        compressed = unpack_bitstream(blob, uniform=self.cfg.uniform)
        fields = self.entropy.decompress_dict(compressed)
        t1 = time.perf_counter()
        contour, seq, stream, model_param, salience = self.fields_to_device(fields)
        dec = self.decoder(contour, seq, stream, model_param, self._step_arg, salience)
        ri = dec.range_image.cpu().numpy()  # waits for the device
        pc = ri[..., None] * self.transform_map
        t2 = time.perf_counter()
        return pc, ri, {"entropy": t1 - t0, "device_decode": t2 - t1}
