"""Single-frame codec: host projection -> encoder -> entropy -> ``.rpcc``
and back (port of ``rpcc_tpu/models/pipeline.py::RPCCCodec``).

The ``.rpcc`` byte layout (with the u8 ``salience_level`` field first in
non-uniform mode), the field dtypes and the timing keys are the
reference's, so blobs cross-decode between the two packages.

On a card the codec uploads the raw cloud and projects it there
(``ops/projection_device.py``, the kernel ``csrc/raster.cu``): the same
grid and delta as the host projection, handed to the encoder as device
tensors, with nothing downloaded and no wait before the graph.  On the CPU
it projects on the host (``ops/projection_host.py``).

``compress`` runs in the span ``codec.compress`` (``utils/timer.py``), its
steps in ``codec.upload`` and ``codec.project`` (on the CPU in the other
order), the encoder's ``graph``, ``codec.device_wait`` (the synchronise
after the graph), ``codec.gather_fields``, ``codec.entropy`` and
``codec.framing``, each with the frame's number in the codec's
compresses; its timing dict comes from the same stamps.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rpcc_tpu_torch.codec.bitstream import pack_bitstream, unpack_bitstream
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.models.decoder import Decoder
from rpcc_tpu_torch.models.encoder import Encoder, EncoderOutput, count_model_rows, num_model_rows
from rpcc_tpu_torch.ops import projection_device
from rpcc_tpu_torch.ops.projection_host import build_transform_map, project_for_encoder
from rpcc_tpu_torch.utils import timer


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device must exist: without
    a card this raises, and nothing falls back to the CPU unless the CPU is
    asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but no CUDA device is available; pass 'cpu' for the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RPCCCodec:
    """A configured encoder/decoder pair for one LiDAR geometry on one
    device: the card unless the CPU is asked for."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig, device="cuda"):
        self.lidar = lidar
        self.cfg = cfg
        self.device = resolve_device(device)
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self.num_models = num_model_rows(cfg)
        self.transform_map = build_transform_map(lidar)  # (H, W, 3) np.float32
        # Device entropy is the batch engine's path: this codec codes the
        # downloaded fields' containers (on its device), so its encoder leaves
        # the flag off (as the reference's).
        self.encoder = Encoder.for_lidar(lidar, cfg.replace(device_entropy=False)).to(self.device)
        self.decoder = Decoder(lidar, cfg).to(self.device)
        self.entropy = BasicCompressor(method_name=cfg.basic_compressor, contour_shape=(self.H, self.W),
                                       device=self.device)
        self._frames = itertools.count()  # the batch number of each compress's spans
        self._projection = None  # the projection kernel's workspace, made at a card's first encode

    @property
    def _step_arg(self):
        """The uniform step, or in non-uniform mode the step of each
        salience level (the reference's ``_step_arg``)."""
        return self.cfg.step if self.cfg.uniform else self.cfg.level_acc

    # ------------------------------------------------------------- encode
    def project(self, points: np.ndarray) -> Tuple[np.ndarray, np.float32]:
        """Host projection: ``(q (H, W), delta)``, the encoder's range image
        being ``q * delta`` in f32.  ``q`` is the u16 snap grid, or with
        ``transfer_precision="f32"`` the exact f32 range image (delta 1)."""
        return project_for_encoder(points, self.lidar, self.cfg)

    def encode_device(self, points: np.ndarray, seed: Optional[int] = None) -> EncoderOutput:
        """Project (on a card: upload the cloud, project it there; on the
        CPU: on the host), run the encoder; returns device tensors."""
        if self.device.type == "cuda":
            if self._projection is None:
                self._projection = projection_device.Workspace(self.lidar, self.cfg, self.device)
            with timer.span("codec.upload"):
                pts = self._projection.upload(points)
            with timer.span("codec.project"):
                q_t, d_t = projection_device.project_cuda(pts, self._projection)
        else:
            with timer.span("codec.project"):
                q, d = self.project(points)
            with timer.span("codec.upload"):
                q_t = torch.from_numpy(q if q.dtype == np.float32 else q.astype(np.int32)).to(self.device)
                d_t = torch.tensor(d, dtype=torch.float32, device=self.device)
        seed = self.cfg.seed if seed is None else seed
        return self.encoder(q_t, d_t, seed, self._step_arg)

    def fields_from_device(self, out: EncoderOutput) -> Dict[str, np.ndarray]:
        """Trim fixed-shape encoder outputs into bitstream field arrays (the
        model table's rows counted, ``models.rows`` / ``models.plane_rows``)."""
        stream_len = int(out.stream_len)
        seq_len = int(out.seq_len)
        fields = {
            "residual_quantized": out.stream[:stream_len].cpu().numpy(),
            "contour_map": out.contour_packed.cpu().numpy(),
            "idx_sequence": out.sequence[:seq_len].cpu().numpy(),
            "plane_param": out.model_param.cpu().numpy().astype(np.float32),
        }
        count_model_rows(fields["plane_param"])
        if out.salience is not None:
            fields["salience_level"] = out.salience.cpu().numpy().astype(np.uint8)
        return fields

    def compress(
        self, points: np.ndarray, seed: Optional[int] = None
    ) -> Tuple[bytes, Dict[str, np.ndarray], Dict[str, float]]:
        """points -> (.rpcc payload bytes, raw fields, stage timings in s:
        ``device_encode`` (projection, upload, the graph to its
        synchronise), ``gather_fields``, ``entropy``, ``framing``)."""
        with timer.span("codec.compress", next(self._frames), stamp=True) as whole:
            out = self.encode_device(points, seed)
            with timer.span("codec.device_wait", stamp=True) as wait:
                _sync(self.device)
            with timer.span("codec.gather_fields", stamp=True) as gather:
                fields = self.fields_from_device(out)
            with timer.span("codec.entropy", stamp=True) as entropy:
                compressed = self.entropy.compress_dict(fields)
            with timer.span("codec.framing", stamp=True) as framing:
                blob = pack_bitstream(compressed, uniform=self.cfg.uniform)
        times = {
            "device_encode": (wait.end_ns - whole.start_ns) / 1e9,
            "gather_fields": gather.wall_ns / 1e9,
            "entropy": entropy.wall_ns / 1e9,
            "framing": framing.wall_ns / 1e9,
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
