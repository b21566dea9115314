"""Host decoder: ``.rpcc`` bitstream -> range image / points, no device.

JAX-free copy of ``rpcc_tpu/models/host_decoder.py``'s ``HostDecoder``:
the reconstruction (run-length seg fill, cluster-ordered dequantize,
intra-predict) runs in the port's native host library
(``csrc/host/decode.cpp``, a copy of the reference's), which raises if it
cannot build, so no numpy twin is kept.  It gives the same floats as
``rpcc_tpu``'s host decoder on the same blobs; the entropy stage batches
the big fields through this package's native rANS containers.
"""

from __future__ import annotations

import ctypes as ct
from typing import Dict, List, Optional, Sequence

import numpy as np

from rpcc_tpu_torch.codec.bitstream import unpack_bitstream
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.codec.native import native_lib
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.ops.projection_host import build_transform_planes


class HostDecoder:
    """Decode .rpcc payloads entirely on the host.

    ``decode_fields`` inverts the entropy-decoded field dict to the (H, W)
    range image; ``decode_blobs``/``decode_blobs_points`` take raw payloads
    and batch the entropy stage through the native rANS decoder.
    """

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig):
        self.lidar = lidar
        self.cfg = cfg
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self._tm = np.ascontiguousarray(build_transform_planes(lidar).reshape(3, self.hw), np.float32)
        self.entropy = BasicCompressor(method_name=cfg.basic_compressor, contour_shape=(self.H, self.W))
        self._level_acc = None if cfg.uniform else np.asarray(cfg.level_acc, np.float32)

    @staticmethod
    def _field_arrays(fields: Dict[str, bytes]):
        """Entropy-decoded field bytes -> (contour, seq, stream, models,
        salience|None) array views."""
        contour = np.frombuffer(fields["contour_map"], np.uint8)
        seq = np.frombuffer(fields["idx_sequence"], np.uint16)
        stream = np.frombuffer(fields["residual_quantized"], np.int16)
        models = np.frombuffer(fields["plane_param"], np.float32).reshape(-1, 4)
        sal = np.frombuffer(fields["salience_level"], np.uint8) if "salience_level" in fields else None
        return contour, seq, stream, models, sal

    def decode_fields(self, fields: Dict[str, bytes]) -> np.ndarray:
        return self.reconstruct(*self._field_arrays(fields))

    def reconstruct(
        self,
        contour_packed: np.ndarray,
        seq: np.ndarray,
        stream: np.ndarray,
        models: np.ndarray,
        salience: Optional[np.ndarray] = None,
        xyz_out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """-> (H, W) f32 range image; if ``xyz_out`` is a preallocated
        (HW, 4) f32 array, also fills it with the compacted xyz0 rows and
        stashes the row count on ``self.last_point_count``."""
        models = np.ascontiguousarray(models, np.float32)
        # Wire-derived fields feed raw C pointers below: validate lengths so
        # a truncated or corrupt .rpcc raises instead of reading out of bounds.
        if contour_packed.size < (self.hw + 7) // 8:
            raise ValueError(
                f"contour_map too short: {contour_packed.size} bytes for a {self.H}x{self.W} grid"
            )
        if models.ndim != 2 or models.shape[1] != 4 or models.shape[0] == 0:
            raise ValueError(f"plane_param must be (M, 4), got {models.shape}")
        if salience is not None and len(salience) < models.shape[0]:
            raise ValueError(f"salience_level has {len(salience)} entries for {models.shape[0]} model rows")
        lib = native_lib()
        contour_packed = np.ascontiguousarray(contour_packed, np.uint8)
        seq = np.ascontiguousarray(seq, np.uint16)
        stream = np.ascontiguousarray(stream, np.int16)
        sal_arr = None if salience is None else np.ascontiguousarray(salience, np.uint8)
        ri = np.empty(self.hw, np.float32)
        la = self._level_acc
        n = lib.host_decode_frame(
            contour_packed.ctypes.data_as(ct.c_void_p),
            seq.ctypes.data_as(ct.c_void_p),
            ct.c_int64(seq.shape[0]),
            stream.ctypes.data_as(ct.c_void_p),
            ct.c_int64(stream.shape[0]),
            models.ctypes.data_as(ct.c_void_p),
            ct.c_int32(models.shape[0]),
            None if sal_arr is None else sal_arr.ctypes.data_as(ct.c_void_p),
            None if la is None else la.ctypes.data_as(ct.c_void_p),
            ct.c_int32(0 if la is None else la.shape[0]),
            ct.c_float(np.float32(self.cfg.step)),
            self._tm.ctypes.data_as(ct.c_void_p),
            ct.c_int32(self.H),
            ct.c_int32(self.W),
            ri.ctypes.data_as(ct.c_void_p),
            None if xyz_out is None else xyz_out.ctypes.data_as(ct.c_void_p),
        )
        self.last_point_count = int(n)
        return ri.reshape(self.H, self.W)

    def entropy_decode_blobs(self, blobs: Sequence[bytes]) -> List[Dict[str, bytes]]:
        """Entropy-decode a batch of payloads (batched native rANS for the
        big fields)."""
        packed = [unpack_bitstream(b, uniform=self.cfg.uniform) for b in blobs]
        return self.entropy.decompress_dict_batch(packed)

    def decode_blobs(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> list of (H, W) f32 range images."""
        return [self.decode_fields(f) for f in self.entropy_decode_blobs(blobs)]

    def decode_blobs_points(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> list of compacted (n, 4) f32 xyz0 arrays (rows whose x+y+z is 0
        dropped, the reference's save rule), ready for .bin output."""
        out = []
        buf = np.empty((self.hw, 4), np.float32)
        for fields in self.entropy_decode_blobs(blobs):
            self.reconstruct(*self._field_arrays(fields), xyz_out=buf)
            out.append(buf[: self.last_point_count].copy())
        return out
