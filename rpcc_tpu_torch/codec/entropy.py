"""Byte-level entropy coders for the ``.rpcc`` fields.

The same surface and bytes as ``rpcc_tpu.codec.entropy``'s
``BasicCompressor``, of which this is the port's own copy: ``lz4 | bzip2 |
gzip | deflate | rans``, selected by name, on bytes-like numpy buffers.

  * ``bzip2``: stdlib ``bz2``.
  * ``gzip``/``deflate``: stdlib ``gzip`` with ``mtime=0``, so the bytes
    are deterministic.
  * ``lz4``: the ``lz4==0.7.0`` ``dumps`` container, a 4-byte little-endian
    uncompressed size and one LZ4 block, coded by the port's native library
    (``csrc/host/lz4.cpp``).
  * ``rans``: the port's JAX-free containers
    (:mod:`rpcc_tpu_torch.codec.rans_codec`).

``rans`` codes on the coder's ``device``: the native host coder for None
or a CPU device, the card's kernels for a CUDA device (its owner's: the
codec's and the engine's).  :meth:`BasicCompressor.compress_dict_pieces`
codes a frame whose residual and contour the encoder graph coded on the
device, from their pieces.  The ``*_dict_batch`` methods code a batch of
frames' fields with the big fields (residual stream, contour plane)
batched, one native call or kernel launch each (a decode: one launch for
both); each frame's bytes equal :meth:`compress_dict` /
:meth:`decompress_dict` of that frame alone, which decodes its big fields
the same way.
"""

from __future__ import annotations

import bz2
import ctypes
import gzip
import struct
from typing import Callable, Dict, List, Optional, Sequence

from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.codec.native import native_lib

METHODS = ("lz4", "bzip2", "gzip", "deflate", "rans")


class BasicCompressor:
    def __init__(self, method_name: str, contour_shape: Optional[tuple] = None, device=None):
        if method_name not in METHODS:
            raise ValueError(f"unknown compression method {method_name!r}; choose from {METHODS}")
        self.method_name = method_name
        # (H, W) of the range image: lets ``rans`` context-code the contour
        # bit plane instead of bzip2ing packed row-major bytes.
        self.contour_shape = contour_shape
        # Where ``rans`` codes: None or a CPU device the native host coder, a CUDA device its kernels.
        self.device = device

    # -- dict-of-fields helpers ---------------------------------------------
    def compress_dict(self, data_dict: Dict[str, object]) -> Dict[str, bytes]:
        out = {}
        for k, v in data_dict.items():
            if k == "contour_map" and self.method_name == "rans" and self.contour_shape is not None:
                out[k] = rans_codec.compress_contour(v, *self.contour_shape, device=self.device)
            else:
                out[k] = self.compress(v)
        return out

    def decompress_dict(self, data_dict: Dict[str, bytes]) -> Dict[str, bytes]:
        if self.method_name == "rans":
            return self.decompress_dict_batch([data_dict])[0]
        return {k: self.decompress(v) for k, v in data_dict.items()}

    def compress_dict_batch(
        self, dicts: Sequence[Dict[str, object]], pool_map: Optional[Callable] = None
    ) -> List[Dict[str, bytes]]:
        """:meth:`compress_dict` of each frame's fields, byte for byte.
        ``pool_map(fn, n)`` (default: in order on this thread) runs the
        per-frame remainder, e.g. on a thread pool."""
        pool_map = pool_map or (lambda fn, n: [fn(i) for i in range(n)])
        if self.method_name != "rans" or not dicts:
            return pool_map(lambda i: self.compress_dict(dicts[i]), len(dicts))
        big = {"residual_quantized": rans_codec.compress_batch([d["residual_quantized"] for d in dicts], self.device)}
        if self.contour_shape is not None:
            big["contour_map"] = rans_codec.compress_contour_batch(
                [d["contour_map"] for d in dicts], *self.contour_shape, device=self.device
            )
        return pool_map(
            lambda i: {k: big[k][i] if k in big else self.compress(v) for k, v in dicts[i].items()},
            len(dicts),
        )

    def compress_dict_pieces(self, data_dict: Dict[str, object], residual, contour, i: int, n: int,
                             stream=None) -> Dict[str, bytes]:
        """:meth:`compress_dict` of a frame whose residual and contour the
        encoder graph coded on the device (``rans`` only): their containers
        from frame ``i`` of the batch's pieces, ``n`` residuals and, where
        :func:`rans_codec.device_stream_rows` names the frame, its int16
        ``stream`` (:func:`rans_codec.device_containers`); ``idx_sequence``
        in the sequence coder's container, the rest of ``data_dict`` as
        :meth:`compress_dict` codes it."""
        resid, contour_blob = rans_codec.device_containers(residual, contour, i, n, *self.contour_shape, stream,
                                                           self.device)
        out = self.compress_dict({k: v for k, v in data_dict.items() if k != "idx_sequence"})
        out.update(residual_quantized=resid, contour_map=contour_blob,
                   idx_sequence=rans_codec.compress_seq_u16(data_dict["idx_sequence"]))
        return out

    def decompress_dict_batch(
        self, dicts: Sequence[Dict[str, bytes]], pool_map: Optional[Callable] = None
    ) -> List[Dict[str, bytes]]:
        """:meth:`decompress_dict` of each frame's fields, the big rans
        fields of the whole batch decoded in one native call each, or on a
        CUDA device in one kernel launch together."""
        pool_map = pool_map or (lambda fn, n: [fn(i) for i in range(n)])
        if self.method_name != "rans" or not dicts:
            return pool_map(lambda i: {k: self.decompress(v) for k, v in dicts[i].items()}, len(dicts))
        resid, contour = rans_codec.batch_decode_big_fields(dicts, self.device)
        big = {k: v for k, v in (("residual_quantized", resid), ("contour_map", contour)) if v is not None}
        return pool_map(
            lambda i: {k: big[k][i] if k in big else self.decompress(v) for k, v in dicts[i].items()},
            len(dicts),
        )

    # -- single buffer -------------------------------------------------------
    def compress(self, np_array) -> bytes:
        if self.method_name == "rans":
            return rans_codec.compress(np_array, device=self.device)
        data = _as_bytes(np_array)
        if self.method_name == "lz4":
            return lz4_compress(data)
        if self.method_name == "bzip2":
            return bz2.compress(data)
        if self.method_name in ("gzip", "deflate"):
            return gzip.compress(data, mtime=0)
        raise ValueError(f"unknown method {self.method_name}")

    def decompress(self, bitstream: bytes) -> bytes:
        if self.method_name == "rans":
            return rans_codec.decompress(bitstream, self.device)
        if self.method_name == "lz4":
            return lz4_decompress(bitstream)
        if self.method_name == "bzip2":
            return bz2.decompress(bitstream)
        if self.method_name in ("gzip", "deflate"):
            return gzip.decompress(bitstream)
        raise ValueError(f"unknown method {self.method_name}")


def _as_bytes(x) -> bytes:
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    return x.tobytes()


def lz4_compress(data: bytes) -> bytes:
    """4-byte LE uncompressed length + one LZ4 block."""
    lib = native_lib()
    cap = lib.lz4_compress_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.lz4_compress_block(data, len(data), out, cap)
    if n == 0:
        raise RuntimeError("lz4 native compression failed")
    return struct.pack("<I", len(data)) + out.raw[:n]


def lz4_decompress(blob: bytes) -> bytes:
    (n,) = struct.unpack("<I", blob[:4])
    out = ctypes.create_string_buffer(n if n else 1)
    got = native_lib().lz4_decompress_block(blob[4:], len(blob) - 4, out, n)
    if got != n:
        raise RuntimeError(f"lz4 native decompression failed ({got} != {n})")
    return out.raw[:n]
