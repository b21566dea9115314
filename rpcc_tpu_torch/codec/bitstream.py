""".rpcc bitstream framing — byte-compatible with the reference (a copy of
``rpcc_tpu/codec/bitstream.py``).

Format (``utils/compress_utils.py:167-196``): the entropy-coded fields are
concatenated, each prefixed with a 4-byte native-order ``struct.pack('i')``
length.  Field order: ``salience_level`` (non-uniform mode only),
``contour_map``, ``idx_sequence``, ``plane_param``, ``residual_quantized``.
The stream does not self-describe (no header with accuracy/mode/LiDAR) —
encoder and decoder must be configured identically, like the reference
(README.md:138-140).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

FIELD_ORDER = ("salience_level", "contour_map", "idx_sequence", "plane_param", "residual_quantized")

# Optional self-describing header (SURVEY §5 pitfall 4 suggests one): the
# reference stream starts with a 4-byte field length, which for any real
# frame is far below 2^24 — so a magic with a high byte set is unambiguous.
HEADER_MAGIC = b"RPC1"


def pack_header(
    uniform: bool,
    accuracy: float,
    segment_method: str,
    cluster_num: int,
    modeling_method: str,
    basic_compressor: str,
    lidar_name: str,
) -> bytes:
    meta = "|".join(
        [
            "u" if uniform else "n",
            repr(float(accuracy)),
            segment_method,
            str(cluster_num),
            modeling_method,
            basic_compressor,
            lidar_name,
        ]
    ).encode()
    return HEADER_MAGIC + struct.pack("<H", len(meta)) + meta


def unpack_header(buf: bytes) -> Tuple[Optional[dict], bytes]:
    """Returns (header dict or None, remaining payload)."""
    if not buf.startswith(HEADER_MAGIC):
        return None, buf
    (n,) = struct.unpack_from("<H", buf, 4)
    parts = buf[6 : 6 + n].decode().split("|")
    head = {
        "uniform": parts[0] == "u",
        "accuracy": float(parts[1]),
        "segment_method": parts[2],
        "cluster_num": int(parts[3]),
        "modeling_method": parts[4],
        "basic_compressor": parts[5],
        "lidar_name": parts[6],
    }
    return head, buf[6 + n :]


def save_compressed_bitstream(file: str, compressed_data: Dict[str, bytes], uniform: bool = True) -> None:
    with open(file, "wb") as f:
        f.write(pack_bitstream(compressed_data, uniform))


def pack_bitstream(compressed_data: Dict[str, bytes], uniform: bool = True) -> bytes:
    parts = []
    fields = FIELD_ORDER if not uniform else FIELD_ORDER[1:]
    for name in fields:
        blob = compressed_data[name]
        parts.append(struct.pack("i", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def read_compressed_bitstream(file: str, uniform: bool = True) -> Dict[str, bytes]:
    with open(file, "rb") as f:
        return unpack_bitstream(f.read(), uniform)


def unpack_bitstream(buf: bytes, uniform: bool = True) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    off = 0
    fields = FIELD_ORDER if not uniform else FIELD_ORDER[1:]
    for name in fields:
        (length,) = struct.unpack_from("i", buf, off)
        off += 4
        out[name] = buf[off : off + length]
        off += length
    if off != len(buf):
        raise ValueError(f"trailing {len(buf) - off} bytes in bitstream")
    return out
