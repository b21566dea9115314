"""The ``rans`` entropy containers, JAX-free.

A copy of ``rpcc_tpu/codec/rans_codec.py``'s single-frame and batch entry
points.  Every encode and decode entry takes ``device=``, the device of its
caller, and codes there:

* ``None`` or a CPU device: the port's native host library
  (``csrc/host/rans.cpp``, a copy of the reference's), which raises if it
  cannot be built.  Every container and every decoded field is
  byte-identical to the reference's under its default
  ``RPCC_RANS_DEVICE=cpu``.
* A CUDA device: the hand-written kernels, which raise without a card
  (nothing falls back to the host).  A batch encode's residual streams are
  one launch of the encode kernel (``csrc/rans.cu``) at the batch's lane
  geometry, its contours another; a decode is one launch of the decode
  kernel (``csrc/rans_decode.cu``) per field group (the residual
  containers of one kind and lane count, or a batch's contours; a batch's
  contours and its largest residual group share one launch in
  :func:`batch_decode_big_fields`), both through ``ops/rans_device.py``.
  The host symbolizes what the bzip2 comparisons need, assembles the
  containers and the lanes, and the native tails finalize decoded
  symbols.  Every container is byte-identical to the reference's under
  ``RPCC_RANS_DEVICE=default``.

The card encodes a batch the way the reference's ``default`` path does:
every frame through the numpy pre-pass's geometry (lanes and T from the
longest frame, 'Z' tried up to 32,768 symbols), where the native path
codes frames above 32,768 symbols apart from the rest; so a batch that
mixes small and big frames gets other (equally valid) containers on the
two devices, each decoded by either.  ``RPCC_RANS_ADAPTIVE=full`` (read at
import, as the reference reads it) takes that path on the host too, and
compares bzip2 with every container of any size.

The batch coders size a batch's lanes from its longest frame, as the
reference's do, so a frame's container can depend on its neighbours;
:func:`compress_batch` groups frames by their own lane geometry first,
which makes each frame's bytes those of :func:`compress` alone.

Every encoder's pieces (native, the card's, the encoder graph's) become
'C' and 'N' containers through :func:`ctx_container` and
:func:`bits_container`; the graph's (``cfg.device_entropy``) by the
reference engine's rule, :func:`device_stream_rows` and
:func:`device_containers`.

Containers (little-endian):
  'C' residual: delta + zigzag + 4-context rANS over 32 interleaved lanes
      u8 magic u8 log2(lanes) u16 T u32 n i32 q0 | u32 n_esc [u32 esc...]
      | NUM_CTX compact freq tables | u32 states[L] u16 counts[L]
      | u16 words[sum(counts)] | u8 dtype
  'D' the same with one table and order-0 rANS (decoded, never emitted,
      as in the reference)
  'Z' bzip2 over the zigzag-delta stream (small fields only)
  'N' contour bits: diagonal wavefront layout, 4-context binary model
  '8' zlib over the u8 view of a u16 field whose values fit a byte
  'B' plain bzip2
"""

from __future__ import annotations

import bz2
import os
import struct
import zlib
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from rpcc_tpu_torch.codec import rans_native

MAGIC_DELTA = 0x44  # 'D'
MAGIC_CTX = 0x43  # 'C'
MAGIC_BZD = 0x5A  # 'Z'
MAGIC_BITS = 0x4E  # 'N'
MAGIC_BZ = 0x42  # 'B'
MAGIC_ZL8 = 0x38  # '8'
ALPHABET = 512
ESCAPE = ALPHABET - 1  # symbol id reserved for |delta| outside table range
NUM_CTX = 4  # rpcc_tpu/ops/rans.py: contexts of the residual model
MAX_LANES = 32
T_BUCKET = 16
BIG_FIELD_BYTES = 64 * 1024
BZD_TRY_MAX_SYMBOLS = 32768
CONTOUR_BZ_TRY_MAX_PIXELS = 65536

_CODE_DTYPE = {0: np.int16, 1: np.uint16, 2: np.int32}

# "full": compare bzip2 with the rANS containers at any size.
_ADAPTIVE_FULL = os.environ.get("RPCC_RANS_ADAPTIVE", "") == "full"

# bzip2's block size bounds a block's length and is named by the stream
# header's fourth byte, and nothing else: an input that fits one block at the
# smallest size (100,000 - 19 bytes after bzip2's first run-length pass,
# which writes a run of 4 bytes as 5) codes to the same bytes at size 1 as at
# size 9 but for that digit, and size 1 allocates a ninth of size 9's tables.
_BZ_ONE_BLOCK_BYTES = (100000 - 19) * 4 // 5


def _bzip2(data: bytes) -> bytes:
    """``bz2.compress(data)`` (block size 9), byte for byte."""
    if len(data) > _BZ_ONE_BLOCK_BYTES:
        return bz2.compress(data)
    out = bz2.compress(data, 1)
    return out[:3] + b"9" + out[4:]


def _coding_device(device):
    """The device a call codes on: None (the native host coder) for
    ``device`` None or a CPU device, a CUDA device as a ``torch.device``
    (raises without a card), ValueError for any other."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"the rANS coder runs on the CPU or a CUDA device, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"the rANS coder was asked for {dev}, and no CUDA device is available")
    return dev


def _lanes_for(n: int) -> int:
    lanes = 1
    while lanes < MAX_LANES and lanes * 64 < n:
        lanes *= 2
    return lanes


def _geometry(n_max: int, lanes=None):
    """(lanes, T) of a batch whose longest frame has n_max symbols:
    ``lanes`` (a power of two in 1..32, else ValueError) or _lanes_for's,
    and T = ceil(n_max / lanes) rounded up to T_BUCKET (at least one bucket)."""
    if lanes is None:
        lanes = _lanes_for(max(n_max, 1))
    elif not (isinstance(lanes, (int, np.integer)) and 1 <= lanes <= MAX_LANES and lanes & (lanes - 1) == 0):
        # The reference writes log2(lanes) rounded down, and no decoder reads such a container back.
        raise ValueError(f"lanes must be a power of two in 1..{MAX_LANES}, got {lanes!r}")
    lanes = int(lanes)
    return lanes, -(-max(1, -(-n_max // lanes)) // T_BUCKET) * T_BUCKET


def _zigzag(d: np.ndarray) -> np.ndarray:
    return np.where(d >= 0, 2 * d, -2 * d - 1).astype(np.int64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return np.where(z % 2 == 0, z // 2, -(z + 1) // 2).astype(np.int64)


def _dtype_code(dt) -> int:
    return {np.dtype(np.int16): 0, np.dtype(np.uint16): 1, np.dtype(np.int32): 2}[np.dtype(dt)]


def compress_seq_u16(data: np.ndarray) -> bytes:
    """idx_sequence coder: zlib over the u8 view when every id fits a byte."""
    data = np.ascontiguousarray(data, np.uint16)
    if data.size == 0 or int(data.max(initial=0)) <= 255:
        return bytes([MAGIC_ZL8]) + zlib.compress(data.astype(np.uint8).tobytes(), 6)
    return bytes([MAGIC_BZ]) + _bzip2(data.tobytes())


def _pick(data: np.ndarray, delta: bytes) -> bytes:
    """:func:`compress`'s choice for an int16/uint16/int32 array given its delta
    container: only the delta container above 64 KB, else the smallest of
    it, plain bzip2 and (u16) the sequence coder."""
    if data.nbytes > BIG_FIELD_BYTES:
        return delta
    candidates = [delta, bytes([MAGIC_BZ]) + _bzip2(data.tobytes())]
    if data.dtype == np.uint16:
        candidates.append(compress_seq_u16(data))
    return min(candidates, key=len)


def compress(data, lanes=None, device=None) -> bytes:
    """int16/uint16/int32 arrays: the smallest of the delta container, plain
    bzip2 and (u16) the sequence coder — only the delta container above
    64 KB.  Anything else: plain bzip2.  ``lanes`` and ``device`` as in
    :func:`compress_delta_batch`."""
    if isinstance(data, np.ndarray) and data.dtype in (np.int16, np.uint16, np.int32):
        return _pick(data, compress_delta_batch([data], lanes, device)[0])
    raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    return bytes([MAGIC_BZ]) + _bzip2(raw)


def compress_batch(arrays: Sequence[np.ndarray], device=None) -> List[bytes]:
    """:func:`compress` of each int16/uint16/int32 array on ``device``,
    byte for byte, with the delta containers coded by one native call or
    kernel launch per group of frames that share a lane geometry (one group
    for a batch of similar frames)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(_geometry(a.size), []).append(i)
    deltas: List[bytes] = [b""] * len(arrays)
    for ix in groups.values():
        for i, blob in zip(ix, compress_delta_batch([arrays[i] for i in ix], device=device)):
            deltas[i] = blob
    return [_pick(a, d) for a, d in zip(arrays, deltas)]


def decompress(blob: bytes, device=None) -> bytes:
    """Any container's bytes, its rANS decoded on ``device`` (see :func:`_coding_device`)."""
    if blob[0] == MAGIC_BZ:
        return bz2.decompress(blob[1:])
    if blob[0] == MAGIC_ZL8:
        return np.frombuffer(zlib.decompress(blob[1:]), np.uint8).astype(np.uint16).tobytes()
    if blob[0] == MAGIC_BITS:
        return decompress_contour(blob, device)
    if blob[0] in (MAGIC_DELTA, MAGIC_CTX, MAGIC_BZD):
        return decompress_delta(blob, device)
    raise ValueError("unknown rans container magic")


# ------------------------------------------------- compact freq-table codec
def _pack_table(freq_row: np.ndarray) -> bytes:
    """u16 max present id (0xFFFF = empty), presence bitmap, one u8 per
    present symbol with 255 escaping to a trailing u16 list."""
    present = np.nonzero(freq_row)[0]
    if present.size == 0:
        return struct.pack("<H", 0xFFFF)
    max_id = int(present[-1])
    bitmap = np.zeros(max_id + 1, np.uint8)
    bitmap[present] = 1
    vals = freq_row[present].astype(np.int64)
    small = vals < 255
    return b"".join(
        [
            struct.pack("<H", max_id),
            np.packbits(bitmap).tobytes(),
            np.where(small, vals, 255).astype(np.uint8).tobytes(),
            vals[~small].astype("<u2").tobytes(),
        ]
    )


def _unpack_table(blob: bytes, off: int, alphabet: int):
    (max_id,) = struct.unpack_from("<H", blob, off)
    off += 2
    freq = np.zeros(alphabet, np.int32)
    if max_id == 0xFFFF:
        return freq, off
    nbytes = (max_id + 8) // 8
    bitmap = np.unpackbits(np.frombuffer(blob, np.uint8, nbytes, off))[: max_id + 1]
    off += nbytes
    present = np.nonzero(bitmap)[0]
    n = present.size
    b = np.frombuffer(blob, np.uint8, n, off).astype(np.int64)
    off += n
    n_esc = int((b == 255).sum())
    esc = np.frombuffer(blob, "<u2", n_esc, off).astype(np.int64)
    off += 2 * n_esc
    vals = b.copy()
    vals[b == 255] = esc
    freq[present] = vals
    return freq, off


def _lane_words(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate each lane's first counts[l] words of a (L, T) block."""
    n_words = int(counts.sum())
    if not n_words:
        return np.zeros(0, "<u2")
    lane_of = np.repeat(np.arange(counts.shape[0]), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n_words) - np.repeat(starts, counts)
    return words[lane_of, pos].astype("<u2")


# --------------------------------------------- contour bit-plane container
def compress_contour(packed: np.ndarray, H: int, W: int, device=None) -> bytes:
    """'N' container of the packed contour bits; small planes (<= 64K
    pixels, or any under ``RPCC_RANS_ADAPTIVE=full``) keep plain bzip2 when
    that is smaller."""
    return compress_contour_batch([packed], H, W, device)[0]


def compress_contour_batch(packed_list: Sequence[np.ndarray], H: int, W: int, device=None) -> List[bytes]:
    """Every frame's contour plane in one native call or, on a CUDA
    ``device``, one kernel launch (which codes at most 512 rows and raises
    past them); each container is the frame's own (the lane length depends
    on H and W only)."""
    if not len(packed_list):
        return []
    pb = np.stack([np.asarray(p, np.uint8) for p in packed_list])
    dev = _coding_device(device)
    if dev is None:
        pieces = rans_native.contour_encode_frames(pb, H, W, _contour_T(H, W))
    else:
        from rpcc_tpu_torch.ops import rans_device

        pieces = rans_device.encode_contours_host(pb, H, W, dev)
    out = []
    for i, p in enumerate(pb):
        blob = bits_container(pieces, i, H, W)
        if _ADAPTIVE_FULL or H * W <= CONTOUR_BZ_TRY_MAX_PIXELS:
            blob = min(blob, bytes([MAGIC_BZ]) + _bzip2(p.tobytes()), key=len)
        out.append(blob)
    return out


def _contour_T(H: int, W: int) -> int:
    """Steps per lane of an H x W plane's 'N' container (its geometry's alone)."""
    return -(-(W + H - 1) // T_BUCKET) * T_BUCKET


def bits_container(pieces, i: int, H: int, W: int) -> bytes:
    """Frame ``i``'s 'N' container of an H x W plane from a batch's encoder
    pieces: numpy arrays in ``ContourPieces``' order (words, n_words,
    counts, states, freqs), native or the card's."""
    words, n_words, counts, states, freqs = pieces
    return build_bits_container(_contour_T(H, W), H, W, freqs[i], states[i], counts[i],
                                np.asarray(words[i, : n_words[i]]).view(np.uint16))


def build_bits_container(T: int, H: int, W: int, freqs: np.ndarray, states: np.ndarray,
                         counts: np.ndarray, words: np.ndarray) -> bytes:
    """An 'N' contour container from its pieces: ``freqs`` (4, 2),
    ``states`` and ``counts`` (H,), ``words`` the sum(counts) u16 words."""
    if T > 0xFFFF:
        raise ValueError(f"bits container lane length T={T} overflows u16")
    return b"".join(
        [
            struct.pack("<BHHH", MAGIC_BITS, T, H, W),
            np.ascontiguousarray(freqs, "<u2").tobytes(),
            np.ascontiguousarray(states, "<u4").tobytes(),
            np.ascontiguousarray(counts, "<u2").tobytes(),
            np.ascontiguousarray(words, "<u2").tobytes(),
        ]
    )


def decompress_contour(blob: bytes, device=None) -> bytes:
    return decompress_contour_batch([blob], device)[0]


def decompress_contour_batch(blobs: Sequence[bytes], device=None) -> List[bytes]:
    """Decode a batch of 'N' contour containers of one geometry in one
    native call or kernel launch (``device``: see :func:`_coding_device`)."""
    lanes, H, W = contour_lanes(blobs)
    return _finalize_contours(decode_lanes(lanes, device), lanes, H, W)


def _finalize_contours(sym: np.ndarray, lanes, H: int, W: int) -> List[bytes]:
    """Each frame's packed contour bits from its decoded wavefront symbols."""
    B, _, T = lanes.words.shape
    packed = rans_native.contour_finalize_frames(sym.reshape(B, H, T), H, W, T)
    return [packed[i].tobytes() for i in range(B)]


class Lanes(NamedTuple):
    """One field group's containers laid out for a batch decode."""

    words: np.ndarray  # (B, L, T) u16, lane l's first counts[l] words
    counts: np.ndarray  # (B, L) int32
    states: np.ndarray  # (B, L) u32
    lives: np.ndarray  # (B, L) int32 live steps per lane
    freqs: np.ndarray  # (B, C, A) int32
    mode: int  # rans_native.MODE_*: the contexts


def contour_lanes(blobs: Sequence[bytes]):
    """-> (Lanes, H, W) of a batch of 'N' containers of one geometry."""
    B = len(blobs)
    heads = [struct.unpack_from("<BHHH", b, 0) for b in blobs]
    T, H, W = heads[0][1:]
    if any(h[1:] != (T, H, W) for h in heads):
        raise ValueError("mixed contour geometries in one batch")
    if T < H + W - 1 or H < 1 or W < 1:
        # The de-skew reads row r at offset r: a smaller T would read past
        # the symbol block.
        raise ValueError(f"corrupt contour container: T={T} < H+W-1 for {H}x{W}")
    freqs = np.zeros((B, 4, 2), np.int32)
    states = np.zeros((B, H), np.uint32)
    counts = np.zeros((B, H), np.int32)
    words = np.zeros((B, H, T), np.uint16)
    for i, blob in enumerate(blobs):
        off = 7
        freqs[i] = np.frombuffer(blob, "<u2", 8, off).astype(np.int32).reshape(4, 2)
        off += 16
        states[i] = np.frombuffer(blob, "<u4", H, off)
        off += 4 * H
        counts[i] = np.frombuffer(blob, "<u2", H, off)
        off += 2 * H
        words[i] = _unpack_lane_words(blob, off, counts[i], T)
    return Lanes(words, counts, states, np.full((B, H), T, np.int32), freqs, rans_native.MODE_WAVEFRONT), H, W


def _unpack_lane_words(blob: bytes, off: int, counts: np.ndarray, T: int) -> np.ndarray:
    """Inverse of :func:`_lane_words`: the packed u16 words at ``off`` ->
    (L, T), lane l holding its first counts[l] words."""
    words = np.zeros((counts.shape[0], T), np.uint16)
    n_words = int(counts.sum())
    if n_words:
        packed_w = np.frombuffer(blob, "<u2", n_words, off)
        lane_of = np.repeat(np.arange(counts.shape[0]), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        words[lane_of, np.arange(n_words) - np.repeat(starts, counts)] = packed_w
    return words


def batch_decode_big_fields(packed: Sequence[dict], device=None):
    """Batch-decode the residual and contour fields of a blob batch:
    ``(resid_bytes | None, contour_bytes | None)``, one entry per frame, or
    None for a field some frame codes with another container (plain bzip2
    of a small field); the caller then decodes each frame on its own.  On a
    device (``device``: see :func:`_coding_device`) the batch's contours and
    its largest residual group (the 'C' or 'D' containers of one lane count
    with the most frames, the first on ties) decode in one kernel launch and
    come back in one copy, each other residual group in a launch of its own."""
    res_blobs = [p["residual_quantized"] for p in packed]
    cms = [p["contour_map"] for p in packed]
    do_res = all(b[0] in (MAGIC_DELTA, MAGIC_CTX, MAGIC_BZD) for b in res_blobs)
    do_cnt = bool(cms) and all(len(c) > 0 and c[0] == MAGIC_BITS for c in cms)
    out, groups = _parse_delta_batch(res_blobs) if do_res else (None, {})
    dev = _coding_device(device) if groups or do_cnt else None
    if dev is None:  # the native decoder, or nothing coded with rANS
        return (_decode_delta_groups(out, groups, None) if do_res else None,
                decompress_contour_batch(cms) if do_cnt else None)
    from rpcc_tpu_torch.ops import rans_device

    lanes = {k: _delta_lanes([p for _, p in items]) for k, items in groups.items()}
    cnt = contour_lanes(cms) if do_cnt else None
    for g in [*lanes.values(), *([cnt[0]] if cnt else [])]:
        _check_tables(g)
    first = max(lanes, key=lambda k: len(groups[k]), default=None)
    pair = lanes.get(first)
    sym_r, sym_c = rans_device.decode_fields_host(
        None if pair is None else pair[:5], None if cnt is None else cnt[0][:5],
        rans_native.MODE_ZIGZAG if pair is None else pair.mode, dev)
    for k, items in groups.items():
        _finalize_delta_group(out, items, lanes[k], sym_r if k == first else decode_lanes(lanes[k], dev))
    return out, (_finalize_contours(sym_c, *cnt) if do_cnt else None)


def _check_tables(lanes: Lanes) -> None:
    """Every table must sum to M, as every encoder's does."""
    if (lanes.freqs.sum(-1) != rans_native.M).any():
        raise ValueError(f"corrupt rans container: a frequency table does not sum to {rans_native.M}")


def decode_lanes(lanes: Lanes, device=None) -> np.ndarray:
    """(B, L*T) int32 symbols of one field group: the native decoder, or
    one launch on a CUDA ``device`` (see :func:`_coding_device`); raises
    unless every table sums to M (:func:`_check_tables`)."""
    _check_tables(lanes)
    dev = _coding_device(device)
    if dev is None:
        return rans_native.decode_ctx_batch(lanes.words, lanes.counts, lanes.states, lanes.freqs,
                                            lanes.words.shape[2], lanes.mode, lives=lanes.lives)
    from rpcc_tpu_torch.ops import rans_device

    if lanes.mode == rans_native.MODE_WAVEFRONT:
        return rans_device.decode_fields_host(None, lanes[:5], rans_native.MODE_ZIGZAG, dev)[1]
    return rans_device.decode_fields_host(lanes[:5], None, lanes.mode, dev)[0]


# --------------------------------------------------------- delta containers
def _symbolize(arr: np.ndarray):
    """array -> (zigzag-delta symbols int32, escapes, q0, n)."""
    q = arr.astype(np.int64).reshape(-1)
    n = q.shape[0]
    d = np.empty(n, np.int64)
    if n:
        d[0] = 0
        d[1:] = np.diff(q)
    zz = _zigzag(d)
    esc_mask = zz >= ESCAPE
    sym = np.where(esc_mask, ESCAPE, zz).astype(np.int32)
    return sym, zz[esc_mask], (int(q[0]) if n else 0), n


def ctx_container(pieces, i: int, L: int, T: int, n: int, dtype, escapes=None) -> bytes:
    """Frame ``i``'s 'C' container of an ``n``-symbol stream of ``dtype`` at
    ``L`` lanes of ``T`` steps from a batch's encoder pieces: numpy arrays
    in ``ResidualPieces``' order (words, n_words, counts, states, freqs,
    escapes, n_esc, q0), native or the card's.  ``escapes``: the frame's
    list in place of the pieces' (past the card's list, the host's)."""
    words, n_words, counts, states, freqs, esc, n_esc, q0 = pieces
    if escapes is None:
        escapes = esc[i, : n_esc[i]]
    return build_ctx_container(L, T, n, int(q0[i]), escapes, freqs[i], states[i], counts[i],
                               np.asarray(words[i, : n_words[i]]).view(np.uint16), dtype)


def _smaller_when_small(blob: bytes, n: int, candidate, any_size: bool = False) -> bytes:
    """``blob``, or ``candidate()`` where shorter, for a stream of at most
    BZD_TRY_MAX_SYMBOLS symbols (any with ``any_size``): the host's pick."""
    if any_size or n <= BZD_TRY_MAX_SYMBOLS:
        return min(blob, candidate(), key=len)
    return blob


def build_ctx_container(L: int, T: int, n: int, q0: int, escapes: np.ndarray, freqs: np.ndarray,
                        states: np.ndarray, counts: np.ndarray, words: np.ndarray, dtype) -> bytes:
    """A 'C' container from its pieces (the native and the device encoders'
    outputs): ``escapes`` the n_esc u32 values, ``freqs`` (NUM_CTX, ALPHABET),
    ``states`` and ``counts`` (L,), ``words`` the sum(counts) u16 words."""
    # Lane word counts ride the wire as u16: past 0xFFFF the container
    # would wrap into an undecodable one.
    if T > 0xFFFF:
        raise ValueError(f"ctx container lane length T={T} overflows u16")
    parts = [
        struct.pack("<BBHIi", MAGIC_CTX, L.bit_length() - 1, T, n, int(q0)),
        struct.pack("<I", escapes.shape[0]),
        np.ascontiguousarray(escapes, "<u4").tobytes(),
    ]
    parts += [_pack_table(freqs[c].astype(np.int64)) for c in range(NUM_CTX)]
    parts += [
        np.ascontiguousarray(states, "<u4").tobytes(),
        np.ascontiguousarray(counts, "<u2").tobytes(),
        np.ascontiguousarray(words, "<u2").tobytes(),
        struct.pack("<B", _dtype_code(dtype)),
    ]
    return b"".join(parts)


def _compress_bzd(sym, escapes, q0: int, n: int, dtype) -> bytes:
    """'Z': the same zigzag-delta stream, bzip2-coded."""
    return b"".join(
        [
            struct.pack("<BBIi", MAGIC_BZD, _dtype_code(dtype), n, q0),
            struct.pack("<I", escapes.shape[0]),
            escapes.astype("<u4").tobytes(),
            _bzip2(sym.astype("<u2").tobytes()),
        ]
    )


def _decompress_bzd(blob: bytes) -> bytes:
    _, dt_code, n, q0 = struct.unpack_from("<BBIi", blob, 0)
    (n_esc,) = struct.unpack_from("<I", blob, 10)
    escapes = np.frombuffer(blob, "<u4", n_esc, 14).astype(np.int64)
    if n == 0:
        return b""
    sym = np.frombuffer(bz2.decompress(blob[14 + 4 * n_esc:]), "<u2").astype(np.int64)[:n]
    zz = sym.copy()
    if n_esc:
        zz[sym == ESCAPE] = escapes
    d = _unzigzag(zz)
    d[0] = 0
    return (q0 + np.cumsum(d)).astype(_CODE_DTYPE[dt_code]).tobytes()


def _zigzag_ctx_np(sym3d: np.ndarray) -> np.ndarray:
    """Context of each symbol: magnitude bucket of the previous delta."""
    prev = np.zeros_like(sym3d)
    prev[:, :, 1:] = sym3d[:, :, :-1]
    mag = (prev + 1) // 2
    ctx = (mag >= 1).astype(np.int32) + (mag >= 3) + (mag >= 8)
    ctx[:, :, 0] = 0
    return ctx.astype(np.int32)


def _needs_wide_escapes(a: np.ndarray) -> bool:
    """int32 streams whose first differences overflow int32 cannot ride the
    delta containers: escape values are u32 on the wire.  int16/uint16
    streams are always safe (zigzag <= 131071)."""
    if a.dtype != np.int32 or a.size < 2:
        return False
    d = np.diff(a.astype(np.int64))
    return bool(d.min() < -(2**31) or d.max() > 2**31 - 1)


def _route_wide_escape_frames(arrays, encode_rest):
    """Frames that need wider escapes as lossless plain-bzip2 ('B')
    containers, ``encode_rest`` coding the others; None when no frame needs
    routing (the common case)."""
    wide = [i for i, a in enumerate(arrays) if _needs_wide_escapes(np.asarray(a))]
    if not wide:
        return None
    out: List[bytes] = [b""] * len(arrays)
    for i in wide:
        out[i] = bytes([MAGIC_BZ]) + _bzip2(np.asarray(arrays[i]).tobytes())
    rest = [i for i in range(len(arrays)) if i not in set(wide)]
    if rest:
        for i, blob in zip(rest, encode_rest([arrays[i] for i in rest])):
            out[i] = blob
    return out


def _device_ctx_containers(arrays: Sequence[np.ndarray], L: int, T: int, device) -> List[bytes]:
    """Each frame's 'C' container from one launch of the encode kernel on
    the CUDA ``device``.  A frame past the kernel's escape list takes the
    host's list (the words do not depend on the list)."""
    from rpcc_tpu_torch.ops import rans_device

    pieces = rans_device.encode_streams_host(arrays, L, T, device)
    return [ctx_container(pieces, i, L, T, a.size, a.dtype,
                          None if pieces.n_esc[i] <= rans_device.ESC_CAP_DEV else _symbolize(a)[1])
            for i, a in enumerate(arrays)]


def _compress_delta_batch_np(arrays: Sequence[np.ndarray], lanes=None, device=None) -> List[bytes]:
    """The numpy pre-pass's path for a batch (lanes and T from its longest
    frame, or ``lanes``): the native coder, or on a CUDA ``device`` the
    encode kernel, and per frame the smaller of 'C' and, up to 32768
    symbols (any under ``RPCC_RANS_ADAPTIVE=full``), 'Z'."""
    routed = _route_wide_escape_frames(arrays, lambda rest: _compress_delta_batch_np(rest, lanes, device))
    if routed is not None:
        return routed
    if not arrays:
        return []
    L, T = _geometry(max(a.size for a in arrays), lanes)
    dev = _coding_device(device)
    per = [None] * len(arrays)  # (symbols, escapes, q0, n) of each frame, where the host needs them
    if dev is None:
        per = [_symbolize(a) for a in arrays]
        sym3d = np.zeros((len(arrays), L, T), np.int32)
        for i, (sym, _, _, n) in enumerate(per):
            sym3d[i].reshape(-1)[:n] = sym
        ns = np.asarray([p[3] for p in per], np.int64)
        words, counts, states, freqs = rans_native.encode_ctx_batch(
            sym3d, _zigzag_ctx_np(sym3d), ALPHABET, NUM_CTX, ns=ns
        )
        blobs = [build_ctx_container(L, T, n, q0, escapes, freqs[i], states[i], counts[i],
                                     _lane_words(words[i], counts[i]), a.dtype)
                 for i, (a, (_, escapes, q0, n)) in enumerate(zip(arrays, per))]
    else:
        blobs = _device_ctx_containers(arrays, L, T, dev)
    return [_smaller_when_small(blob, a.size, lambda a=a, p=p: _compress_bzd(*(p or _symbolize(a)), a.dtype),
                                _ADAPTIVE_FULL)
            for a, p, blob in zip(arrays, per, blobs)]


def compress_delta(arr: np.ndarray, device=None) -> bytes:
    """'C' (or, for small fields, 'Z') container of an int16/uint16/int32 stream."""
    return compress_delta_batch([arr], device=device)[0]


def compress_delta_batch(arrays: Sequence[np.ndarray], lanes=None, device=None) -> List[bytes]:
    """Delta containers of a batch of int16/uint16/int32 streams,
    byte-identical to ``rpcc_tpu.codec.rans_codec.compress_delta_batch``
    (under ``RPCC_RANS_DEVICE=cpu`` for the host, ``default`` for a CUDA
    ``device``, and the same ``RPCC_RANS_ADAPTIVE``): int32 frames whose
    deltas overflow int32 as plain bzip2; on the host (``device`` None or a
    CPU) frames above 32768 symbols take the fused native encoder in one
    call (lanes and T from the longest of them, or ``lanes``), the rest the
    numpy pre-pass (likewise); on a CUDA device, and under
    ``RPCC_RANS_ADAPTIVE=full``, the whole batch takes the pre-pass's path,
    on the card one kernel launch.  ``lanes`` must be a power of two in
    1..32."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if not arrays:
        return []
    dev = _coding_device(device)
    if dev is not None or _ADAPTIVE_FULL:
        return _compress_delta_batch_np(arrays, lanes, dev)
    routed = _route_wide_escape_frames(arrays, lambda rest: compress_delta_batch(rest, lanes))
    if routed is not None:
        return routed
    out: List[bytes] = [b""] * len(arrays)
    big_ix = [i for i, a in enumerate(arrays) if a.size > BZD_TRY_MAX_SYMBOLS]
    small_ix = [i for i, a in enumerate(arrays) if a.size <= BZD_TRY_MAX_SYMBOLS]
    if small_ix:
        for i, blob in zip(small_ix, _compress_delta_batch_np([arrays[i] for i in small_ix], lanes)):
            out[i] = blob
    if big_ix:
        subs = [arrays[i] for i in big_ix]
        L, T = _geometry(max(a.size for a in subs), lanes)
        pieces = rans_native.delta_encode_frames(subs, L, T, ALPHABET, NUM_CTX)
        esc_counts = pieces[6]
        for k, i in enumerate(big_ix):
            if esc_counts[k] < 0:  # escape-capacity overflow
                out[i] = _compress_delta_batch_np([arrays[i]], lanes)[0]
                continue
            out[i] = ctx_container(pieces, k, L, T, subs[k].size, subs[k].dtype)
    return out


# ------------------------------------------ containers from the encoder graph
def device_stream_rows(stream_len: np.ndarray, n_esc: np.ndarray) -> np.ndarray:
    """The frames of a batch the encoder graph coded (``n_esc`` escapes
    each) whose int16 stream :func:`device_containers` needs as well: past
    the kernel's escape list, or of at most BZD_TRY_MAX_SYMBOLS symbols."""
    from rpcc_tpu_torch.ops.rans_device import ESC_CAP_DEV

    return np.flatnonzero((n_esc > ESC_CAP_DEV) | (stream_len <= BZD_TRY_MAX_SYMBOLS))


def device_containers(residual, contour, i: int, n: int, H: int, W: int, stream=None,
                      device=None) -> Tuple[bytes, bytes]:
    """Frame ``i``'s (residual, contour) containers from the pieces the
    encoder graph coded for a batch of H x W grids (``ResidualPieces`` and
    ``ContourPieces`` of numpy arrays; the reference engine's
    ``_finish_device_entropy``): the 'C' as coded, at the grid's lane
    geometry whatever the frame's ``n`` symbols; past the kernel's escape
    list :func:`compress_delta_batch` of the frame's int16 ``stream`` on
    ``device`` in its place; up to BZD_TRY_MAX_SYMBOLS symbols the smaller
    of the two; the 'N' as coded.  ``stream``: for the frames
    :func:`device_stream_rows` names."""
    from rpcc_tpu_torch.ops.rans_device import ESC_CAP_DEV

    def host() -> bytes:
        return compress_delta_batch([stream], device=device)[0]

    if int(residual.n_esc[i]) > ESC_CAP_DEV:
        resid = host()
    else:
        L = residual.counts.shape[-1]
        resid = _smaller_when_small(ctx_container(residual, i, L, _geometry(H * W, L)[1], n, np.int16), n, host)
    return resid, bits_container(contour, i, H, W)


def _parse_delta(blob: bytes):
    """A 'C' or 'D' container's pieces: (magic, lanes, T, n, q0, escapes,
    freqs (NUM_CTX or 1, ALPHABET), states, counts, words (L, T), dtype code)."""
    magic, log_lanes, T, n, q0 = struct.unpack_from("<BBHIi", blob, 0)
    if (1 << log_lanes) > MAX_LANES:
        raise ValueError(f"corrupt delta container: lanes=2^{log_lanes} > {MAX_LANES}")
    lanes = 1 << log_lanes
    if n > lanes * T:
        raise ValueError(f"corrupt delta container: n={n} > lanes*T={lanes}*{T}")
    off = 12
    (n_esc,) = struct.unpack_from("<I", blob, off)
    off += 4
    escapes = np.frombuffer(blob, "<u4", n_esc, off).astype(np.int64)
    off += 4 * n_esc
    freqs = np.zeros((NUM_CTX if magic == MAGIC_CTX else 1, ALPHABET), np.int32)
    for c in range(freqs.shape[0]):
        freqs[c], off = _unpack_table(blob, off, ALPHABET)
    states = np.frombuffer(blob, "<u4", lanes, off).astype(np.uint32)
    off += 4 * lanes
    counts = np.frombuffer(blob, "<u2", lanes, off).astype(np.int32)
    off += 2 * lanes
    words = _unpack_lane_words(blob, off, counts, T)
    off += 2 * int(counts.sum())
    (dt_code,) = struct.unpack_from("<B", blob, off)
    return magic, lanes, T, n, q0, escapes, freqs, states, counts, words, dt_code


def decompress_delta(blob: bytes, device=None) -> bytes:
    """Decode one delta container ('C', 'D' or 'Z')."""
    return decompress_delta_batch([blob], device)[0]


def decompress_delta_batch(blobs: Sequence[bytes], device=None) -> List[bytes]:
    """Decode a batch of delta containers ('B' too, which a routed int32
    frame gets), the rANS ones of one kind and
    lane count in one native call or kernel launch (``device``: see
    :func:`_coding_device`; mixed T decode at the largest, each frame's
    symbols its own)."""
    out, groups = _parse_delta_batch(blobs)
    return _decode_delta_groups(out, groups, _coding_device(device) if groups else None)


def _decode_delta_groups(out: List[bytes], groups: dict, device) -> List[bytes]:
    """Each parsed group decoded (:func:`decode_lanes` on ``device``) and
    finalized into ``out``."""
    for items in groups.values():
        lanes = _delta_lanes([p for _, p in items])
        _finalize_delta_group(out, items, lanes, decode_lanes(lanes, device))
    return out


def _parse_delta_batch(blobs: Sequence[bytes]):
    """-> (out, groups): 'Z' and 'B' containers decoded into ``out`` (the
    others b""), the parsed 'C' and 'D' ones as {(magic, lanes): [(index,
    parsed), ...]}."""
    out: List[bytes] = [b""] * len(blobs)
    groups: dict = {}
    for i, b in enumerate(blobs):
        if b[0] == MAGIC_BZD:
            out[i] = _decompress_bzd(b)
        elif b[0] == MAGIC_BZ:  # an int32 frame routed past the delta containers
            out[i] = bz2.decompress(b[1:])
        elif b[0] in (MAGIC_CTX, MAGIC_DELTA):
            p = _parse_delta(b)
            groups.setdefault(p[:2], []).append((i, p))
        else:
            raise ValueError("unknown delta container magic")
    return out, groups


def _finalize_delta_group(out: List[bytes], items, lanes: Lanes, sym: np.ndarray) -> None:
    """A group's decoded symbols -> each of its frames' bytes in ``out``."""
    parsed = [p for _, p in items]
    outs = rans_native.delta_finalize_frames_3d(
        sym.reshape(lanes.words.shape), ALPHABET, [p[2] for p in parsed], [p[3] for p in parsed],
        [p[4] for p in parsed], [p[5] for p in parsed], [p[10] for p in parsed],
    )
    for (i, _), o in zip(items, outs):
        out[i] = o.tobytes()


def _delta_lanes(parsed) -> Lanes:
    """The lanes of parsed 'C' or 'D' containers of one kind and lane
    count, at the largest T (each frame's words and lives at its own T)."""
    magic, L = parsed[0][:2]
    T_max = max(p[2] for p in parsed)
    words = np.zeros((len(parsed), L, T_max), np.uint16)
    for k, p in enumerate(parsed):
        words[k, :, : p[2]] = p[9]
    lives = np.stack([np.clip(p[3] - np.arange(L) * p[2], 0, p[2]) for p in parsed]).astype(np.int32)
    mode = rans_native.MODE_ZIGZAG if magic == MAGIC_CTX else rans_native.MODE_ORDER0
    return Lanes(words, np.stack([p[8] for p in parsed]), np.stack([p[7] for p in parsed]), lives,
                 np.stack([p[6] for p in parsed]), mode)


def delta_lanes(blobs: Sequence[bytes]) -> Lanes:
    """The lanes of 'C' or 'D' containers of one kind and lane count, as
    :func:`decompress_delta_batch` decodes them."""
    parsed = [_parse_delta(b) for b in blobs]
    if len({p[:2] for p in parsed}) != 1:
        raise ValueError("delta_lanes takes containers of one kind and lane count")
    return _delta_lanes(parsed)
