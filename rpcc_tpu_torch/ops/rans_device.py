"""Device rANS coding of the two big bitstream fields: the encode's plain
PyTorch version + the CUDA kernel's wrapper (port of
``rpcc_tpu/ops/rans_device.py``), and the decode kernel's wrapper beside
its plain version (``ops/rans.py``'s decoders).

The engine's default path (``cfg.device_entropy`` with the ``rans`` coder)
entropy-codes the residual stream and the contour plane on the device and
downloads compressed words instead of the fields.  The pieces are those of
the host coders' containers, so the host decoders read them unchanged:

* residual ('C'): delta + zigzag over the live stream (positions at or past
  ``stream_len`` are zero deltas), zigzag values >= ESCAPE become the ESCAPE
  symbol with the value on an escape list in stream order (the first
  ESC_CAP_DEV of them, plus the total count; a frame past the cap is coded
  on the host), 32 live-aware lanes of ``resid_T(HW)`` steps, a 4-context
  model on the previous symbol of the lane, histograms over the live
  positions only;
* contour ('N'): the (H, W) bits sheared into a diagonal wavefront (row r
  delayed r steps), H lanes of ``contour_T(H, W)`` steps, ctx = 2 * above
  + left.

The host containers' encode under ``RPCC_RANS_DEVICE=default`` (the
reference's ``rpcc_tpu/ops/rans.py::encode_streams_batch_ctx`` and
``encode_streams_batch_ctx_explicit``) is the same kernel: residual streams
at the batch's own lane geometry (:func:`encode_streams_cuda`, L a power of
two up to 32 and T a multiple of 16 from its longest frame, zero-padded
(B, n_max) streams with per-frame lengths; :func:`upload_streams`), the
contour exactly as above (:func:`upload_contours`).  A residual's zigzag
value is computed in u32, so an int32 stream whose deltas fit int32 escapes
with the reference's u32 values.

Each lane's symbols are walked in reverse (16-bit renormalization, at most
one word per symbol; the walk is :func:`rpcc_tpu_torch.ops.rans.encode_walk`);
the packed words are the emitted words lane-major in
emission order, followed by the words of the steps that emitted nothing, in
the same order (the reference's stable sort of the (lane, step) keys), so
every output equals the reference's element for element.  A zigzag value
of 2^31 or more (a residual delta of 2^30 or more, which a quantized range
residual never reaches) is an escape here, where the reference's int32
would wrap it negative.

:func:`encode_fields_device` dispatches on the tensors' device: the plain
versions for CPU tensors, one launch of the hand-written kernel
(``csrc/rans.cu``) for CUDA tensors.  A CUDA tensor never falls back to the
plain version: if the kernel cannot build or launch, the call raises.

:func:`decode_streams_device` decodes host-assembled containers' lanes
(one field group: residual lanes with zigzag or order-0 contexts, or
wavefront contour lanes) on a device, and :func:`decode_fields_device` a
batch's residual group and its contours together: one launch of
``csrc/rans_decode.cu`` for CUDA, the plain decoders of
:mod:`rpcc_tpu_torch.ops.rans` for the CPU, with the same rule.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rpcc_tpu_torch.ops.rans import (
    M, RansCode, cumulative, decode_streams_batch_ctx, encode_walk, joint_tables, wavefront_bit_context,
    zero_context, zigzag_magnitude_context,
)

RESID_LANES = 32  # = codec/rans_codec.py MAX_LANES: a container field
ESC_CAP_DEV = 512  # per-frame escape capacity; past it the frame is coded on the host
ALPHABET = 512
ESCAPE = ALPHABET - 1
NUM_CTX = 4
_T_BUCKET = 16  # = codec/rans_codec.py T_BUCKET
MAX_CONTOUR_ROWS = 512  # csrc/rans.cu: contour lanes a block codes (walked 128 at a time)
# csrc/rans.cu: a contour histogram thread counts 4 * ceil(H * T / 2048) steps
# (512 threads, 4 a round) in 16-bit fields, so ceil(H * T / 2048) <= 16383.
MAX_CONTOUR_STEPS = 16383 * 2048

# Launches of the CUDA kernel since the count was last reset (one per call
# of :func:`encode_fields_cuda`, whatever fields it codes; the codec's pool
# threads launch concurrently, so the count rises under a lock).
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()
# Spans timed by ``phase_stamps`` (csrc/rans.cu) in two blocks: frame 0's
# residual stream (stamps 0-4) and frame 0's contour (stamps 5-9).
PHASES = ("histogram", "normalize", "walk", "pack")
STAMP_BLOCKS = ("residual", "contour")


def resid_T(hw: int) -> int:
    """Steps per lane of the device residual container of an HW-pixel grid."""
    return stream_T(hw, RESID_LANES)


def stream_T(width: int, lanes: int) -> int:
    """Steps per lane of ``lanes`` lanes over a ``width``-symbol stream, in
    multiples of 16 (the host containers' T of their longest frame)."""
    return -(-max(1, -(-width // lanes)) // _T_BUCKET) * _T_BUCKET


def contour_T(H: int, W: int) -> int:
    """Steps per lane of the wavefront contour container (geometry-fixed)."""
    return -(-(W + H - 1) // _T_BUCKET) * _T_BUCKET


class ResidualPieces(NamedTuple):
    words: torch.Tensor  # (B, 32 * T) int16: u16 words, the first n_words the container's
    n_words: torch.Tensor  # (B,) int32
    counts: torch.Tensor  # (B, 32) int32 words per lane
    states: torch.Tensor  # (B, 32) int64 final u32 states
    freqs: torch.Tensor  # (B, NUM_CTX, ALPHABET) int32 normalized tables
    escapes: torch.Tensor  # (B, ESC_CAP_DEV) int64 u32 escape values in stream order, 0-filled
    n_esc: torch.Tensor  # (B,) int32 total escapes (may exceed ESC_CAP_DEV)
    q0: torch.Tensor  # (B,) int32 first stream value


class ContourPieces(NamedTuple):
    words: torch.Tensor  # (B, H * T) int16
    n_words: torch.Tensor  # (B,) int32
    counts: torch.Tensor  # (B, H) int32
    states: torch.Tensor  # (B, H) int64
    freqs: torch.Tensor  # (B, 4, 2) int32


# ------------------------------------------------------------------ plain
def _walk_and_pack(key: torch.Tensor, freqs: torch.Tensor, live_lane: torch.Tensor):
    """The renormalization walk of every lane in reverse (the spec's
    :func:`~rpcc_tpu_torch.ops.rans.encode_walk`), and the packing.

    ``key``, ``freqs`` and ``live_lane`` as the spec's
    :func:`~rpcc_tpu_torch.ops.rans.joint_tables` gives them.  -> (words
    (B, L*T) int16, n_words, counts, states int64)."""
    B, L, T = key.shape
    dev = key.device
    words, emit, x = encode_walk(key, freqs, cumulative(freqs), live_lane)
    counts = emit.sum(-1, dtype=torch.int64)
    off = torch.cumsum(counts, -1) - counts  # exclusive, over lanes
    n_words = counts.sum(-1)
    lane_base = torch.arange(L, device=dev, dtype=torch.int64) * T
    dest = torch.where(
        emit,
        off[..., None] + torch.cumsum(emit, -1) - 1,
        n_words[:, None, None] + (lane_base - off)[..., None] + torch.cumsum(~emit, -1) - 1,
    )
    packed = torch.zeros((B, L * T), dtype=torch.int64, device=dev).scatter_(1, dest.reshape(B, -1), words.reshape(B, -1))
    packed = torch.where(packed >= 0x8000, packed - 0x10000, packed).to(torch.int16)
    return packed, n_words.to(torch.int32), counts.to(torch.int32), x


def encode_streams_plain(q: torch.Tensor, stream_len: torch.Tensor, lanes: int, T: Optional[int]) -> ResidualPieces:
    """Plain version over (B, width) int32 streams (zero past
    ``stream_len``) and (B,) int32 live lengths, coded in ``lanes`` lanes
    of ``T`` steps (as :func:`encode_fields_cuda` takes them): the residual
    containers' pieces, with (B, lanes * T) words and (B, lanes) counts and
    states."""
    L, T = _check_residual(q, stream_len, lanes, T)
    B, width = q.shape
    dev = q.device
    q = q.to(torch.int64)
    n = stream_len.to(torch.int64).clamp(0, width).reshape(B, 1)
    iota = torch.arange(width, device=dev)
    live = iota < n
    d = torch.where(live & (iota > 0), q - torch.nn.functional.pad(q[:, :-1], (1, 0)), 0)
    d = ((d + 2**31) & 0xFFFFFFFF) - 2**31  # int32 wrap, as the reference's int32 delta
    zz = torch.where(d >= 0, 2 * d, -2 * d - 1) & 0xFFFFFFFF  # the u32 zigzag value
    is_esc = zz >= ESCAPE
    n_esc = is_esc.sum(-1, dtype=torch.int32)
    rank = torch.cumsum(is_esc, -1) - 1
    slot = torch.where(is_esc & (rank < ESC_CAP_DEV), rank, ESC_CAP_DEV)
    escapes = torch.zeros((B, ESC_CAP_DEV + 1), dtype=torch.int64, device=dev).scatter_(1, slot, zz)[:, :ESC_CAP_DEV]
    sym = torch.where(is_esc, ESCAPE, zz)
    sym = torch.nn.functional.pad(sym, (0, L * T - width)).reshape(B, L, T)
    ctx = zigzag_magnitude_context(torch.nn.functional.pad(sym[:, :, :-1], (1, 0)))
    key, freqs, lives = joint_tables(sym, ctx, ALPHABET, NUM_CTX, n[:, 0])
    words, n_words, counts, states = _walk_and_pack(key, freqs, lives)
    return ResidualPieces(words, n_words, counts, states, freqs, escapes, n_esc, q[:, 0].to(torch.int32))


def encode_residual_field_plain(q: torch.Tensor, stream_len: torch.Tensor) -> ResidualPieces:
    """Plain version over (B, HW) int quantized residual streams (zero past
    ``stream_len``) and (B,) live lengths, at the engine's geometry (32
    lanes of ``resid_T(HW)`` steps): the residual container's pieces."""
    return encode_streams_plain(q.to(torch.int32), stream_len.to(torch.int32), RESID_LANES, resid_T(q.shape[1]))


def encode_contour_field_plain(contour: torch.Tensor) -> ContourPieces:
    """Plain version over (B, H, W) contour planes (nonzero = 1): the
    wavefront contour container's pieces."""
    B, H, W = contour.shape
    T = contour_T(H, W)
    dev = contour.device
    bits = (contour != 0).to(torch.int64)
    col = (torch.arange(W, device=dev)[None, :] + torch.arange(H, device=dev)[:, None]).expand(B, H, W)
    sym = torch.zeros((B, H, T), dtype=torch.int64, device=dev).scatter_(2, col, bits)  # row r delayed r steps
    left = torch.nn.functional.pad(sym[:, :, :-1], (1, 0))
    ctx = wavefront_bit_context(left.transpose(1, 2)).transpose(1, 2)
    ctx[:, :, 0] = 0
    key, freqs, lives = joint_tables(sym, ctx, 2, 4, torch.full((B,), H * T, device=dev))
    words, n_words, counts, states = _walk_and_pack(key, freqs, lives)
    return ContourPieces(words, n_words, counts, states, freqs)


# ------------------------------------------------------------------ the kernel's arithmetic
class StepConstants(NamedTuple):
    """csrc/rans.cu's per-symbol record, as int64 tensors of the shape of
    the frequencies.  With ``t = umulhi(m, x)`` and ``u = t + ((x - t) >>
    sh1)``, ``x // f == u >> sh2`` and ``(x >> 16) // f == u >> (sh2 + 16)``
    for every u32 ``x``: Granlund-Montgomery's round-up method with ``l =
    ceil(log2 f)``, whose multiplier for ``f << 16`` is the one for ``f``.
    The renormalization test is ``x > xm1`` (``xm1 = (f << 18) - 1`` in
    u32: never true at ``f = M``), and the update needs ``M - f``."""

    m: torch.Tensor
    xm1: torch.Tensor
    sh1: torch.Tensor
    sh2: torch.Tensor
    m_minus_f: torch.Tensor


def step_constants(freqs: torch.Tensor) -> StepConstants:
    """The kernel's step constants for frequencies in [0, M] (0, which no
    coded step reads, as 1): the tests' twin of ``csrc/rans.cu::make_record``."""
    f = freqs.to(torch.int64).clamp(min=1)
    l = sum((f > (1 << k)).to(torch.int64) for k in range(15))  # ceil(log2 f), f <= 2^14
    m = ((1 << 32) * ((1 << l) - f)) // f + 1
    return StepConstants(m, ((f << 18) - 1) & 0xFFFFFFFF, l.clamp(max=1), (l - 1).clamp(min=0), M - f)


def _umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of the u32 product a * b, in int64 without overflow."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def twin_quotients(x: torch.Tensor, k: StepConstants):
    """``(x // f, (x >> 16) // f)`` as the kernel computes them: one
    multiply-high, then shifts and adds."""
    t = _umulhi(k.m, x)
    u = t + ((x - t) >> k.sh1)
    return u >> k.sh2, u >> (k.sh2 + 16)


def twin_step(x: torch.Tensor, c: torch.Tensor, k: StepConstants):
    """One reverse rANS step as the kernel writes it, branch-free, on u32
    states held in int64: -> (new state, the word written, emitted)."""
    emit = x > k.xm1
    q_keep, q_emit = twin_quotients(x, k)
    word = x & 0xFFFF
    x = (torch.where(emit, x >> 16, x) + c + torch.where(emit, q_emit, q_keep) * k.m_minus_f) & 0xFFFFFFFF
    return x, word, emit


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def _library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("rans.cu")
    lib.rpcc_rans_encode_launch.restype = ctypes.c_int
    lib.rpcc_rans_encode_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4  # q, stream_len, B_res, width, lanes, T_res
        + [ctypes.c_void_p] + [ctypes.c_int] * 4  # contour, B_cnt, H, W, T_cnt
        + [ctypes.c_void_p] * 8  # residual outputs
        + [ctypes.c_void_p] * 5  # contour outputs
        + [ctypes.c_void_p] * 4  # key scratch, word scratch, phase stamps, stream
    )
    return lib


def _kernel():
    return _library().rpcc_rans_encode_launch


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _check_residual(q: torch.Tensor, stream_len: torch.Tensor, lanes: int, T: Optional[int]) -> Tuple[int, int]:
    """Raises unless the residual inputs are valid; -> (lanes, T) as ints
    (T None: :func:`stream_T`)."""
    if q.dtype != torch.int32 or stream_len.dtype != torch.int32:
        raise TypeError(f"q and stream_len must be int32, got {q.dtype} and {stream_len.dtype}")
    if q.ndim != 2 or q.shape[1] < 1 or stream_len.shape != (q.shape[0],):
        raise ValueError(f"expected (B, width) q and (B,) stream_len, got {tuple(q.shape)} and {tuple(stream_len.shape)}")
    if stream_len.device != q.device:
        raise ValueError("q and stream_len must share a device")
    if not (_is_int(lanes) and 1 <= lanes <= RESID_LANES and lanes & (lanes - 1) == 0):
        raise ValueError(f"lanes must be a power of two in 1..{RESID_LANES}, got {lanes!r}")
    if T is None:
        T = stream_T(q.shape[1], lanes)
    if not (_is_int(T) and T > 0 and T % _T_BUCKET == 0 and lanes * T >= q.shape[1]):
        raise ValueError(f"T must be a positive multiple of {_T_BUCKET} with lanes * T >= {q.shape[1]}, got {T!r}")
    if lanes * T * max(q.shape[0], 1) >= 2**31:
        raise ValueError("residual batch exceeds 2^31 lane steps")
    return int(lanes), int(T)


def _check_contour(contour: torch.Tensor) -> None:
    if contour.dtype != torch.int32:
        raise TypeError(f"contour must be int32, got {contour.dtype}")
    if contour.ndim != 3 or contour.shape[1] < 1 or contour.shape[2] < 1:
        raise ValueError(f"expected a (B, H, W) contour, got {tuple(contour.shape)}")
    B, H, W = contour.shape
    if H * contour_T(H, W) * max(B, 1) >= 2**31:
        raise ValueError("contour batch exceeds 2^31 lane steps")


def check_contour_fits_kernel(H: int, W: int) -> None:
    """Raises unless the CUDA kernel codes an H x W contour (the plain
    version has no such limits)."""
    if H > MAX_CONTOUR_ROWS:
        raise ValueError(f"the kernel codes at most {MAX_CONTOUR_ROWS} contour rows, got {H}")
    if H * contour_T(H, W) > MAX_CONTOUR_STEPS:
        raise ValueError(f"a contour of {H} x {W} has more than {MAX_CONTOUR_STEPS} lane steps")


def encode_fields_cuda(
    q: Optional[torch.Tensor], stream_len: Optional[torch.Tensor], contour: Optional[torch.Tensor],
    phase_stamps: Optional[torch.Tensor] = None, lanes: int = RESID_LANES, T: Optional[int] = None,
) -> Tuple[Optional[ResidualPieces], Optional[ContourPieces]]:
    """The CUDA kernel on CUDA tensors: the residual pieces of (B, width)
    int32 ``q`` with (B,) int32 ``stream_len``, coded in ``lanes`` lanes
    (a power of two up to 32) of ``T`` steps (a multiple of 16, lanes * T >=
    width; None: :func:`stream_T`, which is ``resid_T(width)`` at the
    engine's 32 lanes), and the contour pieces of a (B', H, W) int32
    ``contour``, either field None, in one launch on the current stream (no
    synchronize); raises on any other input.  ``phase_stamps``, an int64
    CUDA tensor of ``len(STAMP_BLOCKS) * (len(PHASES) + 1)`` elements,
    receives the ``%globaltimer`` (ns) at the bounds of the phases of frame
    0's residual block, then of its contour block (a field not coded leaves
    its stamps as they were)."""
    global LAUNCHES
    if q is None and contour is None:
        raise ValueError("nothing to encode")
    tensors = [t for t in (q, stream_len, contour) if t is not None]
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"encode_fields_cuda needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, stream_len and contour must be contiguous")
    n_stamps = len(STAMP_BLOCKS) * (len(PHASES) + 1)
    if phase_stamps is not None and (
        phase_stamps.device != dev or phase_stamps.dtype != torch.int64
        or phase_stamps.numel() != n_stamps or not phase_stamps.is_contiguous()
    ):
        raise ValueError(f"phase_stamps must be a contiguous int64 tensor of {n_stamps} on {dev}")
    br = width = t_res = 0
    if q is not None:
        lanes, t_res = _check_residual(q, stream_len, lanes, T)
        br, width = q.shape
    bc = H = W = t_cnt = 0
    if contour is not None:
        _check_contour(contour)
        bc, H, W = contour.shape
        check_contour_fits_kernel(H, W)
        t_cnt = contour_T(H, W)
    fn = _kernel()
    n_scratch = br * lanes * t_res + bc * H * t_cnt
    with torch.cuda.device(dev):
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        res = cnt = None
        if q is not None:
            res = ResidualPieces(
                empty((br, lanes * t_res), torch.int16), empty((br,), torch.int32),
                empty((br, lanes), torch.int32), empty((br, lanes), torch.int64),
                empty((br, NUM_CTX, ALPHABET), torch.int32), empty((br, ESC_CAP_DEV), torch.int64),
                empty((br,), torch.int32), empty((br,), torch.int32),
            )
        if contour is not None:
            cnt = ContourPieces(
                empty((bc, H * t_cnt), torch.int16), empty((bc,), torch.int32), empty((bc, H), torch.int32),
                empty((bc, H), torch.int64), empty((bc, 4, 2), torch.int32),
            )
        key_scratch = empty((max(n_scratch, 1),), torch.int16)
        word_scratch = empty((max(n_scratch, 1),), torch.int16)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(
            ptr(q), ptr(stream_len), br, width, lanes if q is not None else 0, t_res,
            ptr(contour), bc, H, W, t_cnt,
            *([p.data_ptr() for p in res] if res is not None else [None] * 8),
            *([p.data_ptr() for p in cnt] if cnt is not None else [None] * 5),
            key_scratch.data_ptr(), word_scratch.data_ptr(), ptr(phase_stamps),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rANS kernel launch failed: cudaError_t {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return res, cnt


def encode_streams_cuda(q: torch.Tensor, stream_len: torch.Tensor, lanes: int, T: int) -> ResidualPieces:
    """The residual pieces of :func:`encode_streams_plain`'s inputs from one
    launch of the CUDA kernel (:func:`encode_fields_cuda`)."""
    return encode_fields_cuda(q, stream_len, None, lanes=lanes, T=T)[0]


def encode_fields_device(
    q: Optional[torch.Tensor], stream_len: Optional[torch.Tensor], contour: Optional[torch.Tensor],
    lanes: int = RESID_LANES, T: Optional[int] = None,
) -> Tuple[Optional[ResidualPieces], Optional[ContourPieces]]:
    """Both fields' container pieces on the tensors' own device: one kernel
    launch for CUDA tensors, the plain versions for CPU tensors.  Either
    field may be None; ``lanes`` and ``T`` as in :func:`encode_fields_cuda`."""
    tensors = [t for t in (q, stream_len, contour) if t is not None]
    if not tensors:
        raise ValueError("nothing to encode")
    if tensors[0].device.type == "cuda":
        return encode_fields_cuda(q, stream_len, contour, lanes=lanes, T=T)
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(f"unsupported devices {[str(t.device) for t in tensors]}")
    res = cnt = None
    if q is not None:
        res = encode_streams_plain(q, stream_len, lanes, T)
    if contour is not None:
        _check_contour(contour)
        cnt = encode_contour_field_plain(contour)
    return res, cnt


def encode_residual_field_device(q: torch.Tensor, stream_len: torch.Tensor) -> ResidualPieces:
    """The residual pieces alone at the engine's geometry (:func:`encode_fields_device`)."""
    return encode_fields_device(q, stream_len, None)[0]


def encode_contour_field_device(contour: torch.Tensor) -> ContourPieces:
    """The contour pieces alone (:func:`encode_fields_device`)."""
    return encode_fields_device(None, None, contour)[1]


def upload_streams(arrays, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer streams (int16, uint16 or int32 arrays of any lengths) ->
    (q (B, max(n_max, 1)) int32, zero past each stream, and (B,) int32
    lengths) on ``device``, as the kernel takes them."""
    width = max([int(np.asarray(a).size) for a in arrays] + [1])
    q = np.zeros((len(arrays), width), np.int32)
    for b, a in enumerate(arrays):
        a = np.asarray(a).reshape(-1)
        q[b, : a.size] = a
    lens = np.asarray([np.asarray(a).size for a in arrays], np.int32)
    return torch.from_numpy(q).to(device), torch.from_numpy(lens).to(device)


def upload_contours(packed: np.ndarray, H: int, W: int, device) -> torch.Tensor:
    """(B, ceil(H * W / 8)) u8 packed contour bits (MSB first) -> the
    kernel's (B, H, W) int32 planes on ``device``."""
    bits = np.unpackbits(np.asarray(packed, np.uint8).reshape(len(packed), -1), axis=1)[:, : H * W]
    return torch.from_numpy(bits.reshape(-1, H, W)).to(device).to(torch.int32)


# ------------------------------------------------------------------ decode
# Context models of a field group (= codec/rans_native.py's decode modes):
# the residual 'C' container's zigzag contexts, the contour 'N' container's
# wavefront contexts, the order-0 'D' container's single table.
MODE_ZIGZAG, MODE_WAVEFRONT, MODE_ORDER0 = 0, 1, 2
_DECODE_CTX = {MODE_ZIGZAG: zigzag_magnitude_context, MODE_WAVEFRONT: wavefront_bit_context, MODE_ORDER0: zero_context}
_DECODE_TABLES = {MODE_ZIGZAG: NUM_CTX, MODE_WAVEFRONT: 4, MODE_ORDER0: 1}  # contexts C of the (B, C, A) freqs
# Launches of the decode kernel since the count was last reset (one per call
# of :func:`decode_fields_cuda` or :func:`decode_streams_cuda`, whatever
# groups it decodes; rises under the encode's lock).
DECODE_LAUNCHES = 0
# Spans timed by ``phase_stamps`` (csrc/rans_decode.cu) in two blocks: the
# residual group's frame 0 (stamps 0-3), the contour group's frame 0 (4-7).
DECODE_PHASES = ("tables", "walk", "flush")
DECODE_STAMP_BLOCKS = ("residual", "contour")


@functools.lru_cache(maxsize=None)
def _decode_library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("rans_decode.cu")
    lib.rpcc_rans_decode_fields_launch.restype = ctypes.c_int
    lib.rpcc_rans_decode_fields_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6  # residual: words, counts, states, lives, freqs, out; B, L, T, C, A, mode
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3  # contour: the same six; B, H, T
        + [ctypes.c_void_p] * 2  # phase stamps, stream
    )
    return lib


def _decode_kernel():
    return _decode_library().rpcc_rans_decode_fields_launch


def _check_decode(words, counts, states, lives, freqs, mode: int) -> None:
    if mode not in _DECODE_CTX:
        raise ValueError(f"unknown decode mode {mode}")
    for name, t, dt in (("words", words, torch.int16), ("counts", counts, torch.int32), ("states", states, torch.int64),
                        ("lives", lives, torch.int32), ("freqs", freqs, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if words.ndim != 3 or min(words.shape) < 1:
        raise ValueError(f"expected (B, L, T) words with B, L, T >= 1, got {tuple(words.shape)}")
    B, L, _ = words.shape
    if any(t.shape != (B, L) for t in (counts, states, lives)):
        raise ValueError(f"counts, states and lives must be ({B}, {L}), got "
                         f"{[tuple(t.shape) for t in (counts, states, lives)]}")
    C = _DECODE_TABLES[mode]
    if freqs.ndim != 3 or freqs.shape[:2] != (B, C) or freqs.shape[2] < 1 or (mode == MODE_WAVEFRONT and freqs.shape[2] != 2):
        raise ValueError(f"mode {mode} needs ({B}, {C}, A) freqs{' with A = 2' if mode == MODE_WAVEFRONT else ''}, "
                         f"got {tuple(freqs.shape)}")
    if any(t.device != words.device for t in (counts, states, lives, freqs)):
        raise ValueError("words, counts, states, lives and freqs must share a device")


def check_decode_fits_kernel(L: int, A: int, mode: int) -> None:
    """Raises unless the CUDA decode kernel takes L lanes of an A-symbol
    alphabet in ``mode`` (the plain version has no such limits): a residual
    field's lanes are one warp, a contour's rows a block."""
    if mode == MODE_WAVEFRONT:
        if L > MAX_CONTOUR_ROWS:
            raise ValueError(f"the decode kernel takes at most {MAX_CONTOUR_ROWS} contour rows, got {L}")
    elif L > RESID_LANES or A > ALPHABET:
        raise ValueError(f"the decode kernel takes at most {RESID_LANES} lanes of at most {ALPHABET} symbols, "
                         f"got {L} lanes of {A}")


def decode_streams_plain(words, counts, states, lives, freqs, mode: int) -> torch.Tensor:
    """Plain version: (B, L, T) words (u16 in int16), (B, L) int32 counts
    and lives, int64 u32 states, (B, C, A) int32 freqs -> (B, L*T) int32
    symbols, decoded with ``mode``'s contexts."""
    _check_decode(words, counts, states, lives, freqs, mode)
    return decode_streams_batch_ctx(RansCode(words, counts, states), freqs, words.shape[2],
                                    ctx_fn=_DECODE_CTX[mode], lives=lives)


def _cuda_group(tensors, mode: int, dev) -> Tuple[int, int, int, int, int]:
    """Raises unless one field group's tensors are the kernel's: contiguous,
    on ``dev`` (a CUDA device), within its limits -> (B, L, T, C, A)."""
    _check_decode(*tensors, mode)
    if dev.type != "cuda" or tensors[0].device != dev:
        raise ValueError(f"the decode kernel needs CUDA tensors on one device, got {tensors[0].device} and {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("words, counts, states, lives and freqs must be contiguous")
    B, L, T = tensors[0].shape
    C, A = tensors[4].shape[1:]
    check_decode_fits_kernel(L, A, mode)
    return B, L, T, C, A


def decode_fields_cuda(residual, contour, mode: int = MODE_ZIGZAG,
                       phase_stamps: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """Both big fields of a batch in one launch of the CUDA decode kernel:
    ``residual`` (the tensors of :func:`decode_streams_plain`: words, counts,
    states, lives, freqs) decoded with ``mode``'s contexts (zigzag or
    order-0) and ``contour`` (the same five, wavefront contexts), either
    None, all contiguous on one CUDA device -> ((B_r, L * T_r) int32 or
    None, (B_c, H * T_c) int32 or None) on the current stream (no
    synchronize); raises on any other input.  ``phase_stamps``, an int64 CUDA tensor of
    ``len(DECODE_STAMP_BLOCKS) * (len(DECODE_PHASES) + 1)`` elements,
    receives the ``%globaltimer`` (ns) at the bounds of the phases of the
    residual group's frame 0, then of the contour group's (a group not
    decoded leaves its stamps as they were)."""
    global DECODE_LAUNCHES
    if residual is None and contour is None:
        raise ValueError("nothing to decode")
    if mode not in (MODE_ZIGZAG, MODE_ORDER0):
        raise ValueError(f"the residual group's mode must be {MODE_ZIGZAG} or {MODE_ORDER0}, got {mode}")
    dev = (residual if residual is not None else contour)[0].device
    shape_r = _cuda_group(residual, mode, dev) if residual is not None else (0, 1, 1, 1, 1)
    shape_c = _cuda_group(contour, MODE_WAVEFRONT, dev) if contour is not None else (0, 1, 1, 4, 2)
    n_stamps = len(DECODE_STAMP_BLOCKS) * (len(DECODE_PHASES) + 1)
    if phase_stamps is not None and (
        phase_stamps.device != dev or phase_stamps.dtype != torch.int64
        or phase_stamps.numel() != n_stamps or not phase_stamps.is_contiguous()
    ):
        raise ValueError(f"phase_stamps must be a contiguous int64 tensor of {n_stamps} on {dev}")
    (br, L, tr, C, A), (bc, H, tc) = shape_r, shape_c[:3]
    fn = _decode_kernel()
    with torch.cuda.device(dev):
        res_out = torch.empty((br, L * tr), dtype=torch.int32, device=dev)
        cnt_out = torch.empty((bc, H * tc), dtype=torch.int32, device=dev)
        ptrs = lambda g, out: [t.data_ptr() for t in g] + [out.data_ptr()] if g is not None else [None] * 6  # noqa: E731
        err = fn(*ptrs(residual, res_out), br, L, tr, C, A, mode, *ptrs(contour, cnt_out), bc, H, tc,
                 None if phase_stamps is None else phase_stamps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rANS decode kernel launch failed: cudaError_t {err}")
    with _LAUNCHES_LOCK:
        DECODE_LAUNCHES += 1
    return (res_out if residual is not None else None), (cnt_out if contour is not None else None)


def decode_streams_cuda(words, counts, states, lives, freqs, mode: int,
                        phase_stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA decode kernel on one field group's contiguous CUDA tensors
    of :func:`decode_streams_plain`'s types: one launch on the current
    stream (no synchronize) -> (B, L*T) int32; raises on any other input.
    The kernel reads each frequency as u16 (the wire's type) and equals the
    plain version for frequencies in [0, 2^16).  ``phase_stamps`` as in
    :func:`decode_fields_cuda`."""
    group = (words, counts, states, lives, freqs)
    if mode == MODE_WAVEFRONT:
        return decode_fields_cuda(None, group, phase_stamps=phase_stamps)[1]
    return decode_fields_cuda(group, None, mode, phase_stamps)[0]


def upload_decode_lanes(words: np.ndarray, counts: np.ndarray, states: np.ndarray, lives: np.ndarray,
                        freqs: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """Host-assembled lanes of one field group ((B, L, T) u16 words, (B, L)
    counts, u32 states and live steps, (B, C, A) freqs) -> contiguous
    tensors on ``device`` of the decoders' types."""

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return (up(np.ascontiguousarray(words, np.uint16).view(np.int16), np.int16), up(counts, np.int32),
            up(states, np.int64), up(lives, np.int32), up(freqs, np.int32))


def decode_streams_device(words: np.ndarray, counts: np.ndarray, states: np.ndarray, lives: np.ndarray,
                          freqs: np.ndarray, mode: int, device) -> torch.Tensor:
    """Host-assembled lanes of one field group (:func:`upload_decode_lanes`)
    uploaded to ``device`` and decoded there: one kernel launch for a CUDA
    device, the plain version for the CPU -> (B, L*T) int32 symbols on
    ``device``."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    args = upload_decode_lanes(words, counts, states, lives, freqs, device)
    if device.type == "cuda":
        return decode_streams_cuda(*args, mode)
    return decode_streams_plain(*args, mode)


def decode_fields_device(residual, contour, mode: int, device) -> Tuple[Optional[torch.Tensor], ...]:
    """Host-assembled lanes of a residual group (decoded with ``mode``'s
    contexts) and of a contour group (numpy (words, counts, states, lives,
    freqs) each, as :func:`upload_decode_lanes` takes them; either None)
    uploaded to ``device`` and decoded there: one kernel launch for both on
    a CUDA device (:func:`decode_fields_cuda`), the plain version of each on
    the CPU -> ((B_r, L * T_r) int32 or None, (B_c, H * T_c) int32 or None)
    on ``device``."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    res = None if residual is None else upload_decode_lanes(*residual, device)
    cnt = None if contour is None else upload_decode_lanes(*contour, device)
    if device.type == "cuda":
        return decode_fields_cuda(res, cnt, mode)
    if res is None and cnt is None:
        raise ValueError("nothing to decode")
    return (None if res is None else decode_streams_plain(*res, mode),
            None if cnt is None else decode_streams_plain(*cnt, MODE_WAVEFRONT))


def fields_to_host(residual: Optional[torch.Tensor], contour: Optional[torch.Tensor]):
    """numpy copies of :func:`decode_fields_device`'s outputs (None stays
    None), joined on their device and downloaded in one copy."""
    outs = [t for t in (residual, contour) if t is not None]
    flat = torch.cat([t.reshape(-1) for t in outs]).cpu().numpy()
    host, at = [], 0
    for t in (residual, contour):
        host.append(None if t is None else flat[at:at + t.numel()].reshape(t.shape))
        at += 0 if t is None else t.numel()
    return tuple(host)
