"""Device rANS coding: the encode and decode kernels' wrappers
(``csrc/rans.cu``, ``csrc/rans_decode.cu``) beside their plain PyTorch
versions (port of ``rpcc_tpu/ops/rans_device.py``; the decoders are
``ops/rans.py``'s).  What this module gives back is a container's pieces:
words, word counts, lane states, tables and escapes.  The containers
themselves, and the choice between a device-coded and a host-coded one,
are ``codec/rans_codec.py``'s.

The encoder graph (``cfg.device_entropy`` with the ``rans`` coder) codes
the residual stream and the contour plane of a batch in one launch of
:func:`encode_fields_device`, as the pieces of these containers:

* residual ('C'): delta + zigzag over the live stream (positions at or past
  ``stream_len`` are zero deltas), zigzag values >= ESCAPE become the ESCAPE
  symbol with the value on an escape list in stream order (the first
  ESC_CAP_DEV of them, plus the total count), 32 live-aware lanes of
  ``resid_T(HW)`` steps, a 4-context model on the previous symbol of the
  lane, histograms over the live positions only;
* contour ('N'): the (H, W) bits sheared into a diagonal wavefront (row r
  delayed r steps), H lanes of ``contour_T(H, W)`` steps, ctx = 2 * above
  + left.

The host containers' encode on a CUDA device (the reference's
``rpcc_tpu/ops/rans.py::encode_streams_batch_ctx`` and
``encode_streams_batch_ctx_explicit``, which it runs under
``RPCC_RANS_DEVICE=default``) is the same kernel: residual streams at the
batch's own lane geometry (:func:`encode_streams_host`, L a power of two
up to 32 and T a multiple of 16 from its longest frame, zero-padded
(B, n_max) streams with per-frame lengths), the contour exactly as above
(:func:`encode_contours_host`).  A residual's zigzag value is computed in
u32, so an int32 stream whose deltas fit int32 escapes with the
reference's u32 values.

Each lane's symbols are walked in reverse (16-bit renormalization, at most
one word per symbol; the walk is :func:`rpcc_tpu_torch.ops.rans.encode_walk`);
the packed words are the emitted words lane-major in
emission order, followed by the words of the steps that emitted nothing, in
the same order (the reference's stable sort of the (lane, step) keys), so
every output equals the reference's element for element.  A zigzag value
of 2^31 or more (a residual delta of 2^30 or more, which a quantized range
residual never reaches) is an escape here, where the reference's int32
would wrap it negative.

Its entry points: the plain versions (:func:`encode_streams_plain`,
:func:`encode_contour_field_plain`, :func:`decode_streams_plain`); the
kernels on CUDA tensors, one launch each (:func:`encode_fields_cuda`,
:func:`decode_fields_cuda`); the encoder graph's
:func:`encode_fields_device` (the kernel for CUDA tensors, which never fall
back to the plain versions: if the kernel cannot build or launch, the call
raises); the codec's host-array calls (:func:`encode_streams_host`,
:func:`encode_contours_host`, :func:`decode_fields_host`: each packs its
arrays into one staging buffer, pinned for a card, that goes up in one copy
into one device workspace of inputs, outputs and scratch,
:class:`_Workspace`, and its outputs come back in one copy; the plain
versions on the CPU); and the ``upload_*`` helpers, which put host arrays
on a device as the kernels take them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rpcc_tpu_torch.ops.rans import (
    M, RansCode, cumulative, decode_streams_batch_ctx, encode_walk, joint_tables, wavefront_bit_context,
    zero_context, zigzag_magnitude_context,
)
from rpcc_tpu_torch.utils import timer

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
    return _check_geometry(q.shape[0], q.shape[1], lanes, T)


def _check_geometry(B: int, width: int, lanes: int, T: Optional[int]) -> Tuple[int, int]:
    """Raises unless ``lanes`` lanes of ``T`` steps code B streams of
    ``width`` symbols; -> (lanes, T) as ints (T None: :func:`stream_T`)."""
    if not (_is_int(lanes) and 1 <= lanes <= RESID_LANES and lanes & (lanes - 1) == 0):
        raise ValueError(f"lanes must be a power of two in 1..{RESID_LANES}, got {lanes!r}")
    if T is None:
        T = stream_T(width, lanes)
    if not (_is_int(T) and T > 0 and T % _T_BUCKET == 0 and lanes * T >= width):
        raise ValueError(f"T must be a positive multiple of {_T_BUCKET} with lanes * T >= {width}, got {T!r}")
    if lanes * T * max(B, 1) >= 2**31:
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


# ------------------------------------------------------------------ one call's buffers
_ALIGN = 256  # bytes: every view of a workspace or staging buffer starts at a multiple
_NUMPY = {torch.uint8: np.uint8, torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64}


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _as_device(device) -> torch.device:
    """``device`` as a torch.device with its index (a CUDA device without
    one is the current device), raising unless it is the CPU or CUDA."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Workspace:
    """One call's memory on ``device``: a single allocation holding the
    ``outputs``, then the ``inputs``, then the ``scratch`` (each a list of
    (name, shape, torch dtype)), every one at an _ALIGN-byte offset: its
    address :meth:`ptr`, its tensor :meth:`view`.  The inputs are written
    on the host into one staging buffer (pinned for a CUDA device;
    :meth:`host`) and go up in one copy (:meth:`upload`); the outputs, laid
    out first, come back in one copy (:meth:`download`).  Both buffers come
    from PyTorch's caching allocators, which reuse blocks by size and are
    safe across threads."""

    def __init__(self, device: torch.device, outputs, inputs=(), scratch=()):
        self.device = device
        self._cuda = device.type == "cuda"
        self._spans, self._bounds, at = {}, {}, 0  # name -> (offset, bytes, shape, torch dtype)
        for kind, items in (("out", outputs), ("in", inputs), ("scratch", scratch)):
            lo = at
            for name, shape, dt in items:
                n = _nbytes(shape, dt)
                self._spans[name] = (at, n, tuple(shape), dt)
                at += -(-n // _ALIGN) * _ALIGN
            self._bounds[kind] = (lo, at)
        self.buf = torch.empty(max(at, _ALIGN), dtype=torch.uint8, device=device)
        self._base = self.buf.data_ptr()
        lo, hi = self._bounds["in"]
        self._staging = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=self._cuda) if hi > lo else None
        self._staged = None if self._staging is None else self._staging.numpy()

    def ptr(self, name: str) -> int:
        """The device address of ``name``."""
        return self._base + self._spans[name][0]

    def view(self, name: str) -> torch.Tensor:
        """``name`` as a tensor on the device, a view of the workspace."""
        off, n, shape, dt = self._spans[name]
        return self.buf[off:off + n].view(dt).reshape(shape)

    def host(self, name: str) -> np.ndarray:
        """The staging buffer's numpy view of input ``name``, to be filled before :meth:`upload`."""
        off, n, shape, dt = self._spans[name]
        at = off - self._bounds["in"][0]
        return self._staged[at:at + n].view(_NUMPY[dt]).reshape(shape)

    def upload(self) -> None:
        """The staged inputs into the workspace: one copy on the current stream."""
        if self._staging is not None:
            lo, hi = self._bounds["in"]
            self.buf[lo:hi].copy_(self._staging, non_blocking=self._cuda)

    def download(self) -> dict:
        """The outputs as numpy arrays, from one copy of their span (on a
        CUDA device into pinned memory, then the current stream waited on;
        on the CPU the workspace's own memory)."""
        end = self._bounds["out"][1]
        host = self.buf[:end]
        if self._cuda:
            host = torch.empty(end, dtype=torch.uint8, pin_memory=True)
            host.copy_(self.buf[:end], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        flat = host.numpy()
        return {name: flat[off:off + n].view(_NUMPY[dt]).reshape(shape)
                for name, (off, n, shape, dt) in self._spans.items() if off < end}


def _encode_outputs(br: Optional[int], lanes: int, t_res: int, bc: Optional[int], H: int, t_cnt: int):
    """The (name, shape, dtype) outputs of one encode launch: the residual
    pieces ("r_" + field, when ``br`` is not None) and the contour pieces
    ("c_" + field, when ``bc`` is not None), in the pieces' field order."""
    out = []
    if br is not None:
        out += list(zip(("r_" + f for f in ResidualPieces._fields), (
            (br, lanes * t_res), (br,), (br, lanes), (br, lanes), (br, NUM_CTX, ALPHABET), (br, ESC_CAP_DEV), (br,), (br,),
        ), (torch.int16, torch.int32, torch.int32, torch.int64, torch.int32, torch.int64, torch.int32, torch.int32)))
    if bc is not None:
        out += list(zip(("c_" + f for f in ContourPieces._fields), (
            (bc, H * t_cnt), (bc,), (bc, H), (bc, H), (bc, 4, 2),
        ), (torch.int16, torch.int32, torch.int32, torch.int64, torch.int32)))
    return out


def _encode_scratch(br: int, lanes: int, t_res: int, bc: int, H: int, t_cnt: int):
    n = max(br * lanes * t_res + bc * H * t_cnt, 1)
    return [("key_scratch", (n,), torch.int16), ("word_scratch", (n,), torch.int16)]


def _encode_pieces(ws: _Workspace, residual: bool, contour: bool):
    res = ResidualPieces(*(ws.view("r_" + f) for f in ResidualPieces._fields)) if residual else None
    cnt = ContourPieces(*(ws.view("c_" + f) for f in ContourPieces._fields)) if contour else None
    return res, cnt


def _check_encode(q, stream_len, contour, lanes, T, phase_stamps):
    """Raises unless the inputs are the kernel's: contiguous CUDA tensors
    on one device, within its limits -> (dev, (br | None, width, lanes,
    t_res), (bc | None, H, W, t_cnt))."""
    if q is None and contour is None:
        raise ValueError("nothing to encode")
    tensors = [t for t in (q, stream_len, contour) if t is not None]
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"encode_fields_cuda needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, stream_len and contour must be contiguous")
    _check_stamps(phase_stamps, dev, len(STAMP_BLOCKS) * (len(PHASES) + 1))
    br = None
    width = t_res = 0
    if q is not None:
        lanes, t_res = _check_residual(q, stream_len, lanes, T)
        br, width = q.shape
    bc = None
    H = W = t_cnt = 0
    if contour is not None:
        _check_contour(contour)
        bc, H, W = contour.shape
        check_contour_fits_kernel(H, W)
        t_cnt = contour_T(H, W)
    return dev, (br, width, lanes, t_res), (bc, H, W, t_cnt)


def _check_stamps(phase_stamps, dev, n_stamps: int) -> None:
    if phase_stamps is not None and (
        phase_stamps.device != dev or phase_stamps.dtype != torch.int64
        or phase_stamps.numel() != n_stamps or not phase_stamps.is_contiguous()
    ):
        raise ValueError(f"phase_stamps must be a contiguous int64 tensor of {n_stamps} on {dev}")


def _encode_launch(dev, ptr, res_shape, cnt_shape, phase_stamps) -> None:
    """One launch of the encode kernel on the current stream of ``dev``:
    the residual field of ``res_shape`` ((B, width, lanes, T), B None for
    none) and the contour field of ``cnt_shape`` ((B, H, W, T), B None for
    none), its inputs, pieces and scratch at the addresses ``ptr(name)``
    gives ("q", "stream_len", "contour", :func:`_encode_outputs`' and
    :func:`_encode_scratch`'s names).  Counts the launch under
    ``launch.rans_encode`` (one per call of :func:`encode_fields_cuda`,
    whatever fields it codes)."""
    (br, width, lanes, t_res), (bc, H, W, t_cnt) = res_shape, cnt_shape
    res, cnt = br is not None, bc is not None
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(
            ptr("q") if res else None, ptr("stream_len") if res else None, br or 0, width, lanes if res else 0, t_res,
            ptr("contour") if cnt else None, bc or 0, H, W, t_cnt,
            *([ptr("r_" + f) for f in ResidualPieces._fields] if res else [None] * 8),
            *([ptr("c_" + f) for f in ContourPieces._fields] if cnt else [None] * 5),
            ptr("key_scratch"), ptr("word_scratch"), None if phase_stamps is None else phase_stamps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rANS kernel launch failed: cudaError_t {err}")
    timer.count("launch.rans_encode")


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
    synchronize); raises on any other input.  The pieces and the kernel's
    scratch are views of one workspace.  ``phase_stamps``, an int64
    CUDA tensor of ``len(STAMP_BLOCKS) * (len(PHASES) + 1)`` elements,
    receives the ``%globaltimer`` (ns) at the bounds of the phases of frame
    0's residual block, then of its contour block (a field not coded leaves
    its stamps as they were)."""
    dev, rs, cs = _check_encode(q, stream_len, contour, lanes, T, phase_stamps)
    (br, _, lanes, t_res), (bc, H, _, t_cnt) = rs, cs
    ws = _Workspace(dev, _encode_outputs(br, lanes, t_res, bc, H, t_cnt),
                    scratch=_encode_scratch(br or 0, lanes, t_res, bc or 0, H, t_cnt))
    given = {"q": q, "stream_len": stream_len, "contour": contour}
    _encode_launch(dev, lambda n: given[n].data_ptr() if n in given else ws.ptr(n), rs, cs, phase_stamps)
    return _encode_pieces(ws, q is not None, contour is not None)


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


def _fill_streams(q: np.ndarray, lens: np.ndarray, arrays) -> None:
    """Row b of the (B, width) ``q``: stream b, zero past it; ``lens[b]`` its length."""
    for b, a in enumerate(arrays):
        a = np.asarray(a).reshape(-1)
        q[b, : a.size] = a
        q[b, a.size:] = 0
        lens[b] = a.size


def _stream_width(arrays) -> int:
    return max([int(np.asarray(a).size) for a in arrays] + [1])


def upload_streams(arrays, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer streams (int16, uint16 or int32 arrays of any lengths) ->
    (q (B, max(n_max, 1)) int32, zero past each stream, and (B,) int32
    lengths) on ``device``, as the kernel takes them."""
    q = np.empty((len(arrays), _stream_width(arrays)), np.int32)
    lens = np.empty(len(arrays), np.int32)
    _fill_streams(q, lens, arrays)
    return torch.from_numpy(q).to(device), torch.from_numpy(lens).to(device)


def upload_contours(packed: np.ndarray, H: int, W: int, device) -> torch.Tensor:
    """(B, ceil(H * W / 8)) u8 packed contour bits (MSB first) -> the
    kernel's (B, H, W) int32 planes on ``device``."""
    bits = np.unpackbits(np.asarray(packed, np.uint8).reshape(len(packed), -1), axis=1)[:, : H * W]
    return torch.from_numpy(bits.reshape(-1, H, W)).to(device).to(torch.int32)


def _copy_pieces(ws: _Workspace, prefix: str, pieces) -> None:
    """The plain version's pieces into a workspace's outputs."""
    for f, t in zip(pieces._fields, pieces):
        ws.view(prefix + f).copy_(t)


def encode_streams_host(arrays, lanes: int, T: Optional[int], device) -> ResidualPieces:
    """The residual pieces (numpy arrays, as :func:`encode_streams_plain`
    gives them) of integer streams (int16, uint16 or int32 arrays of any
    lengths) coded in ``lanes`` lanes of ``T`` steps on ``device``: the
    streams staged and uploaded in one copy, one launch of the kernel for a
    CUDA device (the plain version for the CPU), the pieces downloaded in
    one copy."""
    dev = _as_device(device)
    B, width = len(arrays), _stream_width(arrays)
    lanes, T = _check_geometry(B, width, lanes, T)
    cuda = dev.type == "cuda"
    ws = _Workspace(dev, _encode_outputs(B, lanes, T, None, 0, 0),
                    [("q", (B, width), torch.int32), ("stream_len", (B,), torch.int32)],
                    _encode_scratch(B, lanes, T, 0, 0, 0) if cuda else ())
    _fill_streams(ws.host("q"), ws.host("stream_len"), arrays)
    ws.upload()
    if cuda:
        _encode_launch(dev, ws.ptr, (B, width, lanes, T), (None, 0, 0, 0), None)
    else:
        _copy_pieces(ws, "r_", encode_streams_plain(ws.view("q"), ws.view("stream_len"), lanes, T))
    host = ws.download()
    return ResidualPieces(*(host["r_" + f] for f in ResidualPieces._fields))


def encode_contours_host(packed: np.ndarray, H: int, W: int, device) -> ContourPieces:
    """The contour pieces (numpy arrays) of (B, ceil(H * W / 8)) u8 packed
    contour bits (MSB first) on ``device``: the bits staged as bytes and
    uploaded in one copy, one launch of the kernel for a CUDA device (which
    codes at most 512 rows and raises past them; the plain version for the
    CPU), the pieces downloaded in one copy."""
    dev = _as_device(device)
    packed = np.asarray(packed, np.uint8).reshape(len(packed), -1)
    B, t_cnt = packed.shape[0], contour_T(H, W)
    cuda = dev.type == "cuda"
    if cuda:
        check_contour_fits_kernel(H, W)
    ws = _Workspace(dev, _encode_outputs(None, 0, 0, B, H, t_cnt), [("bits", (B, H, W), torch.uint8)],
                    [("contour", (B, H, W), torch.int32)] + (_encode_scratch(0, 0, 0, B, H, t_cnt) if cuda else []))
    ws.host("bits")[...] = np.unpackbits(packed, axis=1)[:, : H * W].reshape(B, H, W)
    ws.upload()
    contour = ws.view("contour")
    contour.copy_(ws.view("bits"))
    _check_contour(contour)
    if cuda:
        _encode_launch(dev, ws.ptr, (None, 0, 0, 0), (B, H, W, t_cnt), None)
    else:
        _copy_pieces(ws, "c_", encode_contour_field_plain(contour))
    host = ws.download()
    return ContourPieces(*(host["c_" + f] for f in ContourPieces._fields))


# ------------------------------------------------------------------ decode
# Context models of a field group (= codec/rans_native.py's decode modes):
# the residual 'C' container's zigzag contexts, the contour 'N' container's
# wavefront contexts, the order-0 'D' container's single table.
MODE_ZIGZAG, MODE_WAVEFRONT, MODE_ORDER0 = 0, 1, 2
_DECODE_CTX = {MODE_ZIGZAG: zigzag_magnitude_context, MODE_WAVEFRONT: wavefront_bit_context, MODE_ORDER0: zero_context}
_DECODE_TABLES = {MODE_ZIGZAG: NUM_CTX, MODE_WAVEFRONT: 4, MODE_ORDER0: 1}  # contexts C of the (B, C, A) freqs
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


def _check_decode_shapes(words, counts, states, lives, freqs, mode: int) -> None:
    """Raises unless one field group's shapes are (B, L, T) words, (B, L)
    counts, states and lives and (B, C, A) freqs with ``mode``'s C (and
    A = 2 for the wavefront), B, L, T >= 1."""
    if mode not in _DECODE_CTX:
        raise ValueError(f"unknown decode mode {mode}")
    if len(words) != 3 or min(words) < 1:
        raise ValueError(f"expected (B, L, T) words with B, L, T >= 1, got {words}")
    B, L, _ = words
    if any(s != (B, L) for s in (counts, states, lives)):
        raise ValueError(f"counts, states and lives must be ({B}, {L}), got {[counts, states, lives]}")
    C = _DECODE_TABLES[mode]
    if len(freqs) != 3 or freqs[:2] != (B, C) or freqs[2] < 1 or (mode == MODE_WAVEFRONT and freqs[2] != 2):
        raise ValueError(f"mode {mode} needs ({B}, {C}, A) freqs{' with A = 2' if mode == MODE_WAVEFRONT else ''}, "
                         f"got {freqs}")


def _check_decode(words, counts, states, lives, freqs, mode: int) -> None:
    if mode not in _DECODE_CTX:
        raise ValueError(f"unknown decode mode {mode}")
    for name, t, dt in (("words", words, torch.int16), ("counts", counts, torch.int32), ("states", states, torch.int64),
                        ("lives", lives, torch.int32), ("freqs", freqs, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    _check_decode_shapes(*(tuple(t.shape) for t in (words, counts, states, lives, freqs)), mode)
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


def _check_fields(residual, contour, mode: int):
    if residual is None and contour is None:
        raise ValueError("nothing to decode")
    if mode not in (MODE_ZIGZAG, MODE_ORDER0):
        raise ValueError(f"the residual group's mode must be {MODE_ZIGZAG} or {MODE_ORDER0}, got {mode}")


_LANE_FIELDS = (("words", torch.int16), ("counts", torch.int32), ("states", torch.int64), ("lives", torch.int32),
                ("freqs", torch.int32))


def _decode_launch(dev, ptr, shape_r, shape_c, mode: int, phase_stamps) -> None:
    """One launch of the decode kernel on the current stream of ``dev``:
    the residual group of ``shape_r`` ((B, L, T, C, A), or None) decoded
    with ``mode``'s contexts and the contour group of ``shape_c`` ((B, H,
    T), or None), each group's five inputs and its symbols at the addresses
    ``ptr(name)`` gives ("r_words" .. "r_freqs", "r_out"; "c_" the same).
    Counts the launch under ``launch.rans_decode`` (one per call of
    :func:`decode_fields_cuda` or :func:`decode_fields_host` on a card,
    whatever groups it decodes)."""
    br, L, tr, C, A = shape_r or (0, 1, 1, 1, 1)
    bc, H, tc = shape_c or (0, 1, 1)
    names = [n for n, _ in _LANE_FIELDS] + ["out"]
    ptrs = lambda p, shape: [ptr(p + n) for n in names] if shape is not None else [None] * 6  # noqa: E731
    fn = _decode_kernel()
    with torch.cuda.device(dev):
        err = fn(*ptrs("r_", shape_r), br, L, tr, C, A, mode, *ptrs("c_", shape_c), bc, H, tc,
                 None if phase_stamps is None else phase_stamps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rANS decode kernel launch failed: cudaError_t {err}")
    timer.count("launch.rans_decode")


def _decode_outputs(shape_r, shape_c):
    """The (name, shape, dtype) outputs of a decode: "r_out" and "c_out"."""
    return [(p + "out", (shape[0], shape[1] * shape[2]), torch.int32)
            for p, shape in (("r_", shape_r), ("c_", shape_c)) if shape is not None]


def decode_fields_cuda(residual, contour, mode: int = MODE_ZIGZAG,
                       phase_stamps: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """Both big fields of a batch in one launch of the CUDA decode kernel:
    ``residual`` (the tensors of :func:`decode_streams_plain`: words, counts,
    states, lives, freqs) decoded with ``mode``'s contexts (zigzag or
    order-0) and ``contour`` (the same five, wavefront contexts), either
    None, all contiguous on one CUDA device -> ((B_r, L * T_r) int32 or
    None, (B_c, H * T_c) int32 or None), views of one workspace, on the
    current stream (no synchronize); raises on any other input.
    ``phase_stamps``, an int64 CUDA tensor of
    ``len(DECODE_STAMP_BLOCKS) * (len(DECODE_PHASES) + 1)`` elements,
    receives the ``%globaltimer`` (ns) at the bounds of the phases of the
    residual group's frame 0, then of the contour group's (a group not
    decoded leaves its stamps as they were)."""
    _check_fields(residual, contour, mode)
    dev = (residual if residual is not None else contour)[0].device
    if dev.type != "cuda":
        raise ValueError(f"the decode kernel needs CUDA tensors, got {dev}")
    shape_r = _cuda_group(residual, mode, dev) if residual is not None else None
    shape_c = _cuda_group(contour, MODE_WAVEFRONT, dev)[:3] if contour is not None else None
    _check_stamps(phase_stamps, dev, len(DECODE_STAMP_BLOCKS) * (len(DECODE_PHASES) + 1))
    ws = _Workspace(dev, _decode_outputs(shape_r, shape_c))
    given = {p + n: t for p, g in (("r_", residual), ("c_", contour)) if g is not None
             for (n, _), t in zip(_LANE_FIELDS, g)}
    _decode_launch(dev, lambda n: given[n].data_ptr() if n in given else ws.ptr(n), shape_r, shape_c, mode,
                   phase_stamps)
    return (ws.view("r_out") if residual is not None else None), (ws.view("c_out") if contour is not None else None)


def upload_decode_lanes(words: np.ndarray, counts: np.ndarray, states: np.ndarray, lives: np.ndarray,
                        freqs: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """Host-assembled lanes of one field group ((B, L, T) u16 words, (B, L)
    counts, u32 states and live steps, (B, C, A) freqs) -> contiguous
    tensors on ``device`` of the decoders' types."""

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return (up(np.ascontiguousarray(words, np.uint16).view(np.int16), np.int16), up(counts, np.int32),
            up(states, np.int64), up(lives, np.int32), up(freqs, np.int32))


def _decode_staged(residual, contour, mode: int, device) -> _Workspace:
    """Both groups' host-assembled lanes (numpy (words, counts, states,
    lives, freqs) each, as :func:`upload_decode_lanes` takes them; either
    None) staged and uploaded in one copy, and decoded on ``device``: one
    kernel launch for a CUDA device, each group's plain version for the
    CPU -> the workspace, whose "r_out" and "c_out" hold the symbols."""
    _check_fields(residual, contour, mode)
    dev = _as_device(device)
    cuda = dev.type == "cuda"
    groups, shapes = [], {}
    for p, g, m in (("r_", residual, mode), ("c_", contour, MODE_WAVEFRONT)):
        if g is None:
            continue
        dims = [tuple(np.shape(a)) for a in g]
        _check_decode_shapes(*dims, m)
        (B, L, T), (_, C, A) = dims[0], dims[4]
        if cuda:
            check_decode_fits_kernel(L, A, m)
        shapes[p] = (B, L, T, C, A) if p == "r_" else (B, L, T)
        groups.append((p, g, dims))
    ws = _Workspace(dev, _decode_outputs(shapes.get("r_"), shapes.get("c_")),
                    [(p + name, shape, dt) for p, _, dims in groups for (name, dt), shape in zip(_LANE_FIELDS, dims)])
    for p, g, _ in groups:
        for (name, _), a in zip(_LANE_FIELDS, g):
            host = ws.host(p + name)
            (host.view(np.uint16) if name == "words" else host)[...] = a
    ws.upload()
    if cuda:
        _decode_launch(dev, ws.ptr, shapes.get("r_"), shapes.get("c_"), mode, None)
    else:
        for p, _, _ in groups:
            sym = decode_streams_plain(*(ws.view(p + name) for name, _ in _LANE_FIELDS),
                                       mode if p == "r_" else MODE_WAVEFRONT)
            ws.view(p + "out").copy_(sym)
    return ws


def decode_fields_host(residual, contour, mode: int, device) -> Tuple[Optional[np.ndarray], ...]:
    """Host-assembled lanes of a residual group (decoded with ``mode``'s
    contexts) and of a contour group (numpy (words, counts, states, lives,
    freqs) each, as :func:`upload_decode_lanes` takes them; either None)
    uploaded to ``device`` in one copy and decoded there: one kernel launch
    for both on a CUDA device, the plain version of each on the CPU ->
    ((B_r, L * T_r) int32 or None, (B_c, H * T_c) int32 or None) numpy
    symbols, downloaded in one copy."""
    host = _decode_staged(residual, contour, mode, device).download()
    return host.get("r_out"), host.get("c_out")
