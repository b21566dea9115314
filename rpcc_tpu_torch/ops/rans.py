"""The spec of the interleaved-lane rANS coder (port of
``rpcc_tpu/ops/rans.py``): the encode side's tables and contexts, and the
decoders.

Scheme: one model per context and frame; 32-bit state, 16-bit
renormalized output, ``PROB_BITS = 14``.  Encoding walks each lane's
symbols in reverse so decoding streams forward; at most one word is
emitted per symbol, and a lane reads its words from the back.  :func:`normalize_freqs` is bit-exact to the
reference's (f32 ``floor(count * (M / total))``, present symbols bumped to
1, the correction on the first argmax, and the repair pass for a top
symbol that cannot absorb a negative correction), as is the port's C++
twin ``csrc/host/rans.cpp::normalize_freqs_row`` and the CUDA kernel's
warp version in ``csrc/rans.cu``.

The decoders (:func:`rans_decode`, :func:`rans_decode_ctx` and their batch
forms) are T-step loops of tensor ops, each step the reference's
``lax.scan`` step: u32 arithmetic held in int64 and masked to 32 bits, the
word index clamped into the lane's buffer as the reference's gather clamps
it, so a corrupt container decodes to the spec's output and never reads
out of bounds.  They are the plain versions of ``csrc/rans_decode.cu``
(:mod:`rpcc_tpu_torch.ops.rans_device`), run by the tests and on the CPU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

PROB_BITS = 14
M = 1 << PROB_BITS  # total frequency
RANS_L = 1 << 16  # state lower bound
IO_BITS = 16
_U32 = 0xFFFFFFFF


def normalize_freqs(counts: torch.Tensor) -> torch.Tensor:
    """Normalize histograms along the last axis to sum exactly M -> int32.

    Every present symbol keeps freq >= 1 and the correction lands on the
    first most frequent symbol.  When the bump-to-1 of many rare symbols
    overdraws the budget so far that the top symbol cannot absorb the
    correction, the row is re-floored with 1 reserved per present symbol
    (``floor(c * (M - A_pos) / total) + 1``), whose correction is >= 0."""
    counts = counts.to(torch.int32)
    present = counts > 0
    total = counts.sum(-1, keepdim=True).clamp_min(1)
    total_f = total.to(torch.float32)
    scale = torch.tensor(float(M), dtype=torch.float32, device=counts.device) / total_f
    f = torch.floor(counts.to(torch.float32) * scale).to(torch.int32)
    f = torch.where(present & (f == 0), 1, f)
    delta = M - f.sum(-1, keepdim=True, dtype=torch.int32)
    top = torch.argmax(f, -1, keepdim=True)  # the first of equal maxima
    ok = f.gather(-1, top) + delta >= 1
    a_pos = present.sum(-1, keepdim=True, dtype=torch.int32)
    scale2 = (M - a_pos).to(torch.float32) / total_f
    f2 = torch.floor(counts.to(torch.float32) * scale2).to(torch.int32) + present.to(torch.int32)
    delta2 = M - f2.sum(-1, keepdim=True, dtype=torch.int32)
    top2 = torch.argmax(f2, -1, keepdim=True)
    f = f.scatter_add(-1, top, delta)
    f2 = f2.scatter_add(-1, top2, delta2)
    return torch.where(ok, f, f2)


def cumulative(freqs: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums along the last axis (int32)."""
    c = torch.cumsum(freqs.to(torch.int64), -1).to(torch.int32)
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def zigzag_magnitude_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """Context of a residual symbol: the bucket of the previous delta's
    magnitude, edges [1, 3, 8] (``|d| = (sym + 1) // 2``; ESCAPE maps to
    the largest bucket)."""
    mag = (prev_sym + 1) // 2
    return (mag >= 1).to(torch.int32) + (mag >= 3).to(torch.int32) + (mag >= 8).to(torch.int32)


def wavefront_bit_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """4-context binary model of the diagonal-wavefront contour layout, over
    previous symbols with the lanes on the last axis: lane r's own previous
    symbol is the LEFT neighbour and lane r-1's is the one ABOVE;
    ctx = 2 * above + left."""
    above = torch.nn.functional.pad(prev_sym[..., :-1], (1, 0))
    return 2 * above + prev_sym


def zero_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """The order-0 model's context: always 0."""
    return torch.zeros_like(prev_sym)


# ------------------------------------------------------------------ decode
class RansCode(NamedTuple):
    words: torch.Tensor  # (..., L, T) u16 words (any integer dtype; read as u16), front-packed per lane
    counts: torch.Tensor  # (..., L) words per lane
    states: torch.Tensor  # (..., L) final u32 states (int64 or int32 bits)


def slot_to_symbol(freqs: torch.Tensor) -> torch.Tensor:
    """(..., A) frequencies -> (..., M) int64 slot -> symbol table: the
    symbol ids repeated by their frequencies, as the reference's
    ``jnp.repeat(arange(A), freqs, total_repeat_length=M)`` (a table
    summing to less than M is padded with the last id, one summing to more
    is cut at M)."""
    incl = torch.cumsum(freqs.to(torch.int64), -1).contiguous()
    slots = torch.arange(M, dtype=torch.int64, device=freqs.device).expand(*freqs.shape[:-1], M).contiguous()
    return torch.searchsorted(incl, slots, right=True).clamp_(max=freqs.shape[-1] - 1)


def _decode_lanes(
    code: RansCode, freqs: torch.Tensor, cums: torch.Tensor, slot2sym: torch.Tensor,
    ctx_fn: Callable[[torch.Tensor], torch.Tensor], T: int, live: torch.Tensor,
) -> torch.Tensor:
    """The decode loop over (B, L) lanes: ``code`` leaves (B, L, Tw) and
    (B, L), tables (B, C, A) / (B, C, M), ``live`` (B, L) -> (B, L, T) int32.
    Lane positions at or past ``live`` decode to 0 and leave the lane's
    state and word cursor alone."""
    words, counts, states = code
    B, L = states.shape
    C, A = freqs.shape[-2:]
    dev = states.device
    ftab = (freqs.to(torch.int64) & _U32).reshape(B, C * A)
    ctab = (cums.to(torch.int64) & _U32).reshape(B, C * A)
    s2s = slot2sym.to(torch.int64).reshape(B, C * M)
    w = words.to(torch.int64) & 0xFFFF
    last = w.shape[-1] - 1
    x = states.to(torch.int64) & _U32
    cur = counts.to(torch.int64)
    prev = torch.zeros((B, L), dtype=torch.int64, device=dev)
    out = torch.empty((B, L, T), dtype=torch.int32, device=dev)
    for t in range(T):
        active = t < live
        c_id = prev if t == 0 else ctx_fn(prev).to(torch.int64)  # prev is 0 at t == 0
        slot = x & (M - 1)
        s = s2s.gather(1, c_id * M + slot)
        key = c_id * A + s
        x_new = (ftab.gather(1, key) * (x >> PROB_BITS) + slot - ctab.gather(1, key)) & _U32
        need = active & (x_new < RANS_L)
        cur = torch.where(need, cur - 1, cur)
        wv = w.gather(2, cur.clamp(0, last)[..., None])[..., 0]
        x_new = torch.where(need, ((x_new << IO_BITS) | wv) & _U32, x_new)
        x = torch.where(active, x_new, x)
        prev = torch.where(active, s, 0)
        out[:, :, t] = prev
    return out


def _single(code: RansCode) -> RansCode:
    return RansCode(*(t[None] for t in code))


def rans_decode(code: RansCode, freqs: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor, T: int) -> torch.Tensor:
    """Order-0 decode of one frame's (L, Tw) words -> (L, T) int32 symbols
    (forward order); every lane decodes all T steps."""
    return rans_decode_ctx(code, freqs[None], cum[None], slot2sym[None], zero_context, T)


def rans_decode_ctx(
    code: RansCode, freqs: torch.Tensor, cums: torch.Tensor, slot2sym: torch.Tensor,
    ctx_fn: Callable[[torch.Tensor], torch.Tensor], T: int, live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode one frame with (C, A) tables and contexts from the lane's
    previously decoded symbol (``ctx_fn`` maps the (..., L) previous symbols
    to contexts; lane starts use context 0) -> (L, T) int32.  Lane positions
    >= ``live`` (L,) decode to 0 without touching the state."""
    L = code.states.shape[0]
    if live is None:
        live = torch.full((L,), T, dtype=torch.int64, device=code.states.device)
    return _decode_lanes(_single(code), freqs[None], cums[None], slot2sym[None], ctx_fn, T, live[None])[0]


def decode_stream(code: RansCode, freqs: torch.Tensor, T: int) -> torch.Tensor:
    """Order-0 decode of one frame -> (L * T,) int32."""
    return rans_decode(code, freqs, cumulative(freqs), slot_to_symbol(freqs), T).reshape(-1)


def decode_streams_batch(code: RansCode, freqs: torch.Tensor, T: int) -> torch.Tensor:
    """Order-0 decode of (B, L, *) codes with (B, A) tables -> (B, L*T) int32."""
    return decode_streams_batch_ctx(code, freqs[:, None], T, zero_context)


def decode_streams_batch_ctx(
    code: RansCode, freqs: torch.Tensor, T: int,
    ctx_fn: Callable[[torch.Tensor], torch.Tensor] = zigzag_magnitude_context,
    lives: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Context-modeled decode of (B, L, *) codes with (B, C, A) tables ->
    (B, L*T) int32; ``lives`` (B, L) live symbols per lane (None: T),
    clipped to T."""
    B, L = code.states.shape
    if lives is None:
        lives = torch.full((B, L), T, dtype=torch.int64, device=code.states.device)
    sym = _decode_lanes(code, freqs, cumulative(freqs), slot_to_symbol(freqs), ctx_fn, T,
                        torch.clamp(lives.to(torch.int64), max=T))
    return sym.reshape(B, -1)
