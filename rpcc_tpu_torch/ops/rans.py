"""The spec of the interleaved-lane rANS coder (port of
``rpcc_tpu/ops/rans.py``): the encoders, their tables and contexts, and
the decoders.

Scheme: one model per context and frame; 32-bit state, 16-bit
renormalized output, ``PROB_BITS = 14``.  Encoding walks each lane's
symbols in reverse so decoding streams forward; at most one word is
emitted per symbol, and a lane reads its words from the back.  :func:`normalize_freqs` is bit-exact to the
reference's (f32 ``floor(count * (M / total))``, present symbols bumped to
1, the correction on the first argmax, and the repair pass for a top
symbol that cannot absorb a negative correction), as is the port's C++
twin ``csrc/host/rans.cpp::normalize_freqs_row`` and the CUDA kernel's
warp version in ``csrc/rans.cu``.

The encoders (:func:`rans_encode`, :func:`rans_encode_ctx` and their
batch forms) walk each lane in reverse, each step the reference's
``lax.scan`` step on u32 states held in int64; a lane's words come out
front-packed (the rest of its row 0), its count and final state beside
them.  The histograms are a ``bincount`` of the live joint (context,
symbol) keys, which is what the reference's sort + searchsorted
(``_hist_sorted``, a TPU workaround) computes.  The words are int32 tensors
holding u16 values, the states int64 ones holding u32 values.  The walk,
:func:`encode_walk`, and its tables, :func:`joint_tables`, are also
those of the plain versions of ``csrc/rans.cu`` in
:mod:`rpcc_tpu_torch.ops.rans_device`, which pack the same words
lane-major.

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
NUM_CTX = 4  # contexts of the zigzag-magnitude model


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


def bit_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """Binary context = the previous bit (a column-major contour lane's
    previous symbol is the bit above)."""
    return prev_sym


def zero_context(prev_sym: torch.Tensor) -> torch.Tensor:
    """The order-0 model's context: always 0."""
    return torch.zeros_like(prev_sym)


# ------------------------------------------------------------------ encode
class RansCode(NamedTuple):
    words: torch.Tensor  # (..., L, T) u16 words (any integer dtype; read as u16), front-packed per lane
    counts: torch.Tensor  # (..., L) words per lane
    states: torch.Tensor  # (..., L) final u32 states (int64 or int32 bits)


def encode_walk(key: torch.Tensor, freqs: torch.Tensor, cums: torch.Tensor, live: torch.Tensor):
    """The encode loop over (B, L) lanes, each lane's T steps in reverse:
    ``key`` (B, L, T) int64 index of each step's (context, symbol) into the
    flattened (B, C, A) ``freqs`` / ``cums``, ``live`` (B, L) live steps
    per lane (the steps at or past it are neither coded nor emit).  ->
    (words (B, L, T) int64, the state's low 16 bits before each step in
    walk order (step T - 1 first); emit (B, L, T) bool, whether that step
    emitted its word; states (B, L) int64 final u32 states)."""
    B, L, T = key.shape
    dev = key.device
    f_all = freqs.reshape(B, -1).to(torch.int64).gather(1, key.reshape(B, -1)).reshape(B, L, T)
    c_all = cums.reshape(B, -1).to(torch.int64).gather(1, key.reshape(B, -1)).reshape(B, L, T)
    live = live.to(torch.int64)
    x = torch.full((B, L), RANS_L, dtype=torch.int64, device=dev)
    words = torch.empty((B, L, T), dtype=torch.int64, device=dev)
    emit = torch.empty((B, L, T), dtype=torch.bool, device=dev)
    for i, t in enumerate(range(T - 1, -1, -1)):
        active = t < live
        f = torch.where(active, f_all[:, :, t], 1)
        e = active & ((x >> 18) >= f)  # x >= f * 2^18, the renormalization test
        words[:, :, i] = x & 0xFFFF
        emit[:, :, i] = e
        x = torch.where(e, x >> IO_BITS, x)
        x = torch.where(active, (x // f) * M + c_all[:, :, t] + x % f, x)
    return words, emit, x


def _encode_lanes(key: torch.Tensor, freqs: torch.Tensor, cums: torch.Tensor, lives: torch.Tensor) -> RansCode:
    """:func:`encode_walk`'s inputs -> RansCode with (B, L, T) int32
    front-packed words, (B, L) int32 counts and int64 states."""
    T = key.shape[-1]
    words, emit, states = encode_walk(key, freqs, cums, lives)
    pos = torch.where(emit, torch.cumsum(emit, -1) - 1, T)  # emitted words to the front, the rest dropped
    packed = torch.zeros(words.shape[:2] + (T + 1,), dtype=torch.int64, device=words.device).scatter_(2, pos, words)
    return RansCode(packed[:, :, :T].to(torch.int32), emit.sum(-1, dtype=torch.int32), states)


def joint_counts(key: torch.Tensor, K: int, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) integer keys -> (B, K) int32 counts of the keys in [0, K) at
    the positions where ``live`` (B, N) holds (all when None)."""
    B = key.shape[0]
    keep = (key >= 0) & (key < K)
    if live is not None:
        keep &= live
    key = torch.where(keep, key.to(torch.int64), K) + torch.arange(B, device=key.device)[:, None] * (K + 1)
    return torch.bincount(key.reshape(-1), minlength=B * (K + 1)).reshape(B, K + 1)[:, :K].to(torch.int32)


def lane_live(n, L: int, T: int) -> torch.Tensor:
    """Live symbols per lane of a flat stream of length ``n`` laid out
    (L, T) row-major: lane l codes only flat positions < n.  ``n`` an int
    or a (...,) tensor -> (..., L) int64."""
    n = torch.as_tensor(n, dtype=torch.int64)
    return (n[..., None] - torch.arange(L, device=n.device) * T).clamp(0, T)


def joint_tables(sym3d: torch.Tensor, ctx3d: torch.Tensor, alphabet: int, num_ctx: int, ns: torch.Tensor):
    """What every batch encoder walks with, its own and the device
    encoders' plain versions: (B, L, T) symbols under (B, L, T) contexts,
    the first ``ns`` (B,) flat positions of each frame live -> (key (B, L,
    T) int64 joint (context, symbol) index, 0 past ns; freqs (B, C, A)
    int32 normalized from the live keys; lives (B, L) int64 live steps per
    lane)."""
    B, L, T = sym3d.shape
    ns = torch.as_tensor(ns, device=sym3d.device).to(torch.int64).reshape(B, 1)
    key = (ctx3d.to(torch.int64) * alphabet + sym3d.to(torch.int64)).reshape(B, -1)
    live = torch.arange(L * T, device=sym3d.device) < ns
    freqs = normalize_freqs(joint_counts(key, num_ctx * alphabet, live).reshape(B, num_ctx, alphabet))
    return torch.where(live, key, 0).reshape(B, L, T), freqs, lane_live(ns[:, 0], L, T)


def _all_live(sym3d: torch.Tensor) -> torch.Tensor:
    B, L, T = sym3d.shape
    return torch.full((B,), L * T, dtype=torch.int64, device=sym3d.device)


def rans_encode_ctx(symbols: torch.Tensor, ctx: torch.Tensor, freqs: torch.Tensor, cums: torch.Tensor,
                    live: Optional[torch.Tensor] = None) -> RansCode:
    """Encode one frame's (L, T) symbols, each under the (C, A) table row of
    its context in ``ctx`` (L, T); lane positions >= ``live`` (L,) are
    skipped (None codes everything)."""
    L, T = symbols.shape
    if live is None:
        live = torch.full((L,), T, dtype=torch.int64, device=symbols.device)
    key = ctx.to(torch.int64) * freqs.shape[-1] + symbols.to(torch.int64)
    code = _encode_lanes(key[None], freqs[None], cums[None], live[None])
    return RansCode(*(t[0] for t in code))


def rans_encode(symbols: torch.Tensor, freqs: torch.Tensor, cum: torch.Tensor) -> RansCode:
    """Order-0 encode of one frame's (L, T) symbols; lane i encodes its row."""
    return rans_encode_ctx(symbols, torch.zeros_like(symbols), freqs[None], cum[None])


def pack_symbols(flat: torch.Tensor, lanes: int, pad_symbol: int):
    """Pad a flat symbol stream to lanes * T and reshape to (lanes, T) -> (symbols, T)."""
    n = flat.shape[0]
    T = max(1, -(-n // lanes))  # T >= 1 keeps the loops well-formed
    padded = torch.full((lanes * T,), pad_symbol, dtype=flat.dtype, device=flat.device)
    padded[:n] = flat
    return padded.reshape(lanes, T), T


def encode_stream(flat_symbols: torch.Tensor, alphabet: int, lanes: int = 128):
    """Order-0 encode of a flat int32 symbol stream -> (RansCode, freqs (A,));
    the histogram counts the padding (symbol 0), as the decode reads it."""
    sym2d, _ = pack_symbols(flat_symbols, lanes, pad_symbol=0)
    code, freqs = encode_streams_batch(sym2d[None], alphabet)
    return RansCode(*(t[0] for t in code)), freqs[0]


def encode_streams_batch(sym3d: torch.Tensor, alphabet: int):
    """Order-0 encode of (B, L, T) int32 symbols, a model per frame ->
    (RansCode with (B, L, T) / (B, L) leaves, freqs (B, A))."""
    code, freqs = _encode_batch(sym3d, torch.zeros_like(sym3d), alphabet, 1, _all_live(sym3d))
    return code, freqs[:, 0]


def _ctx_of(sym3d: torch.Tensor, ctx_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Per-symbol context from the previous symbol of the lane (0 at starts)."""
    ctx = ctx_fn(torch.nn.functional.pad(sym3d[:, :, :-1], (1, 0))).clone()
    ctx[:, :, 0] = 0
    return ctx


def _encode_batch(sym3d: torch.Tensor, ctx3d: torch.Tensor, alphabet: int, num_ctx: int, ns: torch.Tensor):
    key, freqs, lives = joint_tables(sym3d, ctx3d, alphabet, num_ctx, ns)
    return _encode_lanes(key, freqs, cumulative(freqs), lives), freqs


def encode_streams_batch_ctx(
    sym3d: torch.Tensor, alphabet: int, ctx_fn: Callable[[torch.Tensor], torch.Tensor] = zigzag_magnitude_context,
    num_ctx: int = NUM_CTX, ns: Optional[torch.Tensor] = None,
):
    """Context-modeled batch encode of (B, L, T) int32 symbols, the context
    of each from the lane's previous symbol -> (RansCode, freqs (B, C, A)
    int32).  With ``ns`` (B,) live stream lengths the lanes are live-aware:
    positions at or past ns are neither counted nor coded."""
    return _encode_batch(sym3d, _ctx_of(sym3d, ctx_fn), alphabet, num_ctx, _all_live(sym3d) if ns is None else ns)


def encode_streams_batch_ctx_explicit(sym3d: torch.Tensor, ctx3d: torch.Tensor, alphabet: int, num_ctx: int):
    """Batch encode of (B, L, T) symbols under caller-supplied (B, L, T)
    contexts (the decoder must reproduce them from decoded symbols), every
    position live -> (RansCode, freqs (B, C, A) int32)."""
    return _encode_batch(sym3d, ctx3d, alphabet, num_ctx, _all_live(sym3d))


# ------------------------------------------------------------------ decode
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
