"""The rANS decode in the port (``rpcc_tpu_torch/ops/rans.py``'s decoders,
``ops/rans_device.py``'s decode wrapper and the CUDA path of
``codec/rans_codec.py``, run on a faked card) against ``rpcc_tpu``'s on the
CPU, and the CUDA decode kernel (``csrc/rans_decode.cu``) against the plain
version on the card.

Tolerances and why: none.  Decoding is integer arithmetic, so the plain
decoders equal ``rpcc_tpu.ops.rans``'s element for element (also on
corrupt inputs, where both clamp the word index), the codec's device path
gives the native backend's and ``rpcc_tpu``'s bytes, and the kernel equals
the plain version on every symbol.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.codec import rans_codec as ref_codec
from rpcc_tpu.ops import rans as ref_rans
from rpcc_tpu_torch.codec import rans_codec, rans_native
from rpcc_tpu_torch.ops import rans, rans_device
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

MODES = {"zigzag": rans_device.MODE_ZIGZAG, "wavefront": rans_device.MODE_WAVEFRONT, "order0": rans_device.MODE_ORDER0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_rans_decode.py")
    return torch.device("cuda:0")


def _fake_card(monkeypatch):
    """A faked card: ``torch.cuda.is_available()`` says yes, and the
    codec's decode wrapper checks that it was handed a CUDA device and runs
    the plain version on the CPU through the same staging buffers.  -> the
    list of calls made: (mode, device, residual frames or None, contour
    frames or None)."""
    calls = []
    fields = rans_device.decode_fields_host

    def decode_fields_host(residual, contour, mode, device):
        assert torch.device(device).type == "cuda"
        calls.append((mode, str(device), None if residual is None else residual[0].shape[0],
                      None if contour is None else contour[0].shape[0]))
        return fields(residual, contour, mode, "cpu")

    monkeypatch.setattr(rans_device, "decode_fields_host", decode_fields_host)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return calls


# ------------------------------------------------------------------ inputs
def _symbols(kind: str, B: int, L: int, T: int, seed: int) -> np.ndarray:
    """(B, L, T) int32 symbols: residual-like zigzag symbols, a skewed
    stream (one symbol almost everywhere), uniform over the alphabet, or
    contour bits."""
    rng = np.random.default_rng(seed)
    if kind == "bits":
        return (rng.random((B, L, T)) < 0.15).astype(np.int32)
    if kind == "skewed":
        return np.where(rng.random((B, L, T)) < 0.995, 3, rng.integers(0, 512, (B, L, T))).astype(np.int32)
    if kind == "uniform":
        return rng.integers(0, 512, (B, L, T)).astype(np.int32)
    return np.minimum(rng.geometric(0.35, (B, L, T)) - 1, 511).astype(np.int32)


def _contexts(sym3d: np.ndarray, mode: int) -> np.ndarray:
    """The context of each symbol from the lane's previous symbol (and, for
    the wavefront, the previous symbol of the lane above); 0 at t == 0."""
    if mode == rans_device.MODE_ZIGZAG:
        return rans_codec._zigzag_ctx_np(sym3d)
    ctx = np.zeros_like(sym3d)
    if mode == rans_device.MODE_WAVEFRONT:
        above = np.zeros_like(sym3d)
        above[:, 1:, 1:] = sym3d[:, :-1, :-1]
        ctx[:, :, 1:] = 2 * above[:, :, 1:] + sym3d[:, :, :-1]
    return ctx


def _native_code(sym3d: np.ndarray, mode: int, ns=None):
    """(words (B, L, T) u16, counts, states u32, freqs (B, C, A)) of the
    port's native encoder under ``mode``'s contexts, live-aware with ns."""
    A = 2 if mode == rans_device.MODE_WAVEFRONT else 512
    C = 1 if mode == rans_device.MODE_ORDER0 else 4
    return rans_native.encode_ctx_batch(sym3d, _contexts(sym3d, mode), A, C,
                                        ns=None if ns is None else np.asarray(ns, np.int64))


def _lives(ns, L: int, T: int) -> np.ndarray:
    return np.stack([np.clip(n - np.arange(L) * T, 0, T) for n in ns]).astype(np.int32)


def _garbage(B: int, L: int, T: int, C: int, A: int, seed: int):
    """Arbitrary lanes: random words, states, counts up to 2T (the index
    clamps on both sides), u16 tables that do not sum to M, lives in [-1, T + 2]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, (B, L, T)).astype(np.uint16), rng.integers(0, 2 * T, (B, L)).astype(np.int32),
            rng.integers(0, 1 << 32, (B, L)).astype(np.uint32), rng.integers(0, 1 << 16, (B, C, A)).astype(np.int32),
            rng.integers(-1, T + 3, (B, L)).astype(np.int32))


def _torch_code(words, counts, states):
    return rans.RansCode(torch.from_numpy(np.asarray(words).astype(np.int64)), torch.from_numpy(np.asarray(counts)),
                         torch.from_numpy(np.asarray(states).astype(np.int64)))


def _ref_code(words, counts, states):
    return ref_rans.RansCode(jnp.asarray(words), jnp.asarray(counts), jnp.asarray(states))


# ------------------------------------------------------------------ the spec
@pytest.mark.parametrize("kind", ["normalized", "short", "long", "zeros", "one_symbol"])
def test_slot_to_symbol_equals_reference(kind):
    rng = np.random.default_rng(3)
    f = {
        "normalized": rans_native.normalize_freqs(rng.integers(0, 50, 512)[None])[0],
        "short": np.r_[rng.integers(0, 20, 511), 0],  # sums to < M: padded with the last id
        "long": rng.integers(0, 200, 512),  # sums to > M: cut at M
        "zeros": np.zeros(512, np.int64),
        "one_symbol": np.eye(512, dtype=np.int64)[7] * rans.M,
    }[kind].astype(np.int32)
    want = np.asarray(ref_rans.slot_to_symbol(jnp.asarray(f)))
    assert np.array_equal(rans.slot_to_symbol(torch.from_numpy(f)).numpy(), want)
    assert np.array_equal(rans.slot_to_symbol(torch.from_numpy(np.stack([f, f])))[1].numpy(), want)


def _mixed_T_batch(mode: int, seed: int):
    """Three frames coded at their own T (64, 32, 48), live-aware, laid out
    at T_max = 64 as the codec lays out a mixed-T batch."""
    L, Ts, ns = 8, (64, 32, 48), (8 * 64 - 5, 0, 8 * 48 // 3)
    kind = "bits" if mode == rans_device.MODE_WAVEFRONT else "residual"
    words = np.zeros((3, L, 64), np.uint16)
    counts, states, freqs, lives = [], [], [], []
    for b, (T, n) in enumerate(zip(Ts, ns)):
        sym = _symbols(kind, 1, L, T, seed + b)
        w, c, s, f = _native_code(sym, mode, [n])
        words[b, :, :T] = w[0]
        counts.append(c[0]), states.append(s[0]), freqs.append(f[0]), lives.append(_lives([n], L, T)[0])
    return words, np.stack(counts), np.stack(states), np.stack(freqs), np.stack(lives), 64


@pytest.mark.parametrize("case", ["zigzag_reference_encoder", "zigzag_native_mixed_T", "wavefront_reference_encoder",
                                  "wavefront_native_mixed_T", "order0_native_mixed_T", "zigzag_garbage",
                                  "wavefront_garbage", "order0_garbage"])
def test_batch_decoders_equal_reference(case):
    """decode_streams_batch_ctx (and, order-0, decode_streams_batch) equal
    rpcc_tpu.ops.rans's element for element, with lives and mixed T."""
    mode = MODES[case.split("_")[0]]
    ctx_fns = {rans_device.MODE_ZIGZAG: (rans.zigzag_magnitude_context, ref_rans.zigzag_magnitude_context),
               rans_device.MODE_WAVEFRONT: (rans.wavefront_bit_context, ref_rans.wavefront_bit_context),
               rans_device.MODE_ORDER0: (rans.zero_context, lambda p: jnp.zeros_like(p))}
    fn, ref_fn = ctx_fns[mode]
    if case.endswith("reference_encoder"):
        B, L, T = 3, 16, 96
        # The contour is coded whole (its wavefront contexts read the lane above).
        ns = np.array([L * T] * B if mode == rans_device.MODE_WAVEFRONT else [L * T, L * T // 3 + 1, 1], np.int32)
        sym = _symbols("bits" if mode == rans_device.MODE_WAVEFRONT else "residual", B, L, T, 1)
        # Zero past n, as the codec pads: the wavefront's contexts then read 0
        # above a dead lane on both sides.
        sym = np.where(np.arange(L * T) < ns[:, None], sym.reshape(B, -1), 0).reshape(B, L, T).astype(np.int32)
        if mode == rans_device.MODE_WAVEFRONT:
            code, f = ref_rans.encode_streams_batch_ctx_explicit(jnp.asarray(sym), jnp.asarray(_contexts(sym, mode)), 2, 4)
        else:
            code, f = ref_rans.encode_streams_batch_ctx(jnp.asarray(sym), 512, ns=jnp.asarray(ns))
        words, counts, states, freqs = (np.asarray(a) for a in (*code, f))
        lives = _lives(ns, L, T)
        want_sym = sym.reshape(B, -1)
    elif case.endswith("mixed_T"):
        words, counts, states, freqs, lives, T = _mixed_T_batch(mode, 5)
        want_sym = None
    else:
        C, A = (1, 512) if mode == rans_device.MODE_ORDER0 else (4, 2 if mode == rans_device.MODE_WAVEFRONT else 512)
        T = 80
        words, counts, states, freqs, lives = _garbage(2, 12, T, C, A, 9)
        want_sym = None
    want = np.asarray(ref_rans.decode_streams_batch_ctx(_ref_code(words, counts, states), jnp.asarray(freqs), T,
                                                        ctx_fn=ref_fn, lives=jnp.asarray(lives)))
    got = rans.decode_streams_batch_ctx(_torch_code(words, counts, states), torch.from_numpy(freqs), T, ctx_fn=fn,
                                        lives=torch.from_numpy(lives)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if want_sym is not None:
        assert np.array_equal(got, want_sym)
    if mode == rans_device.MODE_ORDER0:
        ref0 = np.asarray(ref_rans.decode_streams_batch(_ref_code(words, counts, states), jnp.asarray(freqs[:, 0]), T))
        got0 = rans.decode_streams_batch(_torch_code(words, counts, states), torch.from_numpy(freqs[:, 0]), T).numpy()
        assert np.array_equal(got0, ref0)


@pytest.mark.parametrize("kind", ["reference_encoder", "garbage"])
def test_single_frame_decoders_equal_reference(kind):
    """rans_decode, decode_stream and rans_decode_ctx (live-aware) of one
    frame equal the reference's."""
    T = 64
    if kind == "reference_encoder":
        code, f = ref_rans.encode_streams_batch(jnp.asarray(_symbols("residual", 1, 8, T, 2)), 512)
        words, counts, states, freqs = (np.asarray(a)[0] for a in (*code, f))
    else:
        words, counts, states, freqs, _ = (a[0] for a in _garbage(1, 8, T, 1, 512, 4))
        freqs = freqs[0]
    tcode, rcode = _torch_code(words, counts, states), _ref_code(words, counts, states)
    tf, rf = torch.from_numpy(freqs), jnp.asarray(freqs)
    want = np.asarray(ref_rans.rans_decode(rcode, rf, ref_rans.cumulative(rf), ref_rans.slot_to_symbol(rf), T))
    assert np.array_equal(rans.rans_decode(tcode, tf, rans.cumulative(tf), rans.slot_to_symbol(tf), T).numpy(), want)
    assert np.array_equal(rans.decode_stream(tcode, tf, T).numpy(), np.asarray(ref_rans.decode_stream(rcode, rf, T)))
    f4 = np.stack([np.roll(freqs, k) for k in range(4)])
    live = np.array([T, 10, 0, 1, T, T - 1, 5, T], np.int32)
    t4, r4 = torch.from_numpy(f4), jnp.asarray(f4)
    want = np.asarray(ref_rans.rans_decode_ctx(
        rcode, r4, jnp.stack([ref_rans.cumulative(r) for r in r4]), jnp.stack([ref_rans.slot_to_symbol(r) for r in r4]),
        ref_rans.zigzag_magnitude_context, T, jnp.asarray(live)))
    got = rans.rans_decode_ctx(tcode, t4, rans.cumulative(t4), rans.slot_to_symbol(t4), rans.zigzag_magnitude_context,
                               T, torch.from_numpy(live)).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ the wrapper on the CPU
def _decode_group(lanes, mode: int, device) -> np.ndarray:
    """One field group's lanes (words, counts, states, lives, freqs) decoded
    with ``mode``'s contexts by ``decode_fields_host`` on ``device``."""
    if mode == rans_device.MODE_WAVEFRONT:
        return rans_device.decode_fields_host(None, lanes, rans_device.MODE_ZIGZAG, device)[1]
    return rans_device.decode_fields_host(lanes, None, mode, device)[0]


def _cuda_group(tensors, mode: int):
    """One field group's CUDA tensors through ``decode_fields_cuda``."""
    if mode == rans_device.MODE_WAVEFRONT:
        return rans_device.decode_fields_cuda(None, tensors)[1]
    return rans_device.decode_fields_cuda(tensors, None, mode)[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_streams_device_on_the_cpu_is_the_plain_version(mode):
    words, counts, states, freqs, lives, T = _mixed_T_batch(MODES[mode], 11)
    got = _decode_group((words, counts, states, lives, freqs), MODES[mode], "cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.int32 and got.shape == (3, 8 * T)
    ctx_fn = {"zigzag": rans.zigzag_magnitude_context, "wavefront": rans.wavefront_bit_context,
              "order0": rans.zero_context}[mode]
    want = rans.decode_streams_batch_ctx(_torch_code(words, counts, states), torch.from_numpy(freqs), T,
                                         ctx_fn=ctx_fn, lives=torch.from_numpy(lives))
    assert np.array_equal(got, want.numpy())
    native = rans_native.decode_ctx_batch(words, counts, states, freqs, T, MODES[mode], lives=lives)
    assert np.array_equal(got, native)


def test_decode_wrapper_checks_inputs():
    words, counts, states, freqs, lives, T = _mixed_T_batch(rans_device.MODE_ZIGZAG, 12)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (words.view(np.int16), counts, states.astype(np.int64),
                                                              lives, freqs)]
    assert np.array_equal(rans_device.decode_streams_plain(*t, rans_device.MODE_ZIGZAG).numpy(),
                          _decode_group((words, counts, states, lives, freqs), 0, "cpu"))
    bad = [
        (t[0].to(torch.int32), *t[1:]),  # words not int16
        (t[0], t[1], t[2].to(torch.int32), *t[3:]),  # states not int64
        (t[0], t[1][:, :4], *t[2:]),  # counts of another lane count
        (t[0][:, :, 0], *t[1:]),  # words not (B, L, T)
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            rans_device.decode_streams_plain(*args, rans_device.MODE_ZIGZAG)
    with pytest.raises(ValueError):  # 4 tables for order-0
        rans_device.decode_streams_plain(*t, rans_device.MODE_ORDER0)
    with pytest.raises(ValueError):
        rans_device.decode_streams_plain(*t, 7)
    with pytest.raises(ValueError):  # the CUDA wrapper takes CUDA tensors only
        _cuda_group(t, rans_device.MODE_ZIGZAG)


@pytest.mark.parametrize("L, A, mode, fits", [
    (32, 512, rans_device.MODE_ZIGZAG, True), (33, 512, rans_device.MODE_ZIGZAG, False),
    (32, 513, rans_device.MODE_ORDER0, False), (1, 1, rans_device.MODE_ORDER0, True),
    (512, 2, rans_device.MODE_WAVEFRONT, True), (513, 2, rans_device.MODE_WAVEFRONT, False),
])
def test_decode_kernel_limits_at_the_edge(L, A, mode, fits):
    if fits:
        rans_device.check_decode_fits_kernel(L, A, mode)
    else:
        with pytest.raises(ValueError):
            rans_device.check_decode_fits_kernel(L, A, mode)


# ------------------------------------------------------------------ the codec's device path
def _contour_planes(B: int, H: int, W: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = np.cumsum(rng.random((B, H, W)) < 0.08, axis=2)
    c = np.ones((B, H, W), np.uint8)
    c[:, :, 1:] = ids[:, :, 1:] != ids[:, :, :-1]
    return c


def _device_residual_blobs():
    """'C' containers at the device's lane geometry (32 lanes, resid_T(HW)),
    from the plain device encoder's pieces."""
    hw, rng = 16 * 200, np.random.default_rng(21)
    q = np.round(rng.normal(0, 3, (3, hw))).astype(np.int32)
    q[2, 50:60] = [900, -700, 5000, 0, 2, 9000, -9000, 3, 1, 0]
    n = np.array([hw, hw // 3, hw], np.int32)
    q[1, n[1]:] = 0
    L, T = rans_device.RESID_LANES, rans_device.resid_T(hw)
    res = rans_device.encode_streams_plain(torch.from_numpy(q), torch.from_numpy(n), L, T)
    res = res._make(p.numpy() for p in res)
    blobs = [rans_codec.ctx_container(res, b, L, T, int(n[b]), np.int16) for b in range(3)]
    return blobs, [q[b, :n[b]].astype(np.int16).tobytes() for b in range(3)]


def _device_contour_blobs(H: int, W: int):
    c = _contour_planes(2, H, W, 22)
    words, nw, counts, states, freqs = [p.numpy() for p in rans_device.encode_contour_field_plain(torch.from_numpy(c).to(torch.int32))]
    T = rans_device.contour_T(H, W)
    blobs = [rans_codec.build_bits_container(T, H, W, freqs[b], states[b], counts[b].astype(np.uint16),
                                             words[b, :nw[b]].view(np.uint16)) for b in range(2)]
    return blobs, [np.packbits(c[b]).tobytes() for b in range(2)]


def _host_residual_blobs():
    """Host-coded containers of mixed sizes: lane counts 32 and 16, T from
    each frame, 'Z' beside 'C', i16 and u16 streams."""
    rng = np.random.default_rng(23)
    arrays = [np.cumsum(rng.integers(-3, 4, n)).astype(np.int16) for n in (40000, 33000, 1500, 36000)]
    arrays.append(np.abs(np.cumsum(rng.integers(-2, 3, 34000))).astype(np.uint16))
    blobs = [rans_codec.compress_delta_batch([a])[0] for a in arrays]
    assert sorted({b[0] for b in blobs}) == [rans_codec.MAGIC_CTX, rans_codec.MAGIC_BZD]
    return blobs, [a.tobytes() for a in arrays]


def _host_contour_blobs(H: int, W: int):
    c = _contour_planes(3, H, W, 24)
    packed = [np.packbits(x.reshape(-1)) for x in c]
    blobs = [rans_codec.build_bits_container(*_bits_pieces(p, H, W)) for p in packed]
    return blobs, [p.tobytes() for p in packed]


def _bits_pieces(packed, H: int, W: int):
    T = -(-(W + H - 1) // rans_codec.T_BUCKET) * rans_codec.T_BUCKET
    words, n_words, counts, states, freqs = rans_native.contour_encode_frames(packed[None], H, W, T)
    return T, H, W, freqs[0], states[0], counts[0].astype(np.uint16), words[0, :n_words[0]]


@pytest.mark.parametrize("kind", ["host_residual", "device_residual", "host_contour", "device_contour",
                                  "contour_32E_32x2250"])
def test_codec_device_path_equals_native_and_reference(monkeypatch, kind):
    """decompress_*_batch(..., device="cuda") on a faked card (the plain
    version) gives the host's and rpcc_tpu's bytes."""
    blobs, want = {
        "host_residual": _host_residual_blobs,
        "device_residual": _device_residual_blobs,
        "host_contour": lambda: _host_contour_blobs(16, 300),
        "device_contour": lambda: _device_contour_blobs(16, 300),
        "contour_32E_32x2250": lambda: _host_contour_blobs(32, 2250),
    }[kind]()
    if "residual" in kind:
        ours, ref = rans_codec.decompress_delta_batch, ref_codec.decompress_delta_batch
    else:
        ours, ref = rans_codec.decompress_contour_batch, ref_codec.decompress_contour_batch
    want_host = ours(blobs)
    _fake_card(monkeypatch)
    got = ours(blobs, device="cuda")
    assert got == want_host == ref(blobs) == want


def _order0_blob(arr: np.ndarray) -> bytes:
    """A 'D' container in the reference's layout (header <BBHIi, escapes, one
    table, states, counts, words, dtype) from rpcc_tpu's order-0 encoder."""
    sym, escapes, q0, n = ref_codec._symbolize(arr)
    L = ref_codec._lanes_for(max(n, 1))
    T = -(-max(1, -(-n // L)) // ref_codec.T_BUCKET) * ref_codec.T_BUCKET
    sym3d = np.zeros((1, L, T), np.int32)
    sym3d.reshape(-1)[:n] = sym
    code, freqs = ref_rans.encode_streams_batch(jnp.asarray(sym3d), ref_codec.ALPHABET)
    words, counts, states = (np.asarray(a)[0] for a in code)
    lane_words = np.concatenate([words[lane, :counts[lane]] for lane in range(L)]).astype("<u2")
    return b"".join([
        struct.pack("<BBHIi", ref_codec.MAGIC_DELTA, L.bit_length() - 1, T, n, q0),
        struct.pack("<I", escapes.shape[0]), escapes.astype("<u4").tobytes(),
        ref_codec._pack_table(np.asarray(freqs)[0].astype(np.int64)),
        states.astype("<u4").tobytes(), counts.astype("<u2").tobytes(), lane_words.tobytes(),
        struct.pack("<B", ref_codec._dtype_code(arr.dtype)),
    ])


def test_order0_container_decodes_in_both_backends(monkeypatch):
    """The port decodes the reference's order-0 'D' container (it raised
    "unknown delta container magic" before) to rpcc_tpu's bytes, alone,
    batched with 'C' containers and through batch_decode_big_fields."""
    rng = np.random.default_rng(31)
    arrays = [np.cumsum(rng.integers(-4, 5, 3000)).astype(np.int16), np.cumsum(rng.integers(-2, 3, 700)).astype(np.uint16)]
    arrays[0][100] = 20000  # two escapes
    d_blobs = [_order0_blob(a) for a in arrays]
    assert all(b[0] == rans_codec.MAGIC_DELTA for b in d_blobs)
    c_blob = rans_codec.compress_delta_batch([np.cumsum(rng.integers(-3, 4, 40000)).astype(np.int16)])[0]
    blobs = [d_blobs[0], c_blob, d_blobs[1]]
    want = ref_codec.decompress_delta_batch(blobs)
    assert want[0] == arrays[0].tobytes() and want[2] == arrays[1].tobytes()
    assert rans_codec.decompress_delta_batch(blobs) == want
    _fake_card(monkeypatch)
    assert rans_codec.decompress_delta_batch(blobs, device="cuda") == want
    assert [rans_codec.decompress(b) for b in d_blobs] == [ref_codec.decompress(b) for b in d_blobs]
    assert [rans_codec.decompress(b, "cuda") for b in d_blobs] == [ref_codec.decompress(b) for b in d_blobs]
    c_blobs, c_want = _host_contour_blobs(8, 64)
    packed = [{"residual_quantized": r, "contour_map": c} for r, c in zip(blobs, c_blobs)]
    for device in (None, "cpu", "cuda"):
        resid, contour = rans_codec.batch_decode_big_fields(packed, device=device)
        assert resid == want and contour == c_want


def _corrupt(kind: str):
    """(decoder, blobs) of one corrupt container and the container's kind."""
    blobs, _ = _device_residual_blobs()
    blob = bytearray(blobs[2])  # 3 escapes
    if kind == "escape_list":  # one escape too many on the list
        (n_esc,) = struct.unpack_from("<I", blob, 12)
        blob[12:16] = struct.pack("<I", n_esc + 1)
        blob[16 + 4 * n_esc:16 + 4 * n_esc] = struct.pack("<I", 7)
        return rans_codec.decompress_delta_batch, [bytes(blob)]
    if kind == "lane_count":  # 2^6 lanes
        blob[1] = 6
        return rans_codec.decompress_delta_batch, [bytes(blob)]
    if kind == "short_T":  # n > lanes * T
        struct.pack_into("<H", blob, 2, 16)
        return rans_codec.decompress_delta_batch, [bytes(blob)]
    if kind == "freq_table":  # a table that no longer sums to M
        c_blobs, _ = _host_contour_blobs(8, 64)
        c = bytearray(c_blobs[0])
        struct.pack_into("<H", c, 7, struct.unpack_from("<H", c, 7)[0] + 1)
        return rans_codec.decompress_contour_batch, [bytes(c)]
    c_blobs, _ = _host_contour_blobs(8, 64)  # contour T < H + W - 1
    c = bytearray(c_blobs[0])
    struct.pack_into("<H", c, 1, 64)
    return rans_codec.decompress_contour_batch, [bytes(c)]


@pytest.mark.parametrize("kind", ["escape_list", "lane_count", "short_T", "contour_short_T", "freq_table"])
def test_corrupt_containers_raise_on_both_backends(monkeypatch, kind):
    fn, blobs = _corrupt(kind)
    _fake_card(monkeypatch)
    messages = []
    for device in (None, "cuda"):
        with pytest.raises(ValueError) as info:
            fn(blobs, device=device)
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "corrupt" in messages[0]


def test_default_backend_needs_a_card(monkeypatch):
    """A CUDA device decodes on the card or raises; it never decodes on the
    host.  The CPU decodes natively, and a device of another kind raises."""
    blobs, _ = _device_residual_blobs()
    c_blobs, _ = _device_contour_blobs(8, 64)
    z = rans_codec.compress_delta_batch([np.arange(100, dtype=np.int16)])[0]  # encoded on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rans_codec.decompress_delta_batch(blobs, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        rans_codec.decompress_contour_batch(c_blobs, device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        rans_codec.decompress(blobs[0], torch.device("cuda"))
    # The CPU decodes natively, and a batch with no rANS container needs no card.
    assert rans_codec.decompress_delta_batch(blobs[:1], device="cpu") == ref_codec.decompress_delta_batch(blobs[:1])
    assert z[0] == rans_codec.MAGIC_BZD
    assert rans_codec.decompress_delta_batch([z], device="cuda") == [np.arange(100, dtype=np.int16).tobytes()]
    # A device the coder does not run on.
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        rans_codec.decompress_delta_batch(blobs, device="meta")


def test_default_backend_makes_one_call_per_field_group(monkeypatch):
    """On a CUDA device batch_decode_big_fields decodes the batch's contours
    and its largest residual group (here the 'C' containers of one lane
    count) in one call of decode_fields_host, and every other group (the
    'D' ones) in one call of its own; here the calls run the plain version
    on the CPU, and the bytes are the host's."""
    h_blobs, h_want = _host_residual_blobs()
    d_blob = _order0_blob(np.arange(500, dtype=np.int16) % 7)
    blobs = h_blobs + [d_blob]
    c_blobs, c_want = _host_contour_blobs(8, 64)
    c_blobs = c_blobs + c_blobs[:2] + c_blobs[:1]
    packed = [{"residual_quantized": r, "contour_map": c} for r, c in zip(blobs, c_blobs)]
    want = rans_codec.batch_decode_big_fields(packed)
    calls = _fake_card(monkeypatch)
    assert rans_codec.batch_decode_big_fields(packed, "cuda") == want
    assert want[0][:5] == h_want and want[1][:3] == c_want
    c_groups = {}
    for b in h_blobs:
        if b[0] == rans_codec.MAGIC_CTX:
            c_groups[b[1]] = c_groups.get(b[1], 0) + 1
    assert len(c_groups) == 1  # one lane count: the largest group, paired with the contours
    assert calls == [(rans_device.MODE_ZIGZAG, "cuda", max(c_groups.values()), len(c_blobs)),
                     (rans_device.MODE_ORDER0, "cuda", 1, None)]


def _fields_lanes(kind: str, B: int, seed: int, mode: int, H: int = 64, T: int = 160):
    """Numpy lanes (words, counts, states, lives, freqs) of B natively coded
    frames: residual-like or skewed symbols at 32 lanes (``mode``'s
    contexts, live-aware), or an H-row contour."""
    if mode == rans_device.MODE_WAVEFRONT:
        sym = _symbols("bits", B, H, T, seed)
        words, counts, states, freqs = _native_code(sym, mode)
        return words, counts, states, _lives([H * T] * B, H, T), freqs
    L = 32
    ns = [L * T - 3 * b for b in range(B)]
    sym = _symbols(kind, B, L, T, seed)
    words, counts, states, freqs = _native_code(sym, mode, ns)
    return words, counts, states, _lives(ns, L, T), freqs


def _plain_of(lanes, mode):
    return rans_device.decode_streams_plain(*rans_device.upload_decode_lanes(*lanes, "cpu"), mode)


@pytest.mark.parametrize("case", ["zigzag_and_contour", "order0_and_contour", "residual_only", "contour_only"])
def test_decode_fields_device_on_the_cpu_is_the_plain_version(case):
    """decode_fields_host on the CPU: each group's plain version, B_r != B_c."""
    mode = rans_device.MODE_ORDER0 if case.startswith("order0") else rans_device.MODE_ZIGZAG
    res = None if case == "contour_only" else _fields_lanes("residual", 3, 51, mode)
    cnt = None if case == "residual_only" else _fields_lanes("bits", 2, 52, rans_device.MODE_WAVEFRONT, H=40, T=96)
    got_r, got_c = rans_device.decode_fields_host(res, cnt, mode, "cpu")
    for got, lanes, m in ((got_r, res, mode), (got_c, cnt, rans_device.MODE_WAVEFRONT)):
        if lanes is None:
            assert got is None
            continue
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        assert np.array_equal(got, _plain_of(lanes, m).numpy())
        assert np.array_equal(got, rans_native.decode_ctx_batch(*lanes[:3], lanes[4], lanes[0].shape[2], m,
                                                                lives=lanes[3]))


def test_decode_fields_wrapper_checks_inputs():
    res = [torch.from_numpy(np.ascontiguousarray(a)) for a in _fields_lanes("residual", 2, 53, rans_device.MODE_ZIGZAG)]
    res[0], res[2] = res[0].view(torch.int16), res[2].to(torch.int64)
    with pytest.raises(ValueError):  # nothing to decode
        rans_device.decode_fields_cuda(None, None)
    with pytest.raises(ValueError):  # the residual group in the wavefront mode
        rans_device.decode_fields_cuda(res, None, rans_device.MODE_WAVEFRONT)
    with pytest.raises(ValueError):  # CPU tensors
        rans_device.decode_fields_cuda(res, None)
    with pytest.raises(ValueError):
        rans_device.decode_fields_host(None, None, rans_device.MODE_ZIGZAG, "cpu")
    with pytest.raises(ValueError):
        rans_device.decode_fields_host(None, None, rans_device.MODE_ZIGZAG, "meta")


# ------------------------------------------------------------------ the card
def _card_case(case: str):
    """(words, counts, states, lives, freqs, mode) numpy inputs of one named
    kernel case."""
    if case.startswith("garbage"):
        mode = MODES[case.split("_")[1]]
        C, A = (1, 512) if mode == rans_device.MODE_ORDER0 else (4, 2 if mode == rans_device.MODE_WAVEFRONT else 512)
        L = 40 if mode == rans_device.MODE_WAVEFRONT else 32
        words, counts, states, freqs, lives = _garbage(3, L, 300, C, A, 41)
        return words, counts, states, lives, freqs, mode
    if case == "64E_residual":  # 32 lanes of a 64x2000 frame's T, live-aware
        B, L, T, kind, ns = 2, 32, 4000, "residual", [128000, 90001]
    elif case == "skewed":  # one symbol ~99.5% (a word every ~100 steps); frame 2 one symbol, tables of f = M
        B, L, T, kind, ns = 3, 32, 512, "skewed", [16384, 16384, 16384]
    elif case == "uniform":  # ~9 bits a symbol: a word almost every other step
        B, L, T, kind, ns = 2, 32, 512, "uniform", [16384, 7000]
    elif case == "edges":  # n = 0, n = 1, a lane count below 32, lanes with no words
        B, L, T, kind, ns = 4, 8, 64, "residual", [0, 1, 8 * 64, 3 * 64 + 5]
    elif case == "order0":
        B, L, T, kind, ns = 3, 32, 256, "uniform", [8192, 4000, 0]
    elif case.startswith("wavefront_H"):
        H = int(case.split("H")[1])
        B, L, T, kind, ns = 2, H, 2064 if H == 64 else 200, "bits", None
    mode = (rans_device.MODE_WAVEFRONT if kind == "bits" else
            rans_device.MODE_ORDER0 if case == "order0" else rans_device.MODE_ZIGZAG)
    sym = _symbols(kind, B, L, T, 43)
    if case == "skewed":
        sym[2] = 3
    words, counts, states, freqs = _native_code(sym, mode, ns)
    if case == "skewed":
        assert (freqs[2].max(-1) == rans.M).all()
    return words, counts, states, _lives(ns if ns is not None else [L * T] * B, L, T), freqs, mode


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["64E_residual", "skewed", "uniform", "edges", "order0", "wavefront_H1",
                                  "wavefront_H32", "wavefront_H33", "wavefront_H64", "wavefront_H512",
                                  "garbage_zigzag", "garbage_order0", "garbage_wavefront"])
def test_cuda_decode_kernel_equals_plain(cuda_device, case):
    words, counts, states, lives, freqs, mode = _card_case(case)
    before = timer.counters()
    got = _decode_group((words, counts, states, lives, freqs), mode, cuda_device)
    torch.cuda.synchronize(cuda_device)
    assert timer.counters_since(before).get("launch.rans_decode", 0) == 1
    want = _decode_group((words, counts, states, lives, freqs), mode, "cpu")
    assert np.array_equal(got, want)
    if not case.startswith("garbage"):
        assert np.array_equal(want, rans_native.decode_ctx_batch(words, counts, states, freqs, words.shape[2],
                                                                 mode, lives=lives))


@pytest.mark.cuda
def test_cuda_decode_wrapper_rejects_bad_input(cuda_device):
    words, counts, states, lives, freqs, mode = _card_case("edges")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in (words.view(np.int16), counts, states.astype(np.int64), lives, freqs)]
    wide = torch.zeros((1, 8, 2 * words.shape[2]), dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError):  # strided words
        _cuda_group((wide[:, :, ::2].expand(t[0].shape[0], -1, -1), *t[1:]), mode)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=cuda_device)  # noqa: E731
    with pytest.raises(ValueError):  # 33 residual lanes
        _cuda_group((z((1, 33, 16), torch.int16), z((1, 33), torch.int32), z((1, 33), torch.int64),
                     z((1, 33), torch.int32), z((1, 4, 512), torch.int32)), rans_device.MODE_ZIGZAG)
    with pytest.raises(ValueError):  # 513 contour rows
        _cuda_group((z((1, 513, 16), torch.int16), z((1, 513), torch.int32),
                     z((1, 513), torch.int64), z((1, 513), torch.int32), z((1, 4, 2), torch.int32)),
                    rans_device.MODE_WAVEFRONT)
    with pytest.raises(ValueError):  # a tensor on the CPU
        _cuda_group((t[0], t[1].cpu(), *t[2:]), mode)


@pytest.mark.cuda
def test_cuda_default_backend_decodes_the_containers(cuda_device):
    """On the card: one kernel launch per field group, the host's bytes."""
    h_blobs, h_want = _host_residual_blobs()
    d_blobs, d_want = _device_residual_blobs()
    c_blobs, c_want = _host_contour_blobs(32, 2250)
    before = timer.counters()
    blobs = h_blobs + d_blobs + [_order0_blob(np.arange(900, dtype=np.int16) % 5)]
    assert rans_codec.decompress_delta_batch(blobs, cuda_device)[:8] == h_want + d_want
    assert rans_codec.decompress_contour_batch(c_blobs, cuda_device) == c_want
    lanes = {b[1] for b in h_blobs + d_blobs if b[0] == rans_codec.MAGIC_CTX}
    assert timer.counters_since(before).get("launch.rans_decode", 0) == len(lanes) + 2


def _counted_lanes(mode: int, B: int, L: int, T: int, counts, seed: int):
    """Lanes of random words and u32 states with the given word counts per
    lane (cycled over the lanes), normalized tables and full lives: the
    ring's edges at chosen cursors, with the plain version as the oracle."""
    rng = np.random.default_rng(seed)
    C, A = (4, 2) if mode == rans_device.MODE_WAVEFRONT else ((1, 512) if mode == rans_device.MODE_ORDER0 else (4, 512))
    freqs = rans_native.normalize_freqs(rng.integers(0, 40, (B * C, A)) + (rng.random((B * C, A)) < 0.5))
    counts = np.resize(np.asarray(counts, np.int32), (B, L))
    return (rng.integers(0, 1 << 16, (B, L, T)).astype(np.uint16), counts,
            rng.integers(1 << 16, 1 << 32, (B, L)).astype(np.uint32), np.full((B, L), T, np.int32),
            np.asarray(freqs, np.int32).reshape(B, C, A))


# Word counts one before, at and after the residual's 64-step rounds and
# 256-word ring, and the contour's 32-step rounds and 128-word ring.
RES_COUNTS = (0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257, 299, 300, 301, 7)
CNT_COUNTS = (0, 1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 300)


def _fields_case(case: str):
    """(residual lanes or None, contour lanes or None, mode, natively coded) of one named card case."""
    Z, W, O = rans_device.MODE_ZIGZAG, rans_device.MODE_WAVEFRONT, rans_device.MODE_ORDER0
    if case.startswith("counts_T"):
        T = int(case[len("counts_T"):])
        return _counted_lanes(Z, 3, 32, T, RES_COUNTS, 61), _counted_lanes(W, 2, 40, T, CNT_COUNTS, 62), Z, False
    if case == "zero_words":  # frame 0 one symbol (f = M, no word), frame 1 five live lanes
        sym = _symbols("residual", 2, 32, 128, 63)
        sym[0] = 3
        ns = [32 * 128, 5 * 128]
        words, counts, states, freqs = _native_code(sym, Z, ns)
        assert (counts[0] == 0).all() and (counts[1, 5:] == 0).all()
        res = (words, counts, states, _lives(ns, 32, 128), freqs)
        return res, _fields_lanes("bits", 3, 64, W, H=33, T=128), Z, True
    res_kind, _, cnt = case.partition("_contour")
    H, B_c = (int(v) for v in cnt.split("x")) if cnt else (0, 0)
    mode = O if res_kind == "order0" else Z
    res = None
    if res_kind != "none":
        kind = {"zigzag": "residual", "order0": "uniform"}.get(res_kind, res_kind)
        res = _fields_lanes(kind, 3, 65, mode, T=512 if kind in ("skewed", "uniform") else 160)
    cnt_lanes = _fields_lanes("bits", B_c, 66, W, H=H, T=2064 if H == 64 else 200) if H else None
    return res, cnt_lanes, mode, True


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zigzag_contour64x2", "order0_contour33x1", "skewed_contour1x2", "uniform_contour512x1",
                                  "zigzag", "none_contour64x3", "zero_words", "counts_T300", "counts_T320"])
def test_cuda_fields_launch_equals_plain(cuda_device, case):
    """One launch of both field groups (B_r != B_c where both are given)
    equals each group's plain version and, on coded inputs, the native
    decoder; a residual lane's word counts around the ring's rounds; lanes
    with no word; the skewed and uniform tables; contours of H 1, 33, 64
    and 512."""
    res, cnt, mode, coded = _fields_case(case)
    before = timer.counters()
    host = rans_device.decode_fields_host(res, cnt, mode, cuda_device)
    assert timer.counters_since(before).get("launch.rans_decode", 0) == 1
    for g, lanes, m in ((host[0], res, mode), (host[1], cnt, rans_device.MODE_WAVEFRONT)):
        if lanes is None:
            assert g is None
            continue
        want = _plain_of(lanes, m).numpy()
        assert g.dtype == np.int32 and np.array_equal(g, want)
        if coded:
            assert np.array_equal(want, rans_native.decode_ctx_batch(*lanes[:3], lanes[4], lanes[0].shape[2], m,
                                                                     lives=lanes[3]))


@pytest.mark.cuda
def test_cuda_decode_stamps_in_phase_order(cuda_device):
    """The phase stamps of both blocks are set and come in phase order."""
    res, cnt, mode, _ = _fields_case("zigzag_contour64x2")
    args = [rans_device.upload_decode_lanes(*g, cuda_device) for g in (res, cnt)]
    k = len(rans_device.DECODE_PHASES) + 1
    stamps = torch.zeros(len(rans_device.DECODE_STAMP_BLOCKS) * k, dtype=torch.int64, device=cuda_device)
    rans_device.decode_fields_cuda(*args, mode, phase_stamps=stamps)
    torch.cuda.synchronize(cuda_device)
    for block in stamps.cpu().reshape(-1, k).tolist():
        assert block[0] > 0 and all(a <= b for a, b in zip(block, block[1:])), block
    with pytest.raises(ValueError):  # stamps of the wrong size
        rans_device.decode_fields_cuda(*args, mode, phase_stamps=stamps[:-1])
