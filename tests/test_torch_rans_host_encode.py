"""The host containers' rANS encode in the port: the encode spec
(``rpcc_tpu_torch/ops/rans.py``) against ``rpcc_tpu.ops.rans``, the
codec's encode paths (``codec/rans_codec.py``) on the host (``device``
None) and on a CUDA device against ``rpcc_tpu``'s bytes under its
``RPCC_RANS_DEVICE`` ``cpu`` and ``default`` (and each
``RPCC_RANS_ADAPTIVE``), the card path's plain version on a faked card on
the CPU, and the CUDA kernel (``csrc/rans.cu``) at the host geometry on the
card.

Tolerances: none.  Integer coding has no rounding, so the spec's words,
counts, states and tables equal the reference's element for element, and
every container equals ``rpcc_tpu``'s byte for byte.  The reference's
``default`` backend runs its JAX encoders on the default device, the CPU
here.
"""

import bz2
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpcc_tpu
from rpcc_tpu.codec import rans_codec as ref_codec
from rpcc_tpu.ops import rans as ref_rans
from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.ops import rans, rans_device
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_rans_host_encode.py")
    return torch.device("cuda:0")


def _walk(n: int, seed: int = 0, dtype=np.int16, step: int = 3) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).integers(-step, step + 1, n)).astype(dtype)


def _both(monkeypatch, device: str = "cpu", full: bool = False):
    """The reference under RPCC_RANS_DEVICE=``device`` and both codecs under
    the same RPCC_RANS_ADAPTIVE -> the port's device for the same bytes
    (None for cpu, the CUDA device for default)."""
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", device)
    for mod in (rans_codec, ref_codec):
        monkeypatch.setattr(mod, "_ADAPTIVE_FULL", full)
    return None if device == "cpu" else "cuda"


def _code_equal(ref_code, code) -> None:
    for name, a, b in zip(("words", "counts", "states"), ref_code, code):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64)), name


# ------------------------------------------------------------------ the spec
@pytest.mark.parametrize("L, T", [(1, 16), (4, 48), (32, 64)])
def test_encode_streams_batch_ctx_matches_reference(L, T):
    """Live-aware context encode at stream lengths 0, 1, a lane's end, one
    past it, and the whole grid."""
    ns = [0, 1, T, T + 1, L * T] if L > 1 else [0, 1, T]
    rng = np.random.default_rng(L)
    sym = np.minimum(np.abs(np.round(rng.normal(0, 4, (len(ns), L, T)))), 511).astype(np.int32)
    sym[:, 0, 1:4] = 511
    for b, n in enumerate(ns):
        sym[b].reshape(-1)[n:] = 0
    ref_code, ref_freqs = ref_rans.encode_streams_batch_ctx(jnp.asarray(sym), 512, ns=jnp.asarray(ns, jnp.int32))
    code, freqs = rans.encode_streams_batch_ctx(torch.from_numpy(sym), 512, ns=torch.tensor(ns))
    assert np.array_equal(np.asarray(ref_freqs), freqs.numpy())
    _code_equal(ref_code, code)
    assert np.array_equal(np.asarray(ref_rans.lane_live(T + 1, L, T)), rans.lane_live(T + 1, L, T).numpy())


def test_encode_streams_batch_ctx_explicit_matches_reference():
    """Wavefront contour contexts (lane r = row r, delayed r steps)."""
    rng = np.random.default_rng(3)
    H, W = 8, 40
    T = -(-(W + H - 1) // 16) * 16
    bits = (rng.random((2, H, W)) < 0.2).astype(np.int32)
    sym = np.zeros((2, H, T), np.int32)
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    sym[:, rows, cols + rows] = bits
    left = np.zeros_like(sym)
    left[:, :, 1:] = sym[:, :, :-1]
    above = np.zeros_like(sym)
    above[:, 1:, 1:] = sym[:, :-1, :-1]
    ctx = 2 * above + left
    ctx[:, :, 0] = 0
    ref_code, ref_freqs = ref_rans.encode_streams_batch_ctx_explicit(jnp.asarray(sym), jnp.asarray(ctx), 2, 4)
    code, freqs = rans.encode_streams_batch_ctx_explicit(torch.from_numpy(sym), torch.from_numpy(ctx), 2, 4)
    assert np.array_equal(np.asarray(ref_freqs), freqs.numpy())
    _code_equal(ref_code, code)


def test_order0_encoders_match_reference():
    rng = np.random.default_rng(4)
    sym = rng.integers(0, 20, (2, 4, 32)).astype(np.int32)
    ref_code, ref_freqs = ref_rans.encode_streams_batch(jnp.asarray(sym), 64)
    code, freqs = rans.encode_streams_batch(torch.from_numpy(sym), 64)
    assert np.array_equal(np.asarray(ref_freqs), freqs.numpy())
    _code_equal(ref_code, code)
    flat = rng.integers(0, 30, 1000).astype(np.int32)
    ref_code, ref_freqs = ref_rans.encode_stream(jnp.asarray(flat), 64, lanes=16)
    code, freqs = rans.encode_stream(torch.from_numpy(flat), 64, lanes=16)
    assert np.array_equal(np.asarray(ref_freqs), freqs.numpy())
    _code_equal(ref_code, code)
    assert np.array_equal(rans.decode_stream(code, freqs, code.words.shape[1]).numpy()[:1000], flat)
    f, c = freqs, rans.cumulative(freqs)
    two = torch.from_numpy(flat[:64].reshape(4, 16))
    _code_equal(ref_rans.rans_encode(jnp.asarray(two.numpy()), jnp.asarray(f.numpy()), jnp.asarray(c.numpy())),
                rans.rans_encode(two, f, c))
    padded, T = rans.pack_symbols(torch.from_numpy(flat[:7]), 4, 9)
    ref_padded, ref_T = ref_rans.pack_symbols(jnp.asarray(flat[:7]), 4, 9)
    assert T == ref_T and np.array_equal(np.asarray(ref_padded), padded.numpy())
    prev = torch.from_numpy(sym[0])
    assert torch.equal(rans.bit_context(prev), prev)


def test_plain_encode_walk_is_the_spec_walk():
    """The device encoders' plain version and the spec share one walk: the
    plain pieces at any lane count equal the spec's code on the same
    symbols (the words' emitted prefix, lane by lane)."""
    a = _walk(3000, 5)
    for L in (1, 2, 8, 32):
        T = rans_device.stream_T(a.size, L)
        res = rans_device.encode_streams_plain(*rans_device.upload_streams([a], "cpu"), L, T)
        sym, _, _, n = rans_codec._symbolize(a)
        sym3d = np.zeros((1, L, T), np.int32)
        sym3d.reshape(-1)[:n] = sym
        code, freqs = rans.encode_streams_batch_ctx(torch.from_numpy(sym3d), 512, ns=torch.tensor([n]))
        assert torch.equal(freqs, res.freqs) and torch.equal(code.counts, res.counts) and torch.equal(code.states, res.states)
        words = rans_codec._lane_words(code.words[0].numpy(), code.counts[0].numpy())
        assert np.array_equal(words, res.words[0, : int(res.n_words[0])].numpy().view(np.uint16))


# ------------------------------------------------------------------ the card's path on a faked card
def _fake_card(monkeypatch):
    """A faked card: ``torch.cuda.is_available()`` says yes, and the
    codec's encode wrappers (and its decode wrapper) check that they were
    handed a CUDA device and run their plain versions on the CPU through
    the same staging buffers.  -> the list of calls made."""
    calls = []
    streams, contours, fields = (rans_device.encode_streams_host, rans_device.encode_contours_host,
                                 rans_device.decode_fields_host)

    def encode_streams_host(arrays, lanes, T, device):
        assert torch.device(device).type == "cuda"
        calls.append(("residual", lanes, T))
        return streams(arrays, lanes, T, "cpu")

    def encode_contours_host(packed, H, W, device):
        assert torch.device(device).type == "cuda"
        calls.append(("contour", len(packed), H, W))
        return contours(packed, H, W, "cpu")

    def decode_fields_host(residual, contour, mode, device):
        assert torch.device(device).type == "cuda"
        calls.append(("decode", mode))
        return fields(residual, contour, mode, "cpu")

    monkeypatch.setattr(rans_device, "encode_streams_host", encode_streams_host)
    monkeypatch.setattr(rans_device, "encode_contours_host", encode_contours_host)
    monkeypatch.setattr(rans_device, "decode_fields_host", decode_fields_host)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return calls


# ------------------------------------------------------------------ faults 3.23-3.25
@pytest.mark.parametrize("device", ["cpu", "default"])
@pytest.mark.parametrize("n, magic", [(2000, "Z"), (70000, "C")])
def test_compress_delta_codes_int32(monkeypatch, device, n, magic):
    """Fault 3.23: ``compress`` delta-codes int32 as the reference does
    (the port sent it to plain bzip2), on the host and the card."""
    a = _walk(n, 23, np.int32, step=40)
    _both(monkeypatch)
    want = ref_codec.compress(a)
    dev = _both(monkeypatch, device)
    if dev is not None:
        _fake_card(monkeypatch)
        assert ref_codec.compress(a) == want
    got = rans_codec.compress(a, device=dev)
    assert got == want and chr(got[0]) == magic
    assert len(got) < len(b"B" + bz2.compress(a.tobytes()))
    _both(monkeypatch)
    assert rans_codec.decompress(got) == a.tobytes() and ref_codec.decompress(got) == a.tobytes()


@pytest.mark.parametrize("device", ["cpu", "default"])
def test_wide_int32_deltas_route_to_plain_bzip2(monkeypatch, device):
    """Fault 3.24: int32 frames whose deltas overflow int32 become lossless
    'B' containers, alone and in a mixed batch (``tests/test_rans.py``'s
    arrays), with the reference's bytes; deltas of +-(2^31 - 1) stay delta
    containers."""
    dev = _both(monkeypatch, device)
    if dev is not None:
        _fake_card(monkeypatch)
    wild = np.asarray([-(2**31), 2**31 - 1, 0, -(2**31), 5], np.int32)
    sane = np.cumsum(np.random.default_rng(0).integers(-3, 4, 40000)).astype(np.int32)
    edge = np.asarray([0, 2**31 - 1, 0, -(2**31 - 1), 0, 7], np.int32)
    for batch in ([wild], [wild, sane], [sane, wild, edge], [edge]):
        got = rans_codec.compress_delta_batch(batch, device=dev)
        assert got == ref_codec.compress_delta_batch(batch)
        assert [b[0] == rans_codec.MAGIC_BZ for b in got] == [a is wild for a in batch]
        assert rans_codec.decompress_delta_batch(got, device=dev) == [a.tobytes() for a in batch]
    assert rans_codec.compress(wild, device=dev) == ref_codec.compress(wild)
    assert rans_codec.decompress(rans_codec.compress(wild, device=dev)) == wild.tobytes()


@pytest.mark.parametrize("device", ["cpu", "default"])
def test_adaptive_full_compares_bzip2_at_any_size(monkeypatch, device):
    """Fault 3.25: under RPCC_RANS_ADAPTIVE=full both codecs try bzip2 on
    fields of any size: a periodic 100,000-symbol field as 'Z', a 64x2000
    contour plane as 'B', a mixed batch on the pre-pass's geometry."""
    periodic = (np.arange(100000) % 50 - 25).astype(np.int16)
    plane = np.zeros((64, 2000), np.uint8)
    plane[::8, :] = 1
    packed = np.packbits(plane.reshape(-1))
    mixed = [_walk(30000, 1), _walk(40000, 2)]
    dev = _both(monkeypatch, device)
    if dev is not None:
        _fake_card(monkeypatch)
    assert rans_codec.compress_delta_batch([periodic], device=dev)[0][0] == rans_codec.MAGIC_CTX
    assert rans_codec.compress_contour(packed, 64, 2000, device=dev)[0] == rans_codec.MAGIC_BITS
    _both(monkeypatch, device, full=True)
    got = rans_codec.compress(periodic, device=dev)
    assert got == ref_codec.compress(periodic) and got[0] == rans_codec.MAGIC_BZD
    got = rans_codec.compress_contour(packed, 64, 2000, device=dev)
    assert got == ref_codec.compress_contour(packed, 64, 2000) and got[0] == rans_codec.MAGIC_BZ
    assert rans_codec.compress_contour_batch([packed], 64, 2000, device=dev) == [got]
    assert rans_codec.compress_delta_batch(mixed, device=dev) == ref_codec.compress_delta_batch(mixed)
    assert rans_codec.decompress(got) == packed.tobytes()


# ------------------------------------------------------------------ the card's path, plain version
_LENGTHS = [0, 1, 64, 65, 1024, 1025, 32768, 32769, 128000]


@pytest.mark.parametrize("n", _LENGTHS)
def test_default_path_bytes(monkeypatch, n):
    """The card's path (its plain version on a faked card, through the
    container path) gives the port's host bytes and rpcc_tpu's under both
    of its backends."""
    a = _walk(n, n)
    want = rans_codec.compress(a)
    assert want == ref_codec.compress(a)
    _fake_card(monkeypatch)
    got = rans_codec.compress(a, device="cuda")
    assert got == want
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
    assert got == ref_codec.compress(a)
    if n:
        assert rans_codec.decompress(got) == a.tobytes()


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
def test_default_path_explicit_lanes(monkeypatch, lanes):
    a = _walk(8000, lanes, step=1)
    batch = [a, a[:500]]
    want = rans_codec.compress_delta_batch(batch, lanes=lanes)
    assert want == ref_codec.compress_delta_batch(batch, lanes=lanes)
    _fake_card(monkeypatch)
    got = rans_codec.compress_delta_batch(batch, lanes=lanes, device="cuda")
    assert got == want
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
    assert got == ref_codec.compress_delta_batch(batch, lanes=lanes)
    assert got[0][1] == lanes.bit_length() - 1 and rans_codec.decompress_delta_batch(got) == [a.tobytes(), a[:500].tobytes()]


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_lanes_must_be_a_power_of_two_up_to_32(monkeypatch, lanes):
    """The reference writes log2(lanes) rounded down for such a count, a
    container no decoder reads back; the port raises on the host and the card."""
    with pytest.raises(ValueError, match="power of two"):
        rans_codec.compress_delta_batch([_walk(100)], lanes=lanes)
    _fake_card(monkeypatch)
    with pytest.raises(ValueError, match="power of two"):
        rans_codec.compress(_walk(100), lanes=lanes, device="cuda")


def test_default_path_mixed_batch_takes_the_references_default_bytes(monkeypatch):
    """Divergence 33 on the card's side: a batch of a small and a big frame
    takes one geometry from the longest frame for both on a CUDA device, as
    the reference's default path codes it (the pre-pass's path on the
    native coder gives the same bytes), which differs from the host's bytes
    (the small frame coded apart); both packages decode both."""
    mixed = [_walk(20000, 7, step=1), _walk(40000, 8)]
    cpu = ref_codec.compress_delta_batch(mixed)
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
    default = ref_codec.compress_delta_batch(mixed)
    assert default != cpu and default[1] == cpu[1]
    assert rans_codec.compress_delta_batch(mixed) == cpu
    assert rans_codec._compress_delta_batch_np(mixed) == default
    calls = _fake_card(monkeypatch)
    assert rans_codec.compress_delta_batch(mixed, device="cuda") == default
    assert calls == [("residual", 32, 1264)]
    want = [a.tobytes() for a in mixed]
    for blobs in (cpu, default):
        assert rans_codec.decompress_delta_batch(blobs) == rans_codec.decompress_delta_batch(blobs, "cuda") == want
        monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "cpu")
        assert ref_codec.decompress_delta_batch(blobs) == want


@pytest.mark.parametrize("case", ["int32_max_deltas", "escapes_513", "u16_sequence"])
def test_default_path_edge_fields(monkeypatch, case):
    rng = np.random.default_rng(11)
    if case == "int32_max_deltas":
        a = np.zeros(3000, np.int32)
        a[1::2] = 2**31 - 1  # deltas of +-(2^31 - 1): the widest a delta container takes
    elif case == "escapes_513":
        a = _walk(40000, 12)
        a[100:100 + 2 * 256:2] += rng.integers(3000, 9000, 256).astype(np.int16)  # two escapes a spike
        a[30000:] += 5000  # and one step: 513
    else:
        a = np.repeat(rng.integers(0, 300, 400), rng.integers(1, 30, 400)).astype(np.uint16)
    if case == "escapes_513":
        res = rans_device.encode_streams_plain(*rans_device.upload_streams([a], "cpu"), 32, rans_device.stream_T(a.size, 32))
        assert int(res.n_esc[0]) == rans_device.ESC_CAP_DEV + 1
    want = rans_codec.compress(a)
    assert want == ref_codec.compress(a)
    _fake_card(monkeypatch)
    got = rans_codec.compress(a, device="cuda")
    assert got == want and (case != "escapes_513" or got[0] == rans_codec.MAGIC_CTX)
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
    assert got == ref_codec.compress(a)
    assert rans_codec.decompress(got) == a.tobytes()


def test_words_do_not_depend_on_the_escape_list():
    """A frame past the kernel's 512 escapes takes the host's escape list;
    its words, counts, states and tables are those of any frame with the
    same symbols, whatever the escaped values."""
    a = _walk(20000, 13)
    b = a.copy()
    spikes = np.arange(50, 19000, 30)
    a[spikes] += 2000
    b[spikes] += 7000  # other escape values, the same symbols
    ra, rb = (rans_device.encode_streams_plain(*rans_device.upload_streams([x], "cpu"), 32, 640) for x in (a, b))
    assert int(ra.n_esc[0]) > rans_device.ESC_CAP_DEV
    for name in ("words", "n_words", "counts", "states", "freqs", "n_esc"):
        assert torch.equal(getattr(ra, name), getattr(rb, name)), name
    assert not torch.equal(ra.escapes, rb.escapes)


def test_default_path_contours(monkeypatch):
    rng = np.random.default_rng(14)
    _fake_card(monkeypatch)
    for H, W in ((16, 100), (64, 2000)):
        batch = [np.packbits(rng.random(H * W) < p) for p in (0.02, 0.3)]
        monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "cpu")
        want = rans_codec.compress_contour_batch(batch, H, W)
        assert want == ref_codec.compress_contour_batch(batch, H, W)
        assert [rans_codec.decompress(b) for b in want] == [p.tobytes() for p in batch]
        monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
        assert rans_codec.compress_contour_batch(batch, H, W, "cuda") == want == ref_codec.compress_contour_batch(batch, H, W)


def test_default_backend_one_launch_per_batch_call(monkeypatch):
    """On a CUDA device each batch call is one encode there (recorded here,
    run by the plain version on the CPU): compress_delta_batch's residuals,
    compress_contour_batch's contours, compress_batch's groups of one lane
    geometry; the bytes are the host's."""
    arrays = [_walk(n, n) for n in (100, 5000, 5000, 40000)]
    contours = [np.packbits(np.random.default_rng(s).random(16 * 100) < 0.1) for s in range(3)]
    want = (rans_codec.compress_batch(arrays), rans_codec.compress_contour_batch(contours, 16, 100),
            rans_codec.compress_delta_batch(arrays[1:3]), rans_codec.compress(arrays[3]))
    calls = _fake_card(monkeypatch)
    assert rans_codec.compress_batch(arrays, "cuda") == want[0]
    assert calls == [("residual", 2, 64), ("residual", 32, 160), ("residual", 32, 1264)]  # three lane geometries
    calls.clear()
    assert rans_codec.compress_contour_batch(contours, 16, 100, "cuda") == want[1]
    assert rans_codec.compress_delta_batch(arrays[1:3], device="cuda") == want[2]
    assert rans_codec.compress(arrays[3], device="cuda") == want[3]
    assert calls == [("contour", 3, 16, 100), ("residual", 32, 160), ("residual", 32, 1264)]
    calls.clear()
    wild = np.asarray([-(2**31), 2**31 - 1], np.int32)
    assert rans_codec.compress_delta_batch([wild], device="cuda") == ref_codec.compress_delta_batch([wild]) and not calls


def test_default_backend_needs_a_card_to_encode(monkeypatch):
    """A CUDA device encodes on the card or raises; it never falls back to
    the native coder."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = np.packbits(np.random.default_rng(0).random(16 * 100) < 0.1)
    for fn in (lambda: rans_codec.compress(_walk(100), device="cuda"),
               lambda: rans_codec.compress_delta_batch([_walk(40000)], device="cuda"),
               lambda: rans_codec.compress_batch([_walk(10)], "cuda"),
               lambda: rans_codec.compress_contour(packed, 16, 100, "cuda"),
               lambda: rans_codec.compress_contour_batch([packed], 16, 100, "cuda")):
        with pytest.raises(RuntimeError, match="asked for cuda, and no CUDA device is available"):
            fn()
    # Fields that need no rANS need no card.
    assert rans_codec.compress(np.zeros(4, np.float32), device="cuda") == ref_codec.compress(np.zeros(4, np.float32))
    assert rans_codec.compress_delta_batch([], device="cuda") == []


def test_version_equals_the_references():
    import rpcc_tpu_torch

    assert rpcc_tpu_torch.__version__ == rpcc_tpu.__version__ == "0.1.0"


def test_decompress_backends_write_the_same_bin(tmp_path):
    """``decompress --decode_backend device`` (the default) and ``host``
    write the same floats."""
    from rpcc_tpu_torch.cli import compress, decompress
    from rpcc_tpu_torch.data import lidar_config
    from rpcc_tpu_torch.data.synth import synth_cloud_for

    pc = synth_cloud_for(lidar_config("VelodyneVLP16"), 3)
    src, blob = tmp_path / "f.bin", tmp_path / "f.rpcc"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
    common = ["--lidar", "VelodyneVLP16", "--device", "cpu"]
    compress.main(["--input", str(src), "--output", str(blob), *common])
    outs = {}
    for backend in ("host", "device", None):
        out = tmp_path / f"{backend}.bin"
        decompress.main(["--input", str(blob), "--output", str(out), *common]
                        + ([] if backend is None else ["--decode_backend", backend]))
        outs[backend] = out.read_bytes()
    assert outs["host"] == outs["device"] == outs[None] and len(outs["host"]) > 0


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_cuda_kernel_equals_plain_at_host_geometry(cuda_device, lanes):
    """The kernel at L lanes and the host's T (from the longest frame)
    equals the plain version on a batch with stream lengths 0, 1, a lane
    boundary, the longest, an int32 frame of deltas +-(2^31 - 1) and one
    past 512 escapes."""
    n_max = 64 * lanes if lanes < 32 else 40000
    T = rans_device.stream_T(n_max, lanes)
    rng = np.random.default_rng(lanes)
    frames = [np.zeros(0, np.int32), _walk(1, 1, np.int32), _walk(min(T, n_max), 2, np.int32), _walk(n_max, 3, np.int32)]
    wide = np.zeros(n_max, np.int32)
    wide[1::2] = 2**31 - 1
    spiky = _walk(n_max, 4, np.int32)
    spiky[:: max(n_max // 600, 1)] += rng.integers(3000, 9000, spiky[:: max(n_max // 600, 1)].size, dtype=np.int32)
    q, n = rans_device.upload_streams(frames + [wide, spiky], cuda_device)
    before = timer.counters()
    got = rans_device.encode_fields_cuda(q, n, None, lanes=lanes, T=T)[0]
    torch.cuda.synchronize(cuda_device)
    assert timer.counters_since(before).get("launch.rans_encode", 0) == 1
    want = rans_device.encode_streams_plain(q, n, lanes, T)
    for name, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert got.counts.shape == (6, lanes)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_geometry(cuda_device):
    q, n = rans_device.upload_streams([_walk(1000, 0, np.int32)], cuda_device)
    for lanes, T in ((3, 512), (64, 16), (32, 24), (1, 992), (0, 16)):
        with pytest.raises(ValueError):
            rans_device.encode_fields_cuda(q, n, None, lanes=lanes, T=T)
    with pytest.raises(ValueError):  # CPU tensors: never the plain version
        rans_device.encode_fields_cuda(q.cpu(), n.cpu(), None, lanes=32, T=32)


@pytest.mark.cuda
def test_cuda_default_backend_bytes_equal_the_native_backends(cuda_device, monkeypatch):
    """On the card every container equals the host's (the mixed batch:
    rpcc_tpu's default bytes), one launch per batch call; a contour of more
    than 512 rows raises."""
    arrays = [_walk(n, n) for n in _LENGTHS]
    mixed = [_walk(20000, 7, step=1), _walk(40000, 8)]
    packed = [np.packbits(np.random.default_rng(s).random(64 * 2000) < 0.05) for s in range(4)]
    want = ([rans_codec.compress(a) for a in arrays], rans_codec._compress_delta_batch_np(mixed),
            rans_codec.compress_contour_batch(packed, 64, 2000))
    before = timer.counters()
    assert [rans_codec.compress(a, device=cuda_device) for a in arrays] == want[0]
    assert rans_codec.compress_delta_batch(mixed, device=cuda_device) == want[1]
    assert rans_codec.compress_contour_batch(packed, 64, 2000, cuda_device) == want[2]
    assert timer.counters_since(before).get("launch.rans_encode", 0) == len(arrays) + 2
    tall = np.packbits(np.zeros(rans_device.MAX_CONTOUR_ROWS + 1, np.uint8))
    with pytest.raises(ValueError, match="contour rows"):
        rans_codec.compress_contour(tall, rans_device.MAX_CONTOUR_ROWS + 1, 1, cuda_device)


@pytest.mark.cuda
def test_cuda_concurrent_encodes_count_every_launch(cuda_device, monkeypatch):
    """The engine's pool threads encode concurrently on the card: with
    more threads than cores and a short switch interval, every call gets
    its own bytes and every launch is counted."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    arrays = [_walk(n, n) for n in range(3000, 3000 + 64 * 37, 37)]
    want = [rans_codec.compress(a) for a in arrays]
    before, interval = timer.counters(), sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            got = list(pool.map(lambda a: rans_codec.compress(a, device=cuda_device), arrays, timeout=300))
    finally:
        sys.setswitchinterval(interval)
    assert got == want and timer.counters_since(before).get("launch.rans_encode", 0) == len(arrays)
