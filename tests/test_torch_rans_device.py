"""Device entropy coding in the port (``rpcc_tpu_torch/ops/rans_device.py``,
``ops/rans.py``, the containers of ``codec/rans_codec.py`` and the engine's
device-entropy path) against ``rpcc_tpu``'s on the CPU, and the CUDA kernel
(``csrc/rans.cu``) against the plain version on the card.

Tolerances and why:
  * the plain residual and contour encoders equal ``rpcc_tpu.ops.
    rans_device``'s outputs exactly, every element (escapes up to
    min(n_esc, 512): the reference's tail past n_esc comes from top_k and is
    not data); integer coding has no rounding to allow for;
  * they also equal the port's native host coder called with the device's
    lane geometry (L = 32, T = resid_T(HW)) on the data it emits (the word
    prefix, counts, states, tables, escapes);
  * the kernel's step arithmetic (``rans_device.step_constants`` /
    ``twin_step``) equals ``//``, ``%`` and the reference's step exactly,
    and a walk driven by it gives every output of the plain encoders;
  * blobs of the device-entropy engine decode within the codec's bound, and
    its bpp is within 2% of host coding (``tests/test_engine.py:109``'s
    tolerance: the device container keeps the grid's T, not the frame's).
"""

import argparse
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu import config as ref_config
from rpcc_tpu.codec import rans_codec as ref_codec
from rpcc_tpu.ops import rans as ref_rans
from rpcc_tpu.ops import rans_device as ref_dev
from rpcc_tpu_torch.cli import common as cli_common
from rpcc_tpu_torch.codec import rans_codec, rans_native
from rpcc_tpu_torch.config import CodecConfig, LidarConfig, load_codec_config
from rpcc_tpu_torch.ops import rans, rans_device
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES_NAMES = ("words", "n_words", "counts", "states", "freqs", "escapes", "n_esc", "q0")
_REF_RES = jax.jit(ref_dev.encode_residual_field_device)
_REF_CNT = jax.jit(ref_dev.encode_contour_field_device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_rans_device.py")
    return torch.device("cuda:0")


def _residual_case(case: str, hw: int, seed: int = 0):
    """(q (HW,) int32 zero past n, n) of one named case."""
    rng = np.random.default_rng(seed)
    q = np.round(rng.normal(0, 3, hw)).astype(np.int32)
    n = {"full": hw, "third": hw // 3, "one": 1, "zero": 0}.get(case, hw)
    if case == "few_escapes":
        q[[5, 100, hw // 2]] = [900, -700, 5000]
    if case == "many_escapes":
        q = rng.integers(-2000, 2000, hw).astype(np.int32)
    q[n:] = 0
    return q, n


def _as_np(pieces):
    out = [p.numpy().astype(np.int64) for p in pieces]
    out[0] = pieces[0].numpy().view(np.uint16).astype(np.int64)  # u16 words
    return out


def _assert_residual_equal(got, ref):
    n_esc = int(ref[6])
    for name, g, r in zip(RES_NAMES, got, ref):
        r = np.asarray(r).astype(np.int64)
        if name == "escapes":
            k = min(n_esc, rans_device.ESC_CAP_DEV)
            g, r = g[:k], r[:k]
        np.testing.assert_array_equal(g, r, err_msg=name)


# ------------------------------------------------------------ the spec
@pytest.mark.parametrize("kind", ["random", "near_uniform_repair", "all_zero", "one_symbol", "sparse"])
def test_normalize_freqs_equals_reference(kind):
    rng = np.random.default_rng(7)
    A = 512
    counts = {
        "random": rng.integers(0, 1000, (6, A)),
        # tests/test_rans.py's pathological row (255 x 513 + 257 singletons):
        # the bump-to-1 overdraws M and only the repair pass gives a valid
        # table; and a shuffled copy, so the argmax is not the first entry.
        "near_uniform_repair": np.stack([np.r_[np.full(255, 513), np.ones(257)],
                                         rng.permutation(np.r_[np.full(255, 513), np.ones(257)])]),
        "all_zero": np.zeros((2, A)),
        "one_symbol": np.eye(A)[[0, 7, 511]] * 12345,
        "sparse": (rng.random((4, A)) < 0.02) * rng.integers(1, 5, (4, A)),
    }[kind].astype(np.int32)
    want = np.asarray(jax.vmap(ref_rans.normalize_freqs)(jnp.asarray(counts)))
    got = rans.normalize_freqs(torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == rans.M).all() and ((got > 0) | (counts == 0)).all()
    np.testing.assert_array_equal(rans.cumulative(torch.from_numpy(got)).numpy(),
                                  np.asarray(jax.vmap(ref_rans.cumulative)(jnp.asarray(got))))


def test_contexts_equal_reference():
    prev = np.random.default_rng(1).integers(0, 2, (5, 16)).astype(np.int32)
    np.testing.assert_array_equal(rans.wavefront_bit_context(torch.from_numpy(prev)).numpy(),
                                  np.asarray(ref_rans.wavefront_bit_context(jnp.asarray(prev))))
    sym = np.arange(0, 512, dtype=np.int32)
    np.testing.assert_array_equal(rans.zigzag_magnitude_context(torch.from_numpy(sym)).numpy(),
                                  np.asarray(ref_rans.zigzag_magnitude_context(jnp.asarray(sym))))


def test_lane_geometry_equals_reference():
    for hw in (1, 4096, 16384, 128000, 72000):
        assert rans_device.resid_T(hw) == ref_dev.resid_T(hw)
    for H, W in ((16, 256), (64, 2000), (32, 2250)):
        assert rans_device.contour_T(H, W) == ref_dev.contour_T(H, W)
    assert (rans_device.RESID_LANES, rans_device.ESC_CAP_DEV, rans_device.ALPHABET, rans_device.NUM_CTX) == (
        ref_dev.RESID_LANES, ref_dev.ESC_CAP_DEV, ref_dev.ALPHABET, ref_dev.NUM_CTX)


# ------------------------------------------------------------ the encoders
@pytest.mark.parametrize("case", ["full", "third", "one", "zero", "few_escapes", "many_escapes"])
def test_residual_plain_equals_reference_and_native(case):
    hw = 16 * 256
    q, n = _residual_case(case, hw)
    ref = [np.asarray(r) for r in _REF_RES(jnp.asarray(q), jnp.int32(n))]
    got = _as_np([p[0] for p in rans_device.encode_fields_device(
        torch.from_numpy(q)[None], torch.tensor([n], dtype=torch.int32), None)[0]])
    _assert_residual_equal(got, ref)
    if case == "many_escapes":
        assert int(ref[6]) > rans_device.ESC_CAP_DEV
    # The native host coder at the device's lane geometry, on the live prefix.
    T = rans_device.resid_T(hw)
    packed, n_words, counts, states, freqs, escapes, esc_counts, q0s = rans_native.delta_encode_frames(
        [q[:n]], rans_device.RESID_LANES, T, rans_device.ALPHABET, rans_device.NUM_CTX)
    nw = int(n_words[0])
    assert nw == got[1]
    np.testing.assert_array_equal(packed[0, :nw], got[0][:nw])
    for a, b in ((counts[0], got[2]), (states[0], got[3]), (freqs[0], got[4]), (q0s[0], got[7])):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b)
    assert esc_counts[0] == got[6]
    k = min(int(got[6]), rans_device.ESC_CAP_DEV)
    np.testing.assert_array_equal(escapes[0, :k].astype(np.int64), got[5][:k])


def _contours(H, W):
    rng = np.random.default_rng(3)
    ids = np.cumsum(rng.random((H, W)) < 0.15, axis=1)  # runs of a seg map's rows
    runs = np.ones((H, W), np.int32)
    runs[:, 1:] = ids[:, 1:] != ids[:, :-1]
    return {
        "runs": runs,
        "random": (rng.random((H, W)) < 0.5).astype(np.int32),
        "all_zero": np.zeros((H, W), np.int32),
        "all_one": np.ones((H, W), np.int32),
    }


@pytest.mark.parametrize("kind", ["runs", "random", "all_zero", "all_one"])
def test_contour_plain_equals_reference_and_native(kind):
    H, W = 16, 256
    c = _contours(H, W)[kind]
    ref = [np.asarray(r) for r in _REF_CNT(jnp.asarray(c))]
    got = _as_np([p[0] for p in rans_device.encode_fields_device(None, None, torch.from_numpy(c)[None])[1]])
    for name, g, r in zip(RES_NAMES, got, ref):
        np.testing.assert_array_equal(g, r.astype(np.int64), err_msg=name)
    T = rans_device.contour_T(H, W)
    words, n_words, counts, states, freqs = rans_native.contour_encode_frames(np.packbits(c)[None], H, W, T)
    nw = int(n_words[0])
    assert nw == got[1]
    np.testing.assert_array_equal(words[0, :nw], got[0][:nw])
    for a, b in ((counts[0], got[2]), (states[0], got[3]), (freqs[0], got[4])):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b)


def test_batched_plain_equals_per_frame():
    hw = 8 * 128
    cases = [_residual_case(c, hw, seed=i) for i, c in enumerate(["full", "third", "zero", "many_escapes"])]
    q = torch.from_numpy(np.stack([c[0] for c in cases]))
    n = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    contours = torch.from_numpy(np.stack(list(_contours(8, 128).values())))
    res, cnt = rans_device.encode_fields_device(q, n, contours)
    for b in range(4):
        one_res, one_cnt = rans_device.encode_fields_device(q[b : b + 1], n[b : b + 1], contours[b : b + 1])
        for x, y in zip(res, one_res):
            assert torch.equal(x[b], y[0])
        for x, y in zip(cnt, one_cnt):
            assert torch.equal(x[b], y[0])


def test_wrapper_checks_inputs():
    q = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        rans_device.encode_fields_device(q.to(torch.int64), torch.zeros(2, dtype=torch.int32), None)
    with pytest.raises(ValueError):
        rans_device.encode_fields_device(q, torch.zeros(3, dtype=torch.int32), None)
    with pytest.raises(ValueError):
        rans_device.encode_fields_device(None, None, None)
    with pytest.raises(ValueError):
        rans_device.encode_fields_cuda(q, torch.zeros(2, dtype=torch.int32), None)  # CPU tensors: never the plain version


@pytest.mark.parametrize("H, W, fits", [
    (128, 262001, True), (128, 262002, False),  # H * T = 16383 * 2048, then 16384 * 2048
    (120, 279497, False),  # H * T = 65535 * 512: a histogram thread would count 65536 steps
    (512, 65009, True), (512, 65010, False), (512, 2, True), (513, 2, False),
])
def test_kernel_contour_limits_at_the_edge(H, W, fits):
    T = rans_device.contour_T(H, W)
    # csrc/rans.cu: a contour histogram thread counts 4 * ceil(H * T / 2048)
    # steps in 16-bit fields, and a block codes at most 512 lanes.
    assert fits == (H <= 512 and 4 * -(-H * T // 2048) <= 65535)
    if fits:
        rans_device.check_contour_fits_kernel(H, W)
    else:
        with pytest.raises(ValueError):
            rans_device.check_contour_fits_kernel(H, W)


def test_plain_contour_has_no_kernel_limit():
    contour = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (1, rans_device.MAX_CONTOUR_ROWS + 1, 2),
                                                                 dtype=np.int32))
    got = rans_device.encode_fields_device(None, None, contour)[1]
    ref = rans_device.encode_contour_field_plain(contour)
    for name, a, b in zip(RES_NAMES, got, ref):
        assert torch.equal(a, b), name


# ------------------------------------------------------------ the kernel's arithmetic
def _twin_xs(f):
    """The dividends the twin is checked on for every frequency f."""
    xs = [torch.zeros_like(f), torch.ones_like(f), f - 1, f, f + 1, f * 2**18 - 1, torch.full_like(f, 2**32 - 1)]
    for k in (2**17, 2**18 - 1):
        xs += [k * f - 1, k * f]
    return xs


@pytest.mark.parametrize("kind", ["edges", "random"])
def test_twin_quotient_is_exact(kind):
    """csrc/rans.cu's multiply-high division equals // and % for every f in
    [1, 2^14], and its quotient of x >> 16 (an emitting step's) equals
    (x >> 16) // f: at the named dividends, and on 10^5 seeded random pairs
    with x below f * 2^18 (the states a step divides) and 10^5 over all of
    u32."""
    if kind == "edges":
        f = torch.arange(1, rans.M + 1, dtype=torch.int64)
        pairs = [(f, x) for x in _twin_xs(f)]
    else:
        rng = np.random.default_rng(11)
        f = torch.from_numpy(rng.integers(1, rans.M + 1, 10**5))
        x = torch.from_numpy(rng.integers(0, 2**62, 10**5)) % (f * 2**18)
        pairs = [(f, x), (f, torch.from_numpy(rng.integers(0, 2**32, 10**5)))]
    for f, x in pairs:
        k = rans_device.step_constants(f)
        assert (k.m >= 1).all() and (k.m < 2**32).all() and (k.sh2 <= 13).all()
        q, q_emit = rans_device.twin_quotients(x, k)
        assert torch.equal(q, x // f)
        assert torch.equal(x - q * f, x % f)
        assert torch.equal(q_emit, (x >> 16) // f)


def test_twin_step_equals_the_reference_step():
    """One branch-free step with the kernel's record == the reference's
    renormalize-then-(x // f) * M + c + x % f, on states across [2^16, 2^32),
    including f = M (xm1 = 2^32 - 1: never emits)."""
    rng = np.random.default_rng(12)
    f = torch.from_numpy(np.r_[rng.integers(1, rans.M + 1, 10**5), [rans.M] * 1000])
    c = torch.from_numpy(rng.integers(0, rans.M, f.numel())) % (rans.M - f + 1)
    x = torch.from_numpy(rng.integers(rans.RANS_L, 2**32, f.numel()))
    got, word, emit = rans_device.twin_step(x, c, rans_device.step_constants(f))
    want_emit = (x >> 18) >= f
    xr = torch.where(want_emit, x >> 16, x)
    assert torch.equal(emit, want_emit) and torch.equal(word, x & 0xFFFF)
    assert torch.equal(got, (xr // f) * rans.M + c + xr % f)
    assert (got < 2**32).all()


def _twin_walk_and_pack(key, freqs, live_lane):
    """``rans_device._walk_and_pack`` as csrc/rans.cu computes it: steps past
    a lane's live length take the dead record (f = M, c = 0); each step is
    ``twin_step`` on the gathered record, writing its word to the front of
    the lane's row if emitted, else to the back; the pack copies each row's
    emitted prefix forward and its suffix reversed."""
    B, L, T = key.shape
    M = rans.M
    f = torch.cat([freqs.reshape(B, -1).to(torch.int64), torch.full((B, 1), M)], 1)
    c = torch.cat([rans.cumulative(freqs).reshape(B, -1).to(torch.int64), torch.zeros((B, 1), dtype=torch.int64)], 1)
    key = torch.where(torch.arange(T) < live_lane[..., None], key, f.shape[1] - 1).reshape(B, L * T)
    k = rans_device.step_constants(f)
    x = torch.full((B, L), rans.RANS_L, dtype=torch.int64)
    rows = torch.zeros((B, L, T), dtype=torch.int64)
    ne = torch.zeros((B, L), dtype=torch.int64)
    nn = torch.zeros((B, L), dtype=torch.int64)
    for t in range(T - 1, -1, -1):
        kt = key.reshape(B, L, T)[:, :, t]
        rec = rans_device.StepConstants(*(v.gather(1, kt) for v in k))
        x, word, emit = rans_device.twin_step(x, c.gather(1, kt), rec)
        rows.scatter_(2, torch.where(emit, ne, T - 1 - nn)[..., None], word[..., None])
        ne += emit
        nn += ~emit
    off = torch.cumsum(ne, -1) - ne
    nw = ne.sum(-1)
    packed = torch.zeros((B, L * T), dtype=torch.int64)
    for b in range(B):
        for lane in range(L):
            e, o = int(ne[b, lane]), int(off[b, lane])
            packed[b, o : o + e] = rows[b, lane, :e]
            s = int(nw[b]) + lane * T - o
            packed[b, s : s + T - e] = rows[b, lane, e:].flip(0)
    packed = torch.where(packed >= 0x8000, packed - 0x10000, packed).to(torch.int16)
    return packed, nw.to(torch.int32), ne.to(torch.int32), x


@pytest.mark.parametrize("field, case", [("residual", c) for c in ("full", "third", "one", "zero", "few_escapes", "many_escapes")]
                         + [("contour", k) for k in ("runs", "random", "all_zero", "all_one")])
def test_twin_walk_equals_plain_encoders(monkeypatch, field, case):
    """A walk driven by the kernel's step twin gives every output of the
    plain encoders on the reference cases above."""
    if field == "residual":
        q, n = _residual_case(case, 16 * 256)
        args = (torch.from_numpy(q)[None], torch.tensor([n], dtype=torch.int32))

        def encode(q, n):
            return rans_device.encode_streams_plain(q, n, rans_device.RESID_LANES, rans_device.resid_T(q.shape[1]))
    else:
        args = (torch.from_numpy(_contours(16, 256)[case])[None],)
        encode = rans_device.encode_contour_field_plain
    want = encode(*args)
    monkeypatch.setattr(rans_device, "_walk_and_pack", _twin_walk_and_pack)
    got = encode(*args)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


# ------------------------------------------------------------ containers
def test_containers_equal_reference_and_decode_in_both_packages():
    hw = 16 * 256
    q, n = _residual_case("few_escapes", hw)
    res = [p[0].numpy() for p in rans_device.encode_fields_device(
        torch.from_numpy(q)[None], torch.tensor([n], dtype=torch.int32), None)[0]]
    words, nw, counts, states, freqs, escapes, n_esc, q0 = res
    L, T = rans_device.RESID_LANES, rans_device.resid_T(hw)
    args = (L, T, n, int(q0), escapes[:n_esc], freqs.astype(np.int64), states, counts.astype(np.uint16),
            words[:nw].view(np.uint16), np.int16)
    blob = rans_codec.build_ctx_container(*args)
    assert blob == ref_codec.build_ctx_container(*args)
    want = q[:n].astype(np.int16).tobytes()
    assert rans_codec.decompress(blob) == want == ref_codec.decompress(blob)

    H, W = 16, 256
    c = _contours(H, W)["runs"]
    words, nw, counts, states, freqs = [p[0].numpy() for p in rans_device.encode_fields_device(
        None, None, torch.from_numpy(c)[None])[1]]
    args = (rans_device.contour_T(H, W), H, W, freqs, states, counts.astype(np.uint16), words[:nw].view(np.uint16))
    blob = rans_codec.build_bits_container(*args)
    assert blob == ref_codec.build_bits_container(*args)
    assert rans_codec.decompress(blob) == np.packbits(c).tobytes() == ref_codec.decompress(blob)

    with pytest.raises(ValueError):
        rans_codec.build_ctx_container(L, 0x10000, 0, 0, escapes[:0], freqs, states, counts, words[:0], np.int16)
    with pytest.raises(ValueError):
        rans_codec.build_bits_container(0x10000, H, W, freqs, states, counts, words[:0])


GRID = LidarConfig(name="grid32", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                   vertical_angle_min_deg=-24.9, height=32, width=1280)


def test_containers_from_reference_engine_outputs_equal_its_blobs():
    """Tier (a): ``rpcc_tpu``'s device-entropy engine's own residual streams
    and contours through the port's encoder and container assembly give its
    containers byte for byte.  The grid has more than 32768 live pixels, so
    the engine keeps the device container (no small-frame pick)."""
    from rpcc_tpu.codec.bitstream import unpack_bitstream as ref_unpack
    from rpcc_tpu.config import LidarConfig as RefLidar
    from rpcc_tpu.parallel import BatchEngine as RefEngine
    from rpcc_tpu_torch.data.synth import synth_cloud_for

    lidar = RefLidar(**{f.name: getattr(GRID, f.name) for f in dataclasses.fields(RefLidar)})
    cfg = ref_config.CodecConfig(cluster_num=16)
    assert cfg.device_entropy
    ref = RefEngine(lidar, cfg, batch_size=2, workers=1)
    clouds = [synth_cloud_for(GRID, s) for s in (0, 1)]
    out, live = ref.encode_batch_device(clouds, [0, 1])
    blobs = [b for b, _ in ref.finalize_encoded(out, live)]
    q = torch.from_numpy(np.asarray(out.stream)[:live].astype(np.int32))
    n = torch.from_numpy(np.asarray(out.stream_len)[:live].astype(np.int32))
    H, W = GRID.height, GRID.width
    bits = np.unpackbits(np.asarray(out.contour_packed)[:live], axis=1)[:, : H * W].reshape(live, H, W)
    res, cnt = (p._make(t.numpy() for t in p)
                for p in rans_device.encode_fields_device(q, n, torch.from_numpy(bits.astype(np.int32))))
    for i in range(live):
        assert int(n[i]) > rans_codec.BZD_TRY_MAX_SYMBOLS
        fields = ref_unpack(blobs[i], uniform=True)
        resid, contour = rans_codec.device_containers(res, cnt, i, int(n[i]), H, W)
        assert resid == fields["residual_quantized"]
        assert contour == fields["contour_map"]


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def engine_runs():
    from rpcc_tpu_torch.parallel.engine import BatchEngine
    from tests.test_roundtrip import SMALL, synth_scene

    cfg = CodecConfig(cluster_num=16)
    clouds = [synth_scene(seed=s) for s in range(3)]
    # A frame of uniformly random ranges: far more than 512 escapes.
    rng = np.random.default_rng(9)
    az, el = rng.uniform(-np.pi, np.pi, 4000), np.deg2rad(rng.uniform(-24, 1.5, 4000))
    r = rng.uniform(3, 70, 4000)
    clouds.append(np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1).astype(np.float32))
    seeds = [4, 5, 6, 7]
    dev = BatchEngine(SMALL, cfg, "cpu", batch_size=4, workers=2)
    host = BatchEngine(SMALL, cfg.replace(device_entropy=False), "cpu", batch_size=4, workers=2)
    staged = dev.stage_downloads(dev.encode_batch_device(clouds, seeds))
    dev_res = dev.finish_staged(staged)
    host_res = host.encode_frames(clouds, seeds)
    one = BatchEngine(SMALL, cfg, "cpu", batch_size=1, workers=1)
    singles = [one.encode_frames([c], [s])[0][0] for c, s in zip(clouds, seeds)]
    yield dict(cfg=cfg, lidar=SMALL, clouds=clouds, seeds=seeds, staged=staged, dev=dev_res, host=host_res,
               singles=singles)
    for e in (dev, host, one):
        e.close()


def test_engine_device_entropy_fields_and_escape_overflow(engine_runs):
    st, res = engine_runs["staged"], engine_runs["dev"]
    assert set(res[0][1]) == {"idx_sequence", "plane_param"}
    np.testing.assert_array_equal(res.stream_len, st.stream_len[: len(res)])
    n_esc = st.residual.n_esc.numpy()
    assert n_esc[3] > rans_device.ESC_CAP_DEV and (n_esc[:3] <= rans_device.ESC_CAP_DEV).all()
    # Every frame here is small enough for the host's pick, so each one's
    # i16 prefix came back.
    np.testing.assert_array_equal(st.stream_rows, np.arange(4))


def test_engine_device_entropy_cross_decodes(engine_runs):
    from rpcc_tpu.models.host_decoder import HostDecoder as RefHostDecoder
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    lidar, cfg = engine_runs["lidar"], engine_runs["cfg"]
    blobs = [b for b, _ in engine_runs["dev"]]
    codec = RPCCCodec(lidar, cfg, "cpu")
    ref_cfg = ref_config.CodecConfig(cluster_num=16)
    for decoded in (HostDecoder(lidar, cfg).decode_blobs(blobs), RefHostDecoder(lidar, ref_cfg).decode_blobs(blobs),
                    [codec.decompress(b)[1] for b in blobs]):
        for rec, pc in zip(decoded, engine_runs["clouds"]):
            q, d = codec.project(pc)
            ri = q.astype(np.float32) * d
            assert np.abs(rec - ri).max() <= cfg.step + 1e-5
            assert (rec[ri == 0] == 0).all()


def test_engine_device_entropy_bpp_close_to_host_coding(engine_runs):
    """Per scene frame, as ``tests/test_engine.py:109``; the escape-overflow
    frame's residual is the host's delta container (the reference engine's
    fallback), which is not the host's smallest pick."""
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream

    pts = engine_runs["dev"].stream_len
    assert np.array_equal(pts, engine_runs["host"].stream_len)
    assert [f["residual_quantized"].size for _, f in engine_runs["host"]] == pts.tolist()
    for (bd, _), (bh, _) in list(zip(engine_runs["dev"], engine_runs["host"]))[:3]:
        assert abs(len(bd) - len(bh)) <= 0.02 * len(bh), (len(bd), len(bh))
    q16 = engine_runs["host"][3][1]["residual_quantized"]
    assert unpack_bitstream(engine_runs["dev"][3][0])["residual_quantized"] == rans_codec.compress_delta_batch([q16])[0]


def test_engine_device_entropy_blobs_independent_of_batch(engine_runs):
    assert [b for b, _ in engine_runs["dev"]] == engine_runs["singles"]


def test_codec_blobs_ignore_the_flag(engine_runs):
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    lidar, cfg = engine_runs["lidar"], engine_runs["cfg"]
    on, off = RPCCCodec(lidar, cfg, "cpu"), RPCCCodec(lidar, cfg.replace(device_entropy=False), "cpu")
    pc, seed = engine_runs["clouds"][0], engine_runs["seeds"][0]
    assert on.compress(pc, seed=seed)[0] == off.compress(pc, seed=seed)[0] == engine_runs["host"][0][0]


def test_engine_device_entropy_needs_the_rans_coder(engine_runs):
    """With another coder the knob is ignored, as ``rpcc_tpu/parallel/
    engine.py:161`` ignores it: the encoder makes no device pieces and the
    engine codes on the host, so its blobs are the single-frame codec's."""
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    lidar, cfg = engine_runs["lidar"], engine_runs["cfg"].replace(basic_compressor="bzip2")
    assert cfg.device_entropy
    clouds, seeds = engine_runs["clouds"][:2], engine_runs["seeds"][:2]
    engine = BatchEngine(lidar, cfg, "cpu", batch_size=2, workers=1)
    try:
        out = engine.encode_batch_device(clouds, seeds).out
        assert out.residual_pieces is None and out.contour_pieces is None
        blobs = [b for b, _ in engine.encode_frames(clouds, seeds)]
    finally:
        engine.close()
    codec = RPCCCodec(lidar, cfg, "cpu")
    assert blobs == [codec.compress(pc, seed=s)[0] for pc, s in zip(clouds, seeds)]


# ------------------------------------------------------------ configuration and CLI
@pytest.mark.parametrize("flag, want", [([], True), (["--device_entropy"], True), (["--no-device_entropy"], False)])
def test_device_entropy_flag(flag, want):
    parser = argparse.ArgumentParser()
    cli_common.add_codec_args(parser, datalist=True)
    args = parser.parse_args(["--datalist", "a", "--output_dir", "b", *flag])
    assert cli_common.config_from_args(args).device_entropy is want


@pytest.mark.parametrize("knob", [True, False])
def test_codec_yaml_knob_equals_reference(knob):
    mine = load_codec_config(device_entropy=knob)
    ref = ref_config.load_codec_config(device_entropy=knob)
    assert mine.device_entropy is knob
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_compress_profile_prints_a_table(tmp_path, capsys):
    from rpcc_tpu_torch.cli import compress
    from rpcc_tpu_torch.data import lidar_config
    from rpcc_tpu_torch.data.synth import synth_cloud_for

    pc = synth_cloud_for(lidar_config("VelodyneVLP16"), 0)[::3]
    src = str(tmp_path / "f.bin")
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
    compress.main(["--input", src, "--output", str(tmp_path / "f.rpcc"), "--lidar", "VelodyneVLP16",
                   "--device", "cpu", "--cluster_num", "16", "--profile"])
    text = capsys.readouterr().out
    assert "Top device operations" in text
    rows = [ln for ln in text.splitlines() if re.match(r"^\s+\d+\.\d{3} ms\s+\d+x\s+\S", ln)]
    assert len(rows) >= 5, text


def test_sass_walk_loop_chain_per_step():
    """rpcc_tpu_torch.utils.rans_sass on a made-up disassembly: an innermost
    loop of 8 steps, each a multiply-high and an add on x, is a chain of 2 a
    step; a loop without 8 multiply-highs is not the walk's."""
    from rpcc_tpu_torch.utils import rans_sass

    line = "        /*{:04x}*/                   {} ;"
    body = ["        Function : rans_encode_kernel", line.format(0, "MOV R4, c[0x0][0x28]"), ".L_x_1:"]
    addr = 16
    for _ in range(8):
        for inst in ("IMAD.HI.U32 R5, R9, R4, RZ", "LDS R9, [R2+0x4]", "IADD3 R4, R5, R4, RZ"):
            body.append(line.format(addr, inst))
            addr += 16
    body.append(line.format(addr, "@P0 BRA `(.L_x_1)"))
    body += [".L_x_2:", line.format(addr + 16, "IMAD.HI.U32 R5, R9, R4, RZ"), line.format(addr + 32, "BRA `(.L_x_2)")]
    loops = rans_sass.walk_loops("\n".join(body))
    assert [(lp["steps"], lp["chain"], lp["instructions"]) for lp in loops] == [(8, 16, 25)]
    assert loops[0]["chain_per_step"] == 2.0


# ------------------------------------------------------------ the card
def _card_inputs(dev, B, H, W, stream_lens, esc_frames=()):
    """Seeded frames; ``esc_frames`` holds frame indices (uniform random
    residuals, far past 512 escapes) or (frame, m) pairs (a ramp of exactly
    m escapes at the stream's start)."""
    rng = np.random.default_rng(B * 1000 + H)
    hw = H * W
    q = np.round(rng.normal(0, 4, (B, hw))).astype(np.int32)
    for e in esc_frames:
        if isinstance(e, tuple):
            b, m = e
            q[b] = 5000 * np.minimum(np.arange(hw), m)
        else:
            q[e] = rng.integers(-3000, 3000, hw)
    for b, n in enumerate(stream_lens):
        q[b, n:] = 0
    ids = np.cumsum(rng.random((B, H, W)) < 0.1, axis=2)
    contour = np.ones((B, H, W), np.int32)
    contour[:, :, 1:] = ids[:, :, 1:] != ids[:, :, :-1]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return to(q), to(np.asarray(stream_lens, np.int32)), to(contour)


# csrc/rans.cu walks in chunks of 128 steps (64 for contours of more than 64
# rows).  At 16x1100 the residual T is 560 (4 chunks + 48) and the contour T
# 1120 (8 chunks + 96): the stream lengths end one step before, at and after
# a chunk boundary of lane 0 (t = 432) and of lane 3 (t = 48).
_CHUNK_EDGES = [431, 432, 433, 3 * 560 + 47, 3 * 560 + 48, 3 * 560 + 49]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B, H, W, lens, esc",
    [(1, 64, 2000, [100000], ()), (3, 16, 256, [4096, 1, 0], (0,)), (2, 32, 2250, [72000, 30000], (1,)),
     (6, 16, 1100, _CHUNK_EDGES, ()), (1, 1, 40, [40], ()), (1, 33, 100, [3300], ()), (1, 129, 100, [12900], ()),
     (1, rans_device.MAX_CONTOUR_ROWS, 40, [40 * rans_device.MAX_CONTOUR_ROWS], ()), (2, 16, 1100, [17600, 17600], ((0, 512), (1, 513))),
     (2, 3, 101, [303, 200], ())],
    ids=["64E", "edges", "32E", "chunk_edges", "H1", "H33", "H129", "H_max", "escapes_512_513", "odd_hw"],
)
def test_cuda_kernel_equals_plain(cuda_device, B, H, W, lens, esc):
    q, n, contour = _card_inputs(cuda_device, B, H, W, lens, esc)
    before = timer.counters()
    res, cnt = rans_device.encode_fields_cuda(q, n, contour)
    torch.cuda.synchronize(cuda_device)
    assert timer.counters_since(before).get("launch.rans_encode", 0) == 1
    ref_res = rans_device.encode_streams_plain(q, n, rans_device.RESID_LANES, rans_device.resid_T(H * W))
    ref_cnt = rans_device.encode_contour_field_plain(contour)
    for name, a, b in zip(RES_NAMES, res, ref_res):
        assert torch.equal(a, b), name
    for name, a, b in zip(RES_NAMES, cnt, ref_cnt):
        assert torch.equal(a, b), name
    for e in esc:
        if isinstance(e, tuple):
            assert int(res.n_esc[e[0]]) == e[1]
        else:
            assert int(res.n_esc[e]) > rans_device.ESC_CAP_DEV


@pytest.mark.cuda
def test_cuda_phase_stamps_time_both_blocks(cuda_device):
    q, n, contour = _card_inputs(cuda_device, 2, 64, 2000, [128000, 90000])
    stamps = torch.zeros(len(rans_device.STAMP_BLOCKS) * (len(rans_device.PHASES) + 1), dtype=torch.int64,
                         device=cuda_device)
    rans_device.encode_fields_cuda(q, n, contour, phase_stamps=stamps)
    torch.cuda.synchronize(cuda_device)
    for block in stamps.cpu().reshape(len(rans_device.STAMP_BLOCKS), -1):
        assert (block > 0).all() and (block.diff() >= 0).all(), block
    with pytest.raises(ValueError):
        rans_device.encode_fields_cuda(q, n, contour, phase_stamps=stamps[:5])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_too_many_contour_rows(cuda_device):
    contour = torch.zeros((1, rans_device.MAX_CONTOUR_ROWS + 1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        rans_device.encode_fields_cuda(None, None, contour)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_strided_input(cuda_device):
    q = torch.zeros((2, 128), dtype=torch.int32, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError):
        rans_device.encode_fields_cuda(q, torch.zeros(2, dtype=torch.int32, device=cuda_device), None)
