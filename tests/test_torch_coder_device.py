"""The port's rANS coder follows its caller's device: the codec, the batch
engine and the decompress CLI hand their device to it; a CPU device (or
None) codes on the native host library and never reaches the plain
PyTorch versions; a CUDA device runs the kernels' wrappers (here on a faked
card, whose wrappers count calls and run the plain versions on the CPU);
``RPCC_RANS_DEVICE`` changes nothing.  Also the host-facing wrappers'
staging buffers against the tensor path they replaced, and divergence 33
(a batch mixing frames of at most and of more than 32,768 symbols) against
``rpcc_tpu`` on both sides.

Tolerances: none, except bpp.  Integer coding is exact, so every container
equals its reference byte for byte and every piece element for element;
the two sides of divergence 33 differ in bytes, and their sizes stay within
0.5% of each other (the codec's bpp limit against the reference).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpcc_tpu.codec import rans_codec as ref_codec
from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.config import CodecConfig
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.ops import rans_device
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIDAR = "VelodyneVLP16"
HOST_WRAPPERS = ("encode_streams_host", "encode_contours_host", "decode_fields_host")
PLAIN = ("encode_streams_plain", "encode_contour_field_plain", "decode_streams_plain")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_coder_device.py")
    return torch.device("cuda:0")


def _walk(n: int, seed: int, step: int = 3) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).integers(-step, step + 1, n)).astype(np.int16)


def _fake_card(monkeypatch) -> list:
    """A faked card: ``torch.cuda.is_available()`` says yes, and each
    host-facing wrapper of ``ops/rans_device.py`` checks that it was handed
    a CUDA device, records its name and runs on the CPU (the plain
    versions, through the same staging buffers).  -> the calls made."""
    calls = []
    for name in HOST_WRAPPERS:
        real = getattr(rans_device, name)

        def fake(*args, _real=real, _name=name):
            assert torch.device(args[-1]).type == "cuda", (_name, args[-1])
            calls.append(_name)
            return _real(*args[:-1], "cpu")

        monkeypatch.setattr(rans_device, name, fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return calls


def _no_plain(monkeypatch) -> None:
    """Every wrapper and plain version of the card's path raises if called."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the card's path or its plain version")

    for name in HOST_WRAPPERS + PLAIN + ("encode_fields_device",):
        monkeypatch.setattr(rans_device, name, refuse)


def _frames(lidar, seeds):
    return [synth_cloud_for(lidar, s) for s in seeds]


def _small_rans_fields(blob: bytes) -> int:
    """The small fields of a blob coded in rANS containers (one decode call each on a card)."""
    from rpcc_tpu_torch.codec.bitstream import unpack_bitstream

    packed = unpack_bitstream(blob, uniform=True)
    assert packed["residual_quantized"][0] == rans_codec.MAGIC_CTX and packed["contour_map"][0] == rans_codec.MAGIC_BITS
    return sum(v[0] in (rans_codec.MAGIC_CTX, rans_codec.MAGIC_DELTA) for k, v in packed.items()
               if k not in ("residual_quantized", "contour_map"))


# ------------------------------------------------------------------ owners hand their device over
def test_owners_hand_their_device_to_the_coder():
    from rpcc_tpu_torch.models.host_decoder import HostDecoder
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    lidar, cfg = lidar_config(LIDAR), CodecConfig(cluster_num=16)
    codec = RPCCCodec(lidar, cfg, "cpu")
    engine = BatchEngine(lidar, cfg, "cpu", batch_size=2, workers=1)
    try:
        assert codec.entropy.device == codec.device == torch.device("cpu")
        assert engine.entropy.device == engine.device == torch.device("cpu")
    finally:
        engine.close()
    assert HostDecoder(lidar, cfg).entropy.device is None  # the caller's explicit ask for the host


def test_codec_codes_on_its_device(monkeypatch):
    """``RPCCCodec``'s coder on a (faked) card: one encode call per coded
    field, one decode call for both big fields (and one per small rANS
    field), the host's bytes and range image."""
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    lidar = lidar_config("Velodyne64E")  # big fields past 32,768 symbols and 64K pixels: 'C' and 'N'
    codec = RPCCCodec(lidar, CodecConfig(cluster_num=16), "cpu")
    pc = synth_cloud_for(lidar, 3)
    blob, fields, _ = codec.compress(pc)
    _, ri, _ = codec.decompress(blob)
    calls = _fake_card(monkeypatch)
    codec.entropy.device = torch.device("cuda")  # the coder of a codec built on a card
    got, _, _ = codec.compress(pc)
    assert got == blob
    coded = [k for k, v in fields.items() if k != "contour_map" and v.dtype in (np.int16, np.uint16, np.int32)]
    assert sorted(calls) == sorted(["encode_streams_host"] * len(coded) + ["encode_contours_host"])
    calls.clear()
    _, ri_card, _ = codec.decompress(got)
    assert np.array_equal(ri_card, ri) and calls == ["decode_fields_host"] * (1 + _small_rans_fields(got))


def test_engine_codes_on_its_device(monkeypatch):
    """``BatchEngine``'s host-entropy containers on a (faked) card: one
    encode call per residual lane geometry, one for the contours, one per
    frame's sequence; the decode's big fields in one call; the host's bytes
    and range images.  With device entropy, the escape-overflow and 'Z'
    re-encodes take the engine's device."""
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    lidar = lidar_config("Velodyne64E")
    clouds, seeds = _frames(lidar, (1, 2)), [5, 6]
    engine = BatchEngine(lidar, CodecConfig(cluster_num=16, device_entropy=False), "cpu", batch_size=2, workers=2)
    try:
        res = engine.encode_frames(clouds, seeds)
        want = [b for b, _ in res]
        ris = engine.decode_range_images(want)
        calls = _fake_card(monkeypatch)
        engine.entropy.device = torch.device("cuda")
        got = [b for b, _ in engine.encode_frames(clouds, seeds)]
        groups = len({rans_codec._geometry(f["residual_quantized"].size) for _, f in res})
        assert got == want
        assert sorted(calls) == sorted(["encode_streams_host"] * (groups + len(clouds)) + ["encode_contours_host"])
        calls.clear()
        assert all(np.array_equal(a, b) for a, b in zip(engine.decode_range_images(got), ris))
        assert calls == ["decode_fields_host"] * (1 + sum(map(_small_rans_fields, got)))
    finally:
        engine.close()
    devices = []
    real = rans_codec.compress_delta_batch

    def record(arrays, lanes=None, device=None):
        devices.append(device)
        return real(arrays, lanes, device)

    monkeypatch.setattr(rans_codec, "compress_delta_batch", record)
    dengine = BatchEngine(lidar, CodecConfig(cluster_num=16), "cpu", batch_size=2, workers=1)
    try:
        dengine.encode_frames([c[:3000] for c in clouds], seeds)  # <= 32,768 returns: the 'Z' comparison
    finally:
        dengine.close()
    assert devices and all(d == torch.device("cpu") for d in devices)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_decompress_cli_hands_its_device_to_the_coder(tmp_path, monkeypatch, backend):
    """``decompress --decode_backend device`` decodes the big fields on
    ``--device``; ``host`` keeps the native host coder (device None)."""
    from rpcc_tpu_torch.cli import compress, decompress

    pc = synth_cloud_for(lidar_config(LIDAR), 3)
    src, blob, out = tmp_path / "f.bin", tmp_path / "f.rpcc", tmp_path / "rec.bin"
    np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(src)
    common = ["--lidar", LIDAR, "--device", "cpu", "--cluster_num", "16"]
    compress.main(["--input", str(src), "--output", str(blob), *common])
    devices = []
    real = rans_codec.batch_decode_big_fields

    def record(packed, device=None):
        devices.append(device)
        return real(packed, device)

    monkeypatch.setattr(rans_codec, "batch_decode_big_fields", record)
    decompress.main(["--input", str(blob), "--output", str(out), *common, "--decode_backend", backend])
    want = torch.device("cpu") if backend == "device" else None
    assert devices and all(d == want for d in devices) and out.stat().st_size > 0


# ------------------------------------------------------------------ the CPU never takes the card's path
def test_cpu_device_never_reaches_the_plain_versions(monkeypatch):
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    lidar = lidar_config(LIDAR)
    codec = RPCCCodec(lidar, CodecConfig(cluster_num=16), "cpu")
    pc = synth_cloud_for(lidar, 2)
    arrays = [_walk(n, n) for n in (100, 5000, 40000)]
    packed = [np.packbits(np.random.default_rng(s).random(64 * 2000) < 0.05) for s in range(2)]
    blob = codec.compress(pc)[0]
    _no_plain(monkeypatch)
    assert codec.compress(pc)[0] == blob
    codec.decompress(blob)
    for device in (None, "cpu", torch.device("cpu")):
        blobs = rans_codec.compress_batch(arrays, device)
        assert blobs[2][0] == rans_codec.MAGIC_CTX and blobs == [ref_codec.compress(a) for a in arrays]
        assert rans_codec.decompress_delta_batch(blobs, device) == [a.tobytes() for a in arrays]
        cnt = rans_codec.compress_contour_batch(packed, 64, 2000, device)
        assert all(c[0] == rans_codec.MAGIC_BITS for c in cnt)
        assert [rans_codec.decompress(c, device) for c in cnt] == [p.tobytes() for p in packed]
        big = [{"residual_quantized": r, "contour_map": c} for r, c in zip(blobs[1:], cnt)]
        assert rans_codec.batch_decode_big_fields(big, device) == ([a.tobytes() for a in arrays[1:]],
                                                                   [p.tobytes() for p in packed])


# ------------------------------------------------------------------ the environment changes nothing
_ENV_RUN = r"""
import hashlib, sys
import numpy as np
from rpcc_tpu_torch.codec import rans_codec
assert not hasattr(rans_codec, "_RANS_DEVICE")
rng = np.random.default_rng(0)
arrays = [np.cumsum(rng.integers(-3, 4, n)).astype(np.int16) for n in (100, 5000, 20000, 40000)]
packed = [np.packbits(rng.random(16 * 100) < 0.1) for _ in range(2)]
blobs = rans_codec.compress_delta_batch(arrays) + rans_codec.compress_contour_batch(packed, 16, 100)
assert rans_codec.decompress_delta_batch(blobs[:4]) == [a.tobytes() for a in arrays]
print(hashlib.sha256(b"".join(blobs)).hexdigest())
"""


def test_rpcc_rans_device_in_the_environment_changes_nothing():
    env = {k: v for k, v in os.environ.items() if k != "RPCC_RANS_DEVICE"}
    outs = {}
    for value in (None, "default", "cpu"):
        run_env = dict(env, **({} if value is None else {"RPCC_RANS_DEVICE": value}), CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, "-c", _ENV_RUN], cwd=ROOT, env=run_env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[value] = proc.stdout.strip()
    assert len(set(outs.values())) == 1 and len(outs[None]) == 64


# ------------------------------------------------------------------ divergence 33
@pytest.mark.parametrize("side", ["cpu", "card"])
def test_divergence_33_mixed_batch(monkeypatch, side):
    """A batch of a 20,000- and a 40,000-symbol frame: on the CPU the
    reference's bytes under ``cpu``, on the (faked) card its bytes under
    ``default`` (one geometry for the batch); either side's containers
    decode in both packages, and their sizes stay within 0.5%."""
    mixed = [_walk(20000, 7, step=1), _walk(40000, 8)]
    want = [a.tobytes() for a in mixed]
    host = rans_codec.compress_delta_batch(mixed)
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "cpu")
    assert host == ref_codec.compress_delta_batch(mixed)
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "default")
    card_ref = ref_codec.compress_delta_batch(mixed)
    if side == "cpu":
        got, other = host, card_ref
    else:
        _fake_card(monkeypatch)
        got, other = rans_codec.compress_delta_batch(mixed, device="cuda"), host
        assert got == card_ref
    assert got != other and got[1] == other[1]
    monkeypatch.setattr(ref_codec, "_RANS_DEVICE", "cpu")
    assert rans_codec.decompress_delta_batch(got) == ref_codec.decompress_delta_batch(got) == want
    rel = abs(sum(map(len, got)) - sum(map(len, other))) / sum(map(len, other))
    assert rel <= 0.005, rel


# ------------------------------------------------------------------ the staging-buffer wrappers
@pytest.mark.parametrize("T", [16, 64, 4000])
@pytest.mark.parametrize("L", [1, 16, 32])
def test_staged_wrappers_give_the_same_pieces(L, T):
    """The host-facing wrappers (one staging buffer, one workspace, one
    download) on the CPU give the pieces of the tensor path they replaced:
    the streams uploaded one tensor at a time and coded by the plain
    version, and each decoded group's symbols."""
    cap = L * T
    lengths = [cap, 0, 1, cap // 2 + 3] if T < 4000 else [cap, cap // 3]
    arrays = [_walk(n, n + L) for n in lengths]
    got = rans_device.encode_streams_host(arrays, L, T, "cpu")
    want = rans_device.encode_streams_plain(*rans_device.upload_streams(arrays, "cpu"), L, T)
    for name, a, b in zip(want._fields, got, want):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b.numpy()), name
    lanes = rans_codec.delta_lanes([rans_codec.ctx_container(got, i, L, T, n, np.int16) for i, n in enumerate(lengths)])
    H, W = 4, T - 3
    packed = np.stack([np.packbits(np.random.default_rng(s).random(H * W) < 0.2) for s in range(2)])
    cnt = rans_device.encode_contours_host(packed, H, W, "cpu")
    cnt_want = rans_device.encode_contour_field_plain(rans_device.upload_contours(packed, H, W, "cpu"))
    for name, a, b in zip(cnt_want._fields, cnt, cnt_want):
        assert np.array_equal(a, b.numpy()), name
    c_lanes = rans_codec.contour_lanes([rans_codec.bits_container(cnt, i, H, W) for i in range(2)])[0]
    sym_r, sym_c = rans_device.decode_fields_host(lanes[:5], c_lanes[:5], lanes.mode, "cpu")
    for sym, g in ((sym_r, lanes), (sym_c, c_lanes)):
        plain = rans_device.decode_streams_plain(*rans_device.upload_decode_lanes(*g[:5], "cpu"), g.mode)
        assert sym.dtype == np.int32 and np.array_equal(sym, plain.numpy())
    assert np.array_equal(rans_device.decode_fields_host(None, c_lanes[:5], rans_device.MODE_ZIGZAG, "cpu")[1], sym_c)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 64, 4000])
@pytest.mark.parametrize("L", [1, 16, 32])
def test_cuda_staged_wrappers_equal_the_kernel_on_uploaded_tensors(cuda_device, L, T):
    """On the card the staged wrappers give the pieces and symbols of the
    kernels launched on tensors uploaded one at a time, one launch each."""
    lengths = [L * T, 0, 1, L * T // 2 + 3]
    arrays = [_walk(n, n + L) for n in lengths]
    before = timer.counters()
    got = rans_device.encode_streams_host(arrays, L, T, cuda_device)
    assert timer.counters_since(before).get("launch.rans_encode", 0) == 1
    q, n = rans_device.upload_streams(arrays, cuda_device)
    want = rans_device.encode_fields_cuda(q, n, None, lanes=L, T=T)[0]
    for name, a, b in zip(want._fields, got, want):
        assert np.array_equal(a, b.cpu().numpy()), name
    H, W = 64, 2000
    packed = np.stack([np.packbits(np.random.default_rng(s).random(H * W) < 0.05) for s in range(3)])
    cnt = rans_device.encode_contours_host(packed, H, W, cuda_device)
    cnt_want = rans_device.encode_fields_cuda(None, None, rans_device.upload_contours(packed, H, W, cuda_device))[1]
    for name, a, b in zip(cnt_want._fields, cnt, cnt_want):
        assert np.array_equal(a, b.cpu().numpy()), name
    words, counts, states = (np.asarray(x) for x in (got.words.view(np.uint16), got.counts, got.states))
    lanes = (words.reshape(len(arrays), L, T), counts, states.astype(np.uint32),
             np.stack([np.clip(m - np.arange(L) * T, 0, T) for m in lengths]).astype(np.int32), got.freqs)
    before = timer.counters()
    sym, _ = rans_device.decode_fields_host(lanes, None, rans_device.MODE_ZIGZAG, cuda_device)
    assert timer.counters_since(before).get("launch.rans_decode", 0) == 1
    plain = rans_device.decode_fields_cuda(rans_device.upload_decode_lanes(*lanes, cuda_device), None)[0]
    assert np.array_equal(sym, plain.cpu().numpy())
