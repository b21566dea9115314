"""The rANS coder's bzip2 (``rans_codec._bzip2``): a one-block input coded
at block size 1 with the header's digit written as 9, which is
``bz2.compress``'s stream (block size 9) byte for byte.

On the CPU: ``_bzip2`` == ``bz2.compress`` for empty, short, random,
periodic and run-length-heavy inputs at and past its bound; the single-frame
codec's payloads (VLP-16 and HDL-64E sweeps, a short sweep where 'Z' is
tried, one past the kernel's escape list, the HDL-32E channel table with
DBSCAN and salience levels) and the CPU engine's equal those made with
``bz2.compress`` in its place, and every ``_bzip2`` call of them is within
its bound.

On the card (``python -m pytest -m cuda tests/test_torch_codec_bzip2.py``),
in the benchmark's three configurations (the 64E default, the 32E channel
table with DBSCAN and non-uniform steps, the 64E with plane models) over 8
sweeps each, one with its far returns dropped: the codec's payloads and the
engine's B = 8 payloads equal those made with ``bz2.compress``; a short and
an escape-overflow sweep likewise, and decode back within the step.

Tolerances: none.  Integer coding is exact, so every payload equals its
reference byte for byte.

The module imports nothing from ``tests`` (a site-installed package of
that name can shadow the repository's).
"""

import bz2

import numpy as np
import pytest
import torch

from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.config import CodecConfig
from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.parallel.engine import BatchEngine

torch.set_num_threads(1)

DROP_FAR_M = 26.0  # the benchmark's drop-far range
BOUND = rans_codec._BZ_ONE_BLOCK_BYTES


def _walk(n: int, seed: int, step: int, dtype=np.int16) -> np.ndarray:
    w = np.cumsum(np.random.default_rng(seed).integers(-step, step + 1, n))
    return (w % 60000 if dtype == np.uint16 else w).astype(dtype)


def _nearest(pc: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` returns of ``pc`` nearest the sensor: a sweep of at most n residuals."""
    return pc[np.argsort(np.linalg.norm(pc, axis=1))[:n]]


def _drop_far(pc: np.ndarray) -> np.ndarray:
    return pc[np.linalg.norm(pc, axis=1) < DROP_FAR_M]


def _runs_of_four(n: int) -> bytes:
    """n bytes in runs of exactly 4: bzip2's first pass writes each as 5 bytes."""
    return np.repeat(np.arange(-(-n // 4)) % 2 * 255, 4)[:n].astype(np.uint8).tobytes()


def _periodic(n: int, period: int, seed: int) -> bytes:
    """n bytes repeating one random chunk: rotations of the block tie in
    bzip2's sort."""
    chunk = np.random.default_rng(seed).integers(0, 256, period, dtype=np.uint8).tobytes()
    return (chunk * (n // period + 1))[:n]


@pytest.mark.parametrize(
    "kind, n",
    [("empty", 0), ("byte", 1), ("zeros", 1000), ("random", 3000), ("u16_walk", 3000), ("f32_table", 1616),
     ("random", BOUND), ("runs_of_four", BOUND), ("runs_of_four", BOUND + 8), ("zeros", 200000),
     ("periodic_3", 60000), ("periodic_997", BOUND)],
)
def test_bzip2_equals_block_size_nine(kind, n):
    """``rans_codec._bzip2`` == ``bz2.compress`` (block size 9) byte for
    byte, coded at block size 1 up to ``_BZ_ONE_BLOCK_BYTES``; past it a
    block-size-1 stream would differ (the runs of four fill a second
    block), so it codes at 9."""
    rng = np.random.default_rng(n)
    data = {
        "empty": b"", "byte": b"\x07", "zeros": bytes(n), "random": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
        "u16_walk": _walk(n // 2, 3, 40, np.uint16).tobytes(),
        "f32_table": rng.standard_normal(n // 4).astype(np.float32).tobytes(), "runs_of_four": _runs_of_four(n),
        "periodic_3": _periodic(n, 3, 5), "periodic_997": _periodic(n, 997, 6),
    }[kind]
    assert rans_codec._bzip2(data) == bz2.compress(data)
    if kind == "runs_of_four" and n > BOUND:
        one = bz2.compress(data, 1)
        assert one[:3] + b"9" + one[4:] != bz2.compress(data)


def _config(mode, accuracy=None):
    if mode == "dbscan_nonuniform":
        return lidar_config("Velodyne32E", VELODYNE_32E_CSV), CodecConfig(
            segment_method="DBSCAN", compress_framework="non-uniform")
    lidar = lidar_config("VelodyneVLP16" if mode == "vlp16" else "Velodyne64E")
    kw = {} if accuracy is None else {"accuracy": accuracy}
    if mode == "plane":
        kw.update(modeling_method="plane", plane_angle_threshold=75.0)
    return lidar, CodecConfig(**kw)


def _watched(monkeypatch, calls):
    """``rans_codec._bzip2``, its input lengths appended to ``calls``."""
    real = rans_codec._bzip2

    def bzip2(data):
        calls.append(len(data))
        return real(data)

    monkeypatch.setattr(rans_codec, "_bzip2", bzip2)


def _with_block_size_nine(monkeypatch, make):
    """``make()`` with ``bz2.compress`` in ``_bzip2``'s place."""
    with monkeypatch.context() as m:
        m.setattr(rans_codec, "_bzip2", bz2.compress)
        return make()


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize(
    "mode, accuracy, sweep",
    [("vlp16", None, "full"), ("default", None, "full"), ("default", None, "short"),
     ("default", 0.0001, "full"), ("dbscan_nonuniform", None, "drop_far")],
)
def test_codec_payload_equals_block_size_nine(monkeypatch, mode, accuracy, sweep):
    """A CPU codec's payload with ``_bzip2`` == with ``bz2.compress``:
    the sequence's and model table's bzip2, the 'Z' container of a short
    stream (VLP-16, the short sweep), a VLP-16 contour's plain bzip2, an
    escape-overflow residual (a tiny accuracy) and the salience levels."""
    lidar, cfg = _config(mode, accuracy)
    codec = RPCCCodec(lidar, cfg, "cpu")
    pc = synth_cloud_for(lidar, 5)
    pc = {"full": pc, "short": _nearest(pc, 30000), "drop_far": _drop_far(pc)}[sweep]
    calls = []
    _watched(monkeypatch, calls)
    blob, fields, _ = codec.compress(pc, seed=11)
    want, want_fields, _ = _with_block_size_nine(monkeypatch, lambda: codec.compress(pc, seed=11))
    assert blob == want
    assert all(np.array_equal(fields[k], want_fields[k]) for k in want_fields)
    assert calls and max(calls) <= BOUND
    if sweep == "short":
        assert fields["residual_quantized"].size <= rans_codec.BZD_TRY_MAX_SYMBOLS


def test_cpu_engine_payloads_equal_block_size_nine(monkeypatch):
    """The CPU engine's payloads over a batch with ``_bzip2`` == with
    ``bz2.compress``."""
    lidar, cfg = _config("vlp16")
    engine = BatchEngine(lidar, cfg, "cpu", batch_size=3, workers=1)
    pcs = [synth_cloud_for(lidar, s) for s in (1, 2)] + [_drop_far(synth_cloud_for(lidar, 3))]
    calls = []
    _watched(monkeypatch, calls)
    got = [blob for blob, _ in engine.encode_frames(pcs, seeds=[7, 8, 9])]
    want = _with_block_size_nine(monkeypatch, lambda: [b for b, _ in engine.encode_frames(pcs, seeds=[7, 8, 9])])
    assert got == want
    assert calls and max(calls) <= BOUND


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_codec_bzip2.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "dbscan_nonuniform", "plane"])
def test_cuda_payloads_equal_block_size_nine(cuda_device, monkeypatch, mode):
    """Eight sweeps (one with its far returns dropped) through the codec and
    through the engine at B = 8 on the card: every payload with ``_bzip2``
    == with ``bz2.compress``."""
    lidar, cfg = _config(mode)
    codec = RPCCCodec(lidar, cfg, cuda_device)
    engine = BatchEngine(lidar, cfg, cuda_device, batch_size=8)
    pcs = [synth_cloud_for(lidar, s) for s in range(8)]
    pcs[3] = _drop_far(pcs[3])
    seeds = list(range(11, 19))

    def both():
        return ([codec.compress(pc, seed=s)[0] for pc, s in zip(pcs, seeds)],
                [b for b, _ in engine.encode_frames(pcs, seeds=seeds)])

    both()  # warm-up: the graphs' eager calls
    got = both()
    want = _with_block_size_nine(monkeypatch, both)
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["short", "escape_overflow"])
def test_cuda_short_and_overflow_sweeps(cuda_device, monkeypatch, sweep):
    """A sweep of at most 32,768 residuals ('Z' and plain bzip2 tried) and
    one past the kernel's escape list (a tiny accuracy) on the card: the
    payload with ``_bzip2`` == with ``bz2.compress``, and ``decompress``
    gives the range image back within the step."""
    lidar, cfg = _config("default", 0.0001 if sweep == "escape_overflow" else None)
    codec = RPCCCodec(lidar, cfg, cuda_device)
    pc = synth_cloud_for(lidar, 9)
    if sweep == "short":
        pc = _nearest(pc, 30000)
    blob, fields, _ = codec.compress(pc, seed=3)
    assert blob == _with_block_size_nine(monkeypatch, lambda: codec.compress(pc, seed=3)[0])
    if sweep == "short":
        assert fields["residual_quantized"].size <= rans_codec.BZD_TRY_MAX_SYMBOLS
    _, ri, _ = codec.decompress(blob)
    q, d = codec.project(pc)
    ri_in = q.astype(np.float32) * d
    assert float(np.abs(ri - ri_in).max()) <= cfg.step + 1e-5
    assert bool((ri[ri_in == 0] == 0).all())
