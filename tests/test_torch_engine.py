"""The port's batch engine against ``rpcc_tpu``'s on the CPU.

Both engines encode the same ragged set of 5 SMALL frames (the port at
batch 3: 3 + 2, with host entropy coding and with device entropy coding;
``rpcc_tpu``'s u16-snap, host-entropy engine at batch 8, padded).
Tolerances and why:
  * cross-decode both ways within step + 1e-5 (step + max level delta in
    non-uniform mode) of the encoder's range image, zero pixels exact: the
    codec's contract (tests/test_roundtrip.py);
  * aggregate bpp within 0.5% of ``rpcc_tpu``'s: f32 last bits of a model
    row or an FMA-broken tie may move a residual (tests/test_torch_codec.py);
    within 2% with device entropy (``tests/test_engine.py:109``: its
    containers keep the grid's lane length, not the frame's);
  * the port's host decoder gives ``rpcc_tpu``'s host decoder's floats bit
    for bit (same native kernel, same tables), and the port's device
    decoder gives the host decoder's floats bit for bit (it gathers the
    same rays);
  * the pipeline gives the synchronous path's bytes and points exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.models.host_decoder import HostDecoder as RefHostDecoder
from rpcc_tpu.parallel import BatchEngine as RefEngine
from rpcc_tpu_torch.models.host_decoder import HostDecoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.parallel.aggregate import batch_report, batch_totals
from rpcc_tpu_torch.parallel.engine import BatchEngine
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPP_TOL = {False: 0.005, True: 0.02}  # by device_entropy
SEEDS = [4, 5, 6, 7, 8]
MODES = {"uniform": {}, "nonuniform": dict(compress_framework="non-uniform")}
ENTROPY = {"host_entropy": False, "device_entropy": True}
_REF_RUNS = {}  # mode -> rpcc_tpu's engine results, shared by both entropy settings


def _bound(cfg):
    return (cfg.step if cfg.uniform else cfg.step + max(cfg.level_delta_acc)) + 1e-5


@pytest.fixture(scope="module", params=[(m, e) for m in MODES for e in ENTROPY], ids=lambda p: p[0] if p[1] == "host_entropy" else "-".join(p))
def runs(request):
    mode, entropy = request.param
    cfg = CodecConfig(cluster_num=16, device_entropy=ENTROPY[entropy], **MODES[mode])
    clouds = [synth_scene(seed=s) for s in range(5)]
    port = BatchEngine(SMALL, cfg, "cpu", batch_size=3, workers=2)
    first, second = port.encode_frames(clouds[:3], SEEDS[:3]), port.encode_frames(clouds[3:], SEEDS[3:])
    port_res = first + second
    if mode not in _REF_RUNS:
        ref = RefEngine(SMALL, cfg.replace(transfer_precision="u16", device_entropy=False), batch_size=8, workers=2)
        _REF_RUNS[mode] = ref.encode_frames(clouds, SEEDS)
    ref_res = _REF_RUNS[mode]
    codec = RPCCCodec(SMALL, cfg, "cpu")
    ris = []
    for pc in clouds:
        q, d = codec.project(pc)
        ris.append(q.astype(np.float32) * d)
    yield dict(cfg=cfg, clouds=clouds, port=port, ris=ris,
               blobs=[b for b, _ in port_res], fields=[f for _, f in port_res],
               points=np.concatenate([first.stream_len, second.stream_len]),
               ref_blobs=[b for b, _ in ref_res], ref_fields=[f for _, f in ref_res])
    port.close()


def _assert_within_bound(decoded, ris, cfg):
    for rec, ri in zip(decoded, ris):
        assert np.abs(rec - ri).max() <= _bound(cfg)
        assert (rec[ri == 0] == 0).all()


def test_port_blobs_decode_with_rpcc_tpu(runs):
    _assert_within_bound(RefHostDecoder(SMALL, runs["cfg"]).decode_blobs(runs["blobs"]), runs["ris"], runs["cfg"])


def test_rpcc_tpu_blobs_decode_with_port_engine(runs):
    port = runs["port"]
    ris = np.concatenate([port._materialize_ris(port.decode_blobs_device(runs["ref_blobs"][i : i + 3]))[0]
                          for i in (0, 3)])
    _assert_within_bound(list(ris), runs["ris"], runs["cfg"])


def test_bpp_close_to_rpcc_tpu_engine(runs):
    """Point counts from the engine's staged stream lengths: with device
    entropy the fields hold no residual stream."""
    port = batch_report(batch_totals(runs["points"].tolist(), [len(b) for b in runs["blobs"]]))
    ref = batch_report(batch_totals([f["residual_quantized"].size for f in runs["ref_fields"]],
                                    [len(b) for b in runs["ref_blobs"]]))
    assert port["frames"] == ref["frames"] == 5 and port["points"] == ref["points"]
    if not runs["cfg"].device_entropy:
        assert [f["residual_quantized"].size for f in runs["fields"]] == runs["points"].tolist()
    print(f"bpp port {port['bpp']:.5f} rpcc_tpu {ref['bpp']:.5f}")
    assert abs(port["bpp"] - ref["bpp"]) <= BPP_TOL[runs["cfg"].device_entropy] * ref["bpp"]


def test_host_decoder_gives_reference_floats(runs):
    for blobs in (runs["blobs"], runs["ref_blobs"]):
        got = HostDecoder(SMALL, runs["cfg"]).decode_blobs(blobs)
        ref = RefHostDecoder(SMALL, runs["cfg"]).decode_blobs(blobs)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        got_pts = HostDecoder(SMALL, runs["cfg"]).decode_blobs_points(blobs)
        ref_pts = RefHostDecoder(SMALL, runs["cfg"]).decode_blobs_points(blobs)
        for a, b in zip(got_pts, ref_pts):
            np.testing.assert_array_equal(a, b)


def test_device_decode_equals_host_decode(runs):
    port = runs["port"]
    host = HostDecoder(SMALL, runs["cfg"]).decode_blobs_points(runs["blobs"])
    dev = port.decode_blobs_points(runs["blobs"][:3]) + port.decode_blobs_points(runs["blobs"][3:])
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a, b)
    clouds = port.decode_blobs(runs["blobs"][:3])
    assert clouds[0].shape == (SMALL.height, SMALL.width, 3)


def test_pipeline_equals_synchronous(runs):
    port = runs["port"]
    stats = {}
    batches = [(runs["clouds"][:3], SEEDS[:3]), (runs["clouds"][3:], SEEDS[3:])]
    blobs = [b for res in port.encode_pipeline(batches, stats=stats) for b, _ in res]
    assert blobs == runs["blobs"]
    assert stats["batches"] == 2 and stats["dispatch_s"] > 0 and "pool_entropy_cpu_s" in stats
    piped = [p for pts in port.decode_pipeline([blobs[:3], blobs[3:]]) for p in pts]
    for a, b in zip(piped, port.decode_blobs_points(blobs[:3]) + port.decode_blobs_points(blobs[3:])):
        np.testing.assert_array_equal(a, b)
    assert len(piped) == 5


def test_batch_size_and_seed_checks():
    engine = BatchEngine(SMALL, CodecConfig(cluster_num=16), "cpu", batch_size=2, workers=1)
    clouds = [synth_scene(seed=0)] * 3
    with pytest.raises(ValueError):
        engine.encode_frames(clouds)
    with pytest.raises(ValueError):
        engine.encode_frames(clouds[:2], [0, 2**32])
    assert len(engine.encode_frames(clouds[:1])) == 1  # the ring slot was handed back
    engine.close()


def test_engine_and_datalist_clis_never_import_jax():
    code = (
        "import sys\n"
        "import rpcc_tpu_torch.parallel.engine, rpcc_tpu_torch.parallel.prefetch\n"
        "import rpcc_tpu_torch.cli.compress_datalist, rpcc_tpu_torch.cli.decompress_datalist\n"
        "import rpcc_tpu_torch.models.host_decoder, rpcc_tpu_torch.data.pointcloud_io\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (m == 'jax' or m.startswith('jax.'))]\n"
        "print('ok' if not bad else bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok", proc.stdout
