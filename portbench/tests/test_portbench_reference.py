"""The plain reference against the program on the CPU: its projection is
the program's, its decode of the program's payloads is the program's host
decoder's, bit for bit, and it refuses what it should."""

import numpy as np
import pytest

from portbench import bench, frames, reference

SPEC = bench.load_benchmark()
CONFIGS = [bench.load_config(SPEC, c["name"]) for c in SPEC["configs"]]
TRAFFIC = {"frames": 4, "drop_far_every": 4, "drop_far_m": 26.0}


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: c["name"])
def encoded(request):
    pytest.importorskip("rpcc_tpu_torch")
    from portbench.runners import program_config
    from rpcc_tpu_torch.models.pipeline import RPCCCodec
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    cfg = request.param
    lidar, codec = program_config(cfg)
    fs = frames.make_frames(cfg["lidar"], TRAFFIC, 2**32 + 3)
    eng = BatchEngine(lidar, codec, "cpu", 4, workers=2)
    try:
        blobs = [b for b, _ in eng.encode_frames(fs.clouds)]
    finally:
        eng.close()
    single = RPCCCodec(lidar, codec, "cpu").compress(fs.clouds[3])[0]
    return cfg, fs, blobs, single, lidar, codec


def test_projection_is_the_programs(encoded):
    cfg, fs, _, _, lidar, _ = encoded
    from rpcc_tpu_torch.ops.projection_host import project_points_host

    for cloud in fs.clouds:
        mine, theirs = reference.project(cloud, cfg["lidar"]), project_points_host(cloud, lidar)
        assert np.array_equal(mine != 0, theirs != 0)
        np.testing.assert_allclose(mine, theirs, rtol=1e-6)


def test_decode_is_the_host_decoders_bit_for_bit(encoded):
    cfg, fs, blobs, single, lidar, codec = encoded
    from rpcc_tpu_torch.models.host_decoder import HostDecoder

    want = HostDecoder(lidar, codec).decode_blobs(blobs + [single])
    got = reference.decode_payloads(blobs + [single], cfg["lidar"], cfg["codec"])
    for g, w in zip(got, want):
        assert g is not None and np.array_equal(g.range_image, w)
    for k, g in enumerate(got[:4]):
        chk = reference.depth_check(g.range_image, g.step, reference.project(fs.clouds[k], cfg["lidar"]), cfg["codec"])
        assert chk.occupancy_mismatch == 0 and chk.err_over_bound <= 1.001


def test_allowed_steps_are_the_programs_levels(encoded):
    # The reference works the salience levels out from the input alone; on
    # the program's own payloads it allows each pixel the step they state.
    cfg, fs, blobs, _, _, _ = encoded
    for k, d in enumerate(reference.decode_payloads(blobs, cfg["lidar"], cfg["codec"])):
        ref = reference.project(fs.clouds[k], cfg["lidar"])
        live = d.seg != 1
        assert live.sum() == (ref != 0).sum()
        assert np.array_equal(reference.allowed_step(ref, d.seg, cfg["codec"])[live], d.step[live])


def test_an_answer_left_unchecked_fails_the_run(encoded, monkeypatch):
    from types import SimpleNamespace

    from portbench import bench, judge

    cfg, fs, blobs, _, _, _ = encoded
    monkeypatch.setattr(judge, "MAX_DISTINCT", 1)
    record = SimpleNamespace(outputs=[(0, blobs[0]), (0, blobs[0][:-1])], missing=0)
    v = judge.judge(record, fs.clouds, cfg, bench.load_limits())
    assert all(x <= lim for x, lim in v.checks.values())
    assert v.failed == 1 and not v.correct


def test_broken_payloads_are_refused(encoded):
    cfg, fs, blobs, _, _, _ = encoded
    ref = reference.project(fs.clouds[0], cfg["lidar"])
    truncated = blobs[0][:-5]
    assert reference.decode_payloads([truncated], cfg["lidar"], cfg["codec"]) == [None]
    fields = reference.unpack_payload(blobs[0], cfg["codec"]["compress_framework"] == "uniform")
    off = blobs[0].index(fields["residual_quantized"]) + len(fields["residual_quantized"]) // 2
    flipped = blobs[0][:off] + bytes([blobs[0][off] ^ 0x40]) + blobs[0][off + 1:]
    d = reference.decode_payloads([flipped], cfg["lidar"], cfg["codec"])[0]
    assert d is None or reference.depth_check(d.range_image, d.step, ref, cfg["codec"]).err_over_bound > 2


def test_bf16_depths_fail_the_guarantee(encoded):
    cfg, fs, blobs, _, _, _ = encoded
    import torch

    d = reference.decode_payloads(blobs[:1], cfg["lidar"], cfg["codec"])[0]
    low = torch.from_numpy(d.range_image).to(torch.bfloat16).to(torch.float32).numpy()
    chk = reference.depth_check(low, d.step, reference.project(fs.clouds[0], cfg["lidar"]), cfg["codec"])
    assert chk.err_over_bound > 3
