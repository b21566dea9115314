"""The port's point-cloud entry (``make_encoder`` / ``make_batch_encoder``
with ``from_ri=False``, ``Encoder.encode_points``) against itself and
against ``rpcc_tpu``'s ``build_encode_fn(lidar, cfg)`` on raw points (CPU).

Tolerances and why:
  * against the port's own from-ri encoder on its own in-graph range image
    (delta 1): every output exact, the device-entropy pieces included;
  * fed the reference's own in-graph range image, the tiers of
    tests/test_torch_codec.py: seg ids, contour and run values exact, the
    model table within rtol 1e-4, a residual within 1 and only in a cluster
    whose model row differs;
  * end to end, each package encoding its own points (its own projection:
    depths an ulp or two apart, ROADMAP 3.2): every blob decodes in both
    packages within step + 1e-5 of its encoder's range image, zero pixels
    exact, and the two packages' bpp within 0.5%;
  * a zero-padded batch of uneven clouds: each frame's outputs equal its
    B = 1 encode exactly.

The module imports nothing from ``tests`` (the card's machine has a
site-installed package of that name).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rpcc_tpu import config as ref_config
from rpcc_tpu.codec.bitstream import pack_bitstream as ref_pack_bitstream
from rpcc_tpu.models.encoder import build_encode_fn
from rpcc_tpu.models.pipeline import RPCCCodec as RefCodec
from rpcc_tpu_torch.codec.bitstream import pack_bitstream
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.models.encoder import Encoder, make_batch_encoder, make_encoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops.projection_host import build_transform_map
from rpcc_tpu_torch.ops.stream import stream_sort
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

EVEN = LidarConfig(name="small64", horizontal_fov_deg=360.0, vertical_angle_max_deg=2.0,
                   vertical_angle_min_deg=-24.9, height=16, width=256)
TABLE = dataclasses.replace(EVEN, name="small-table",
                            vertical_angles_deg=tuple(float(a) for a in np.linspace(2.0, -24.9, 16) ** 3 / 24.9 ** 2))
BPP_TOL = 0.005
SEED = 3
MODES = {
    "default": (EVEN, {}),
    "dbscan": (EVEN, dict(segment_method="DBSCAN")),
    "table": (TABLE, {}),
}


def scene(lidar, seed):
    """A street scene ray-cast on the LiDAR's scan grid (chip_smoke.py)."""
    return chip_smoke.scene_cloud(np, build_transform_map(lidar), seed)


def ref_cfg(cfg):
    return ref_config.CodecConfig(**dataclasses.asdict(cfg))


def ref_lidar(lidar):
    return ref_config.LidarConfig(**dataclasses.asdict(lidar))


@functools.lru_cache(maxsize=None)
def _ref_encode(mode, device_entropy=False):
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, device_entropy=device_entropy, **over)
    fn = jax.jit(build_encode_fn(ref_lidar(lidar), ref_cfg(cfg)))
    return fn(scene(lidar, 10), np.uint32(SEED), np.float32(cfg.step))


def _assert_outputs_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if isinstance(x, tuple):  # a piece tuple
            assert all(torch.equal(u, v) for u, v in zip(x, y)), name
        elif x is not None:
            assert torch.equal(x, y), name


def _blob(codec, out, fields_from, pack):
    fields = fields_from(out)
    return pack(codec.entropy.compress_dict(fields), uniform=True), fields


@pytest.mark.parametrize("mode", list(MODES))
def test_points_entry_equals_own_from_ri_encoder(mode):
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, **over)  # device entropy on: its pieces too
    encode = make_encoder(lidar, cfg, from_ri=False, device="cpu")
    pc = scene(lidar, 10)
    out = encode(pc, SEED, cfg.step)
    assert out.range_image.shape == (lidar.height, lidar.width) and out.residual_pieces is not None
    ri = out.range_image.clone()
    enc = make_encoder(lidar, cfg, from_ri=True, device="cpu")
    assert isinstance(enc, Encoder)
    _assert_outputs_equal(out, enc(ri, torch.tensor(1.0), SEED, cfg.step))
    _assert_outputs_equal(out, encode(pc, SEED, cfg.step))


@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_on_reference_range_image_meets_codec_tiers(mode):
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, device_entropy=False, **over)
    ref = _ref_encode(mode)
    enc = Encoder.for_lidar(lidar, cfg)
    out = enc(torch.from_numpy(np.array(ref.range_image)), torch.tensor(1.0), SEED, cfg.step)
    n, m = int(ref.stream_len), int(ref.seq_len)
    assert int(out.stream_len) == n and int(out.seq_len) == m
    np.testing.assert_array_equal(out.seg_idx.numpy(), np.asarray(ref.seg_idx))
    np.testing.assert_array_equal(out.contour_packed.numpy(), np.asarray(ref.contour_packed))
    np.testing.assert_array_equal(out.sequence.numpy()[:m], np.asarray(ref.sequence)[:m])
    np.testing.assert_allclose(out.model_param.numpy(), np.asarray(ref.model_param), rtol=1e-4, atol=1e-5)
    dq = out.stream.numpy()[:n].astype(np.int32) - np.asarray(ref.stream)[:n]
    order, _ = stream_sort(out.seg_idx.reshape(-1), [], enc.num_models)
    row_differs = (out.model_param.numpy() != np.asarray(ref.model_param)).any(1)
    assert np.abs(dq).max() <= 1
    assert row_differs[order.seg.numpy()[:n][dq != 0]].all()


@functools.lru_cache(maxsize=None)
def _cross(mode):
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, device_entropy=False, **over)
    port, ref = RPCCCodec(lidar, cfg, "cpu"), RefCodec(ref_lidar(lidar), ref_cfg(cfg))
    out = make_encoder(lidar, cfg, device="cpu")(scene(lidar, 10), SEED, cfg.step)
    ref_out = _ref_encode(mode)
    blob, fields = _blob(port, out, port.fields_from_device, pack_bitstream)
    ref_blob, ref_fields = _blob(ref, ref_out, ref.fields_from_device, ref_pack_bitstream)
    return dict(cfg=cfg, port=port, ref=ref, blob=blob, fields=fields, ri=out.range_image.numpy(),
                ref_blob=ref_blob, ref_fields=ref_fields, ref_ri=np.asarray(ref_out.range_image))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", ["port->port", "port->ref", "ref->port", "ref->ref"])
def test_points_blobs_cross_decode(mode, route):
    run = _cross(mode)
    src, dst = route.split("->")
    blob, ri = (run["blob"], run["ri"]) if src == "port" else (run["ref_blob"], run["ref_ri"])
    _, ri_rec, _ = run[dst].decompress(blob)
    assert np.abs(ri_rec - ri).max() <= run["cfg"].step + 1e-5
    assert (ri_rec[ri == 0] == 0).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_points_bpp_close_to_reference(mode):
    run = _cross(mode)
    bpp = len(run["blob"]) * 8 / run["fields"]["residual_quantized"].size
    ref_bpp = len(run["ref_blob"]) * 8 / run["ref_fields"]["residual_quantized"].size
    print(f"{mode}: bpp port {bpp:.5f} ref {ref_bpp:.5f}, blobs equal {run['blob'] == run['ref_blob']}")
    assert abs(bpp - ref_bpp) <= BPP_TOL * ref_bpp


@pytest.mark.parametrize("mode", ["default", "table"])
def test_batch_of_uneven_clouds_equals_single_frames(mode):
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, **over)
    frames = [scene(lidar, 11), scene(lidar, 12)[::2], scene(lidar, 13)[:500]]
    n = max(f.shape[0] for f in frames) + 5
    batch = np.zeros((len(frames), n, 3), np.float32)
    for b, f in enumerate(frames):
        batch[b, : f.shape[0]] = f
    seeds = [4, 5, 6]
    out = make_batch_encoder(lidar, cfg, device="cpu")(batch, seeds, cfg.step)
    single = make_encoder(lidar, cfg, device="cpu")
    for b, f in enumerate(frames):
        _assert_outputs_equal(out.map(lambda x: x[b]), single(f, seeds[b], cfg.step))


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (make_encoder, make_batch_encoder):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_encoder(EVEN, CodecConfig())
    with pytest.raises(ValueError, match="points must be"):
        make_encoder(EVEN, CodecConfig(), device="cpu")(np.zeros((4, 2), np.float32), 0, 0.04)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_points_encoder.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_points_encode_matches_cpu(cuda_device, mode):
    """On the card: one FPS (or DBSCAN) wrapper call and one rANS launch
    per encode, repeat encodes identical, and the card's blob decodes on
    the CPU within the bound with its bpp within 0.5% of the CPU encode's."""
    lidar, over = MODES[mode]
    cfg = CodecConfig(cluster_num=16, **over)
    pc = scene(lidar, 10)
    encode = make_encoder(lidar, cfg, device=cuda_device)
    encode(pc, SEED, cfg.step)
    torch.cuda.synchronize()
    before = timer.counters()
    out = encode(pc, SEED, cfg.step)
    torch.cuda.synchronize()
    seg = "dbscan" if cfg.segment_method == "DBSCAN" else "fps"
    n = timer.counters_since(before)
    launches = {k: n.get("launch." + c, 0) for k, c in (("fps", "fps"), ("dbscan", "dbscan"), ("rans", "rans_encode"))}
    assert launches == {"fps": 0, "dbscan": 0, "rans": 1, seg: 1}
    _assert_outputs_equal(out, encode(pc, SEED, cfg.step))

    host_cfg = cfg.replace(device_entropy=False)
    blobs = {}
    for dev in (cuda_device, "cpu"):
        codec = RPCCCodec(lidar, host_cfg, "cpu")
        o = make_encoder(lidar, host_cfg, device=dev)(pc, SEED, cfg.step)
        o = type(o)(*(None if x is None else x.cpu() for x in o))
        blobs[str(dev)] = _blob(codec, o, codec.fields_from_device, pack_bitstream) + (o.range_image.numpy(),)
    codec = RPCCCodec(lidar, host_cfg, "cpu")
    for blob, fields, ri in blobs.values():
        _, ri_rec, _ = codec.decompress(blob)
        assert np.abs(ri_rec - ri).max() <= cfg.step + 1e-5
    bpp = {k: len(b) * 8 / f["residual_quantized"].size for k, (b, f, _) in blobs.items()}
    assert abs(bpp[str(cuda_device)] - bpp["cpu"]) <= BPP_TOL * bpp["cpu"]
