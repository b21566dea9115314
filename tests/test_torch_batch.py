"""The port's batched graph on the CPU: a frame's results must not depend on
the batch it rides in.

  * ragged sets of 5 frames through the batch engine at batch 2 (2, 2, 1)
    and 5 give, per frame, the single-frame codec's ``.rpcc`` bytes with
    host entropy coding, and the batch-1 engine's with device entropy
    coding, in all five codec modes of tests/test_torch_codec.py;
  * batched threefry draws equal ``jax.vmap`` of ``jax.random`` bit for bit;
  * the batched DBSCAN plain version equals its per-frame runs;
  * the batched ``fit_plane_weighted`` equals its per-frame runs bit for bit
    (its sums are fixed-order; torch's ``.sum`` may pick its association
    from the tensor's shape);
  * the batched decoder equals its per-frame runs.

Inputs are made with numpy from seeds.
"""

import jax
import numpy as np
import pytest
import torch

from rpcc_tpu.codec.bitstream import unpack_bitstream
from rpcc_tpu.config import CodecConfig
from rpcc_tpu_torch.models.decoder import Decoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import dbscan, prng, ransac, stream
from rpcc_tpu_torch.parallel.engine import BatchEngine
from tests.test_roundtrip import SMALL, synth_scene
from tests.test_torch_codec import MODES

torch.set_num_threads(1)

SEEDS = [0, 1, 12345, 2**32 - 1, 7]


@pytest.fixture(scope="module", params=list(MODES))
def mode(request):
    cfg = CodecConfig(cluster_num=16, **MODES[request.param])
    clouds = [synth_scene(seed=s) for s in range(5)]
    seeds = [3 * s + 1 for s in range(5)]
    codec = RPCCCodec(SMALL, cfg, "cpu")
    singles = [codec.compress(pc, seed=s)[0] for pc, s in zip(clouds, seeds)]
    return dict(cfg=cfg, clouds=clouds, seeds=seeds, singles=singles)


def _engine_blobs(cfg, mode, batch):
    engine = BatchEngine(SMALL, cfg, "cpu", batch_size=batch, workers=2)
    try:
        blobs = []
        for i in range(0, 5, batch):
            res = engine.encode_frames(mode["clouds"][i : i + batch], mode["seeds"][i : i + batch])
            blobs += [b for b, _ in res]
    finally:
        engine.close()
    return blobs


@pytest.mark.parametrize("batch", [2, 5])
def test_batched_blobs_equal_single_frame(mode, batch):
    blobs = _engine_blobs(mode["cfg"].replace(device_entropy=False), mode, batch)
    assert [b == s for b, s in zip(blobs, mode["singles"])] == [True] * 5


@pytest.mark.parametrize("batch", [2, 5])
def test_batched_device_entropy_blobs_equal_batch_one(mode, batch):
    cfg = mode["cfg"].replace(device_entropy=True)
    blobs, ones = _engine_blobs(cfg, mode, batch), _engine_blobs(cfg, mode, 1)
    assert [b == s for b, s in zip(blobs, ones)] == [True] * 5


@pytest.mark.parametrize("shape", [(), (7,), (100, 10), (20000,)])
def test_batched_draws_equal_vmap(shape):
    seeds = np.asarray(SEEDS, np.uint32)
    jk = jax.vmap(jax.random.PRNGKey)(seeds)
    tk = prng.prng_key(seeds.astype(np.int64).tolist(), "cpu")
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    j_split = jax.vmap(jax.random.split)(jk)
    t_split = prng.split(tk)
    np.testing.assert_array_equal(np.asarray(j_split).astype(np.int64), t_split.numpy())
    ju = jax.vmap(lambda k: jax.random.uniform(k, shape))(j_split[:, 1])
    tu = prng.uniform(t_split[:, 1], shape)
    np.testing.assert_array_equal(np.asarray(ju).view(np.int32), tu.numpy().view(np.int32))
    jr = jax.vmap(lambda k: jax.random.randint(k, shape, 0, 6))(j_split[:, 0])
    np.testing.assert_array_equal(np.asarray(jr), prng.randint(t_split[:, 0], shape, 0, 6).numpy())
    for b in range(len(SEEDS)):  # each row is the single-key draw
        np.testing.assert_array_equal(tu[b].numpy(), prng.uniform(t_split[b, 1], shape).numpy())


def _dbscan_frames():
    """Three 16x128 frames: random blobs (some across the seam), one long
    wall, one all-inactive frame."""
    H, W = 16, 128
    pcs = np.zeros((3, H, W, 3), np.float32)
    active = np.zeros((3, H, W), bool)
    rng = np.random.default_rng(11)
    for _ in range(5):
        ctr = rng.uniform(-30, 30, 3)
        r0, c0 = int(rng.integers(1, H - 5)), int(rng.integers(0, W))
        for r in range(r0, r0 + 4):
            for c in range(c0, c0 + 10):
                pcs[0, r, c % W] = ctr + [0.245 * (c - c0), 0.3 * (r - r0), 0] + rng.normal(0, 0.02, 3)
                active[0, r, c % W] = True
    for r in (7, 8):
        for c in range(10, 120):
            pcs[1, r, c] = [0.245 * c, 14.0, 0.3 * r]
            active[1, r, c] = True
    pcs[2] = rng.uniform(-20, 20, (H, W, 3))
    return torch.from_numpy(np.ascontiguousarray(np.transpose(pcs, (0, 3, 1, 2)))), torch.from_numpy(active)


def test_batched_dbscan_equals_per_frame():
    planes, active = _dbscan_frames()
    raw = dbscan.dbscan_labels(planes, active, 1.2)
    ids = dbscan.dbscan_range_image(planes, active, 1.2, 8)
    assert raw.shape == active.shape and raw.dtype == torch.int32
    for b in range(3):
        torch.testing.assert_close(raw[b], dbscan.dbscan_labels(planes[b], active[b], 1.2), rtol=0, atol=0)
        torch.testing.assert_close(ids[b], dbscan.dbscan_range_image(planes[b], active[b], 1.2, 8), rtol=0, atol=0)
    assert (raw[2] == 16 * 128).all() and (ids[0] >= dbscan.FIRST_CLUSTER_ID).any()


def test_batched_plane_fit_bit_equal():
    """The repair's test: the batched fit equals each frame's own fit."""
    rng = np.random.default_rng(2)
    pts = torch.from_numpy((rng.normal(size=(6, 5000, 3)) * [20.0, 20.0, 0.3]).astype(np.float32))
    w = torch.from_numpy((rng.uniform(size=(6, 5000)) > 0.3).astype(np.float32))
    batched = ransac.fit_plane_weighted(pts, w)
    for b in range(6):
        np.testing.assert_array_equal(batched[b].numpy(), ransac.fit_plane_weighted(pts[b], w[b]).numpy())
    # The fixed-order sum itself: independent of the other rows and of padding.
    x = torch.from_numpy(rng.normal(size=(4, 4133)).astype(np.float32))
    total = stream.fixed_order_sum(x)
    for b in range(4):
        assert stream.fixed_order_sum(x[b]).item() == total[b].item()
    np.testing.assert_allclose(total.numpy(), x.double().sum(-1).numpy(), rtol=1e-5)


def test_ground_plane_batched_equals_single():
    pcs = [synth_scene(seed=s) for s in range(3)]
    codec = RPCCCodec(SMALL, CodecConfig(cluster_num=16), "cpu")
    q = torch.stack([torch.from_numpy(codec.project(pc)[0].astype(np.int32)) for pc in pcs])
    d = torch.tensor([codec.project(pc)[1] for pc in pcs])
    out = codec.encoder(q, d, [5, 6, 7], codec.cfg.step)
    for b in range(3):
        one = codec.encoder(q[b], d[b], 5 + b, codec.cfg.step)
        for name, got in out._asdict().items():
            if got is not None:
                np.testing.assert_array_equal(got[b].numpy(), getattr(one, name).numpy(), err_msg=name)


def test_batched_decoder_equals_per_frame():
    cfg = CodecConfig(cluster_num=16, compress_framework="non-uniform")
    codec = RPCCCodec(SMALL, cfg, "cpu")
    dec = Decoder(SMALL, cfg)
    fields = [
        codec.fields_to_device(codec.entropy.decompress_dict(
            unpack_bitstream(codec.compress(synth_scene(seed=s), seed=s)[0], uniform=False)))
        for s in range(3)
    ]
    pad = lambda xs: torch.nn.utils.rnn.pad_sequence(list(xs), batch_first=True)  # noqa: E731
    contour, seq, strm, models, sal = zip(*fields)
    out = dec(torch.stack(contour), pad(seq), pad(strm), torch.stack(models), cfg.level_acc, torch.stack(sal))
    for b in range(3):
        one = dec(*fields[b][:4], cfg.level_acc, fields[b][4])
        np.testing.assert_array_equal(out.range_image[b].numpy(), one.range_image.numpy())
