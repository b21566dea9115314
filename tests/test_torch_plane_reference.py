"""Plane models: the port against the plain PyTorch reference
(``tests/plain_plane_reference.py``: R-PCC's per-cluster RANSAC planes, one
cluster at a time, in float32, nothing of the port imported).

  * the reference's threefry draws equal ``rpcc_tpu_torch.ops.prng``'s bit
    for bit, so both fit the same 10 x 4 samples of every cluster;
  * the encoder's model table, on seeded scenes at 16x256 (three seeds)
    and once at the HDL-64E's 64x2000, equals the reference's computed
    from the encoder's own range image, segmentation and seed: the same
    plane-or-point decisions, normals within 1e-5 and d within 1e-4 m, or
    the float32 turn of an ill-conditioned fit where that is larger
    (``compare``: another summation order and another eigen-solver, both
    in float32);
  * the engine's payloads decode within the guarantee, their plane rows
    are the reference's, and its ``stats`` and the ``models.*`` counters
    count the downloaded tables; the fit runs in three spans inside
    ``graph.models``;
  * the encoder fed bfloat16 inputs misses the reference's table computed
    from the float32 inputs;
  * on the card (``cuda``), the replayed graph's tables at 64x2000, B = 8.

The module imports nothing from ``tests`` (a site-installed package of
that name can shadow the repository's): the reference is loaded by path.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.encoder import Encoder, count_model_rows
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.projection_host import project_for_encoder
from rpcc_tpu_torch.parallel.engine import BatchEngine
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)


def _load_reference():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plain_plane_reference.py")
    spec = importlib.util.spec_from_file_location("plain_plane_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()
SMALL = LidarConfig("small16", 360.0, 2.0, -24.9, 16, 256)
SMALL_CFG = CodecConfig(modeling_method="plane", cluster_num=16)


def lidar_dict(lidar: LidarConfig) -> dict:
    return dict(height=lidar.height, width=lidar.width, horizontal_fov_deg=lidar.horizontal_fov_deg,
                vertical_angle_max_deg=lidar.vertical_angle_max_deg,
                vertical_angle_min_deg=lidar.vertical_angle_min_deg, vertical_angles_deg=lidar.vertical_angles_deg)


def _grid(lidar, cfg, cloud):
    q, d = project_for_encoder(cloud, lidar, cfg)
    return torch.from_numpy(q.astype(np.int32)), torch.tensor(d, dtype=torch.float32)


def _encode(lidar, cfg, cloud, seed):
    enc = Encoder.for_lidar(lidar, cfg)
    return enc(*_grid(lidar, cfg, cloud), seed, cfg.step)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, 2**32 - 1])
def test_threefry_draws_equal_the_ports(seed):
    key = prng.split(prng.prng_key(seed, "cpu"))[1]
    assert tuple(int(k) for k in key) == REF.model_key(seed)
    m = SMALL_CFG.cluster_num + 2
    want = prng.uniform(key, (m, REF.RANSAC_ITERS * REF.RANSAC_N))
    np.testing.assert_array_equal(REF.uniform(REF.model_key(seed), (m, REF.RANSAC_ITERS * REF.RANSAC_N)).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("case", ["16x256-0", "16x256-3", "16x256-9", "64x2000-1"])
def test_encoder_tables_equal_the_reference(case):
    size, seed = case.split("-")
    seed = int(seed)
    if size == "64x2000":
        lidar, cfg = lidar_config("Velodyne64E"), CodecConfig(modeling_method="plane")
    else:
        lidar, cfg = SMALL, SMALL_CFG
    out = _encode(lidar, cfg, synth_cloud_for(lidar, seed), seed)
    fit = REF.plane_models(out.range_image, out.seg_idx, seed, lidar_dict(lidar), cfg.cluster_num + 2,
                           cfg.plane_angle_threshold)
    res = REF.compare(out.model_param, fit, cfg.plane_angle_threshold)
    assert res["ok"], res
    assert res["planes"] >= res["clusters"] // 2 and res["decisions_equal"] == res["clusters"]


def test_prediction_of_a_plane_row_and_a_point_row():
    lidar = lidar_dict(SMALL)
    table = torch.zeros((3, 4))
    table[1] = torch.tensor([0.0, 0.0, 0.0, 12.5])
    table[2] = torch.tensor([0.0, 0.0, 1.0, 1.8])  # the ground at z = -1.8
    seg = torch.zeros((SMALL.height, SMALL.width), dtype=torch.int64)
    seg[:8] = 1
    seg[8:] = 2
    pred = REF.predict(table, seg, lidar)
    rays = REF.scan_rays(lidar)
    assert (pred[:8] == 12.5).all()
    np.testing.assert_allclose((pred[8:] * rays[2, 8:]).numpy(), -1.8, rtol=1e-6)


@pytest.fixture(scope="module")
def engine_run():
    lidar, cfg = SMALL, SMALL_CFG
    clouds = [synth_cloud_for(lidar, s) for s in range(6)]
    eng = BatchEngine(lidar, cfg, "cpu", batch_size=3)
    stats: dict = {}
    before = timer.counters()
    try:
        batches = [r for r in eng.encode_pipeline([(clouds[:3], [40, 41, 42]), (clouds[3:], [43, 44, 45])],
                                                  stats=stats)]
    finally:
        eng.close()
    return dict(lidar=lidar, cfg=cfg, clouds=clouds, batches=batches, stats=stats,
                counted=timer.counters_since(before))


def test_engine_payloads_round_trip_with_the_references_planes(engine_run):
    lidar, cfg = engine_run["lidar"], engine_run["cfg"]
    codec = RPCCCodec(lidar, cfg, "cpu")
    items = [item for batch in engine_run["batches"] for item in batch]
    for i, (blob, fields) in enumerate(items):
        cloud, seed = engine_run["clouds"][i], 40 + i
        _, ri_rec, _ = codec.decompress(blob)
        out = _encode(lidar, cfg, cloud, seed)
        ri = out.range_image.numpy()
        assert np.abs(ri_rec - ri).max() <= cfg.step / 2 + 1e-5
        assert (ri_rec[ri == 0] == 0).all()
        fit = REF.plane_models(out.range_image, out.seg_idx, seed, lidar_dict(lidar), cfg.cluster_num + 2)
        table = torch.from_numpy(fields["plane_param"])
        res = REF.compare(table, fit)
        assert res["ok"], (i, res)
        payload_planes = (table[2:, 0] + table[2:, 1] + table[2:, 2]) != 0
        assert torch.equal(payload_planes, fit.use_plane[2:]) and payload_planes.any()


def test_engine_stats_and_counters_count_the_tables(engine_run):
    rows = planes = 0
    for batch in engine_run["batches"]:
        t = np.stack([fields["plane_param"] for _, fields in batch])[:, 2:]
        r, p = int((t != 0).any(-1).sum()), int((t[..., 0] + t[..., 1] + t[..., 2] != 0).sum())
        assert batch.counts == {"model_rows": r, "plane_rows": p}
        rows, planes = rows + r, planes + p
    assert 0 < planes <= rows
    assert engine_run["stats"]["model_rows"] == rows and engine_run["stats"]["plane_rows"] == planes
    counted = engine_run["counted"]
    assert counted["models.rows"] >= rows and counted["models.plane_rows"] >= planes


def test_the_plane_fit_runs_in_three_spans_inside_graph_models():
    lidar, cfg = SMALL, SMALL_CFG
    with timer.recording() as rec:
        _encode(lidar, cfg, synth_cloud_for(lidar, 2), 2)
    models = rec.named("graph.models")
    assert len(models) == 1
    parts = [s.name for s in rec.spans if s.parent == models[0].id]
    assert parts == ["graph.models.hypotheses", "graph.models.refit", "graph.models.angle"]


def test_count_model_rows_reads_the_decoders_test():
    t = np.zeros((2, 5, 4), np.float32)
    t[0, 0] = [0.0, 0.0, 1.0, 3.0]  # the ground row: not a cluster
    t[0, 2] = [0.0, 0.0, 0.0, 7.5]  # a point row
    t[0, 3] = [0.6, 0.0, 0.8, -2.0]  # a plane
    t[1, 4] = [0.5, -0.5, 0.0, 1.0]  # a + b + c == 0: decoded as a point row
    before = timer.counters()
    assert count_model_rows(t) == (3, 1)
    assert timer.counters_since(before) == {"models.rows": 3, "models.plane_rows": 1}


def test_bf16_inputs_fail_the_tolerances():
    lidar, cfg, seed = SMALL, SMALL_CFG, 3
    cloud = synth_cloud_for(lidar, seed)
    bf = torch.from_numpy(cloud.astype(np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
    out = _encode(lidar, cfg, bf, seed)
    truth = _encode(lidar, cfg, cloud, seed).range_image
    fit = REF.plane_models(truth, out.seg_idx, seed, lidar_dict(lidar), cfg.cluster_num + 2)
    res = REF.compare(out.model_param, fit)
    assert not res["ok"]
    assert res["decisions_differ"] > 0 or max(res["max_d_dev"], res["max_mean_dev"]) > 100 * REF.D_TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_plane_reference.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_replayed_tables_on_the_card_equal_the_reference(cuda_device):
    """At 64x2000 and B = 8 on the card, the eager call, the capture and a
    replay give the same tables, and each frame's equals the reference's,
    computed on the card from the call's range image and segmentation."""
    lidar, cfg = lidar_config("Velodyne64E"), CodecConfig(modeling_method="plane")
    grids = [_grid(lidar, cfg, synth_cloud_for(lidar, s)) for s in range(8)]
    q = torch.stack([g[0] for g in grids]).to(cuda_device)
    d = torch.stack([g[1] for g in grids]).to(cuda_device)
    seeds = [1000 + s for s in range(8)]
    enc = Encoder.for_lidar(lidar, cfg).to(cuda_device)
    outs = [enc(q, d, seeds, cfg.step) for _ in range(3)]
    torch.cuda.synchronize(cuda_device)
    assert enc._captures and all(torch.equal(o.model_param, outs[0].model_param) for o in outs[1:])
    for b in range(8):
        fit = REF.plane_models(outs[2].range_image[b], outs[2].seg_idx[b], seeds[b], lidar_dict(lidar),
                               cfg.cluster_num + 2, cfg.plane_angle_threshold)
        res = REF.compare(outs[2].model_param[b], fit, cfg.plane_angle_threshold)
        assert res["ok"], (b, res)
