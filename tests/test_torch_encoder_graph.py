"""The encoder's CUDA graphs (``models/encoder.py``): a key's first call runs
eagerly, the second captures and replays, every later one replays.

On the card (``python -m pytest -m cuda tests/test_torch_encoder_graph.py``),
in the benchmark's configurations (the 64E default, the 64E with plane
models, the 32E channel table with DBSCAN and non-uniform steps), every
``EncoderOutput`` field of a call equals ``Encoder._graph`` run eagerly on
the same inputs:

  (a) at B = 8, two frame and seed sets replayed through one capture, each
      against its own eager result (a seed or grid baked into the graph
      would show);
  (b) a replay after the pinned host cache was churned with other values
      (a graph that read host memory would show);
  (c) a ragged B = 3 batch and an unbatched frame with an int seed;
  (d) ``BatchEngine.encode_pipeline`` over 5 batches gives the payloads of
      ``encode_frames`` batch by batch (a replay overwriting outputs still
      being staged would show);
  (e) over n calls of one key ``graph.eager``, ``graph.captures`` and
      ``graph.replays`` count 1, 1 and n - 1, and each replay counts the
      launches of an eager call (at the 64E one FPS and one rANS encode);
  (f) with plane models, the engine's ``stats`` and the ``models.*``
      counters, and the codec's counters, count the tables downloaded.

On the CPU the path stays eager and never captures.

The module imports nothing from ``tests`` (a site-installed package of
that name can shadow the repository's).
"""

import numpy as np
import pytest
import torch

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.encoder import Encoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.projection_host import project_for_encoder
from rpcc_tpu_torch.parallel.engine import BatchEngine
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

GRAPH_COUNTERS = ("graph.eager", "graph.captures", "graph.replays")


def _config(mode):
    if mode == "default":
        return lidar_config("Velodyne64E"), CodecConfig()
    if mode == "plane":
        return lidar_config("Velodyne64E"), CodecConfig(modeling_method="plane")
    lidar = lidar_config("Velodyne32E", VELODYNE_32E_CSV)
    return lidar, CodecConfig(segment_method="DBSCAN", compress_framework="non-uniform")


def _step(cfg):
    return cfg.step if cfg.uniform else cfg.level_acc


def _grids(lidar, cfg, seeds, device):
    """(q (B, H, W) int32, delta (B,) f32) of synthetic scenes, on ``device``."""
    q, d = zip(*(project_for_encoder(synth_cloud_for(lidar, s), lidar, cfg) for s in seeds))
    return (torch.from_numpy(np.stack(q).astype(np.int32)).to(device),
            torch.tensor(d, dtype=torch.float32).to(device))


def _assert_same(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        pairs = zip(g, w) if isinstance(g, tuple) else [(g, w)]  # a piece tuple's tensors, or the field
        for x, y in pairs:
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), name


def _eager(enc, q, delta, seeds):
    """``Encoder._graph`` on the inputs, with nothing captured or kept."""
    return enc._graph(q, delta, prng.seed_words(seeds, q.device), _step(enc.cfg))


@pytest.mark.parametrize("single", [False, True], ids=["batch", "single"])
def test_cpu_path_never_captures(single):
    lidar = LidarConfig("small16", 360.0, 2.0, -24.9, 16, 256)
    cfg = CodecConfig(cluster_num=8)
    enc = Encoder.for_lidar(lidar, cfg)
    q, d = _grids(lidar, cfg, (1, 2), "cpu")
    args = (q[0], d[0], 5) if single else (q, d, [5, 6])
    before = timer.counters()
    outs = [enc(*args, cfg.step) for _ in range(3)]
    assert not set(timer.counters_since(before)) & set(GRAPH_COUNTERS)
    assert enc._captures == {}
    for o in outs[1:]:
        _assert_same(o, outs[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_encoder_graph.py")
    return torch.device("cuda:0")


MODES = ["default", "plane", "dbscan_nonuniform"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_replays_equal_eager_calls_on_their_own_inputs(cuda_device, mode):
    """(a), (b): two frame and seed sets through one capture, and a replay
    after the pinned host cache was churned."""
    lidar, cfg = _config(mode)
    enc = Encoder.for_lidar(lidar, cfg).to(cuda_device)
    sets = []
    for frames, seeds in ((range(0, 8), list(range(100, 108))), (range(8, 16), [2**32 - 1 - i for i in range(8)])):
        q, d = _grids(lidar, cfg, frames, cuda_device)
        sets.append((q, d, torch.tensor(seeds, dtype=torch.int64).to(cuda_device)))
    want = [_eager(enc, *s) for s in sets]
    got = [enc(*sets[0], _step(cfg)), enc(*sets[1], _step(cfg))]  # eager, then capture and replay
    got += [enc(*sets[0], _step(cfg)), enc(*sets[1], _step(cfg))]  # replays
    # Churn the caching host allocator: pinned blocks of every small size,
    # released and taken again, filled with other values.
    for _ in range(4):
        junk = [torch.empty(n, dtype=torch.uint8, pin_memory=True).fill_(0xA5) for n in range(1, 4097, 7)]
        del junk
    got.append(enc(*sets[0], _step(cfg)))
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got, [want[0], want[1], want[0], want[1], want[0]]):
        _assert_same(g, w)
    assert not torch.equal(want[0].stream, want[1].stream)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_ragged_and_unbatched_keys(cuda_device, mode):
    """(c): a B = 3 batch with a seed list and an unbatched frame with an
    int seed, each through its eager call, its capture and two replays."""
    lidar, cfg = _config(mode)
    enc = Encoder.for_lidar(lidar, cfg).to(cuda_device)
    q, d = _grids(lidar, cfg, (3, 4, 5), cuda_device)
    seeds = [11, 12, 13]
    want = _eager(enc, q, d, seeds)
    want1 = _eager(enc, q[1:2], d[1:2], [7])
    want1 = type(want1)(*(None if f is None else f[0] for f in want1))
    for _ in range(4):
        _assert_same(enc(q, d, seeds, _step(cfg)), want)
        _assert_same(enc(q[1], d[1], 7, _step(cfg)), want1)
    assert sum(hasattr(c, "graph") for c in enc._captures.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_pipeline_payloads_equal_batch_by_batch(cuda_device, mode):
    """(d): the pipeline stages batch k while batch k + 1 replays."""
    lidar, cfg = _config(mode)
    clouds = [synth_cloud_for(lidar, s) for s in range(20)]
    batches = [(clouds[i:i + 4], list(range(50 + i, 54 + i))) for i in range(0, 20, 4)]
    piped, serial = BatchEngine(lidar, cfg, cuda_device, batch_size=4), BatchEngine(lidar, cfg, cuda_device, batch_size=4)
    try:
        got = [[blob for blob, _ in res] for res in piped.encode_pipeline(batches)]
        want = [[blob for blob, _ in serial.encode_frames(c, s)] for c, s in batches]
    finally:
        piped.close()
        serial.close()
    assert got == want
    assert len({b for blobs in want for b in blobs}) == 20


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_counters_over_one_key(cuda_device, mode):
    """(e): 1 eager call, 1 capture and n - 1 replays over n calls; each
    replay counts an eager call's launches."""
    lidar, cfg = _config(mode)
    enc = Encoder.for_lidar(lidar, cfg).to(cuda_device)
    q, d = _grids(lidar, cfg, range(8), cuda_device)
    seeds = torch.arange(8, dtype=torch.int64).to(cuda_device)
    n = 5
    before = timer.counters()
    launches = []
    for _ in range(n):
        c0 = timer.counters()
        enc(q, d, seeds, _step(cfg))
        launches.append({k: v for k, v in timer.counters_since(c0).items() if k.startswith("launch.")})
    torch.cuda.synchronize(cuda_device)
    moved = timer.counters_since(before)
    assert [moved.get(k, 0) for k in GRAPH_COUNTERS] == [1, 1, n - 1]
    assert all(c == launches[0] for c in launches[1:])
    if mode == "dbscan_nonuniform":
        assert launches[0] == {"launch.dbscan": 1, "launch.rans_encode": 1}
    else:
        assert launches[0] == {"launch.fps": 1, "launch.rans_encode": 1}


def _rows(tables):
    t = np.asarray(tables)[..., 2:, :]
    return int((t != 0).any(-1).sum()), int((t[..., 0] + t[..., 1] + t[..., 2] != 0).sum())


@pytest.mark.cuda
def test_plane_rows_counted_from_the_downloaded_tables(cuda_device):
    """(f): the engine's ``model_rows`` / ``plane_rows`` over a pipeline of
    three B = 8 batches (an eager call, a capture, a replay), the codec's
    over three B = 1 compresses, each equal to the rows of the tables."""
    lidar, cfg = _config("plane")
    clouds = [synth_cloud_for(lidar, s) for s in range(24)]
    eng = BatchEngine(lidar, cfg, cuda_device, batch_size=8)
    stats: dict = {}
    before = timer.counters()
    try:
        res = list(eng.encode_pipeline([(clouds[i:i + 8], list(range(i, i + 8))) for i in range(0, 24, 8)], stats=stats))
    finally:
        eng.close()
    moved = timer.counters_since(before)
    rows, planes = _rows([f["plane_param"] for batch in res for _, f in batch])
    assert 0 < planes <= rows
    assert (stats["model_rows"], stats["plane_rows"]) == (rows, planes)
    assert (moved["models.rows"], moved["models.plane_rows"]) == (rows, planes)
    assert [moved.get(k, 0) for k in GRAPH_COUNTERS] == [1, 1, 2]
    codec = RPCCCodec(lidar, cfg, cuda_device)
    before = timer.counters()
    tables = [codec.compress(clouds[k], seed=k)[1]["plane_param"] for k in (0, 1, 2)]
    moved = timer.counters_since(before)
    assert (moved["models.rows"], moved["models.plane_rows"]) == _rows(tables)
    assert [moved.get(k, 0) for k in GRAPH_COUNTERS] == [1, 1, 2]
