"""The port's spans and counters (``rpcc_tpu_torch/utils/timer.py``) and
where the program opens them: the engine's stages and waits, the encoder
graph's parts, the codec's steps.

On the CPU, at a 16 x 256 LiDAR: tracing off keeps nothing; a 3-batch
``encode_pipeline`` gives each stage span once per batch, on the engine's
four threads, with its waits and the graph nested under it and the
batch's number on each; the engine's ``stats`` and the codec's timing
dicts are the sums of their spans' stamps; counters add up across threads
and are read by difference; the spans' clock is ``torch.profiler``'s.  On
the card (``python -m pytest -m cuda tests/test_torch_tracing.py``): the
encoder graph never synchronises, so its spans time the host's issue.
"""

import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.pipeline import RPCCCodec
from rpcc_tpu_torch.parallel.engine import BatchEngine
from rpcc_tpu_torch.utils import timer

torch.set_num_threads(1)

LIDAR = LidarConfig("small16", 360.0, 2.0, -24.9, 16, 256)
CFG = CodecConfig(cluster_num=8)
STAGES = ("engine.prepare", "engine.dispatch", "engine.stage", "engine.finish")
GRAPH_PARTS = ("graph.segment", "graph.sort", "graph.models", "graph.quantize", "graph.contour", "graph.entropy")


def _clouds(n):
    return [synth_cloud_for(LIDAR, s) for s in range(n)]


@pytest.fixture(scope="module")
def engine_run():
    """A 3-batch pipeline (2 + 2 + 1 frames) inside a recording, with
    ``stats``."""
    eng = BatchEngine(LIDAR, CFG, "cpu", batch_size=2, workers=2)
    clouds = _clouds(5)
    batches = [(clouds[0:2], [1, 2]), (clouds[2:4], [3, 4]), (clouds[4:5], [5])]
    list(eng.encode_pipeline(batches))  # warm-up, tracing off
    stats = {}
    try:
        with timer.recording() as rec:
            out = list(eng.encode_pipeline(batches, stats=stats))
    finally:
        eng.close()
    return rec, stats, out


def test_tracing_off_keeps_nothing_and_returns_the_shared_no_op():
    assert timer.span("x") is timer.NO_SPAN and timer.span("y", 3) is timer.NO_SPAN
    with timer.recording() as rec:
        assert timer.span("x") is not timer.NO_SPAN
    codec = RPCCCodec(LIDAR, CFG, "cpu")
    with timer.span("outside") as sp:
        _, _, times = codec.compress(_clouds(1)[0])
    assert sp is timer.NO_SPAN and times["device_encode"] > 0.0
    stamped = timer.span("stamped", stamp=True)
    with stamped:
        time.sleep(0.001)
    assert stamped.wall_ns >= 1_000_000 and stamped.id == 0  # stamped, kept nowhere
    assert rec.spans == [] and rec.counters == {}


def test_recordings_do_not_nest():
    with timer.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with timer.recording():
                pass
    assert timer.span("x") is timer.NO_SPAN


def test_engine_stage_spans_carry_batch_numbers_on_four_threads(engine_run):
    rec, _, out = engine_run
    assert [len(r) for r in out] == [2, 2, 1]
    by_id = {s.id: s for s in rec.spans}
    for name in STAGES:
        spans = rec.named(name)
        assert sorted(s.batch for s in spans) == [0, 1, 2], name
        assert all(s.parent is None for s in spans), name
        assert len({s.thread for s in spans}) == 1, name  # each stage on its own thread
    assert len({rec.named(n)[0].thread for n in STAGES}) == 4
    want_parent = {"engine.slot_wait": "engine.prepare", "graph": "engine.dispatch",
                   "engine.device_wait": "engine.stage", **{p: "graph" for p in GRAPH_PARTS}}
    for child, parent in want_parent.items():
        spans = rec.named(child)
        assert sorted(s.batch for s in spans) == [0, 1, 2], child
        for s in spans:
            up = by_id[s.parent]
            assert up.name == parent and up.batch == s.batch and up.thread == s.thread, child
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns, child
    assert rec.named("engine.copy_wait") == []  # the CPU copies nothing


def test_engine_stats_are_the_sums_of_the_stage_spans(engine_run):
    rec, stats, _ = engine_run
    assert stats["batches"] == 3
    for name in STAGES:
        key = name.split(".")[1]
        spans = rec.named(name)
        assert stats[key + "_s"] == pytest.approx(sum(s.wall_ns for s in spans) / 1e9, rel=0, abs=1e-9)
        assert stats[key + "_cpu_s"] == pytest.approx(sum(s.cpu_ns for s in spans) / 1e9, rel=0, abs=1e-9)


def test_codec_timings_are_its_spans():
    codec = RPCCCodec(LIDAR, CFG, "cpu")
    clouds = _clouds(2)
    codec.compress(clouds[0])  # warm-up: frame 0
    with timer.recording() as rec:
        timings = [codec.compress(pc)[2] for pc in clouds]
    tops = rec.named("codec.compress")
    assert [s.batch for s in tops] == [1, 2] and all(s.parent is None for s in tops)
    for top, t in zip(tops, timings):
        kids = {s.name: s for s in rec.spans if s.parent == top.id}
        assert set(kids) == {"codec.project", "codec.upload", "graph", "codec.device_wait",
                             "codec.gather_fields", "codec.entropy", "codec.framing"}
        assert all(s.batch == top.batch for s in kids.values())
        assert t["gather_fields"] == kids["codec.gather_fields"].wall_ns / 1e9
        assert t["entropy"] == kids["codec.entropy"].wall_ns / 1e9
        assert t["framing"] == kids["codec.framing"].wall_ns / 1e9
        assert t["device_encode"] == (kids["codec.device_wait"].end_ns - top.start_ns) / 1e9
        parts = sum(kids[k].wall_ns for k in ("codec.project", "codec.upload", "graph", "codec.device_wait")) / 1e9
        assert parts <= t["device_encode"] < parts + 1e-3
        assert {s.name for s in rec.spans if s.parent == kids["graph"].id} == set(GRAPH_PARTS) - {"graph.entropy"}


def test_counters_add_up_across_threads_and_read_by_difference():
    before = timer.counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.recording() as rec:
            threads = [threading.Thread(target=lambda: [timer.count("test.tracing.hits") for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timer.counters_since(before) == {"test.tracing.hits": 32_000} == rec.counters
    snap = timer.counters()
    snap["test.tracing.hits"] = 0  # a copy: nothing resets the registry
    timer.count("test.tracing.hits", 5)
    assert timer.counters()["test.tracing.hits"] == before.get("test.tracing.hits", 0) + 32_005


def test_held_counts_stay_on_their_thread_until_added():
    """``holding_counts`` keeps one thread's counts out of the counters
    (a CUDA graph's capture) while other threads' counts still land."""
    before = timer.counters()
    with timer.holding_counts() as held:
        timer.count("test.tracing.held", 3)
        other = threading.Thread(target=lambda: timer.count("test.tracing.held", 2))
        other.start()
        other.join(timeout=60)
        with timer.holding_counts() as inner:
            timer.count("test.tracing.held")
        timer.count("test.tracing.held", 4)
    assert not other.is_alive()
    assert held == {"test.tracing.held": 7} and inner == {"test.tracing.held": 1}
    assert timer.counters_since(before) == {"test.tracing.held": 2}
    timer.count("test.tracing.held", 5)
    assert timer.counters_since(before) == {"test.tracing.held": 7}


def test_spans_share_the_profilers_clock():
    """A lone operator between two sleeps lies inside its span, within
    0.5 ms of both ends; over a traced CPU encode, every operator that
    starts inside ``graph.segment`` also ends inside it (within 0.5 ms),
    and the first and last of them sit within 0.5 ms of its ends."""
    from torch.profiler import ProfilerActivity, profile

    codec = RPCCCodec(LIDAR, CFG, "cpu")
    pc = _clouds(1)[0]
    codec.compress(pc)  # warm-up
    slack = 500_000
    with profile(activities=[ProfilerActivity.CPU]) as prof, timer.recording() as rec:
        time.sleep(0.005)
        with timer.span("probe"):
            torch.ones(1000).mul_(2.0)
        time.sleep(0.005)
        codec.compress(pc)
    ops = [(e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    probe = rec.named("probe")[0]
    inside = [o for o in ops if probe.start_ns - slack <= o[1] <= probe.end_ns + slack]
    assert {o[0] for o in inside} >= {"aten::ones", "aten::mul_"}
    assert all(probe.start_ns <= o[1] and o[2] <= probe.end_ns for o in inside)
    assert min(o[1] for o in inside) - probe.start_ns < slack and probe.end_ns - max(o[2] for o in inside) < slack
    main = Counter(o[3] for o in inside).most_common(1)[0][0]
    seg = rec.named("graph.segment")[0]
    in_seg = [o for o in ops if o[3] == main and seg.start_ns <= o[1] < seg.end_ns]
    assert len(in_seg) > 50
    assert all(o[2] <= seg.end_ns + slack for o in in_seg)
    assert min(o[1] for o in in_seg) - seg.start_ns < slack
    assert seg.end_ns - max(o[2] for o in in_seg) < slack


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest -m cuda tests/test_torch_tracing.py")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "dbscan_nonuniform"])
def test_cuda_encoder_graph_never_synchronises(cuda_device, mode):
    """``Encoder.forward`` on the card under ``set_sync_debug_mode("error")``,
    batched (the engine's device seeds, device entropy) and single-frame (an
    int seed, the codec's path): neither a key's eager call nor its replays
    wait for the device, so the ``graph`` spans time the host's issue alone.
    The eager call and the capture (which drains the device before it
    captures) span the graph's parts; a replay spans ``graph.replay``."""
    from rpcc_tpu_torch.data import VELODYNE_32E_CSV, lidar_config
    from rpcc_tpu_torch.models.encoder import Encoder
    from rpcc_tpu_torch.ops.projection_host import project_for_encoder

    if mode == "default":
        lidar, cfg = lidar_config("Velodyne64E"), CodecConfig()
    else:
        lidar = lidar_config("Velodyne32E", VELODYNE_32E_CSV)
        cfg = CodecConfig(segment_method="DBSCAN", compress_framework="non-uniform")
    step = cfg.step if cfg.uniform else cfg.level_acc
    q, d = zip(*(project_for_encoder(synth_cloud_for(lidar, s), lidar, cfg) for s in (1, 2)))
    q = torch.from_numpy(np.stack(q).astype(np.int32)).to(cuda_device)
    d = torch.tensor(d, dtype=torch.float32).to(cuda_device)
    seeds = torch.tensor([7, 8], dtype=torch.int64).to(cuda_device)
    calls = ((q, d, seeds, step), (q[0], d[0], 7, step))

    def encoders():
        return (Encoder.for_lidar(lidar, cfg).to(cuda_device),
                Encoder.for_lidar(lidar, cfg.replace(device_entropy=False)).to(cuda_device))

    want = [enc(*args) for enc, args in zip(encoders(), calls)]  # warm-up: kernels built and loaded
    torch.cuda.synchronize(cuda_device)
    runs = list(zip(encoders(), calls))

    def unsynchronised():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return [enc(*args) for enc, args in runs]
        finally:
            torch.cuda.set_sync_debug_mode(0)

    with timer.recording() as rec:
        got = unsynchronised()  # each key's eager call
        got += [enc(*args) for enc, args in runs]  # its capture, and a replay
        torch.cuda.synchronize(cuda_device)
        got += unsynchronised() + unsynchronised()  # replays
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got, want * 4):
        assert torch.equal(g.stream, w.stream) and torch.equal(g.contour_packed, w.contour_packed)
    graphs = rec.named("graph")
    assert len(graphs) == 8 and all(s.wall_ns > 0 for s in graphs)
    kids = [{s.name for s in rec.spans if s.parent == g.id} for g in graphs]
    assert kids[0] >= {"graph.segment", "graph.entropy"} and kids[2] >= {"graph.segment", "graph.entropy"}
    assert kids[1] >= {"graph.segment"} and kids[3] >= {"graph.segment"}
    assert all(k == {"graph.replay"} for k in kids[4:])
