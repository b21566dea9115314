"""The port's data-parallel layer (``rpcc_tpu_torch.parallel.mesh``, the
process-group ``sharded_stats`` and the datalist CLIs' ``--num_devices``)
against ``rpcc_tpu``'s mesh, on the CPU with gloo ranks.

Ranks are spawned processes running package functions; they write to the
inherited file descriptors, so the output is read with ``capfd``.  Held:
  * ``data_devices`` raises where ``data_mesh`` raises, and the split of a
    datalist over ranks is the frames each mesh device holds of a batch
    sharded over ``P("data")``;
  * 2 ranks write ``.rpcc`` bytes equal to one engine's (and to
    ``--num_devices 1``'s) for the same frames and seeds, with device
    entropy on and off, on a ragged list (5 frames at ``--batch 4``: rank 1
    gets nothing of the last global batch), under a ``--skip_existing``
    resume (one frame to go: rank 1 gets no frame at all) and under
    ``--keep_going``;
  * ``sharded_stats`` over 2 ranks equals one process's ``batch_report`` and,
    element for element, ``make_stats_aggregator(data_mesh(8))`` on the
    same (n_points, bits) slots, 3 of 8 of them empty;
  * a rank that raises fails the launcher with its traceback;
  * no rank imports ``jax`` or ``rpcc_tpu`` (the ranks' import log);
  * ``decompress_datalist`` defaults to the device backend, and 2 ranks
    write the host decoder's points bit for bit.
"""

import os
import re

import numpy as np
import pytest
import torch

from rpcc_tpu.parallel import data_mesh, make_stats_aggregator
from rpcc_tpu_torch.cli import compress_datalist, decompress_datalist
from rpcc_tpu_torch.config import CodecConfig
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.host_decoder import HostDecoder
from rpcc_tpu_torch.parallel.aggregate import all_reduce_totals, batch_report, batch_totals
from rpcc_tpu_torch.parallel.engine import BatchEngine
from rpcc_tpu_torch.parallel.mesh import backend_for, data_devices, rank_frames

torch.set_num_threads(1)

LIDAR = "VelodyneVLP16"
N_FRAMES = 5
BATCH = 4
SEED = 5
COMMON = ["--lidar", LIDAR, "--device", "cpu", "--workers", "2", "--seed", str(SEED)]
BASE = [*COMMON, "--batch", str(BATCH)]
TWO = ["--num_devices", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    """Spawned ranks inherit the environment: one intra-op thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _write(root, names, clouds):
    paths = []
    for name, pc in zip(names, clouds):
        paths.append(os.path.join(root, name))
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(paths[-1])
    return paths


def _datalist(path, entries):
    with open(path, "w") as f:
        f.write("\n".join(entries) + "\n")
    return path


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh"))
    clouds = [synth_cloud_for(lidar_config(LIDAR), i) for i in range(N_FRAMES)]
    paths = _write(root, [f"{i:06d}.bin" for i in range(N_FRAMES)], clouds)
    return dict(root=root, clouds=clouds, paths=paths, lst=_datalist(os.path.join(root, "list.txt"), paths))


def _one_engine(cfg, clouds, seeds, batch=BATCH):
    """One engine's blobs and point counts, in batches of ``batch``."""
    engine = BatchEngine(lidar_config(LIDAR), cfg, "cpu", batch_size=batch, workers=2)
    blobs, points = [], []
    for s in range(0, len(clouds), batch):
        res = engine.encode_frames(clouds[s : s + batch], seeds[s : s + batch])
        blobs += [b for b, _ in res]
        points += [max(int(n), 1) for n in res.stream_len]
    engine.close()
    return blobs, points


# ------------------------------------------------------------------ devices


@pytest.mark.parametrize("case", ["zero", "past_visible"])
def test_data_devices_rejects_what_data_mesh_rejects(case):
    import jax

    port_n, ref_n = (0, 0) if case == "zero" else (torch.cuda.device_count() + 1, jax.device_count() + 1)
    with pytest.raises(ValueError):
        data_mesh(ref_n)
    with pytest.raises(ValueError, match="visible" if case == "past_visible" else ">= 1"):
        data_devices(port_n, "cuda")
    if case == "zero":
        with pytest.raises(ValueError):
            data_devices(0, "cpu")
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError):
            data_devices(1, "cuda")


@pytest.mark.parametrize("n", [1, 2, 8])
def test_data_devices_gives_n_cpu_devices_as_data_mesh_gives_n(n):
    assert data_devices(n, "cpu") == [torch.device("cpu")] * n
    assert data_mesh(n).devices.size == n
    assert data_devices(None, "cpu") == [torch.device("cpu")]


@pytest.mark.parametrize("devices, want", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:0"], "nccl"),
    (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0", "cpu"], "gloo"),
])
def test_backend_rule(devices, want):
    assert backend_for([torch.device(d) for d in devices]) == want


@pytest.mark.parametrize("n, batch, world", [(5, 4, 2), (20, 8, 2), (7, 3, 4), (3, 8, 8), (1, 1, 2), (17, 5, 1)])
def test_rank_frames_are_the_frames_each_mesh_device_holds(n, batch, world):
    """The reference's engine rounds the batch up to a multiple of the mesh
    and shards each (padded) batch over ``P("data")``: device r holds rows
    [r b, (r + 1) b) of it."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = data_mesh(world)
    sharding = NamedSharding(mesh, P("data"))
    b, _ = rank_frames(n, batch, 0, world)
    step = b * world
    held = {d: [] for d in mesh.devices.flat}
    for k in range(0, n, step):
        arr = jax.device_put(np.arange(k, k + step), sharding)
        for shard in arr.addressable_shards:
            held[shard.device] += [int(i) for i in np.asarray(shard.data) if i < n]
    for r, d in enumerate(mesh.devices.flat):
        assert rank_frames(n, batch, r, world) == (b, held[d]), r
    assert sorted(i for r in range(world) for i in rank_frames(n, batch, r, world)[1]) == list(range(n))


# ------------------------------------------------------------------ stats


def test_sharded_stats_needs_a_group():
    engine = BatchEngine(lidar_config(LIDAR), CodecConfig(), "cpu", batch_size=1, workers=1)
    try:
        with pytest.raises(ValueError, match="process group"):
            engine.sharded_stats([10], [100])
    finally:
        engine.close()


def test_sharded_stats_in_a_world_of_one_keeps_int64(frames, tmp_path):
    """In a gloo group of one: an EncodedBatch's stream_len counts the
    points, and totals past 2^31 do not wrap."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "init"), rank=0, world_size=1)
    engine = BatchEngine(lidar_config(LIDAR), CodecConfig(), "cpu", batch_size=2, workers=1, group=dist.group.WORLD)
    try:
        res = engine.encode_frames(frames["clouds"][:2], [0, 1])
        sizes = [len(b) for b, _ in res]
        assert engine.sharded_stats(res, sizes) == {**batch_report(batch_totals(res.stream_len, sizes)), "errors": 0}
        big = np.array([3, 2**40, 2**33 + 8, 7], np.int64)
        np.testing.assert_array_equal(all_reduce_totals(big, dist.group.WORLD), big)
    finally:
        engine.close()
        dist.destroy_process_group()


# ------------------------------------------------------------------ ranks


@pytest.mark.parametrize("entropy", ["device_entropy", "host_entropy"])
def test_two_ranks_write_one_engines_blobs_and_sum_its_stats(frames, entropy, capfd, monkeypatch):
    cfg = CodecConfig(device_entropy=entropy == "device_entropy")
    flags = [] if cfg.device_entropy else ["--no-device_entropy"]
    if cfg.device_entropy:
        monkeypatch.setenv("PYTHONVERBOSE", "1")  # the ranks log every import to stderr
    out2 = os.path.join(frames["root"], "two_" + entropy)
    res2 = compress_datalist.main(["--datalist", frames["lst"], "--output_dir", out2, *TWO, *flags, *BASE])
    text = capfd.readouterr()
    monkeypatch.delenv("PYTHONVERBOSE", raising=False)
    out1 = os.path.join(frames["root"], "one_" + entropy)
    res1 = compress_datalist.main(["--datalist", frames["lst"], "--output_dir", out1, "--num_devices", "1", *flags, *BASE])

    blobs2 = _read([compress_datalist._mirror_path(p, out2, "rpcc") for p in frames["paths"]])
    blobs1 = _read([compress_datalist._mirror_path(p, out1, "rpcc") for p in frames["paths"]])
    want, points = _one_engine(cfg, frames["clouds"], [SEED + i for i in range(N_FRAMES)])
    assert blobs2 == want
    assert blobs1 == want
    assert "backend gloo" in text.out and f"Compressed {N_FRAMES} frames" in text.out

    # One all_reduce: every rank holds the sum, equal to one process's
    # report and to the reference's psum over 8 slots (3 of them empty).
    sizes = [len(b) for b in want]
    assert len(res2) == 2 and res2[0]["report"] == res2[1]["report"] == res1[0]["report"]
    assert res2[0]["report"] == {**batch_report(batch_totals(points, sizes)), "errors": 0}
    slots_points = np.zeros(8, np.int32)
    slots_bits = np.zeros(8, np.int32)
    slots_points[:N_FRAMES] = points
    slots_bits[:N_FRAMES] = np.asarray(sizes) * 8
    ref = np.asarray(make_stats_aggregator(data_mesh(8))(slots_points, slots_bits))
    rep = res2[0]["report"]
    assert [rep["frames"], rep["points"], rep["bits"]] == ref.tolist()

    if cfg.device_entropy:
        assert re.search(r"^import 'rpcc_tpu_torch\.cli\.compress_datalist'", text.err, re.M), "no import log"
        assert not re.search(r"^import '(jax|rpcc_tpu)[.']", text.err, re.M), "a rank imported jax or rpcc_tpu"


def test_two_ranks_resume_skip_existing(frames, tmp_path, capfd):
    """One frame to go: rank 0 encodes it as frame 0 of the resumed list
    (seed --seed + 0), rank 1 holds no frame and still joins the reduce."""
    out = str(tmp_path / "out")
    compress_datalist.main(["--datalist", frames["lst"], "--output_dir", out, "--num_devices", "1", *BASE])
    victim = compress_datalist._mirror_path(frames["paths"][3], out, "rpcc")
    os.remove(victim)
    capfd.readouterr()
    res = compress_datalist.main(["--datalist", frames["lst"], "--output_dir", out, "--skip_existing", *TWO, *BASE])
    text = capfd.readouterr().out
    assert "4 done, 1 to go" in text and "Compressed 1 frames" in text
    assert _read([victim]) == _one_engine(CodecConfig(), frames["clouds"][3:4], [SEED])[0]
    assert res[1]["report"]["frames"] == 1


def test_a_failing_rank_fails_the_launcher_and_keep_going_sums_errors(frames, tmp_path, capfd):
    """--batch 2 over 2 ranks: rank 1 loads the broken entry.  Without
    --keep_going its error fails the run with its traceback (rank 0,
    waiting at the reduce, is stopped); with it, rank 1 skips the frame and
    rank 0's summary counts rank 1's error."""
    bad = str(tmp_path / "broken.bin")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 10)  # not a whole (x, y, z, i) row
    p = frames["paths"]
    entries = [p[0], bad, p[1], p[2]]
    lst = _datalist(str(tmp_path / "list.txt"), entries)
    flags = [*COMMON, "--batch", "2"]
    with pytest.raises(Exception, match="(?s)Process 1 terminated.*ValueError"):
        compress_datalist.main(["--datalist", lst, "--output_dir", str(tmp_path / "fail"), *TWO, *flags])
    capfd.readouterr()
    out = str(tmp_path / "out")
    res = compress_datalist.main(["--datalist", lst, "--output_dir", out, "--keep_going", *TWO, *flags])
    text = capfd.readouterr().out
    assert "ERROR loading" in text and "Compressed 3 frames" in text and "1 errors" in text
    assert res[0]["report"]["errors"] == 1
    assert not os.path.exists(compress_datalist._mirror_path(bad, out, "rpcc"))
    out1 = str(tmp_path / "one")
    compress_datalist.main(["--datalist", lst, "--output_dir", out1, "--keep_going", "--num_devices", "1", *flags])
    good = [e for e in entries if e != bad]
    assert _read([compress_datalist._mirror_path(e, out, "rpcc") for e in good]) == \
        _read([compress_datalist._mirror_path(e, out1, "rpcc") for e in good])


def test_decompress_defaults_to_the_device_and_two_ranks_write_host_points(frames, tmp_path, capfd):
    assert decompress_datalist.build_parser().parse_args(["--datalist", "l", "--output_dir", "o"]).decode_backend == "device"
    enc = str(tmp_path / "rpcc")
    compress_datalist.main(["--datalist", frames["lst"], "--output_dir", enc, "--num_devices", "1", *BASE])
    outs = [compress_datalist._mirror_path(p, enc, "rpcc") for p in frames["paths"]]
    lst = _datalist(str(tmp_path / "rpcc.txt"), outs)
    rec = str(tmp_path / "rec")
    capfd.readouterr()
    res = decompress_datalist.main(["--datalist", lst, "--output_dir", rec, *TWO, *BASE])
    assert "backend gloo" in capfd.readouterr().out
    want = HostDecoder(lidar_config(LIDAR), CodecConfig()).decode_blobs_points(_read(outs))
    for o, w in zip(outs, want):
        got = np.fromfile(decompress_datalist._mirror_path(o, rec, "bin"), np.float32).reshape(-1, 4)
        np.testing.assert_array_equal(got, w)
    rep = res[0]["report"]
    assert rep["frames"] == N_FRAMES and rep["points"] == sum(len(w) for w in want)
    assert rep["bits"] == 8 * sum(os.path.getsize(o) for o in outs)
