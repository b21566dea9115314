"""The port's datalist CLIs on the CPU (``rpcc_tpu_torch.cli.compress_datalist``
and ``decompress_datalist``), run in-process on small VLP-16 frames.

Frame i of the list is encoded with seed ``--seed + i`` and, with
``--no-device_entropy``, its ``.rpcc`` equals the single-frame codec's for
that seed byte for byte; at the default (device entropy) it equals the
B = 1 engine's and decodes within the bound; both decode
backends write the host decoder's points bit for bit; outputs mirror the
input paths, replacing only the trailing extension and never escaping
``--output_dir``; ``--skip_existing`` resumes; ``--keep_going`` isolates a
bad input without writing anything for it.
"""

import os

import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu_torch.cli import compress_datalist, decompress_datalist
from rpcc_tpu_torch.data import lidar_config, read_datalist
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.models.host_decoder import HostDecoder
from rpcc_tpu_torch.models.pipeline import RPCCCodec

torch.set_num_threads(1)

LIDAR = "VelodyneVLP16"
N_FRAMES = 5
BASE = ["--lidar", LIDAR, "--device", "cpu", "--batch", "2", "--workers", "2"]
HOST = ["--no-device_entropy"]  # host entropy: blobs equal the single-frame codec's


def _write_frames(root, n=N_FRAMES):
    """Frames under a directory whose name holds ``bin`` and ``.bin``."""
    src = os.path.join(root, "bin", "drive.bin.d")
    os.makedirs(src)
    lidar = lidar_config(LIDAR)
    paths, clouds = [], []
    for i in range(n):
        pc = synth_cloud_for(lidar, i)
        paths.append(os.path.join(src, f"{i:06d}.bin"))
        np.concatenate([pc, np.zeros((pc.shape[0], 1), np.float32)], 1).tofile(paths[-1])
        clouds.append(pc)
    return paths, clouds


def _datalist(path, entries):
    with open(path, "w") as f:
        f.write("\n".join(["", *entries, "  ", ""]))  # blank lines are skipped
    return path


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dl"))
    paths, clouds = _write_frames(root)
    lst = _datalist(os.path.join(root, "list.txt"), paths)
    out = os.path.join(root, "rpcc")
    compress_datalist.main(["--datalist", lst, "--output_dir", out, "--seed", "5", *HOST, *BASE])
    outs = [compress_datalist._mirror_path(p, out, "rpcc") for p in paths]
    return dict(root=root, paths=paths, clouds=clouds, lst=lst, out=out, outs=outs)


def test_read_datalist_strips_blank_lines(compressed):
    assert read_datalist(compressed["lst"]) == compressed["paths"]


def test_blobs_equal_single_frame_codec_per_seed(compressed):
    codec = RPCCCodec(lidar_config(LIDAR), CodecConfig(), "cpu")
    for i, (pc, path) in enumerate(zip(compressed["clouds"], compressed["outs"])):
        assert "/bin/drive.bin.d/" in path and path.endswith(f"{i:06d}.rpcc")
        with open(path, "rb") as f:
            assert f.read() == codec.compress(pc, seed=5 + i)[0], i


@pytest.mark.parametrize("backend", ["host", "device"])
def test_decompress_backends_write_host_decoder_points(compressed, backend):
    lst = _datalist(os.path.join(compressed["root"], f"rpcc_{backend}.txt"), compressed["outs"])
    rec = os.path.join(compressed["root"], "rec_" + backend)
    decompress_datalist.main(["--datalist", lst, "--output_dir", rec, "--decode_backend", backend, *BASE])
    blobs = []
    for p in compressed["outs"]:
        with open(p, "rb") as f:
            blobs.append(f.read())
    lidar, cfg = lidar_config(LIDAR), CodecConfig()
    want = HostDecoder(lidar, cfg).decode_blobs_points(blobs)
    ris = HostDecoder(lidar, cfg).decode_blobs(blobs)
    codec = RPCCCodec(lidar, cfg, "cpu")
    for p, w, ri, pc in zip(compressed["outs"], want, ris, compressed["clouds"]):
        got = np.fromfile(decompress_datalist._mirror_path(p, rec, "bin"), np.float32).reshape(-1, 4)
        np.testing.assert_array_equal(got, w)
        q, d = codec.project(pc)
        assert np.abs(ri - q.astype(np.float32) * d).max() <= cfg.step + 1e-5


def test_skip_existing_resumes(compressed, capsys):
    victim = compressed["outs"][3]
    os.remove(victim)
    capsys.readouterr()
    compress_datalist.main(["--datalist", compressed["lst"], "--output_dir", compressed["out"],
                            "--seed", "5", "--skip_existing", *HOST, *BASE])
    assert "4 done, 1 to go" in capsys.readouterr().out
    with open(victim, "rb") as f:
        # The resumed list holds one frame, so it is frame 0 of that run
        # (``rpcc_tpu``'s seeding rule): --seed + 0.
        assert f.read() == RPCCCodec(lidar_config(LIDAR), CodecConfig(), "cpu").compress(
            compressed["clouds"][3], seed=5)[0]


def test_keep_going_skips_a_bad_input(tmp_path, capsys):
    paths, clouds = _write_frames(str(tmp_path), n=3)
    bad = os.path.join(str(tmp_path), "bin", "drive.bin.d", "broken.bin")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 10)  # not a whole (x, y, z, i) row
    entries = [paths[0], bad, paths[1], paths[2]]
    lst = _datalist(str(tmp_path / "list.txt"), entries)
    out = str(tmp_path / "out")
    with pytest.raises(ValueError):
        compress_datalist.main(["--datalist", lst, "--output_dir", out, *HOST, *BASE])
    compress_datalist.main(["--datalist", lst, "--output_dir", out, "--keep_going", *HOST, *BASE])
    text = capsys.readouterr().out
    assert "ERROR loading" in text and "1 errors" in text
    assert not os.path.exists(compress_datalist._mirror_path(bad, out, "rpcc"))
    codec = RPCCCodec(lidar_config(LIDAR), CodecConfig(), "cpu")
    for i, p in enumerate(entries):
        if p != bad:
            with open(compress_datalist._mirror_path(p, out, "rpcc"), "rb") as f:
                assert f.read() == codec.compress(clouds[paths.index(p)], seed=i)[0]

    # A corrupt bitstream only skips its own decode batch.
    good = [compress_datalist._mirror_path(p, out, "rpcc") for p in paths]
    corrupt = os.path.join(out, "corrupt.rpcc")
    with open(corrupt, "wb") as f:
        f.write(b"\x01" * 40)
    lst2 = _datalist(str(tmp_path / "list2.txt"), [good[0], good[1], corrupt, good[2]])
    rec = str(tmp_path / "rec")
    decompress_datalist.main(["--datalist", lst2, "--output_dir", rec, "--keep_going", *BASE])
    assert "ERROR decoding batch" in capsys.readouterr().out
    assert os.path.exists(decompress_datalist._mirror_path(good[0], rec, "bin"))
    assert not os.path.exists(decompress_datalist._mirror_path(good[2], rec, "bin"))


def test_decompress_rejects_non_rpcc_entries(tmp_path):
    lst = _datalist(str(tmp_path / "list.txt"), [str(tmp_path / "frame.bin")])
    with pytest.raises(ValueError):
        decompress_datalist.main(["--datalist", lst, "--output_dir", str(tmp_path / "o"), *BASE])


@pytest.mark.parametrize(
    "entry, want",
    [
        ("data/bin/seq.bin.d/000001.bin", "out/data/bin/seq.bin.d/000001.rpcc"),
        ("/abs/bin/x.bin", "out/abs/bin/x.rpcc"),
        ("//srv/data/a.bin", "out/srv/data/a.rpcc"),
        ("../../etc/a.bin", "out/etc/a.rpcc"),
        ("  plain.pcd  ", "out/plain.rpcc"),
    ],
)
def test_mirror_path_replaces_only_the_extension(entry, want):
    assert compress_datalist._mirror_path(entry, "out", "rpcc") == want


def test_device_entropy_default_equals_b1_engine_and_decodes(compressed, capsys):
    """The default datalist run codes the big fields on the device: each
    blob equals the B = 1 engine's for its seed, decodes within the bound,
    and ``--output`` prints each frame's BPP over its live residual count."""
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    out = os.path.join(compressed["root"], "rpcc_dev")
    capsys.readouterr()
    compress_datalist.main(["--datalist", compressed["lst"], "--output_dir", out, "--seed", "5", "--output", *BASE])
    text = capsys.readouterr().out
    lidar, cfg = lidar_config(LIDAR), CodecConfig()
    assert cfg.device_entropy
    engine = BatchEngine(lidar, cfg, "cpu", batch_size=1, workers=1)
    codec = RPCCCodec(lidar, cfg, "cpu")
    blobs = []
    for i, (pc, path) in enumerate(zip(compressed["clouds"], compressed["paths"])):
        with open(compress_datalist._mirror_path(path, out, "rpcc"), "rb") as f:
            blobs.append(f.read())
        res = engine.encode_frames([pc], [5 + i])
        assert blobs[-1] == res[0][0], i
        bits = len(blobs[-1]) * 8
        assert f"BPP: {bits / int(res.stream_len[0]):.4f}" in text
    engine.close()
    for rec, pc in zip(HostDecoder(lidar, cfg).decode_blobs(blobs), compressed["clouds"]):
        q, d = codec.project(pc)
        assert np.abs(rec - q.astype(np.float32) * d).max() <= cfg.step + 1e-5
