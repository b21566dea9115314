"""A tiny CPU rehearsal of every cell's loop (four frames, a one-second
window), the control that ``correct`` has to refuse, and the faults it has
to catch: the timed path broken underneath, the rest of the run as it is.

These runs skip the harness's look for a card (``run.run_cell`` on the
CPU); ``run.main`` keeps it, and the ``cuda`` test drives it on a card."""

import json

import numpy as np
import pytest

from portbench import bench, run

SPEC = bench.load_benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = {"traffic": {"frames": 4, "batch_size": 4}}


def _run(cell, seconds=1.0, overrides=SMALL, **kw):
    return run.run_cell(cell, 2**31 + 99, seconds, False, device="cpu", overrides=overrides, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_reports_the_cells_metrics(cell):
    out = _run(cell, seconds=4.0)  # long enough for a CPU batch to finish inside the window
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in bench.metrics_for(SPEC, cell, "end_to_end")}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["checks"]["depth_err_over_bound"]["value"] <= 1.001
    json.dumps(out)


def test_a_traced_rehearsal_reads_the_per_layer_metrics_and_a_breakdown():
    # On the CPU the host's operators stand in for the card's (portbench/trace.py).
    cell = "hdl64e_kitti_default.sensor_10hz"
    out = run.run_cell(cell, 2**31 + 98, 3.0, True, device="cpu",
                       overrides={"traffic": {"frames": 4, "trace_seconds": 1.0}})
    assert out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in bench.metrics_for(SPEC, cell, "per_layer")}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps and all(isinstance(name, str) and seconds > 0 for name, seconds in gaps)
    assert 1 <= len(out["breakdown"]["device_ops"]) <= 10


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_refused(cell):
    out = _run(cell, control="bf16")
    assert not out["correct"]
    assert out["checks"]["depth_err_over_bound"]["value"] > out["checks"]["depth_err_over_bound"]["limit"]


def _flip(blob: bytes) -> bytes:
    """One bit flipped in the middle of the payload's residual container."""
    from portbench import reference

    for uniform in (True, False):
        try:
            f = reference.unpack_payload(blob, uniform)
            break
        except reference.Undecodable:
            continue
    off = blob.index(f["residual_quantized"]) + len(f["residual_quantized"]) // 2
    return blob[:off] + bytes([blob[off] ^ 0x10]) + blob[off + 1:]


def _encode_fault(kind):
    from rpcc_tpu_torch.parallel.engine import BatchEngine, EncodedBatch

    orig = BatchEngine.finish_staged
    prev = []

    def broken(self, st):
        res = orig(self, st)
        items = list(res)
        if kind == "half":  # half of the batch left out, the rest repeated in its place
            h = max(1, len(items) // 2)
            items = items[:h] + items[: len(items) - h]
        elif kind == "altered":  # an answer altered where it is produced
            items[0] = (_flip(items[0][0]), items[0][1])
        elif kind == "stale":  # a step that returns its state unchanged: the previous batch again
            prev.append(items)
            items = prev[-2] if len(prev) > 1 else items
        return EncodedBatch(items, res.stream_len)

    return BatchEngine, "finish_staged", broken


def _levels_fault(kind):
    """Every cluster at the coarsest salience level ("coarse"), as a program
    that dropped its key points or its levels would code it."""
    from rpcc_tpu_torch.models import encoder

    orig = encoder.salience_levels_from_counts

    def broken(kp_cnt, counts, level_kp_num, ground_level):
        lvl = orig(kp_cnt, counts, level_kp_num, ground_level)
        return lvl.clamp(min=len(level_kp_num) - 1)

    return encoder, "salience_levels_from_counts", broken


def _codec_fault(kind):
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    orig = RPCCCodec.compress
    prev = []

    def broken(self, points, seed=None):
        blob, fields, times = orig(self, points, seed)
        if kind == "altered":
            blob = _flip(blob)
        elif kind == "stale":
            prev.append(blob)
            blob = prev[-2] if len(prev) > 1 else blob
        return blob, fields, times

    return RPCCCodec, "compress", broken


FAULTS = [
    ("hdl64e_kitti_default.archive_encode", _encode_fault, "half"),
    ("hdl64e_kitti_default.archive_encode", _encode_fault, "altered"),
    ("hdl64e_kitti_default.archive_encode", _encode_fault, "stale"),
    ("hdl32e_nclt_dbscan_nonuniform.archive_encode", _encode_fault, "half"),
    ("hdl32e_nclt_dbscan_nonuniform.archive_encode", _encode_fault, "altered"),
    ("hdl32e_nclt_dbscan_nonuniform.archive_encode", _encode_fault, "stale"),
    ("hdl32e_nclt_dbscan_nonuniform.archive_encode", _levels_fault, "coarse"),
    ("hdl64e_kitti_default.sensor_10hz", _codec_fault, "altered"),
    ("hdl64e_kitti_default.sensor_10hz", _codec_fault, "stale"),
]


@pytest.mark.parametrize("cell,fault,kind", FAULTS, ids=[f"{c}-{k}" for c, _, k in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, kind, monkeypatch):
    monkeypatch.setattr(*fault(kind))
    # a stale answer needs a second distinct batch (or frame) to stand in for
    out = _run(cell, overrides={"traffic": {"frames": 8, "batch_size": 4}} if kind == "stale" else SMALL)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 41, 2**32 + 43, 2**33 + 47])
def test_coarse_levels_are_refused_on_the_card(card, seed, monkeypatch, capsys):
    """The 32E cell at its own size on the card, every cluster coded at the
    coarsest level: ``correct`` false, the reading printed."""
    monkeypatch.setattr(*_levels_fault("coarse"))
    out = run.run_cell("hdl32e_nclt_dbscan_nonuniform.archive_encode", seed, 5.0, False)
    with capsys.disabled():
        print(f"coarse levels, seed {seed}: correct {out['correct']}, failed {out['failed']} of "
              f"{out['attempted']}, checks {json.dumps(out['checks'])}")
    assert not out["correct"]
    assert out["checks"]["depth_err_over_bound"]["value"] > out["checks"]["depth_err_over_bound"]["limit"]


@pytest.mark.cuda
def test_one_short_run_on_the_card(card, capsys):
    assert run.main(["--workload", CELLS[0], "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_without_a_card_the_run_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
