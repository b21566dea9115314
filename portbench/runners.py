"""The traffic runners: the system under test, ``rpcc_tpu_torch``, run
through the entry points its users call, with the window timed by the
host's clock.

A traffic file names its runner and parameters:

* ``engine_encode``: closed loop, ``BatchEngine.encode_pipeline`` over
  batches of ``batch_size`` frames cycled in the seed's order (dataset
  jobs, ``compress_datalist``);
* ``codec_stream``: open loop, one frame due every ``period_s`` seconds
  through ``RPCCCodec.compress`` (a vehicle coding each sweep as it
  arrives), each frame timed from when it was due.

Set-up (counted in ``setup_s``): the program's imports and the card's
context, the frames, the engine or codec, and a warm-up pass over every
batch (or frame) the window will send, so every kernel is built and
loaded before the window opens.  The window is then ``seconds`` long.
With ``trace`` its last ``trace_seconds`` run apart: the profiler is
started while the program is idle (its first start takes seconds), that
part runs on a pipeline or schedule of its own, and the profiler stops
once the program is idle again; the program's own stage totals and
timings, and the end-to-end readings, come from the part before it.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from portbench.frames import FrameSet
from portbench.trace import DeviceTrace, Spans, TraceResult

ENGINE_ENCODE_STAGES = {"_prepare_batch": "prepare", "_dispatch_prepared": "dispatch",
                        "stage_downloads": "stage", "finish_staged": "finish"}
DRAIN_LIMIT_S = 60.0  # an open loop's backlog is served this long past the window, then counted missing


class Record(NamedTuple):
    loop: str  # "closed" or "open"
    setup_s: float  # process start to the window's start
    window_s: float
    frames_done: int  # frames completed in the window
    missing: int  # frames due in the window that never came back
    outputs: list  # (frame index, payload bytes)
    batches: list  # the frame indices of each batch the window cycles
    latencies_s: Optional[list]  # open loop: each due frame, from due to done
    lateness_s: Optional[list]  # open loop: each due frame, from due to its start
    stats: Optional[dict]  # engine stage totals over the untraced part of the window
    timings: Optional[list]  # codec timing dicts over the untraced part of the window
    trace: Optional[TraceResult]
    memory_peak_bytes: int
    cpu_s: Optional[float] = None  # closed loop: the process's CPU seconds over the untraced part of the window


class Context(NamedTuple):
    config: dict
    traffic: dict
    frames: FrameSet
    seconds: float
    trace: bool
    device: str
    seed: int
    control: Optional[str]  # "bf16": the program's inputs held in bfloat16
    t_start: float  # perf_counter at process start


def program_config(config: dict):
    """The port's ``(LidarConfig, CodecConfig)`` of a configuration file."""
    from rpcc_tpu_torch.config import CodecConfig, LidarConfig

    lid = config["lidar"]
    table = lid.get("vertical_angles_deg")
    lidar = LidarConfig(config["name"], float(lid["horizontal_fov_deg"]), float(lid["vertical_angle_max_deg"]),
                        float(lid["vertical_angle_min_deg"]), int(lid["height"]), int(lid["width"]),
                        None if table is None else tuple(float(a) for a in table))
    codec = dict(config["codec"])
    for k in ("level_key_point_num", "level_delta_acc"):
        codec[k] = tuple(codec[k])
    return lidar, CodecConfig(**codec)


def bf16(a: np.ndarray) -> np.ndarray:
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def _program_inputs(ctx: Context) -> List[np.ndarray]:
    if ctx.control == "bf16":
        return [bf16(c) for c in ctx.frames.clouds]
    return ctx.frames.clouds


def _batches(ctx: Context) -> List[List[int]]:
    b = int(ctx.traffic["batch_size"])
    order = [int(k) for k in ctx.frames.order]
    return [order[i: i + b] for i in range(0, len(order), b)]


def _span_methods(obj, names: Dict[str, str], spans: Spans) -> None:
    for attr, name in names.items():
        setattr(obj, attr, spans.wrap(name, getattr(obj, attr)))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def _stage_totals(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()}


class _Part(NamedTuple):
    """One pipeline run's window: when it opened and closed (perf_counter
    and wall-clock ns), the frames it completed, the frames its batches
    lacked, the engine's stage totals over it and the process's CPU
    seconds over it (every thread, from the opening result to the first
    result past the close, as the stage totals)."""

    t0: float
    t_end: float
    ns: tuple
    done: int
    missing: int
    stats: dict
    cpu_s: float


def _pump(pipeline, inputs: list, sizes: List[int], keep, seconds: float, warm: bool) -> _Part:
    """Drive one ``pipeline(feed, stats)`` with ``inputs`` cycled.  With
    ``warm`` the window opens at the result that ends one pass over the
    inputs, else at the first result (the pipeline is full from then on);
    the feed stops ``seconds`` later and the pipeline drains.
    ``keep(i, result, in_window)`` sees every result after the opening."""
    stats: dict = {}
    clock = {"t0": None, "t_end": None}
    marks: dict = {}

    def feed():
        for j in itertools.count():
            if clock["t_end"] is not None and time.perf_counter() >= clock["t_end"]:
                return
            yield inputs[j % len(inputs)]

    skip = len(inputs) if warm else 1
    done = missing = 0
    for j, res in enumerate(pipeline(feed(), stats)):
        now = time.perf_counter()
        if j == skip - 1:
            clock["t0"], clock["t_end"] = now, now + seconds
            marks["open"], marks["open_ns"], marks["open_cpu"] = dict(stats), time.time_ns(), time.process_time()
            continue
        if j < skip:
            continue
        i = j % len(inputs)
        in_window = now <= clock["t_end"]
        if in_window:
            done += len(res)
        elif "close" not in marks:
            marks["close"], marks["close_ns"], marks["close_cpu"] = dict(stats), time.time_ns(), time.process_time()
        missing += max(0, sizes[i] - len(res))
        keep(i, res, in_window)
    marks.setdefault("close", dict(stats))
    marks.setdefault("close_ns", time.time_ns())
    marks.setdefault("close_cpu", time.process_time())
    return _Part(clock["t0"], clock["t_end"], (marks["open_ns"], marks["close_ns"]), done, missing,
                 _stage_totals(marks["close"], marks["open"]), marks["close_cpu"] - marks["open_cpu"])


def _closed_loop(ctx: Context, spans: Spans, pipeline, inputs: list, sizes: List[int], keep):
    """The closed loop's window: one pipeline over a warm-up pass and
    then ``seconds`` (with a trace, ``seconds - trace_seconds``); with a
    trace, the profiler is started while the program is idle, a second
    pipeline runs ``trace_seconds`` from its first result, and the
    profiler stops once it has drained.  -> (untraced part, trace)."""
    trace_s = float(ctx.traffic["trace_seconds"]) if ctx.trace else 0.0
    part = _pump(pipeline, inputs, sizes, keep, ctx.seconds - trace_s, warm=True)
    if not ctx.trace:
        return part, None
    tracer = DeviceTrace(ctx.device)
    tracer.start()
    traced = _pump(pipeline, inputs, sizes, keep, trace_s, warm=False)
    trace = tracer.stop(spans.snapshot(), window_ns=traced.ns)
    return part._replace(missing=part.missing + traced.missing), trace


def engine_encode(ctx: Context, spans: Spans) -> Record:
    from rpcc_tpu_torch.parallel.engine import BatchEngine

    lidar, cfg = program_config(ctx.config)
    eng = BatchEngine(lidar, cfg, ctx.device, batch_size=int(ctx.traffic["batch_size"]))
    try:
        _span_methods(eng, ENGINE_ENCODE_STAGES, spans)
        batches = _batches(ctx)
        clouds = _program_inputs(ctx)
        inputs = [([clouds[k] for k in b], None) for b in batches]
        outputs: list = []

        def keep(i, res, in_window):
            outputs.extend((k, blob) for k, (blob, _) in zip(batches[i], res))

        part, trace = _closed_loop(ctx, spans, lambda feed, st: eng.encode_pipeline(feed, stats=st),
                                   inputs, [len(b) for b in batches], keep)
        _sync(ctx.device)
        peak = _peak(ctx.device)
    finally:
        eng.close()
    return Record("closed", part.t0 - ctx.t_start, part.t_end - part.t0, part.done, part.missing,
                  outputs, batches, None, None, part.stats, None, trace, peak, part.cpu_s)


class _Stream(NamedTuple):
    """One open-loop schedule: its start (perf_counter and wall-clock ns
    of its window), each due frame's payload, latency from due to done
    and lateness from due to start, the codec's timings, the frames done
    inside the window and those never served."""

    t0: float
    ns: tuple
    outputs: list
    latencies: list
    lateness: list
    timings: list
    done: int
    missing: int


def _schedule(compress, wait, clouds, order: List[int], period: float, seconds: float, first: int) -> _Stream:
    """Frames ``order[first], order[first + 1], ...`` (cycled) due every
    ``period`` seconds for ``seconds``, each compressed when it is due or,
    if the previous one ran late, as soon as that is done."""
    due_n = int(math.ceil(seconds / period - 1e-9))
    outputs, lat, late, timings = [], [], [], []
    done = 0
    t0, t0_ns = time.perf_counter(), time.time_ns()
    for idx in range(due_n):
        due = t0 + idx * period
        now = time.perf_counter()
        if now > t0 + seconds + DRAIN_LIMIT_S:
            break
        if due > now:
            wait(due - now)
        start = time.perf_counter()
        k = order[(first + idx) % len(order)]
        blob, _, timing = compress(clouds[k])
        end = time.perf_counter()
        outputs.append((k, blob))
        done += end <= t0 + seconds
        lat.append(end - due)
        late.append(start - due)
        timings.append(timing)
    return _Stream(t0, (t0_ns, t0_ns + int(seconds * 1e9)), outputs, lat, late, timings, done,
                   due_n - len(outputs))


def codec_stream(ctx: Context, spans: Spans) -> Record:
    from rpcc_tpu_torch.models.pipeline import RPCCCodec

    lidar, cfg = program_config(ctx.config)
    codec = RPCCCodec(lidar, cfg, ctx.device)
    codec.encode_device = spans.wrap("device_encode", codec.encode_device)
    codec.fields_from_device = spans.wrap("gather_fields", codec.fields_from_device)
    codec.entropy.compress_dict = spans.wrap("entropy", codec.entropy.compress_dict)
    compress = spans.wrap("compress", codec.compress)
    wait = spans.wrap("wait", time.sleep)
    clouds = _program_inputs(ctx)
    order = [int(k) for k in ctx.frames.order]
    for k in order:  # warm-up: every frame the window sends
        compress(clouds[k])
    _sync(ctx.device)
    period = float(ctx.traffic["period_s"])
    trace_s = float(ctx.traffic["trace_seconds"]) if ctx.trace else 0.0
    part = _schedule(compress, wait, clouds, order, period, ctx.seconds - trace_s, 0)
    trace = None
    if ctx.trace:  # the profiler starts and stops between frames, on a schedule of its own
        tracer = DeviceTrace(ctx.device)
        tracer.start()
        traced = _schedule(compress, wait, clouds, order, period, trace_s, len(part.outputs))
        trace = tracer.stop(spans.snapshot(), window_ns=traced.ns)
        part = part._replace(outputs=part.outputs + traced.outputs, missing=part.missing + traced.missing)
    _sync(ctx.device)
    peak = _peak(ctx.device)
    return Record("open", part.t0 - ctx.t_start, ctx.seconds - trace_s, part.done, part.missing,
                  part.outputs, [[k] for k in order], part.latencies, part.lateness, None, part.timings,
                  trace, peak)


RUNNERS = {"engine_encode": engine_encode, "codec_stream": codec_stream}
