"""Batched throughput engine on one device: (B, H, W) frame batches through
the encoder and decoder graphs, a host pool for projection and entropy
coding (port of ``rpcc_tpu/parallel/engine.py``).

The dataset-scale path (``compress_datalist`` / ``decompress_datalist``).
Frames are host-projected onto the u16 snap grid (or, with
``transfer_precision="f32"``, to exact f32 range images) into a ring of
pinned (B, H, W) buffers, uploaded as 2-byte (4-byte) words on a copy
stream, widened and encoded on a compute stream, and their live prefixes come back on the copy
stream while the host entropy-codes the batch before (its rANS
containers through the engine's device: on a card, one kernel launch per
batch call).  With ``cfg.device_entropy`` (the default) and the ``rans``
coder, the encoder graph also codes the residual and contour fields in one
kernel launch, and what comes back is their containers' pieces, which the
codec (``codec/rans_codec.py``, through ``BasicCompressor``) makes into
the containers the host decoders read.  The pipeline
(``encode_pipeline`` / ``decode_pipeline``) runs four stages on four
threads:

  1. prepare  (stacker)    host projection into a pinned ring slot, or for
                           decode the batched entropy decode + stacking;
  2. dispatch (uploader)   H2D on the copy stream, then the graph on the
                           compute stream, after the copy's event;
  3. stage    (downloader) the (B,) lengths, read once per batch, then the
                           D2H copies of the exact live prefixes;
  4. finish   (caller)     entropy coding and framing on the pool (decode:
                           back-projection to points).

Each stage runs in a span (``utils/timer.py``) named ``engine.<stage>``
with its batch's number in the run, and the stages' waits in child spans:
``engine.slot_wait`` (a ring slot's last upload), ``engine.device_wait``
(the read of the batch's lengths, which waits for the graph) and
``engine.copy_wait`` (the D2H copies).  The frames whose i16 stream comes
back beside their device containers count under ``engine.stream_downloads``.

Every device tensor read on a stream other than the one it was made on is
marked with ``record_stream`` and stays referenced until the event of the
copy that reads it, so the caching allocator never hands its memory to the
next batch while a copy still reads it.

A batch holds only its live frames: a ragged last batch is a smaller B,
and a frame's ``.rpcc`` bytes are independent of its neighbours (the
graph and the entropy coders are): with ``device_entropy=False`` they equal
the single-frame codec's for the same seed, and with device entropy the
B = 1 engine's and ``rpcc_tpu``'s device containers for the same stream.
The JAX engine's TPU transfer codes (i8/d8/m8, bucketed prefix lengths, the
u8 sequence cast) are not ported: the wire is the u16 snap grid up and the
i16/u16 live prefixes (or compressed words) down, and decode brings back
the (B, H, W) f32 range image, so the device backend's points match the
host backend's within f32 ulps.  In place of the JAX engine's mesh, one
engine runs in each rank of a process group (``parallel/mesh.py``), and
:meth:`BatchEngine.sharded_stats` sums the ranks' totals.
"""

from __future__ import annotations

import concurrent.futures as futures
import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rpcc_tpu_torch.codec import rans_codec
from rpcc_tpu_torch.codec.bitstream import pack_bitstream, unpack_bitstream
from rpcc_tpu_torch.codec.entropy import BasicCompressor
from rpcc_tpu_torch.codec.native import native_lib
from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.models.decoder import Decoder
from rpcc_tpu_torch.models.encoder import Encoder, EncoderOutput, count_model_rows, num_model_rows
from rpcc_tpu_torch.models.pipeline import resolve_device
from rpcc_tpu_torch.ops.projection_host import build_transform_map, build_transform_planes, project_for_encoder
from rpcc_tpu_torch.parallel.aggregate import all_reduce_totals, batch_report, batch_totals
from rpcc_tpu_torch.utils import timer

RING_SLOTS = 3  # pinned upload buffers in flight


def _timed_stage(fn, stats: Optional[dict], key: str, count: bool = False):
    """``fn(batch, *a)``: the stage ``fn(*a)`` in the span ``engine.<key>``
    of batch ``batch``; with ``stats``, its wall and thread-CPU seconds
    (from the span's stamps) accumulate there, and so do the result's
    ``counts`` where it has them (an :class:`EncodedBatch`'s model rows).
    Each stage runs on one thread, so its keys have one writer."""

    def wrapped(batch: int, *a):
        with timer.span("engine." + key, batch, stamp=stats is not None) as sp:
            r = fn(*a)
        if stats is not None:
            stats[key + "_s"] = stats.get(key + "_s", 0.0) + sp.wall_ns / 1e9
            stats[key + "_cpu_s"] = stats.get(key + "_cpu_s", 0.0) + sp.cpu_ns / 1e9
            if count:
                stats["batches"] = stats.get("batches", 0) + 1
            for k, v in getattr(r, "counts", {}).items():
                stats[k] = stats.get(k, 0) + v
        return r

    return wrapped


class _Slot:
    """One pinned upload buffer of the encode ring: u16 snap grids (as
    int16 bits) or, with ``f32``, range images.  ``free`` is set once the
    H2D copy of its last use is queued (``h2d`` is that copy's event), so
    the stacker refills it only after that event fires."""

    def __init__(self, B: int, H: int, W: int, pin: bool, f32: bool):
        self.q = torch.empty((B, H, W), dtype=torch.float32 if f32 else torch.int16, pin_memory=pin)
        self.delta = torch.empty((B,), dtype=torch.float32, pin_memory=pin)
        self.seed = torch.empty((B,), dtype=torch.int64, pin_memory=pin)
        self.q_np = self.q.numpy() if f32 else self.q.numpy().view(np.uint16)
        self.h2d: Optional[torch.cuda.Event] = None
        self.free = threading.Event()
        self.free.set()


class _Prepared(NamedTuple):
    slot: _Slot
    live: int


class _Dispatched(NamedTuple):
    out: EncoderOutput  # device tensors, leading dim = live frames
    live: int
    done: Optional[torch.cuda.Event]  # the encoder's end on the compute stream


class _Staged(NamedTuple):
    live: int
    stream_len: np.ndarray  # (B,)
    seq_len: np.ndarray  # (B,)
    host: Dict[str, Optional[torch.Tensor]]  # live prefixes, host memory
    copied: Optional[torch.cuda.Event]  # the D2H copies' end on the copy stream
    out: EncoderOutput  # keeps the copies' sources referenced until ``copied``
    # Device entropy: the two piece tuples in host memory, and the frames
    # whose i16 stream prefix was downloaded (rows of host["stream"], in order).
    residual: Optional[tuple] = None
    contour: Optional[tuple] = None
    stream_rows: Optional[np.ndarray] = None


class EncodedBatch(list):
    """One ``(.rpcc payload, fields)`` per frame of a batch, and each frame's
    live residual count (its point count) in ``stream_len``: with device
    entropy the fields hold no residual stream to count.  ``counts``: the
    batch's ``model_rows`` and ``plane_rows`` (:func:`count_model_rows`)."""

    def __init__(self, items, stream_len: np.ndarray, counts: Optional[Dict[str, int]] = None):
        super().__init__(items)
        self.stream_len = stream_len
        self.counts = counts or {}


class _DecodePrepared(NamedTuple):
    host: Dict[str, Optional[torch.Tensor]]
    live: int


class _DecodeDispatched(NamedTuple):
    range_image: torch.Tensor  # (B, H, W) f32 on the device
    live: int
    done: Optional[torch.cuda.Event]


class BatchEngine:
    """Batched encode and decode of one LiDAR geometry on one device: the
    card unless the CPU is asked for.  A CUDA device is used as named and
    never swapped for the CPU; a CPU device runs the same stages
    synchronously.  ``group``: the ``torch.distributed`` process group of
    the ranks this engine is one of, for :meth:`sharded_stats`."""

    def __init__(
        self,
        lidar: LidarConfig,
        cfg: CodecConfig,
        device="cuda",
        batch_size: int = 8,
        workers: int = 4,
        group=None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.lidar = lidar
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.group = group
        self.H, self.W = lidar.height, lidar.width
        self.hw = self.H * self.W
        self.num_models = num_model_rows(cfg)
        self.encoder = Encoder.for_lidar(lidar, cfg).to(self.device)
        self.decoder = Decoder(lidar, cfg).to(self.device)
        self.entropy = BasicCompressor(method_name=cfg.basic_compressor, contour_shape=(self.H, self.W),
                                       device=self.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)
        f32 = cfg.transfer_precision == "f32"
        self._ring = [_Slot(batch_size, self.H, self.W, self._cuda, f32) for _ in range(RING_SLOTS)]
        self._ring_next = 0
        self._ring_lock = threading.Lock()
        self._pool = futures.ThreadPoolExecutor(workers)
        self._pool_cpu: Dict[str, float] = {}
        self._pool_cpu_lock = threading.Lock()
        self._stacker = futures.ThreadPoolExecutor(1)
        self._uploader = futures.ThreadPoolExecutor(1)
        self._downloader = futures.ThreadPoolExecutor(1)
        self._tm_planar = np.ascontiguousarray(build_transform_planes(lidar).reshape(3, self.hw), np.float32)
        self.transform_map = build_transform_map(lidar)

    @property
    def _step_arg(self):
        return self.cfg.step if self.cfg.uniform else self.cfg.level_acc

    def _on(self, stream_name: str):
        """Context running torch work on one of the engine's streams (a
        no-op on the CPU)."""
        if not self._cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(getattr(self, stream_name))

    def _record(self) -> Optional[torch.cuda.Event]:
        """An event at the current point of the current stream (CUDA only)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """Host -> device on the current (copy) stream; the result is
        marked for use on the compute stream."""
        dev = t.to(self.device, non_blocking=True, copy=True)
        if self._cuda:
            dev.record_stream(self._compute)
        return dev

    def _download(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Device -> pinned host on the current (copy) stream."""
        if t is None or not self._cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        t.record_stream(self._copy)
        host.copy_(t, non_blocking=True)
        return host

    def close(self) -> None:
        """Stop the engine's threads."""
        for pool in (self._stacker, self._uploader, self._downloader, self._pool):
            pool.shutdown(wait=True)

    def _pool_map(self, key: str, fn, n: int) -> list:
        """``self._pool.map(fn, range(n))`` with the workers' thread-CPU
        seconds accumulated under ``key`` (read via :meth:`pool_cpu_snapshot`)."""

        def timed(i):
            c0 = time.thread_time()
            r = fn(i)
            dt = time.thread_time() - c0
            with self._pool_cpu_lock:
                self._pool_cpu[key] = self._pool_cpu.get(key, 0.0) + dt
            return r

        return list(self._pool.map(timed, range(n)))

    def pool_cpu_snapshot(self) -> Dict[str, float]:
        """Cumulative pool-worker thread-CPU seconds per call site."""
        with self._pool_cpu_lock:
            return dict(self._pool_cpu)

    # ---------------------------------------------------------------- encode
    def _prepare_batch(self, clouds: Sequence[np.ndarray], seeds: Optional[Sequence[int]] = None) -> _Prepared:
        """Pipeline stage 1: host-project the batch into the next ring slot
        (waiting for that slot's last upload to finish)."""
        live = len(clouds)
        if not 0 < live <= self.batch_size:
            raise ValueError(f"a batch holds 1..{self.batch_size} frames, got {live}")
        seeds = [self.cfg.seed] * live if seeds is None else [int(s) for s in seeds]
        if len(seeds) != live or any(not 0 <= s <= 0xFFFFFFFF for s in seeds):
            raise ValueError(f"need {live} uint32 seeds, got {seeds}")
        with self._ring_lock:
            slot = self._ring[self._ring_next]
            self._ring_next = (self._ring_next + 1) % len(self._ring)
        with timer.span("engine.slot_wait"):
            slot.free.wait()
            slot.free.clear()
            if slot.h2d is not None:
                slot.h2d.synchronize()
        delta = slot.delta.numpy()

        def one(i: int) -> None:
            slot.q_np[i], delta[i] = project_for_encoder(clouds[i], self.lidar, self.cfg)

        try:
            self._pool_map("project", one, live)
            slot.seed.numpy()[:live] = seeds
        except BaseException:
            slot.free.set()
            raise
        return _Prepared(slot, live)

    def _dispatch_prepared(self, prepared: _Prepared) -> _Dispatched:
        """Pipeline stage 2: upload a prepared batch on the copy stream and
        queue the encoder on the compute stream behind it."""
        slot, live = prepared
        try:
            with self._on("_copy"):
                q, delta, seed = (self._upload(t[:live]) for t in (slot.q, slot.delta, slot.seed))
                h2d = self._record()
            slot.h2d = h2d
        finally:
            slot.free.set()
        with self._on("_compute"):
            if h2d is not None:
                self._compute.wait_event(h2d)
            if q.dtype == torch.int16:
                q = q.to(torch.int32) & 0xFFFF  # u16 words arrive as int16
            out = self.encoder(q, delta, seed, self._step_arg)
            done = self._record()
        return _Dispatched(out, live, done)

    def encode_batch_device(self, clouds: Sequence[np.ndarray], seeds: Optional[Sequence[int]] = None) -> _Dispatched:
        """Project, upload and launch one batch; returns without waiting for
        the device."""
        return self._dispatch_prepared(self._prepare_batch(clouds, seeds))

    def encode_batch_async(self, clouds: Sequence[np.ndarray], seeds=None) -> futures.Future:
        """:meth:`encode_batch_device` on the uploader thread."""
        return self._uploader.submit(self.encode_batch_device, clouds, seeds)

    def _download_pieces(self, pieces: tuple, read: Dict[str, np.ndarray]) -> tuple:
        """A piece tuple in host memory: the fields already ``read`` (with
        the batch's lengths) as they are, the words cut to the batch's
        largest ``n_words``, the rest downloaded whole."""
        m = max(int(read["n_words"].max()), 1)
        return pieces._make(torch.from_numpy(read[f]) if f in read else self._download(t[:, :m] if f == "words" else t)
                            for f, t in zip(pieces._fields, pieces))

    def stage_downloads(self, dispatched: _Dispatched) -> _Staged:
        """Pipeline stage 3: wait for the batch, read its (B,) lengths (the
        one host sync per batch) and queue the D2H copies of the exact live
        prefixes on the copy stream.  With device entropy those are the
        containers' pieces (their word and escape counts read with the
        lengths), and the i16 stream prefix only of the frames the codec
        names (``rans_codec.device_stream_rows``)."""
        out, live, done = dispatched
        res, cnt = out.residual_pieces, out.contour_pieces
        with self._on("_copy"):
            if done is not None:
                self._copy.wait_event(done)
            rows = [out.stream_len, out.seq_len]
            if res is not None:
                rows += [res.n_words, cnt.n_words, res.n_esc]
            lens = torch.stack([r.to(torch.int64) for r in rows])
            with timer.span("engine.device_wait"):
                lens = lens.cpu().numpy()
            m_seq = max(int(lens[1].max()), 1)
            host = {
                "sequence": self._download(out.sequence.view(torch.int16)[:, :m_seq]),
                "models": self._download(out.model_param),
                "salience": self._download(out.salience),
            }
            stream_rows = None
            if res is not None:
                res = self._download_pieces(res, {"n_words": lens[2], "n_esc": lens[4]})
                cnt = self._download_pieces(cnt, {"n_words": lens[3]})
                stream_rows = rans_codec.device_stream_rows(lens[0], lens[4])
                timer.count("engine.stream_downloads", int(stream_rows.size))
                if stream_rows.size:
                    m = max(int(lens[0][stream_rows].max()), 1)
                    sel = out.stream[:, :m].index_select(0, torch.from_numpy(stream_rows).to(out.stream.device))
                    host["stream"] = self._download(sel)
            else:
                host["stream"] = self._download(out.stream[:, : max(int(lens[0].max()), 1)])
                host["contour"] = self._download(out.contour_packed)
            copied = self._record()
        return _Staged(live, lens[0], lens[1], host, copied, out, res, cnt, stream_rows)

    def finish_staged(self, st: _Staged) -> EncodedBatch:
        """Pipeline stage 4: wait for the copies, entropy-code (big fields
        batched through the native coder, the rest on the pool), frame;
        with device entropy, the codec makes each frame's containers from
        the pieces instead (one call a frame on the pool).  With device
        entropy the fields hold only what the host sees: the sequence, the
        model table and the salience levels."""
        if st.copied is not None:
            with timer.span("engine.copy_wait"):
                st.copied.synchronize()
        h = {k: None if v is None else v.numpy() for k, v in st.host.items()}
        rows = dict(zip(("model_rows", "plane_rows"), count_model_rows(h["models"][: st.live])))
        seq = h["sequence"].view(np.uint16)

        def fields(i: int) -> Dict[str, np.ndarray]:
            f = {"idx_sequence": seq[i, : st.seq_len[i]].copy(), "plane_param": h["models"][i].astype(np.float32)}
            if h["salience"] is not None:
                f["salience_level"] = h["salience"][i].copy()
            return f

        if st.residual is not None:
            res, cnt = (p._make(t.numpy() for t in p) for p in (st.residual, st.contour))

            def one(i: int) -> Tuple[bytes, Dict[str, np.ndarray]]:
                n, f = int(st.stream_len[i]), fields(i)
                stream = None
                if i in st.stream_rows:
                    stream = h["stream"][int(np.searchsorted(st.stream_rows, i)), :n].copy()
                compressed = self.entropy.compress_dict_pieces(f, res, cnt, i, n, stream)
                return pack_bitstream(compressed, uniform=self.cfg.uniform), f

            return EncodedBatch(self._pool_map("entropy", one, st.live), st.stream_len[: st.live], rows)
        dicts = [{"residual_quantized": h["stream"][i, : st.stream_len[i]].copy(), "contour_map": h["contour"][i].copy(),
                  **fields(i)} for i in range(st.live)]
        compressed = self.entropy.compress_dict_batch(
            dicts, pool_map=lambda fn, n: self._pool_map("entropy", fn, n)
        )
        return EncodedBatch([(pack_bitstream(c, uniform=self.cfg.uniform), f) for c, f in zip(compressed, dicts)],
                            st.stream_len[: st.live], rows)

    def sharded_stats(self, results, blob_sizes: Sequence[int], errors: int = 0) -> Dict[str, float]:
        """Frames, points, bits, bpp and ratio over every rank of the
        engine's group, summed with one ``all_reduce`` (with ``errors``, a
        count of this rank's failed frames, beside them).  ``results``: an
        :class:`EncodedBatch` (its ``stream_len`` counts the points) or the
        frames' point counts; ``blob_sizes``: their payload bytes.  Only
        frames with a payload count as frames."""
        if self.group is None:
            raise ValueError("sharded_stats needs an engine with a process group")
        totals = np.append(batch_totals(getattr(results, "stream_len", results), blob_sizes), errors)
        summed = all_reduce_totals(totals, self.group)
        return {**batch_report(summed[:3]), "errors": int(summed[3])}

    def finalize_encoded(self, dispatched: _Dispatched) -> EncodedBatch:
        """Download and entropy-code one dispatched batch."""
        return self.finish_staged(self.stage_downloads(dispatched))

    def encode_frames(self, clouds: Sequence[np.ndarray], seeds=None) -> EncodedBatch:
        """One synchronous batch -> list of (.rpcc payload, fields)."""
        return self.finalize_encoded(self.encode_batch_device(clouds, seeds))

    def _run_pipeline(self, inputs, prepare, dispatch, stage, finish, stats=None):
        """4-deep, 4-thread pipeline shared by encode and decode.

        Yields one finished result per input, in order: the stacker runs
        ``prepare`` on input k, the uploader ``dispatch`` on k-1, the
        downloader ``stage`` on k-2 and the caller ``finish`` on k-3,
        each in its span ``engine.<stage>`` of batch k (the input's number
        in this run).  ``stats`` (optional dict) accumulates, from those
        spans' stamps, ``<stage>_s`` wall and ``<stage>_cpu_s`` thread-CPU
        seconds per stage, ``batches``, ``pool_<site>_cpu_s`` for the pool
        workers over the run, and on encode the model tables' ``model_rows``
        and ``plane_rows``."""
        prepare = _timed_stage(prepare, stats, "prepare")
        dispatch = _timed_stage(dispatch, stats, "dispatch")
        stage = _timed_stage(stage, stats, "stage")
        finish = _timed_stage(finish, stats, "finish", count=True)
        pool0 = None if stats is None else self.pool_cpu_snapshot()

        # (batch number, future) of each stage's batches in flight
        prepared: deque = deque()
        dispatched: deque = deque()
        staged: deque = deque()

        def to_dispatch():
            k, fut = prepared.popleft()
            dispatched.append((k, self._uploader.submit(lambda f=fut, k=k: dispatch(k, f.result()))))

        def to_stage():
            k, fut = dispatched.popleft()
            staged.append((k, self._downloader.submit(lambda f=fut, k=k: stage(k, f.result()))))

        def to_finish():
            k, fut = staged.popleft()
            return finish(k, fut.result())

        try:
            for k, item in enumerate(inputs):
                prepared.append((k, self._stacker.submit(prepare, k, item)))
                if len(prepared) >= 2:
                    to_dispatch()
                if len(dispatched) >= 2:
                    to_stage()
                if len(staged) >= 2:
                    yield to_finish()
            while prepared:
                to_dispatch()
            while dispatched:
                to_stage()
            while staged:
                yield to_finish()
        finally:
            # Let queued stages finish before returning, so no batch is
            # left touching a ring slot or a stream behind the caller, and
            # hand back the ring slots of batches that were never dispatched.
            for q in (prepared, dispatched, staged):
                for _, fut in q:
                    futures.wait([fut])
            for _, fut in prepared:
                if fut.exception() is None and isinstance(fut.result(), _Prepared):
                    fut.result().slot.free.set()
            if pool0 is not None:
                for k, v in self.pool_cpu_snapshot().items():
                    d = v - pool0.get(k, 0.0)
                    if d > 0.0:
                        stats[f"pool_{k}_cpu_s"] = stats.get(f"pool_{k}_cpu_s", 0.0) + d

    def encode_pipeline(self, batches, stats=None):
        """Pipelined encode over an iterable of ``(clouds, seeds)``; yields
        one list of (.rpcc payload, fields) per batch, equal to
        :meth:`encode_frames` of that batch."""
        return self._run_pipeline(
            batches,
            lambda cs: self._prepare_batch(*cs),
            self._dispatch_prepared,
            self.stage_downloads,
            self.finish_staged,
            stats=stats,
        )

    # ---------------------------------------------------------------- decode
    def _prepare_decode(self, blobs: Sequence[bytes]) -> _DecodePrepared:
        """Decode stage 1: entropy-decode a batch (big fields batched) and
        stack it into (pinned) host arrays, zero-padded to the live maxima;
        model tables pad to the configuration's row count."""
        live = len(blobs)
        if not 0 < live <= self.batch_size:
            raise ValueError(f"a batch holds 1..{self.batch_size} blobs, got {live}")
        packed = [unpack_bitstream(b, uniform=self.cfg.uniform) for b in blobs]
        fields = self.entropy.decompress_dict_batch(
            packed, pool_map=lambda fn, n: self._pool_map("entropy_decode", fn, n)
        )
        nb = (self.hw + 7) // 8
        M = self.num_models
        seqs = [np.frombuffer(f["idx_sequence"], np.uint16) for f in fields]
        streams = [np.frombuffer(f["residual_quantized"], np.int16) for f in fields]
        pin = self._cuda

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        host = {
            "contour": zeros((live, nb), torch.uint8),
            "sequence": zeros((live, max(max(s.size for s in seqs), 1)), torch.int16),  # u16 bits
            "stream": zeros((live, max(max(s.size for s in streams), 1)), torch.int16),
            "models": zeros((live, M, 4), torch.float32),
            "salience": None if self.cfg.uniform else zeros((live, M), torch.uint8),
        }
        arr = {k: None if v is None else v.numpy() for k, v in host.items()}
        for i, f in enumerate(fields):
            contour = np.frombuffer(f["contour_map"], np.uint8)
            models = np.frombuffer(f["plane_param"], np.float32).reshape(-1, 4)
            if contour.size != nb or models.shape[0] > M:
                raise ValueError(
                    f"frame {i}: {contour.size} contour bytes and {models.shape[0]} model rows "
                    f"do not fit a {self.H}x{self.W} grid with {M} models"
                )
            arr["contour"][i] = contour
            arr["sequence"][i, : seqs[i].size] = seqs[i].view(np.int16)
            arr["stream"][i, : streams[i].size] = streams[i]
            arr["models"][i, : models.shape[0]] = models
            if arr["salience"] is not None:
                sal = np.frombuffer(f["salience_level"], np.uint8)[:M]
                arr["salience"][i, : sal.size] = sal
        return _DecodePrepared(host, live)

    def _dispatch_decode(self, prepared: _DecodePrepared) -> _DecodeDispatched:
        """Decode stage 2: upload on the copy stream, decode on the compute
        stream behind it."""
        host, live = prepared
        with self._on("_copy"):
            dev = {k: None if v is None else self._upload(v) for k, v in host.items()}
            h2d = self._record()
        with self._on("_compute"):
            if h2d is not None:
                self._compute.wait_event(h2d)
            seq = dev["sequence"].to(torch.int32) & 0xFFFF
            dec = self.decoder(dev["contour"], seq, dev["stream"], dev["models"], self._step_arg, dev["salience"])
            done = self._record()
        return _DecodeDispatched(dec.range_image, live, done)

    def decode_blobs_device(self, blobs: Sequence[bytes]) -> _DecodeDispatched:
        """Entropy-decode, stack, upload and launch one decode batch."""
        return self._dispatch_decode(self._prepare_decode(blobs))

    def _materialize_ris(self, dispatched: _DecodeDispatched) -> Tuple[np.ndarray, int]:
        """Decode stage 3: download the (B, H, W) f32 range images."""
        ri, live, done = dispatched
        with self._on("_copy"):
            if done is not None:
                self._copy.wait_event(done)
            host = self._download(ri)
            copied = self._record()
        if copied is not None:
            copied.synchronize()
        return host.numpy(), live

    def _points_from_ris(self, ris: np.ndarray, live: int) -> List[np.ndarray]:
        """-> (H, W, 3) clouds."""
        return [ris[i][..., None] * self.transform_map for i in range(live)]

    def _points4_from_ris(self, ris: np.ndarray, live: int) -> List[np.ndarray]:
        """-> compacted (n, 4) f32 xyz0 rows per frame, the .bin save format
        (rows whose x+y+z is 0 dropped), by the native ``backproject_compact``."""
        import ctypes as ct

        lib = native_lib()
        tm_p = self._tm_planar.ctypes.data_as(ct.c_void_p)
        out: List[np.ndarray] = []
        for i in range(live):
            ri = np.ascontiguousarray(ris[i], np.float32)
            buf = np.empty((self.hw, 4), np.float32)
            n = lib.backproject_compact(
                ri.ctypes.data_as(ct.c_void_p), tm_p, ct.c_int64(self.hw), buf.ctypes.data_as(ct.c_void_p)
            )
            out.append(buf[: int(n)])
        return out

    def decode_range_images(self, blobs: Sequence[bytes]) -> np.ndarray:
        """-> the (B, H, W) f32 range images of a batch of payloads."""
        ris, live = self._materialize_ris(self.decode_blobs_device(blobs))
        return ris[:live]

    def decode_blobs(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> (H, W, 3) clouds."""
        return self._points_from_ris(*self._materialize_ris(self.decode_blobs_device(blobs)))

    def decode_blobs_points(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        """-> compacted (n, 4) f32 xyz0 rows per frame, the .bin save format."""
        return self._points4_from_ris(*self._materialize_ris(self.decode_blobs_device(blobs)))

    def decode_pipeline(self, blob_batches, stats=None):
        """Pipelined decode over an iterable of blob lists (mirror of
        :meth:`encode_pipeline`): yields per batch the compacted (n, 4)
        rows of :meth:`decode_blobs_points`."""
        return self._run_pipeline(
            blob_batches,
            self._prepare_decode,
            self._dispatch_decode,
            self._materialize_ris,
            lambda rl: self._points4_from_ris(*rl),
            stats=stats,
        )
