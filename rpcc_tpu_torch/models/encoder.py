"""The encoder graph (port of ``rpcc_tpu/models/encoder.py``): FPS (over
the zero-masked grid, or with ``cpu_fps`` over the compacted non-ground
set) or DBSCAN segmentation, point or plane models,
uniform or non-uniform (salience) quantization, on evenly spaced LiDARs or
ones with a channel table (CSV).

Input: a (B, H, W) batch of grids ``q``, each frame's ``delta`` (``ri = q
* delta``, projected on the host: a u16 snap grid, or in
``transfer_precision="f32"`` the exact f32 range image with delta 1) and
seed.  Output: every codec
artefact the host entropy-codes — segmentation, model table, the
cluster-ordered quantized residual stream, the contour code and, in
non-uniform mode, the per-cluster salience levels — each with a leading B;
with ``cfg.device_entropy`` and the ``rans`` coder also the residual and
contour containers' pieces, coded on the device by one kernel launch.
The batch runs as one graph (the JAX package's ``jax.vmap`` of the frame
graph): no loop over frames and no host sync inside; a frame's outputs do
not depend on the other frames of its batch.  A single (H, W) frame is the
B = 1 case, returned without the batch dimension.  The graph's issue runs
in the span ``graph`` (``utils/timer.py``), its parts in ``graph.segment``,
``graph.features`` (non-uniform), ``graph.sort``, ``graph.models`` (with
plane models its ``graph.models.hypotheses``, ``graph.models.refit`` and
``graph.models.angle``), ``graph.quantize``, ``graph.contour`` and
``graph.entropy`` (device entropy): nothing in it waits for the device,
so they time the host's issue of its launches.  Whoever downloads the
model table counts its rows (:func:`count_model_rows`).

On a card the graph's ~2,200 small launches cost far more to issue from
Python than to run, so :meth:`Encoder.forward` keeps one CUDA graph per
input key (device, B, H, W, ``q``'s dtype and the step; an unbatched call
is the B = 1 batch) and replays it:

1. the first call of a key runs the graph eagerly (``graph.eager``), so a
   one-shot compress or a ragged last batch pays nothing more;
2. the second allocates static inputs (``q``, the f32 ``delta``, the
   int64 seeds), captures the graph over them on a side stream
   (``graph.captures``; the parts' spans as in an eager call) and replays
   it as a later call does;
3. every later call copies its inputs into the static ones, replays the
   graph on the current stream and returns clones of its static outputs,
   made on that stream, so the caller keeps them while the next replay
   runs (``graph.replays``, in the span ``graph.replay``).

The captured graph reads device memory only: the graph's fixed constants
are kept on the card (``ops/const.py``) and the inputs reach it through
the static tensors.  The hand-written kernels run as its nodes; the
``launch.*`` counters count them at each replay, not at the capture.  The
CPU path stays eager.

Raw (N, 3) clouds (the reference's ``from_ri=False`` entry) are projected
on the module's device (``ops/projection.py``) and run through the same
graph as f32 range images with delta 1: :meth:`Encoder.encode_points`,
:func:`make_encoder` and :func:`make_batch_encoder`.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.ops import prng
from rpcc_tpu_torch.ops.const import device_const
from rpcc_tpu_torch.ops.contour import extract_contour, pack_bits_msb
from rpcc_tpu_torch.ops.features import extract_features_with_segment, salience_levels_from_counts
from rpcc_tpu_torch.ops.modeling import plane_models_stream, point_model_table
from rpcc_tpu_torch.ops.projection import project_points
from rpcc_tpu_torch.ops.projection_host import build_transform_planes
from rpcc_tpu_torch.ops.rans_device import ContourPieces, ResidualPieces, encode_fields_device
from rpcc_tpu_torch.ops.rounding import round_half_away
from rpcc_tpu_torch.ops.segment import segment_range_image, segment_range_image_dbscan
from rpcc_tpu_torch.ops.stream import (
    expand_per_cluster,
    per_cluster_sums,
    point_means_stream,
    predict_stream,
    rays_from_perm,
    stream_sort,
)
from rpcc_tpu_torch.utils import timer


def num_model_rows(cfg: CodecConfig) -> int:
    """Model-table rows: FPS = ground + zero-class + K clusters (DBSCAN adds
    a noise class).  Seg ids ride a 12-bit field of the packed contour
    sort, so more than 4095 ids would corrupt the idx_sequence field."""
    rows = cfg.cluster_num + (3 if cfg.segment_method == "DBSCAN" else 2)
    if rows >= (1 << 12):
        raise ValueError(
            f"cluster_num={cfg.cluster_num} needs {rows} model ids, over the "
            f"codec's 4095-id limit"
        )
    return rows


def count_model_rows(model_param: np.ndarray) -> Tuple[int, int]:
    """``(rows, plane_rows)`` of downloaded (..., M, 4) model tables: the
    cluster rows (ids 2 and up) that are not empty (a nonzero entry), and
    of those the ones that carry a plane (``a + b + c != 0``, the
    decoder's test), added to the counters ``models.rows`` and
    ``models.plane_rows`` (``utils/timer.py``)."""
    rows = np.asarray(model_param, np.float32)[..., 2:, :]
    n_rows = int((rows != 0).any(-1).sum())
    n_planes = int((rows[..., 0] + rows[..., 1] + rows[..., 2] != 0).sum())
    timer.count("models.rows", n_rows)
    timer.count("models.plane_rows", n_planes)
    return n_rows, n_planes


class EncoderOutput(NamedTuple):
    range_image: torch.Tensor  # (B, H, W) f32
    seg_idx: torch.Tensor  # (B, H, W) i32
    model_param: torch.Tensor  # (B, M, 4) f32; row 0 = ground plane
    stream: torch.Tensor  # (B, HW) i16 quantized residuals, tail-padded
    stream_len: torch.Tensor  # (B,) number of live residuals
    contour_packed: torch.Tensor  # (B, ceil(HW/8)) u8, np.packbits layout
    sequence: torch.Tensor  # (B, HW) u16 run values, tail-padded
    seq_len: torch.Tensor  # (B,) number of live run values
    salience: Optional[torch.Tensor] = None  # (B, M) u8 levels; non-uniform mode only
    # Device entropy coding (cfg.device_entropy with the rans coder): the
    # residual and contour containers' pieces as encode_fields_device gives
    # them; codec/rans_codec.py makes the containers.
    residual_pieces: Optional[ResidualPieces] = None
    contour_pieces: Optional[ContourPieces] = None

    def map(self, fn) -> "EncoderOutput":
        """``fn`` of every tensor, the pieces' included (None stays None)."""
        return self._make(None if f is None else f._make(fn(t) for t in f) if isinstance(f, tuple) else fn(f)
                          for f in self)


_SEEN = object()  # a key whose eager call has run


class _Captured:
    """One key's CUDA graph of :meth:`Encoder._graph` over static inputs,
    its static outputs, the counts its capture held back and the event
    after the last replay's clones."""

    def __init__(self, enc: "Encoder", q: torch.Tensor, step):
        B = q.shape[0]
        dev = q.device
        self.q = torch.empty(q.shape, dtype=q.dtype, device=dev)
        self.delta = torch.empty((B,), dtype=torch.float32, device=dev)
        self.seed = torch.empty((B,), dtype=torch.int64, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # thread_local: the engine's other threads copy and synchronise
        # while this one captures.
        with timer.holding_counts() as held, torch.cuda.graph(self.graph, stream=side,
                                                              capture_error_mode="thread_local"):
            self.out = enc._graph(self.q, self.delta, self.seed, step)
        self.held = held
        self.done = torch.cuda.Event()
        timer.count("graph.captures")

    def replay(self, q: torch.Tensor, delta: torch.Tensor, seed) -> EncoderOutput:
        """The graph on the caller's inputs, on the current stream, after
        the last replay's clones (on whatever stream they ran)."""
        with timer.span("graph.replay"):
            stream = torch.cuda.current_stream(q.device)
            stream.wait_event(self.done)
            self.q.copy_(q)
            self.delta.copy_(delta)
            self.seed.copy_(prng.seed_words(seed, q.device))
            self.graph.replay()
            out = self.out.map(torch.clone)
            self.done.record(stream)
        for name, n in self.held.items():
            timer.count(name, n)
        timer.count("graph.replays")
        return out


class Encoder(nn.Module):
    """Batched encoder over a (3, H, W) ray table (e.g. the JAX package's
    ``build_transform_planes`` output); ``.to(device)`` moves the table."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig, tm_planes: np.ndarray):
        super().__init__()
        self.lidar, self.cfg = lidar, cfg
        self.num_models = num_model_rows(cfg)
        # Device entropy coding: the knob, with the rans coder only.
        self.device_entropy = bool(cfg.device_entropy) and cfg.basic_compressor == "rans"
        self.register_buffer("tm_planes", torch.from_numpy(np.asarray(tm_planes, np.float32)))
        # The in-graph projection's channel table, built as the reference's
        # encoder builds it (degrees * pi / 180 in float64, then f32).
        v_angles = None
        if not lidar.even_dist:
            v_angles = torch.tensor([a * math.pi / 180.0 for a in lidar.vertical_angles_deg], dtype=torch.float32)
        self.register_buffer("v_angles", v_angles)
        # CUDA graphs by input key: _SEEN after the key's eager call, then
        # its _Captured.
        self._captures: Dict[tuple, object] = {}
        self._captures_lock = threading.Lock()

    @classmethod
    def for_lidar(cls, lidar: LidarConfig, cfg: CodecConfig) -> "Encoder":
        return cls(lidar, cfg, build_transform_planes(lidar))

    def _apply(self, fn, *args, **kwargs):
        # A captured graph reads the buffers where they were: moving them
        # drops the graphs.
        with self._captures_lock:
            self._captures.clear()
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def forward(
        self, q: torch.Tensor, delta: torch.Tensor, seed, step: Union[float, Sequence[float]]
    ) -> EncoderOutput:
        """``q``: (B, H, W) integer snap grids (or f32 range images, with
        delta 1) on this module's device; ``delta``: (B,) f32; ``seed``: (B,) uint32 seeds (a sequence, or a
        tensor); ``step``: the quantization step, or in non-uniform mode
        the step of each salience level.  A single (H, W) grid with a 0-d
        delta and an int seed gives unbatched outputs."""
        with timer.span("graph"):
            single = q.ndim == 2
            if single:
                q, delta, seed = q[None], delta.reshape(1), [seed]
            if q.device.type == "cuda":
                out = self._on_card(q, delta, seed, step)
            else:
                out = self._graph(q, delta, seed, step)
            return out.map(lambda t: t[0]) if single else out

    def _on_card(self, q: torch.Tensor, delta: torch.Tensor, seed, step) -> EncoderOutput:
        """The batched graph on a card: eager at a key's first call, then
        captured and replayed (the module docstring)."""
        key = (q.device, *q.shape, q.dtype, np.shape(step), tuple(np.ravel(step).tolist()))
        with self._captures_lock:
            cap = self._captures.get(key)
            if cap is not None:
                if cap is _SEEN:
                    cap = self._captures[key] = _Captured(self, q, step)
                return cap.replay(q, delta, seed)
            self._captures[key] = _SEEN
        timer.count("graph.eager")
        return self._graph(q, delta, seed, step)

    def _graph(self, q: torch.Tensor, delta: torch.Tensor, seed, step) -> EncoderOutput:
        """The batched graph of :meth:`forward`."""
        cfg = self.cfg
        dev = self.tm_planes.device
        B, H, W = q.shape
        hw = H * W
        with timer.span("graph.segment"):
            keys = prng.split(prng.prng_key(seed, dev))  # (B, 2, 2)
            k_seg, k_model = keys[:, 0], keys[:, 1]

            ri = q.to(torch.float32) * delta.to(torch.float32)[:, None, None]
            pc_planes = ri[:, None] * self.tm_planes  # (B, 3, H, W)
            if cfg.segment_method == "DBSCAN":
                seg, ground_model, _ = segment_range_image_dbscan(
                    pc_planes, ri, self.tm_planes, k_seg, cfg.dbscan_eps, cfg.cluster_num
                )
            else:
                seg, ground_model, _ = segment_range_image(
                    pc_planes, ri, self.tm_planes, k_seg, cfg.ground_threshold, cfg.cluster_num, cfg.cpu_fps
                )

        # Evenly spaced rays are recomputed from the stream order; a
        # channel table's rays ride the sort as payloads.
        payloads = [ri.reshape(B, hw)]
        if not self.lidar.even_dist:
            payloads += [self.tm_planes[i].reshape(1, hw).expand(B, hw) for i in range(3)]
        if not cfg.uniform:
            with timer.span("graph.features"):
                _, kp_map = extract_features_with_segment(
                    ri, seg, feature_region=cfg.feature_region, segments=cfg.segments,
                    sharp_num=cfg.sharp_num, less_sharp_num=cfg.less_sharp_num,
                    flat_num=cfg.flat_num, want_feature_map=False,
                )
                payloads.append((kp_map.reshape(B, hw) > 0).to(torch.float32))
        with timer.span("graph.sort"):
            order, carried = stream_sort(seg.reshape(B, hw), payloads, self.num_models)
            ri_s = carried[0]
            rays_s = rays_from_perm(order, self.lidar) if self.lidar.even_dist else carried[1:4]
        with timer.span("graph.models"):
            if cfg.modeling_method == "point":
                model_param = point_model_table(point_means_stream(ri_s, order), self.num_models)
            else:
                model_param = plane_models_stream(
                    ri_s, order, k_model, self.num_models, cfg.plane_angle_threshold, rays_s
                ).table
            model_param[:, 0] = ground_model

        with timer.span("graph.quantize"):
            resid_s = ri_s - predict_stream(model_param, order, rays_s)
            salience = None
            if cfg.uniform:
                step_s = device_const(step, torch.float32, dev)
            else:
                kp_cnt = per_cluster_sums(carried[-1], order).to(torch.int32)  # exact: 0/1 sums
                sal = salience_levels_from_counts(
                    kp_cnt, order.counts, cfg.level_key_point_num, cfg.ground_salience_level
                )
                step_table = device_const(step, torch.float32, dev)
                step_s = expand_per_cluster(step_table[sal.to(torch.int64)], order)
                salience = sal.to(torch.uint8)
            qs = round_half_away(resid_s / step_s).to(torch.int32)
            live = torch.arange(hw, device=dev) < order.stream_len[:, None]
            qs = torch.where(live, qs, 0)

        with timer.span("graph.contour"):
            code = extract_contour(seg)
            contour_packed = pack_bits_msb(code.contour, start_dim=1)
        res = cnt = None
        if self.device_entropy:
            with timer.span("graph.entropy"):
                res, cnt = encode_fields_device(qs.contiguous(), order.stream_len.to(torch.int32),
                                                code.contour.contiguous())
        return EncoderOutput(
            range_image=ri,
            seg_idx=seg,
            model_param=model_param,
            stream=qs.to(torch.int16),  # wraps like the reference's int16 cast
            stream_len=order.stream_len,
            contour_packed=contour_packed,
            sequence=code.sequence.to(torch.uint16),
            seq_len=code.seq_len,
            salience=salience,
            residual_pieces=res,
            contour_pieces=cnt,
        )

    @torch.no_grad()
    def encode_points(self, points, seed, step: Union[float, Sequence[float]]) -> EncoderOutput:
        """Raw points through the graph: an (N, >=3) cloud with an int seed,
        or a zero-padded (B, N, >=3) batch with (B,) seeds (a tensor, numpy
        array or sequence), projected on this module's device and encoded
        as f32 range images with delta 1 (``ri * 1.0`` is exact)."""
        dev = self.tm_planes.device
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        if pts.ndim not in (2, 3) or pts.shape[-1] < 3:
            raise ValueError(f"points must be (N, >=3) or (B, N, >=3), got {tuple(pts.shape)}")
        ri = project_points(pts[..., :3], self.lidar, self.v_angles)
        ones = torch.ones(ri.shape[:-2], dtype=torch.float32, device=dev)
        return self(ri, ones, seed, step)


def make_encoder(lidar: LidarConfig, cfg: CodecConfig, from_ri: bool = False, device="cuda"):
    """The single-frame encoder on ``device`` (the card unless the CPU is
    asked for): ``encode(points (N, >=3), seed, step)``, or with
    ``from_ri=True`` the :class:`Encoder` itself, called as ``encode(q (H,
    W), delta, seed, step)`` (the reference's ``make_encoder``)."""
    from rpcc_tpu_torch.models.pipeline import resolve_device

    enc = Encoder.for_lidar(lidar, cfg).to(resolve_device(device))
    return enc if from_ri else enc.encode_points


def make_batch_encoder(lidar: LidarConfig, cfg: CodecConfig, from_ri: bool = False, device="cuda"):
    """The batched encoder on ``device``: ``encode(points (B, N, >=3)
    zero-padded, seeds (B,), step)``, or with ``from_ri=True`` the
    :class:`Encoder` over (B, H, W) grids with (B,) deltas and seeds (the
    reference's ``make_batch_encoder`` without a mesh)."""
    return make_encoder(lidar, cfg, from_ri, device)
