"""The single-frame codec's projection on its own device: an (N, >=3) cloud
-> the encoder's input ``(grid, delta)``, bit for bit what the host gives
(``ops/projection_host.py::project_for_encoder``, native ``raster.cpp``).

``grid`` is the (H, W) int32 u16 snap grid with its f32 0-d ``delta``, or
with ``transfer_precision="f32"`` the f32 range image with delta 1; the
encoder's range image is ``grid * delta`` in f32.

:func:`project_cuda` runs the hand-written kernel (``csrc/raster.cu``,
two launches) on a CUDA cloud that :meth:`Workspace.upload` sent up; it
never falls back to the plain version: if the kernel cannot build or
launch, the call raises.  :func:`project_plain` is the plain version: the
host's arithmetic in float64 and float32 torch operations in its order,
so it is bit-exact too; it runs on a card as well (every constant is a
0-d tensor on the cloud's device, because PyTorch's CUDA division by a
host scalar multiplies by its reciprocal).

The kernel replaces no Pallas kernel: the reference projects in
``raster.cpp`` and in jnp (``rpcc_tpu/ops/projection.py``).  It was added
so that ``RPCCCodec`` on a card uploads the raw cloud once and projects it
there, in place of ~2 ms of single-threaded host work a 64E sweep and the
grid's upload.  Bytes bound it: 12 B a point read and 4 B a pixel written,
2.05 MB at 128,000 points on 64x2000, 0.61 us at 3.35 TB/s.  Each call of
the kernel's wrapper counts ``launch.project`` (``utils/timer.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from rpcc_tpu_torch.config import CodecConfig, LidarConfig
from rpcc_tpu_torch.ops.projection import scatter_min_image
from rpcc_tpu_torch.ops.projection_host import cloud_rows, projection_constants
from rpcc_tpu_torch.ops.rounding import round_half_away
from rpcc_tpu_torch.utils import timer

# raster.cpp::atan2_det's tan(pi/8) and polynomial, highest power first.
_ATAN_W8 = 0.41421356237309503
_ATAN_C = (0.02961455500835997, -0.05797933104322553, 0.07540656567851425, -0.09074709961180911,
           0.11110049848756427, -0.14285673103306398, 0.19999999129892043, -0.3333333332494847,
           0.999999999999762)
_PI = 3.141592653589793
_TWO_PI_REF = 2.0 * 3.14159265  # raster.cpp's kTwoPiRef, in f32 below


def _atan2_det(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``raster.cpp::atan2_det`` on float64 tensors, operation for
    operation (each torch operation is one IEEE-rounded step)."""
    ay, ax = y.abs(), x.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    t = num / torch.where(den == 0, 1.0, den)
    red = t > _ATAN_W8
    u = torch.where(red, (t - 1.0) / (t + 1.0), t)
    u2 = u * u
    p = torch.full_like(u2, _ATAN_C[0])
    for c in _ATAN_C[1:]:
        p = p * u2 + c
    a = u * p + torch.where(red, u.new_full((), _PI / 4), 0.0)
    a = torch.where(swap, _PI / 2 - a, a)
    a = torch.where(x < 0, _PI - a, a)
    a = torch.where(y < 0, -a, a)
    return torch.where(den == 0, 0.0, a)


def project_plain(points: torch.Tensor, lidar: LidarConfig, cfg: CodecConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (N, >=3) f32 cloud -> ``(grid, delta)`` on its
    device."""
    H, W = lidar.height, lidar.width
    dev = points.device
    hfov, vmin, vres, va = projection_constants(lidar)

    def f32(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32, device=dev)

    def f64(v):
        return torch.full((), float(v), dtype=torch.float64, device=dev)

    x, y, z = (points[:, i].to(torch.float64) for i in range(3))
    h2 = x * x + y * y
    d2 = h2 + z * z
    az = _atan2_det(y, x).to(torch.float32)
    az = torch.where(az < 0, az + f32(_TWO_PI_REF), az)
    v = _atan2_det(z, torch.sqrt(h2)).to(torch.float32)
    depth = torch.sqrt(d2).to(torch.float32)
    col_f = az / f32(hfov) * f32(W)
    if va is None:
        c = round_half_away(col_f).to(torch.int32)
        row = round_half_away((v - f32(vmin)) / f32(vres)).to(torch.int32).clamp(0, H - 1)
    else:
        c = torch.round(col_f).to(torch.int32)  # half-even
        diff = (torch.from_numpy(va).to(dev) - v[:, None]).abs()  # (N, H)
        row = torch.argmin(diff, dim=1).to(torch.int32)  # the first of equal distances
    col = torch.where(c >= W, c - W, c)
    col = torch.where((col < 0) | (col >= W), torch.remainder(c, W), col)  # floored modulo
    ri = scatter_min_image(row * W + col, depth, depth > 0, H, W)
    if cfg.transfer_precision == "f32":
        return ri, f32(1.0)
    alt = ri.max().to(torch.float64) / f64(65535.0)
    delta = torch.maximum(alt, f64(np.float32(cfg.step / 16.0))).to(torch.float32)
    q = torch.round(ri * (f32(1.0) / delta)).clamp_max(65535.0).to(torch.int32)
    return q, delta


@functools.lru_cache(maxsize=None)
def _library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("raster.cu")
    lib.rpcc_project_launch.restype = ctypes.c_int
    lib.rpcc_project_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 5
    )
    return lib


class Workspace:
    """What the kernel keeps between frames on one card: the scratch image
    (H * W words, made empty once; each call leaves it so), the last
    block's ticket, the channel table, the cloud's staging buffers (pinned
    host and device, grown to the largest cloud) and the event after the
    last call's launches.  One caller at a time."""

    def __init__(self, lidar: LidarConfig, cfg: CodecConfig, device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the projection kernel's workspace needs a CUDA device, got {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.lidar, self.cfg, self.device = lidar, cfg, dev
        self.hfov, self.vmin, self.vres, va = projection_constants(lidar)
        self.v_angles = None if va is None else torch.from_numpy(va).to(dev)
        self.scratch = torch.full((lidar.height * lidar.width,), -1, dtype=torch.int32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.staged = self.cloud = None
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(dev))

    def upload(self, points: np.ndarray) -> torch.Tensor:
        """The cloud's :func:`cloud_rows` as a C-contiguous f32 tensor on the
        card, sent from the pinned staging buffer on the current stream
        without a wait; valid until the next upload.  First waits for the
        last call's launches, which follow the last copy out of the buffer
        and read the last cloud."""
        rows = cloud_rows(points)
        n = rows.size
        self.done.synchronize()
        if self.staged is None or self.staged.numel() < n:
            self.staged = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self.cloud = torch.empty(n, dtype=torch.float32, device=self.device)
        staged = self.staged[:n].view(rows.shape)
        np.copyto(staged.numpy(), rows)
        return self.cloud[:n].view(rows.shape).copy_(staged, non_blocking=True)


def project_cuda(points: torch.Tensor, ws: Workspace) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a C-contiguous (N, >=3) f32 CUDA cloud, on the current
    stream, after the workspace's last call; raises on any other input.
    Does not synchronize.  Counts the call under ``launch.project``."""
    if points.device.type != "cuda" or points.device != ws.device:
        raise ValueError(f"project_cuda needs the cloud on the workspace's card, got {points.device}")
    if points.dtype != torch.float32 or points.ndim != 2 or points.shape[1] < 3 or not points.is_contiguous():
        raise ValueError(f"points must be a contiguous (N, >=3) float32 tensor, got {points.dtype} "
                         f"{tuple(points.shape)}")
    lidar, cfg = ws.lidar, ws.cfg
    H, W = lidar.height, lidar.width
    f32 = cfg.transfer_precision == "f32"
    stream = torch.cuda.current_stream(ws.device)
    with torch.cuda.device(ws.device):
        grid = torch.empty((H, W), dtype=torch.float32 if f32 else torch.int32, device=ws.device)
        delta = torch.empty((), dtype=torch.float32, device=ws.device)
        stream.wait_event(ws.done)
        err = _library().rpcc_project_launch(
            points.data_ptr(), points.shape[0], points.shape[1], H, W, int(lidar.even_dist),
            float(ws.hfov), float(ws.vmin), float(ws.vres),
            None if ws.v_angles is None else ws.v_angles.data_ptr(), 0 if ws.v_angles is None else H,
            0 if f32 else 1, float(np.float32(cfg.step / 16.0)),
            ws.scratch.data_ptr(), ws.ticket.data_ptr(), grid.data_ptr(), delta.data_ptr(), stream.cuda_stream,
        )
        ws.done.record(stream)
    if err != 0:
        raise RuntimeError(f"projection kernel launch failed: cudaError_t {err}")
    timer.count("launch.project")
    return grid, delta
