"""Codec and LiDAR configuration (a copy of ``rpcc_tpu/config.py``, so the
port imports nothing of ``rpcc_tpu``; its YAML and CSV files are the port's
own copies under ``data/lidar_cfg/`` and ``cfgs/``).

Mirrors the reference's knob surface (``cfgs/compressor.yaml:4-36`` and
``dataset/lidar_cfg/*.yaml`` in R-PCC) but as typed, hashable dataclasses so
they can be closed over by jit-compiled programs (every field that affects
traced shapes must be static).

Parity notes (reference ``tools/compress.py:46,63``): the YAML ``accuracy`` is
the *maximum reconstruction error*; the quantization step used everywhere in
the codec is ``2 * accuracy``.  We keep the same convention: callers pass the
YAML value and :meth:`CodecConfig.step` returns the doubled step.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Optional, Tuple

import yaml

_BASE_DIR = os.path.dirname(os.path.abspath(__file__))
LIDAR_CFG_DIR = os.path.join(_BASE_DIR, "data", "lidar_cfg")
DEFAULT_CODEC_YAML = os.path.join(_BASE_DIR, "cfgs", "compressor.yaml")


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Per-LiDAR spherical projection geometry.

    Equivalent of the reference lidar YAMLs (``dataset/lidar_cfg``) plus the
    optional per-channel vertical-angle table for unevenly distributed
    channels (``dataset/transformer.py:12-22``).
    """

    name: str
    horizontal_fov_deg: float
    vertical_angle_max_deg: float
    vertical_angle_min_deg: float
    height: int
    width: int
    # Uneven vertical channel distribution: tuple of per-row angles (deg).
    vertical_angles_deg: Optional[Tuple[float, ...]] = None

    @property
    def even_dist(self) -> bool:
        return self.vertical_angles_deg is None

    @property
    def horizontal_fov(self) -> float:
        import math

        return self.horizontal_fov_deg * (math.pi / 180.0)

    @property
    def vertical_max(self) -> float:
        import math

        return self.vertical_angle_max_deg * (math.pi / 180.0)

    @property
    def vertical_min(self) -> float:
        import math

        return self.vertical_angle_min_deg * (math.pi / 180.0)

    @classmethod
    def from_yaml(
        cls, path: str, channel_distribute_csv: Optional[str] = None, name: str = ""
    ) -> "LidarConfig":
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        angles = None
        if channel_distribute_csv is not None:
            rows = []
            with open(channel_distribute_csv, "r") as fin:
                for r in csv.DictReader(fin):
                    rows.append((int(r["channel"]), float(r["vertical_angle"])))
            # Rows are keyed by 'channel' — sort by it so an out-of-order
            # CSV cannot silently misorder every range-image row's angle.
            rows.sort()
            angles = tuple(a for _, a in rows)
        return cls(
            name=name or os.path.splitext(os.path.basename(path))[0],
            horizontal_fov_deg=float(raw["HORIZONTAL_FOV"]),
            vertical_angle_max_deg=float(raw["VERTICAL_ANGLE_MAX"]),
            vertical_angle_min_deg=float(raw["VERTICAL_ANGLE_MIN"]),
            height=int(raw["RANGE_IMAGE_HEIGHT"]),
            width=int(raw["RANGE_IMAGE_WIDTH"]),
            vertical_angles_deg=angles,
        )


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """All codec knobs.  Field names track the reference YAML keys
    (``cfgs/compressor.yaml``) so CLI overrides map 1:1."""

    compress_framework: str = "uniform"  # 'uniform' | 'non-uniform'
    accuracy: float = 0.02  # max reconstruction error; step = 2*accuracy
    # Non-uniform (salience) quantization:
    level_key_point_num: Tuple[int, ...] = (30, 10, 3, 0)
    level_delta_acc: Tuple[float, ...] = (0.0, 0.02, 0.04, 0.06)
    ground_salience_level: int = 2
    feature_region: int = 3
    segments: int = 8
    sharp_num: int = 4
    less_sharp_num: int = 8
    flat_num: int = 6
    # Segmentation:
    segment_method: str = "FPS"  # 'FPS' | 'DBSCAN'
    ground_threshold: float = 0.1
    cluster_num: int = 100
    dbscan_eps: float = 1.5
    # Reference --cpu branch semantics: FPS over the *filtered* (compacted)
    # non-ground set (utils/segment_utils.py:120-124) instead of the
    # zero-masked grid of the GPU path (:139-141).
    cpu_fps: bool = False
    # Modeling:
    modeling_method: str = "point"  # 'point' | 'plane'
    plane_angle_threshold: float = 75.0  # degrees
    # Entropy coding.  Default is this framework's own device/ctx rANS
    # ('rans': adaptive per-field vs bzip2, ~2.8 bpp vs bzip2's ~3.1 on
    # KITTI at acc 0.02); the reference's bzip2/gzip/deflate/lz4 remain.
    basic_compressor: str = "rans"  # 'lz4' | 'bzip2' | 'gzip' | 'deflate' | 'rans'
    # Deterministic seeding for RANSAC / FPS tie-breaking.  The reference is
    # unseeded (o3d RANSAC) and therefore nondeterministic run-to-run
    # (SURVEY.md §5 pitfall 7); we are deterministic by construction.
    seed: int = 0
    # Host->device transfer precision of the range image.  'f32' uploads
    # exact depths (no snap grid; reconstruction error <= accuracy).  'u16',
    # 'i8' and 'm8' all give the u16 snap grid: depths pre-snapped to a
    # per-frame grid delta = max(step/16, depth_max/65535) and uploaded as
    # u16 words, at the price of <= delta/2 extra reconstruction error.  The
    # JAX package's i8 / m8 wire codes (row deltas, nonzero masks) are not
    # ported; their bitstreams equal the u16 grid's, so the three names give
    # the same bytes.  The default 'm8' is the reference's.
    transfer_precision: str = "m8"  # 'f32' | 'u16' | 'i8' | 'm8'
    # Entropy-code the two big fields (residual stream, contour plane) ON
    # DEVICE, inside the encoder graph (ops/rans_device.py): the engine then
    # downloads the containers' pieces (~30 KB of compressed words per
    # frame) instead of the fields, and codec/rans_codec.py assembles the
    # containers the host decoders read ('rans' coder only; engine path).
    # Default on, as in the reference; ignored by non-rans coders and by the
    # single-frame codec (which codes the downloaded fields either way).
    device_entropy: bool = True

    def __post_init__(self):
        # Enum-valued knobs fail loudly on typos: a misspelled
        # transfer_precision would otherwise silently select full-f32
        # uploads (4-8x wire inflation on a wire-bound rig), and a
        # misspelled modeling_method would silently select plane modeling.
        _check = (
            ("compress_framework", ("uniform", "non-uniform")),
            ("segment_method", ("FPS", "DBSCAN")),
            ("modeling_method", ("point", "plane")),
            ("basic_compressor", ("lz4", "bzip2", "gzip", "deflate", "rans")),
            ("transfer_precision", ("f32", "u16", "i8", "m8")),
        )
        for field, allowed in _check:
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r} — expected one of {allowed}")

    @property
    def uniform(self) -> bool:
        return self.compress_framework == "uniform"

    @property
    def step(self) -> float:
        """Quantization step (2x the configured max error)."""
        return self.accuracy * 2.0

    @property
    def level_acc(self) -> Tuple[float, ...]:
        """Per-salience-level quantization steps (non-uniform mode)."""
        return tuple(self.step + d for d in self.level_delta_acc)

    @property
    def num_levels(self) -> int:
        return len(self.level_key_point_num)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "CodecConfig":
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        kwargs = dict(
            compress_framework=raw.get("compress_framework", "uniform"),
            accuracy=float(raw.get("accuracy", 0.02)),
            level_key_point_num=tuple(raw.get("level_key_point_num", (30, 10, 3, 0))),
            level_delta_acc=tuple(raw.get("level_delta_acc", (0.0, 0.02, 0.04, 0.06))),
            ground_salience_level=int(raw.get("ground_salience_level", 2)),
            feature_region=int(raw.get("feature_region", 3)),
            segments=int(raw.get("segments", 8)),
            sharp_num=int(raw.get("sharp_num", 4)),
            less_sharp_num=int(raw.get("less_sharp_num", 8)),
            flat_num=int(raw.get("flat_num", 6)),
            segment_method=raw.get("segment_method", "FPS"),
            ground_threshold=float(raw.get("ground_threshold", 0.1)),
            cluster_num=int(raw.get("cluster_num", 100)),
            dbscan_eps=float(raw.get("DBSCAN_eps", 1.5)),
            modeling_method=raw.get("modeling_method", "point"),
            plane_angle_threshold=float(raw.get("plane_angle_threshold", 75.0)),
            basic_compressor=raw.get("basic_compressor", "rans"),
            # Engine/transport knobs are YAML-settable too (the docstring
            # promises field names map 1:1 to YAML keys).
            cpu_fps=bool(raw.get("cpu_fps", False)),
            seed=int(raw.get("seed", 0)),
            transfer_precision=raw.get("transfer_precision", "m8"),
            device_entropy=bool(raw.get("device_entropy", True)),
        )
        kwargs.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kwargs)

    def replace(self, **kw) -> "CodecConfig":
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(self, **kw)


def load_codec_config(path: Optional[str] = None, **overrides) -> CodecConfig:
    """The :class:`CodecConfig` of a codec YAML (default: the package's
    ``cfgs/compressor.yaml``), with ``overrides`` that are not None."""
    return CodecConfig.from_yaml(path or DEFAULT_CODEC_YAML, **overrides)
