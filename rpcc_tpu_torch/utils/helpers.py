"""Small host helpers (port of ``rpcc_tpu/utils/helpers.py``, the
reference ``utils/utils.py``)."""

from __future__ import annotations

import sys

from rpcc_tpu_torch.config import CodecConfig, load_codec_config  # noqa: F401  (re-export)


def sys_size(data) -> int:
    return sys.getsizeof(data)


def bit_size(data) -> int:
    return len(data)


def np_size(data) -> int:
    return data.nbytes


def load_compressor_cfg(yaml_file: str) -> CodecConfig:
    """YAML -> CodecConfig (the reference returns an EasyDict; this one is
    typed, and ``dataclasses.asdict`` gives the dict)."""
    return load_codec_config(yaml_file)
