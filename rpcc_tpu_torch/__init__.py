"""rpcc_tpu_torch — the range-image LiDAR codec of :mod:`rpcc_tpu`, ported
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package stays the reference: the port keeps its own copies of the
configuration dataclasses, the LiDAR YAML files, the bitstream framing,
the entropy coders and the native host library, writes the same ``.rpcc``
byte layout, and draws the same threefry random numbers for the same
``--seed``.  This package imports ``torch`` and never ``jax`` or
``rpcc_tpu``.  Its entry points run on the card unless the CPU is asked
for.

Layers (bottom-up), mirroring :mod:`rpcc_tpu`:
  * :mod:`rpcc_tpu_torch.csrc`   — CUDA C++ kernels (built with ``nvcc`` at
    first use into ``rpcc_tpu_torch/_build/``).
  * :mod:`rpcc_tpu_torch.ops`    — tensor ops; each kernel's wrapper sits
    beside its plain PyTorch version.
  * :mod:`rpcc_tpu_torch.models` — the encoder/decoder ``nn.Module`` s and
    the single-frame :class:`~rpcc_tpu_torch.models.pipeline.RPCCCodec`.
  * :mod:`rpcc_tpu_torch.codec`  — host entropy coding and the native host
    library (``csrc/host/*.cpp``, built with ``g++`` at first use).
  * :mod:`rpcc_tpu_torch.cli`    — single-frame compress/decompress.

Importing this package imports nothing heavy.
"""

from rpcc_tpu_torch.version import __version__

__all__ = ["__version__"]
