"""The port's native host library: LZ4 blocks, the rANS lanes, the f32 and
u16 snap projections, the host frame decoder and the back-projection.

``csrc/host/*.cpp`` are copies of ``rpcc_tpu/codec/native/*.cpp``, built
with the reference's flags (``-ffp-contract=off`` keeps the projection
bit-identical to its numpy twin; ``-fno-math-errno -fno-trapping-math``
let sqrt and guarded divisions vectorize without changing any IEEE
result), with OpenMP where the toolchain has it and without where it does
not.  :func:`native_lib` builds the library at first use into
``rpcc_tpu_torch/_build/`` (atomically, see
:func:`rpcc_tpu_torch.ops.cuda_build.build_library`) and raises with the
compiler's stderr when it cannot: nothing falls back silently.
"""

from __future__ import annotations

import ctypes as ct
import functools
import os

from rpcc_tpu_torch.ops import cuda_build

SOURCES = ("lz4.cpp", "deflate.cpp", "rans.cpp", "raster.cpp", "decode.cpp")
GXX_FLAGS = (
    "-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno", "-fno-trapping-math",
    "-shared", "-fPIC", "-std=c++17",
)


def _register(lib: ct.CDLL) -> None:
    """ctypes signatures of the entry points the port calls (float
    arguments must be declared: untyped calls pass Python floats as
    doubles and corrupt the ABI)."""
    lib.lz4_compress_bound.restype = ct.c_size_t
    lib.lz4_compress_bound.argtypes = [ct.c_size_t]
    for name in ("lz4_compress_block", "lz4_decompress_block"):
        fn = getattr(lib, name)
        fn.restype = ct.c_size_t
        fn.argtypes = [ct.c_char_p, ct.c_size_t, ct.c_char_p, ct.c_size_t]
    lib.project_bin_raster.restype = None
    lib.project_bin_raster.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64,
        ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_float, ct.c_float, ct.c_float,
        ct.c_void_p, ct.c_int32, ct.c_void_p,
    ]
    lib.project_bin_raster_u16.restype = None
    lib.project_bin_raster_u16.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64,
        ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_float, ct.c_float, ct.c_float,
        ct.c_void_p, ct.c_int32, ct.c_float,
        ct.c_void_p, ct.c_void_p, ct.c_void_p,
    ]
    lib.backproject_compact.restype = ct.c_int64
    lib.backproject_compact.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p]
    lib.host_decode_frame.restype = ct.c_int64
    lib.host_decode_frame.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_int64,
        ct.c_void_p, ct.c_int64,
        ct.c_void_p, ct.c_int32,
        ct.c_void_p, ct.c_void_p, ct.c_int32,
        ct.c_float, ct.c_void_p,
        ct.c_int32, ct.c_int32,
        ct.c_void_p, ct.c_void_p,
    ]
    lib.rans_encode_ctx_batch.restype = None
    lib.rans_encode_ctx_batch.argtypes = [ct.c_void_p] * 5 + [ct.c_int] * 5 + [ct.c_void_p] * 3
    lib.rans_decode_ctx_batch.restype = None
    lib.rans_decode_ctx_batch.argtypes = [ct.c_void_p] * 7 + [ct.c_int] * 6 + [ct.c_void_p]
    lib.rans_delta_encode_frames.restype = None
    lib.rans_delta_encode_frames.argtypes = [ct.c_void_p] * 3 + [ct.c_int] * 6 + [ct.c_void_p] * 8
    lib.rans_contour_encode_frames.restype = None
    lib.rans_contour_encode_frames.argtypes = (
        [ct.c_void_p, ct.c_int, ct.c_int64] + [ct.c_int] * 3 + [ct.c_void_p] * 5
    )
    # Returns the count of frames whose ESCAPE occurrences mismatch their
    # escape list (a corrupt container); the wrapper raises on it.
    lib.rans_delta_finalize_frames.restype = ct.c_int
    lib.rans_delta_finalize_frames.argtypes = [ct.c_void_p] + [ct.c_int] * 4 + [ct.c_void_p] * 7
    lib.rans_contour_finalize_frames.restype = None
    lib.rans_contour_finalize_frames.argtypes = [ct.c_void_p] + [ct.c_int] * 4 + [ct.c_void_p]


@functools.lru_cache(maxsize=None)
def native_lib() -> ct.CDLL:
    """The loaded host library, built at first use; raises if it cannot be
    built or loaded."""
    srcs = [os.path.join(cuda_build.CSRC_DIR, "host", s) for s in SOURCES]
    path = cuda_build.build_library(
        "rpcc_host", srcs, [["g++", *GXX_FLAGS, "-fopenmp"], ["g++", *GXX_FLAGS]], link=["-lz"]
    )
    lib = ct.CDLL(path)
    _register(lib)
    return lib
