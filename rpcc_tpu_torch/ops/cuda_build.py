"""Build and load the package's native libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface; the host library
(``csrc/host/*.cpp``, :mod:`rpcc_tpu_torch.codec.native`) by ``g++``.  Both
build at first use into ``rpcc_tpu_torch/_build/``.  A library's name
carries a hash of its sources and flags, so an edited source builds anew
and a stale library is never loaded; the compiler writes a temporary file
that is renamed into place, so a concurrent process never loads a torn
one.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def build_library(
    stem: str, sources: Sequence[str], commands: Sequence[Sequence[str]], link: Sequence[str] = ()
) -> str:
    """Compile ``sources`` into ``BUILD_DIR/lib<stem>-<hash>.so`` unless it
    exists, and return its path.  ``commands`` are compiler command lines
    tried in order (each gets ``-o <tmp> <sources> <link>``); the first that
    succeeds is renamed into place.  Raises with the compilers' stderr when
    none does."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(repr((list(map(list, commands)), list(link))).encode())
    so_path = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    errors = []
    try:
        for cmd in commands:
            proc = subprocess.run([*cmd, "-o", tmp, *sources, *link], capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, so_path)  # atomic: a concurrent process never loads a torn file
                return so_path
            errors.append(f"$ {' '.join(cmd)} (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    raise RuntimeError(f"building lib{stem} failed:\n" + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def load_cuda_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    stem = os.path.splitext(source)[0]
    return ctypes.CDLL(build_library(stem, [os.path.join(CSRC_DIR, source)], [[_nvcc(), *NVCC_FLAGS]]))
