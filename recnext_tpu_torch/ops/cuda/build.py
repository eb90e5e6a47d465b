"""Build and load one CUDA kernel library: ``nvcc`` at first use, ``ctypes`` after.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled for
``sm_90a`` into a shared library in ``recnext_tpu_torch/_build/`` (git-ignored)
and loaded with ``ctypes``. The library name carries a hash of the source and the
flags, so an edited kernel is never served from a stale build. Nothing is built
or loaded at import: ``CudaLibrary.load`` does it, once per process, under a lock
of its own, so two libraries can be built at the same time from two threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc(source: Path) -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"nvcc not found: the kernel is built from {source} with the "
                       "CUDA toolkit at first use")


class CudaLibrary:
    """One kernel source and the shared library built from it. ``declare(lib)``
    sets the ``argtypes``/``restype`` of the library's C functions."""

    def __init__(self, name: str, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_seconds: float | None = None  # wall time of the build this process did

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:12]}.so"

    def _build(self, out: Path) -> None:
        """Compile the source into ``out`` (atomically: a half-written library is
        never visible under its final name)."""
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)

    def load(self) -> ctypes.CDLL:
        """Build (once per source) and load the library; thread-safe."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.path()
            if not path.exists():
                t0 = time.perf_counter()
                self._build(path)
                self.build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            self._declare(lib)
            self._lib = lib
            return lib
