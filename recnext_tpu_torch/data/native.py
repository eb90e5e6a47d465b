"""ctypes binding of the native image decoder, ``native/recnext_io.cpp``.

The source is the JAX package's, read as it is: libjpeg decode, then a fused
PIL-convention antialiased crop-resize, horizontal flip and (for the float entry)
ImageNet normalization into an NHWC batch, over a pool of C++ threads. It is built
at first use with ``g++ -O3 -shared -fPIC -I data/jpeg62 ... <Pillow's libjpeg>
-Wl,-rpath,<its directory> -lpthread`` into ``recnext_tpu_torch/_build/``
(git-ignored). libjpeg is the one Pillow bundles (``pillow.libs/libjpeg-*.so.62*``,
libjpeg-turbo with the jpeg62 ABI), linked by its full path, and its headers are the
port's copy of libjpeg-turbo 2.1.5's jpeg62 headers (``data/jpeg62/``, with their
license): one route on every machine that has Pillow, so the bits the CPU tests
check are the bits a GPU host decodes, with no system libjpeg or ``jpeglib.h``
needed. Where Pillow bundles no libjpeg, the build raises. The library's name
carries a hash of the source, the headers, the flags and the libjpeg path, so an
edited source is never served from a stale build. The
build holds a file lock and writes a temporary file that ``os.replace`` renames, so
processes that build at once (test workers) never see a half-written library. A
build or ABI failure raises ``NativeBuildError``: the caller that asked for the
native route gets an error, not the PIL route.

Entries (``native/recnext_io.cpp:227-314``): ``decode_jpeg`` (one JPEG to RGB uint8),
``batch_decode_crop`` (float32 NHWC, normalized) and ``batch_decode_crop_u8`` (uint8
NHWC, PIL-rounded, for the train transform's ``post_crop``). A crop row is
``(x, y, w, h, flip)`` in source-image float coordinates (w <= 0: the whole image).
Where the decoder refuses a file (not a JPEG, corrupt), the entry returns None.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from recnext_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG.parent / "native" / "recnext_io.cpp"
BUILD_DIR = PKG / "_build"
JPEG_HEADERS = PKG / "data" / "jpeg62"  # libjpeg-turbo 2.1.5, JPEG_LIB_VERSION 62
FLAGS = ["-O3", "-shared", "-fPIC"]
ABI_VERSION = 3  # rn_version() of the source
BICUBIC = 1  # the source's filter code (0 is bilinear, which no caller takes)
THREADS = 4  # C++ decode threads a batch (the JAX loader's)


class NativeBuildError(RuntimeError):
    """The native decoder could not be built or loaded."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def pillow_libjpeg() -> Path:
    """The libjpeg that Pillow's wheel bundles (``pillow.libs/libjpeg-*.so.62*``);
    raises ``NativeBuildError`` where there is none."""
    try:
        import PIL
    except ImportError as e:
        raise NativeBuildError(f"Pillow is not installed: {e}") from e
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg-*.so.62*")) if libs.is_dir() else []
    if not found:
        raise NativeBuildError(f"Pillow {PIL.__version__} bundles no libjpeg "
                               f"(no libjpeg-*.so.62* in {libs})")
    return found[-1]


def _libs(libjpeg: Path) -> list:
    return [str(libjpeg), f"-Wl,-rpath,{libjpeg.parent}", "-lpthread"]


def library_path() -> Path:
    if not SOURCE.exists():
        raise NativeBuildError(f"the native decoder's source {SOURCE} is missing")
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in sorted(JPEG_HEADERS.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS + _libs(pillow_libjpeg())).encode())
    return BUILD_DIR / f"librecnext_io-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    """Compile into ``out`` under a file lock, atomically."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, f"-I{JPEG_HEADERS}", str(SOURCE), "-o", str(tmp),
               *_libs(pillow_libjpeg())]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> None:
    f32, i64 = np.ctypeslib.ndpointer(np.float32), np.ctypeslib.ndpointer(np.int64)
    lib.rn_version.restype = ctypes.c_int
    lib.rn_version.argtypes = []
    lib.rn_decode_jpeg.restype = ctypes.c_long
    lib.rn_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.rn_batch_decode_crop.restype = ctypes.c_int
    lib.rn_batch_decode_crop.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_int, f32, ctypes.c_int, ctypes.c_int,
        f32, f32, f32, ctypes.c_int]
    lib.rn_batch_decode_crop_u8.restype = ctypes.c_int
    lib.rn_batch_decode_crop_u8.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_int, f32, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int]


def load() -> ctypes.CDLL:
    """Build (once per source) and load the library; raises ``NativeBuildError``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _declare(lib)
        if lib.rn_version() != ABI_VERSION:
            raise NativeBuildError(f"{path}: ABI version {lib.rn_version()}, expected "
                                   f"{ABI_VERSION}")
        _lib = lib
        return lib


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """One JPEG as RGB uint8 (H, W, 3) at full size; None where the decoder refuses it."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    need = lib.rn_decode_jpeg(data, len(data), 0, None, 0, ctypes.byref(w), ctypes.byref(h))
    if need < 0:
        return None
    buf = np.empty(need, np.uint8)
    got = lib.rn_decode_jpeg(data, len(data), 0,
                             buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), need,
                             ctypes.byref(w), ctypes.byref(h))
    return buf.reshape(h.value, w.value, 3) if got == need else None


def _packed(blobs: Sequence[bytes]):
    lengths = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1])]).astype(np.int64)
    return b"".join(blobs), offsets, lengths


def batch_decode_crop(blobs: Sequence[bytes], crops: np.ndarray,
                      size: int) -> Optional[np.ndarray]:
    """Decode, crop, resize (bicubic) to ``size``^2, flip and normalize a batch: float32
    NHWC; None where any file is refused."""
    lib = load()
    data, offsets, lengths = _packed(blobs)
    out = np.empty((len(blobs), size, size, 3), np.float32)
    fails = lib.rn_batch_decode_crop(data, offsets, lengths, len(blobs),
                                     np.ascontiguousarray(crops, np.float32), size,
                                     BICUBIC, IMAGENET_MEAN, IMAGENET_STD, out, THREADS)
    return None if fails else out


def batch_decode_crop_u8(blobs: Sequence[bytes], crops: np.ndarray,
                         size: int) -> Optional[np.ndarray]:
    """As ``batch_decode_crop``, without normalization: PIL-rounded uint8 NHWC."""
    lib = load()
    data, offsets, lengths = _packed(blobs)
    out = np.empty((len(blobs), size, size, 3), np.uint8)
    fails = lib.rn_batch_decode_crop_u8(data, offsets, lengths, len(blobs),
                                        np.ascontiguousarray(crops, np.float32), size,
                                        BICUBIC, out, THREADS)
    return None if fails else out
