"""A reader of flax's ``serialization.msgpack_serialize`` files, in plain Python.

The JAX package writes its variables (``{"params", "batch_stats"}`` trees) with
flax's msgpack encoding. The port reads them without ``flax`` and without the
``msgpack`` package. The decoder covers the subset flax writes:

* maps, arrays, strings, bins, nil, booleans, ints and floats;
* ext 1, an ndarray: a nested msgpack array ``(shape, dtype name, C-order bytes)``;
  ``bfloat16`` (which numpy lacks) is read through ``uint16`` and widened to
  ``float32``, which holds every bfloat16 value exactly;
* ext 3, a numpy scalar, encoded as a 0-d ndarray;
* the ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` map
  that flax makes of an array above ``MAX_CHUNK_SIZE`` bytes, joined back.

Leaves come back as numpy arrays, numpy scalars for ext 3, and Python values
otherwise.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray(data: bytes):
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # the high half of a float32
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _join_chunks(tree: Any) -> Any:
    """flax's chunked arrays back into one array each."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
    return {k: _join_chunks(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data`` (no chunk joining)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the value")
    return out


def msgpack_restore(data: bytes) -> Any:
    """flax's ``serialization.msgpack_restore``: the tree ``msgpack_serialize`` wrote."""
    return _join_chunks(unpackb(data))


def read_msgpack(path: str | Path) -> Any:
    return msgpack_restore(Path(path).read_bytes())
