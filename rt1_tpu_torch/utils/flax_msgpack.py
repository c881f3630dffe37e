"""A reader of flax's msgpack state files (`flax.serialization.to_bytes`),
written in the port because the card's machine has no `msgpack` package.

`restore(data)` is `flax.serialization.msgpack_restore`: nested maps of
numpy arrays. It decodes the msgpack types such files hold (maps, arrays,
str, bin, nil, booleans, ints, floats) and flax's ext types: 1, an array
(a packed `(shape, dtype name, bytes)`), 3, a numpy scalar in the same
form, and 2, a complex number. Arrays flax split into chunks (over 2^30
bytes; a map holding `__msgpack_chunked_array__`) are joined. A bfloat16
leaf arrives as its raw 2-byte words and is widened exactly to float32
(numpy has no bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMBERS = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q",
            0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
_SIZED = {0xc4: ("bin", "B"), 0xc5: ("bin", "H"), 0xc6: ("bin", "I"),
          0xd9: ("str", "B"), 0xda: ("str", "H"), 0xdb: ("str", "I"),
          0xdc: ("array", "H"), 0xdd: ("array", "I"),
          0xde: ("map", "H"), 0xdf: ("map", "I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: "B", 0xc8: "H", 0xc9: "I"}


def _decode(r: _Reader, raw: bool) -> Any:
    """The next object; `raw` keeps str as bytes (flax's inner arrays)."""
    b = r.unpack("B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_decode(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r.take(b & 0x1f), raw)
    if b in _FIXED:
        return _FIXED[b]
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return _str(r.take(n), raw)
        if kind == "array":
            return [_decode(r, raw) for _ in range(n)]
        return _map(r, n, raw)
    if b in _FIXEXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _EXT:
        n = r.unpack(_EXT[b])
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _str(data: bytes, raw: bool):
    return data if raw else data.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r, raw)
        out[key] = _decode(r, raw)
    return out


def loads(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from `data` (all of it)."""
    r = _Reader(data)
    out = _decode(r, raw)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _array(data: bytes) -> np.ndarray:
    """flax's `_ndarray_from_bytes`: a packed (shape, dtype name, bytes)."""
    shape, name, buffer = loads(data, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":  # raw 2-byte words, widened exactly
        words = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return words.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _array(data)
    if code == 3:
        return _array(data)[()]
    if code == 2:
        real, imag = loads(data)
        return complex(real, imag)
    raise ValueError(f"unknown flax msgpack ext type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape: Tuple[int, ...] = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore(data)`: the state tree."""
    return _unchunk(loads(data))
