"""Reader and writer of the msgpack subset that ``flax.serialization.to_bytes``
writes, in pure Python (no msgpack or flax package needed).

The subset: maps with str keys, arrays, str, bin, ints, floats, bool, nil,
and ext type 1 (a numpy array) whose payload is
``packb((shape, dtype_name, buffer))``. Anything else raises ``ValueError``,
flax's chunked-array marker for arrays over 2**30 bytes included.

``packb`` chooses the smallest encoding for each value, as msgpack-python
does, so it writes the same bytes as flax for the same tree.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
CHUNKED_MARKER = "__msgpack_chunked_array__"


# --- writing ---------------------------------------------------------------


def _pack_uint_header(out: bytearray, n: int, fix_base: int, fix_max: int,
                      codes: Tuple[int, ...], widths=(1, 2, 4)) -> None:
    """Length header: a fix byte when n <= fix_max, else the first of
    ``codes`` (8/16/32-bit lengths) that holds n."""
    if fix_max >= 0 and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} is too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} is too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_uint_header(out, n, 0, -1, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialised")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_uint_header(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _pack_uint_header(out, len(x), 0, -1, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, dict):
        _pack_uint_header(out, len(x), 0x80, 15, (0xDE, 0xDF), (2, 4))
        for key, value in x.items():
            if not isinstance(key, str):
                raise ValueError(f"map keys must be str, got {key!r}")
            _pack(out, key)
            _pack(out, value)
    elif isinstance(x, (list, tuple)):
        _pack_uint_header(out, len(x), 0x90, 15, (0xDC, 0xDD), (2, 4))
        for value in x:
            _pack(out, value)
    elif isinstance(x, np.ndarray):
        if x.nbytes > 1 << 30:
            raise ValueError("arrays over 2**30 bytes (flax's chunked form) "
                             "are not supported")
        _pack_ext(out, EXT_NDARRAY, _pack_ndarray(x))
    else:
        raise ValueError(f"cannot serialise {type(x).__name__}")


def packb(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` (numpy arrays as flax's ext type 1)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# --- reading ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def unpack(self, fmt: str, width: int):
        return struct.unpack(fmt, self.take(width))[0]

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"map keys must be str, got {key!r}")
            out[key] = self.value()
        if CHUNKED_MARKER in out:
            raise ValueError("flax's chunked arrays (over 2**30 bytes) are "
                             "not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        data = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not supported")
        return _unpack_ndarray(data)

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint({0xC7: 1, 0xC8: 2, 0xC9: 4}[b]))
        if b == 0xCA:
            return self.unpack(">f", 4)
        if b == 0xCB:
            return self.unpack(">d", 8)
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
                0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
                0xD2: (">i", 4), 0xD3: (">q", 8)}
        if b in ints:
            return self.unpack(*ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _unpack_ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        tuple(shape)).copy()


def unpackb(data: bytes) -> Any:
    """The tree that ``packb`` (or flax's ``to_bytes``) wrote; numpy arrays
    for ext type 1."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return value
