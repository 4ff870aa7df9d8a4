"""msgpack in pure Python, for the subset flax's checkpoints use.

The JAX package writes checkpoints with ``flax.serialization``: a msgpack
map of the variables tree, every array an extension of type 1 whose payload
is itself msgpack, the array ``(shape, dtype name, C-order bytes)``; a NumPy
scalar is type 3 with the same payload.  Tuples were turned into maps keyed
"0", "1", ... before packing, and every map has its keys sorted (the tree
passes through ``jax.tree_util.tree_map`` first).  The port needs neither
flax nor the ``msgpack`` package for that: ``packb`` writes nil, bools,
ints, float64, str, bin, arrays, maps (keys sorted), ``np.ndarray`` and
NumPy scalars, each in the shortest form, as msgpack-python does, so the
bytes equal flax's for the same tree; ``unpackb`` reads every msgpack type,
float32 and the ext forms included, and returns maps as dicts, arrays as
lists, bin as bytes and the flax extensions as NumPy arrays (read-only
views of the buffer) and scalars.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple, Tuple

import numpy as np

NDARRAY, COMPLEX, NPSCALAR = 1, 2, 3      # flax's extension types


class ExtType(NamedTuple):
    """An extension this codec does not interpret."""
    code: int
    data: bytes


# --- encoder ----------------------------------------------------------------

def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _sized(out: bytearray, n: int, small: Tuple[int, int], codes):
    """Header of a str/bin/array/map of length n: a fix form below
    ``small[1]`` (``small[0] | n``), else the first of ``codes`` (8, 16 and
    32-bit lengths; None where the type has no such form) that holds n."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    if n >= 0:
        forms = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
        for top, code, fmt in forms:
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
    else:
        forms = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q"))
        for bottom, code, fmt in forms:
            if n >= bottom:
                out.append(code)
                out += struct.pack(fmt, n)
                return
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _sized(out, n, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), None, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, ExtType):
        _pack_ext(obj.code, obj.data, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


# --- decoder ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    obj = _unpack(reader)
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",          # str
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I",          # bin
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",   # array, map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        value = r.unpack(_FIXED[b])
        return float(value) if b in (0xCA, 0xCB) else value
    if b in _FIXEXT:
        return _ext(r.unpack(">b"), r.take(_FIXEXT[b]))
    if b not in _LEN:
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
    n = r.unpack(_LEN[b])
    if b in (0xD9, 0xDA, 0xDB):
        return str(r.take(n), "utf-8")
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, n)
    return _ext(r.unpack(">b"), r.take(n))


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def _ext(code: int, data: memoryview) -> Any:
    if code in (NDARRAY, NPSCALAR):
        shape, dtype, buf = unpackb(bytes(data))
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == NPSCALAR else arr
    if code == COMPLEX:
        real, imag = unpackb(bytes(data))
        return complex(real, imag)
    return ExtType(code, bytes(data))
