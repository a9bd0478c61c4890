"""The msgpack subset that flax's `serialization.to_bytes` writes, without
the `msgpack` package (the card's machine has none).

Encodes and decodes maps, arrays, str, bin, int, float, nil and bool, and
flax's ext types (`flax/serialization.py`, `_MsgpackExtType`):

- 1, ndarray: the msgpack array (shape, dtype name, C-order buffer);
- 2, native complex: the array (real, imag);
- 3, numpy scalar: an ndarray of shape ().

`packb` writes what `msgpack.packb(tree, default=flax's ext packer,
strict_types=True)` writes for a tree of dicts, lists, scalars and numpy
arrays (the smallest encoding of each int, str and bin length, floats as
float64), so its bytes equal flax's for the same tree.  `unpackb` returns
numpy arrays (a bfloat16 leaf, which numpy lacks, widened to float32) and
decodes every msgpack type. Arrays over flax's 1 GiB chunk size are not
written.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_LEAF_BYTES = 2**30  # flax chunks larger arrays (`MAX_CHUNK_SIZE`)


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                               (0xCF, ">Q", 2**64)):
            if x < top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -(2**7)), (0xD1, ">h", -(2**15)),
                               (0xD2, ">i", -(2**31)), (0xD3, ">q", -(2**63))):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a str, bin, array or map of n entries: the fix form
    when there is one and n fits, else the first of `codes` (8, 16, 32
    bits) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} entries do not fit msgpack's 32-bit sizes")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + data
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code]) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: (shape, dtype name, buffer) packed."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's chunked form")
    return packb((tuple(int(s) for s in arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj`, flax's ext types included."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out += [_sized(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)), data]
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        out += [_sized(len(data), None, 0, (0xC4, 0xC5, 0xC6)), data]
    elif type(obj) in (list, tuple):
        out.append(_sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        out.append(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif type(obj) is complex:
        out.append(_ext(EXT_COMPLEX, packb((obj.real, obj.imag))))
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def _dtype(name: bytes):
    return np.dtype(name.decode())


def _ndarray(data: bytes) -> np.ndarray:
    """flax's `_ndarray_from_bytes`; bfloat16 comes back as float32."""
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape, order="C")


def _unext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xC4 <= b <= 0xC6:
            return self.take(self.unpack(sizes[b - 0xC4]))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return _unext(code, self.take(1 << (b - 0xD4)))
        if 0xC7 <= b <= 0xC9:
            n = self.unpack(sizes[b - 0xC7])
            code = self.unpack(">b")
            return _unext(code, self.take(n))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False):
    """The object `data` encodes (str as bytes with `raw`)."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return obj
