"""The flax msgpack format of the JAX package's checkpoints, without msgpack.

`flax.serialization.to_bytes(tree)` writes the tree's state dict (string
keys; lists as maps keyed "0", "1", ...) as MessagePack with every array as
extension type 1, whose payload is itself the MessagePack array
`[shape, dtype name, raw C-order bytes]`. `pack` writes exactly the bytes
`msgpack.packb(..., use_bin_type=True)` writes for what a state dict holds
(the smallest encoding of every length and integer), so a state dict packed
here is byte for byte what flax writes; `unpack` reads what flax writes. The
port cannot import msgpack or flax.

Written: dict (str keys), list, str, bytes, non-negative int and numpy
arrays of the dtypes in `WRITTEN_DTYPES` (a 0-d array for a scalar, as the
JAX package's states hold them); anything else is refused with a TypeError
or ValueError. The reader stays general, as it reads files written
elsewhere: every MessagePack type, with extension types 1 (arrays of the
dtypes in `DTYPES`) and 3 (flax's numpy scalars); any other extension type
or dtype is refused with a ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
DTYPES = frozenset({"bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                    "uint64", "float16", "float32", "float64", "complex64", "complex128"})
WRITTEN_DTYPES = frozenset({"float32", "int32", "uint32"})


# ------------------------------------------------------------------- write
def _header(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """The header of a str/bin/array/map of length n: the fix form below
    fix_max, else the first of (8-, 16-, 32-bit length) codes that fits."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit MessagePack")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                             (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
        if 0 <= x <= limit:
            return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"integer {x} is not written here (non-negative, below 2**64)")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        head = bytes([fixext[len(data)]])
    else:
        head = _header(len(data), None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _array_payload(x: np.ndarray) -> bytes:
    name = x.dtype.name
    if name not in WRITTEN_DTYPES:
        raise ValueError(f"dtype {name} is not written in the flax msgpack format here")
    return pack([list(x.shape), name, np.ascontiguousarray(x).tobytes("C")])


def _pack_into(x, out: list) -> None:
    if isinstance(x, np.ndarray):
        out.append(_pack_ext(EXT_NDARRAY, _array_payload(x)))
    elif type(x) is int:
        out.append(_pack_int(x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(x, bytes):
        out.append(_header(len(x), None, 0, (0xC4, 0xC5, 0xC6)) + x)
    elif isinstance(x, list):
        out.append(_header(len(x), 0x90, 16, (None, 0xDC, 0xDD)))
        for item in x:
            _pack_into(item, out)
    elif isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, (None, 0xDE, 0xDF)))
        for key, value in x.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {type(key).__name__}")
            _pack_into(key, out)
            _pack_into(value, out)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def pack(x) -> bytes:
    """MessagePack bytes of `x` (see the module docstring)."""
    out: list = []
    _pack_into(x, out)
    return b"".join(out)


# -------------------------------------------------------------------- read
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# type byte -> (kind, format of the length that follows it)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SCALARS:
            return self.num(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _SIZED:
            raise ValueError(f"unknown MessagePack type byte 0x{b:02x}")
        kind, fmt = _SIZED[b]
        n = self.num(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown MessagePack extension type {code}")
        shape, name, raw = _Reader(data).value()
        name = name.decode() if isinstance(name, bytes) else name
        if name not in DTYPES:
            raise ValueError(f"unknown dtype {name!r} in the flax msgpack data")
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr


def unpack(data: bytes):
    """The object `data` encodes; arrays come back as numpy arrays that own
    their memory."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the MessagePack "
                         "object")
    return out
