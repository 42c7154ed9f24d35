"""A self-contained reader of the msgpack files that Flax's
`serialization.to_bytes` writes (the JAX package's checkpoints), needing
neither `msgpack` nor `flax`: the card's machine has neither.

It decodes the subset of msgpack that `to_bytes` emits: nil, bool, ints and
floats of every width, str, bin, array and map of every width, and Flax's
two extension types, ext 1 (an ndarray: a nested msgpack array of shape,
dtype name and C-order bytes) and ext 3 (a numpy scalar, the same encoding
of a 0-d array). A map of the form Flax writes for leaves above its
MAX_CHUNK_SIZE ({"__msgpack_chunked_array__": True, "shape": {...},
"chunks": {...}}) is joined back into one array, as
`flax.serialization.msgpack_restore` does. bfloat16 arrays, which numpy has
no dtype for, are widened to float32 exactly. Anything else raises.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data, raw_str=False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def str_(self, n):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(struct.unpack(">b", self.take(1))[0], n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 / 16 / 32 / 64
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code = struct.unpack(">b", self.take(1))[0]
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self.str_(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map_(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map_(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, code, n):
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported extension type {code}")
        arr = _ndarray_from_bytes(payload)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _ndarray_from_bytes(payload):
    """Flax's ndarray encoding: msgpack [shape, dtype name, C-order bytes]."""
    r = _Reader(payload, raw_str=True)
    shape, name, data = r.value()
    if r.pos != len(payload):
        raise ValueError("msgpack: trailing bytes in an ndarray payload")
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d):
    """The array Flax split into `chunks` (flat pieces) of shape `shape`,
    both stored as maps {"0": ..., "1": ...}."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data) -> dict:
    """The state dict (nested dicts, numpy arrays and scalars, Python ints,
    floats, strings and bools) encoded in `data`, as
    flax.serialization.msgpack_restore returns it."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return out
