"""A pure-Python reader of the ``.msgpack`` checkpoints the JAX package
writes (``flax.serialization.to_bytes``), without the ``msgpack`` package.

:func:`restore` returns what ``flax.serialization.msgpack_restore`` returns
for the same bytes: nested dicts (flax writes lists and tuples as
``{'0': ..., '1': ...}`` dicts, and they stay dicts, as there), Python
``None``/``bool``/``int``/``float``/``str``/``bytes`` and lists, and arrays:

* ext 1 (an ndarray: a msgpack ``(shape, dtype name, buffer)``) -> a
  read-only numpy array made by ``np.frombuffer`` on the buffer given to
  :func:`restore`, at the leaf's offset: no copy of the leaf, nor of the
  file a leaf;
* ext 3 (a numpy scalar, the same payload) -> the numpy scalar;
* ext 2 (a Python complex, a msgpack ``(real, imag)``) -> ``complex``;
* the dtype name ``bfloat16``, which numpy lacks, -> a ``torch.bfloat16``
  tensor (a copy of the leaf: the bits are kept, ``.view(torch.int16)``
  gives them back);
* flax's ``{'__msgpack_chunked_array__': True, 'shape', 'chunks'}`` leaves
  (arrays over ``2**30`` bytes) -> the array, concatenated from its chunks.

The types read are nil, bool, int and uint (8-64 bit and fixint), float32
and float64, str, bin, array, map and ext (fixext 1-16, ext 8/16/32).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


class _Reader:
    """Recursive descent over ``buf`` (any object with the buffer
    protocol); ``raw`` keeps strings as bytes, as flax's inner ndarray
    decode does."""

    def __init__(self, buf, raw: bool = False):
        self.buf = buf
        self.view = memoryview(buf)
        self.raw = raw

    def read(self, pos: int) -> Tuple[Any, int]:
        """The object starting at ``pos`` and the position after it."""
        b = self.view[pos]
        pos += 1
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f, pos)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f, pos)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f, pos)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in _FIXED:
            fmt = _FIXED[b]
            return struct.unpack_from(fmt, self.buf, pos)[0], \
                pos + struct.calcsize(fmt)
        if b in _FIXEXT:
            return self._ext(self.view[pos], pos + 1, _FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = struct.unpack_from(fmt, self.buf, pos)[0]
            pos += struct.calcsize(fmt)
            if kind == "bin":
                return bytes(self.view[pos:pos + n]), pos + n
            if kind == "str":
                return self._str(n, pos)
            if kind == "array":
                return self._array(n, pos)
            if kind == "map":
                return self._map(n, pos)
            return self._ext(struct.unpack_from(">b", self.buf, pos)[0],
                             pos + 1, n)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at "
                         f"{pos - 1}")

    def _str(self, n: int, pos: int):
        s = bytes(self.view[pos:pos + n])
        return (s if self.raw else s.decode("utf-8")), pos + n

    def _array(self, n: int, pos: int):
        out = []
        for _ in range(n):
            v, pos = self.read(pos)
            out.append(v)
        return out, pos

    def _map(self, n: int, pos: int):
        out = {}
        for _ in range(n):
            k, pos = self.read(pos)
            v, pos = self.read(pos)
            out[k] = v
        return out, pos

    def _ext(self, code: int, pos: int, n: int):
        end = pos + n
        if code == EXT_NDARRAY:
            return self._ndarray(pos, end), end
        if code == EXT_NPSCALAR:
            return self._ndarray(pos, end)[()], end
        if code == EXT_COMPLEX:
            (re, im), _ = _Reader(self.buf).read(pos)
            return complex(re, im), end
        raise ValueError(f"msgpack: unknown ext type {code} at {pos}")

    def _ndarray(self, pos: int, end: int):
        """flax's ``(shape, dtype name, buffer)``, the buffer not copied:
        its header is parsed here so its offset in ``buf`` is known."""
        head = _Reader(self.buf, raw=True)
        b = self.view[pos]
        if not 0x90 <= b <= 0x9f or b & 0x0f != 3:
            raise ValueError(f"msgpack: bad ndarray payload at {pos}")
        shape, pos = head.read(pos + 1)
        name, pos = head.read(pos)
        b = self.view[pos]
        if b not in (0xc4, 0xc5, 0xc6):
            raise ValueError(f"msgpack: ndarray buffer is not bin at {pos}")
        fmt = _SIZED[b][1]
        nbytes = struct.unpack_from(fmt, self.buf, pos + 1)[0]
        start = pos + 1 + struct.calcsize(fmt)
        if start + nbytes != end:
            raise ValueError(f"msgpack: ndarray buffer overruns at {pos}")
        name = name.decode() if isinstance(name, bytes) else name
        shape = tuple(shape)
        if name == "bfloat16":
            bits = np.frombuffer(self.buf, np.uint16, nbytes // 2, start)
            return torch.from_numpy(bits.reshape(shape).copy()).view(
                torch.bfloat16)
        dtype = np.dtype(name)
        return np.frombuffer(self.buf, dtype, nbytes // dtype.itemsize,
                             start).reshape(shape)


def unpackb(buf) -> Any:
    """The msgpack object in ``buf`` (which must hold exactly one)."""
    obj, end = _Reader(buf).read(0)
    if end != len(memoryview(buf)):
        raise ValueError(f"msgpack: {len(memoryview(buf)) - end} bytes "
                         f"after the object")
    return obj


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def restore(buf) -> Any:
    """``flax.serialization.msgpack_restore(buf)``, without ``msgpack``."""
    return _unchunk(unpackb(buf))


def read(path: str) -> Any:
    """:func:`restore` of a file's bytes."""
    with open(path, "rb") as f:
        return restore(f.read())
