"""A msgpack decoder for the JAX package's `.ckpt` files, in pure Python.

The JAX package writes a checkpoint with `flax.serialization.msgpack_serialize`
(u2pl_tpu/utils/checkpoint.py:39-75): one msgpack map holding `epoch`,
`best_miou`, `step`, `model_state`, `optimizer_state` and, where the run had
them, `teacher_state`, `memobank` and `prototype`.  Neither `flax` nor
`msgpack` is needed to read it: this module decodes the msgpack types that
layout uses (maps, arrays, strings, bin, ints, floats, nil and bool) and
flax's ext types (`flax/serialization.py`):

  * ext 1, an ndarray: a nested msgpack array (shape, dtype name, the
    C-order bytes);
  * ext 3, a numpy scalar: the same, of shape ();

and joins flax's chunked leaves, `{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": ..., ...}}`, back into one array.
Lists and tuples reach the file as maps keyed "0", "1", ... (flax's
`to_state_dict`) and are returned as such, as `msgpack_restore` returns
them.

An array is a read-only `np.frombuffer` view of the file's bytes, not a
copy, so walking past the optimizer state and the memory bank costs no
copy.  `bfloat16` has no numpy dtype: such an array is read as uint16 and
returned as a `torch.bfloat16` tensor of the same bits (a copy).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["msgpack_restore", "read_msgpack_ckpt"]

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over one msgpack buffer.  A bin value is returned as bytes,
    as msgpack_restore returns it, or with `bin_views` as a memoryview of
    the buffer (an ndarray's data: no copy)."""

    def __init__(self, buf: memoryview, bin_views: bool = False):
        self.buf = buf
        self.pos = 0
        self.bin_views = bin_views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated data ({n} bytes wanted at {self.pos}, "
                             f"{len(self.buf)} in all)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
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
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _BIN:
            data = self.take(self.unpack(_BIN[b]))
            return data if self.bin_views else bytes(data)
        if b in _EXT:
            n = self.unpack(_EXT[b])
            return _ext(self.unpack(">b"), self.take(n))
        if b in _FIXEXT:
            return _ext(self.unpack(">b"), self.take(_FIXEXT[b]))
        if b in _NUM:
            return self.unpack(_NUM[b])
        if b in _STR:
            return str(self.take(self.unpack(_STR[b])), "utf-8")
        if b in _ARRAY:
            return self.array(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUM = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
        0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _ndarray(data: memoryview):
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C-order bytes)."""
    shape, dtype, raw = _Reader(data, bin_views=True).obj()
    dtype = str(dtype, "utf-8") if isinstance(dtype, memoryview) else dtype
    shape = tuple(shape)
    if dtype == "bfloat16":
        # a tensor may be written to, the file's bytes may not: the bf16
        # leaf is the one that is copied
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"msgpack: ext type {code} is not one of flax's checkpoint types")


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked array leaves, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = _as_tuple(tree["shape"])
        chunks = _as_tuple(tree["chunks"])
        if all(torch.is_tensor(c) for c in chunks):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _as_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def msgpack_restore(data) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` returns, decoded
    without flax: numpy arrays (read-only views of `data`), numpy scalars,
    `torch.bfloat16` tensors for bfloat16 leaves, and Python values."""
    reader = _Reader(memoryview(data))
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return _unchunk(tree)


def read_msgpack_ckpt(path: str) -> Any:
    """Decode the `.ckpt` file at `path` (see `msgpack_restore`)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
