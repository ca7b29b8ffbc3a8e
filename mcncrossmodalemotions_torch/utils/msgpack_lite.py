"""A reader of the msgpack subset that flax's serialization writes.

The JAX package saves its train state as ``net-epoch-N.msgpack``:
``flax.serialization.to_bytes``, a msgpack map of the state's fields
(``mcncrossmodalemotions_tpu/train/checkpoints.py``). The port imports
neither flax nor msgpack, so this module decodes that format by itself:

- nil, bool, ints of every width, float32 and float64, str and bin,
  arrays (as lists) and maps (as dicts);
- ext type 1, an ndarray: a packed ``(shape, dtype name, buffer)``. Leaves
  come back as C-ordered numpy arrays, except ``bfloat16``, which numpy
  lacks: it becomes a ``torch.bfloat16`` tensor, the buffer read as
  uint16 and viewed as bfloat16;
- ext type 3, a numpy scalar, stored as a 0-d ndarray;
- flax's ``__msgpack_chunked_array__`` dicts (arrays over 1 GiB cut into
  chunks) are joined back into one array;
- tuples and lists, which flax stores as ``{"0": ..., "1": ...}`` maps,
  stay dicts (``as_tuple`` turns one back).

Anything else (another ext type, a reserved byte, trailing bytes, a
truncated buffer) raises ``MsgpackError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {  # first byte -> (struct format of the length or value, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"),
    0xCE: (">I", "value"), 0xCF: (">Q", "value"),
    0xD0: (">b", "value"), 0xD1: (">h", "value"),
    0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class MsgpackError(ValueError):
    """The bytes are not the msgpack subset this reader knows, or end early."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        if b not in _SIZED:
            raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} is "
                               "not in the msgpack subset flax writes")
        fmt, kind = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "value":
            return n
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as exc:
            raise MsgpackError(f"bad utf-8 at offset {self.pos - n}") from exc

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.obj()
            if isinstance(key, (dict, list)):
                raise MsgpackError("a map key that is a map or an array")
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise MsgpackError(f"ext type {code} is not an ndarray (1) or a numpy "
                           "scalar (3)")


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: a packed (shape, dtype, buffer)."""
    fields = unpackb(payload, chunked=False)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise MsgpackError("an ndarray record is not (shape, dtype, buffer)")
    shape, name, buf = fields
    if isinstance(name, bytes):
        name = name.decode()
    if not (isinstance(shape, list) and all(isinstance(s, int) for s in shape)
            and isinstance(name, str) and isinstance(buf, bytes)):
        raise MsgpackError("an ndarray record is not (shape, dtype, buffer)")
    count = int(np.prod(shape, dtype=np.int64))
    dtype = np.dtype(np.uint16) if name == "bfloat16" else _dtype(name)
    if len(buf) != count * dtype.itemsize:
        raise MsgpackError(f"ndarray {name}{shape}: {len(buf)} bytes, "
                           f"{count * dtype.itemsize} expected")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _dtype(name: str) -> np.dtype:
    try:
        dtype = np.dtype(name)
    except TypeError as exc:
        raise MsgpackError(f"unknown dtype {name!r}") from exc
    if dtype.hasobject:
        raise MsgpackError(f"dtype {name!r} holds objects")
    return dtype


def as_tuple(tree: Dict[str, Any]) -> Tuple[Any, ...]:
    """A tuple or list that flax stored as ``{"0": a, "1": b, ...}``."""
    try:
        return tuple(tree[str(i)] for i in range(len(tree)))
    except KeyError as exc:
        raise MsgpackError(f"not a stored tuple: keys {sorted(tree)}") from exc


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked arrays back into one array, everywhere."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(int(s) for s in as_tuple(tree["shape"]))
        chunks = as_tuple(tree["chunks"])
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes, chunked: bool = True) -> Any:
    """Decode one msgpack object that fills ``data`` (flax's
    ``msgpack_restore``); ``chunked`` joins chunked arrays."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after the "
                           "object")
    return _unchunk(obj) if chunked else obj
