"""A reader of flax's msgpack checkpoints, in pure Python.

Every checkpoint the JAX package writes (``zoo/``, ``--save-to``,
``AttributeSavingMixin.save``, ``save_state``) is
``flax.serialization.to_bytes`` of a state: msgpack of the state's
state-dict, with flax's ext types for arrays. This module reads those bytes
without flax or the ``msgpack`` package, so a checkpoint loads where only
torch and numpy are installed.

What it decodes:

- the msgpack types: maps, arrays, str, bin, ints, floats, nil, bools,
  fixext and ext;
- flax's ext codes: ``1`` an ndarray ``(shape, dtype name, bytes)``, ``2``
  a complex ``(real, imag)``, ``3`` a numpy scalar (an ndarray's encoding);
- flax's chunked arrays, ``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``, which it writes for an array above ``MAX_CHUNK_SIZE`` = 2^30
  bytes, back into one array.

Arrays come back as read-only numpy arrays over the file's bytes, as
flax's ``msgpack_restore`` gives them. numpy has no ``bfloat16`` without
``ml_dtypes``, so a bfloat16 leaf comes back as a ``torch.bfloat16`` tensor
with the same bits. An empty map stays an empty dict (an optax
``EmptyState`` is stored as ``{}``). Anything else raises
:class:`FlaxMsgpackError`: an unknown ext code, a dtype numpy cannot name,
truncated or trailing bytes.

:class:`FlaxTree` is a read-only view of a restored tree for the
converters of :mod:`pfrl_tpu_torch.convert`: a mapping with attribute
access to its fields (``state.params``, ``adam.mu``) and integer indexing
of flax's ``"0"``, ``"1"`` keys (``opt_state[1][0]``), as a flax state with
numpy leaves offers them.
"""

import struct
from collections.abc import Mapping
from typing import Any, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class FlaxMsgpackError(ValueError):
    """The bytes are not a flax msgpack checkpoint this reader can decode."""


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise FlaxMsgpackError(f"truncated: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
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
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise FlaxMsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return _ext(code, self.take(n))


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def unpackb(data) -> Any:
    """One msgpack value from ``data``, with flax's ext types decoded;
    raises on trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise FlaxMsgpackError(f"{len(reader.buf) - reader.pos} trailing bytes after the value")
    return out


def _ext(code: int, payload: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise FlaxMsgpackError(f"unknown msgpack ext type code {code} (flax writes 1, 2 and 3)")


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    try:
        shape, name, buffer = unpackb(payload)
    except (TypeError, ValueError) as e:
        raise FlaxMsgpackError(f"an ndarray ext is not (shape, dtype, bytes): {e}") from None
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        return _bfloat16(buffer, shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise FlaxMsgpackError(f"dtype {name!r} has no numpy dtype") from None
    if dtype.hasobject:
        raise FlaxMsgpackError(f"dtype {name!r} holds objects")
    if len(buffer) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise FlaxMsgpackError(f"{len(buffer)} bytes for a {name} array of shape {shape}")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _bfloat16(buffer: bytes, shape: Tuple[int, ...]):
    import torch

    if len(buffer) != 2 * int(np.prod(shape, dtype=np.int64)):
        raise FlaxMsgpackError(f"{len(buffer)} bytes for a bfloat16 array of shape {shape}")
    if not buffer:
        return torch.empty(shape, dtype=torch.bfloat16)
    return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)


def _unchunk(node: dict):
    """flax's ``_unchunk``: the chunks, in key order, joined and reshaped."""
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if any(not isinstance(c, np.ndarray) for c in chunks):
        import torch

        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(node: Any) -> Any:
    if isinstance(node, dict):
        if CHUNKED_KEY in node:
            return _unchunk(node)
        for k, v in node.items():
            node[k] = _unchunk_leaves(v)
    return node


def msgpack_restore(data) -> Any:
    """The counterpart of ``flax.serialization.msgpack_restore``: the state
    dict in ``data`` (nested dicts and lists, numpy leaves), chunked arrays
    joined."""
    return _unchunk_leaves(unpackb(data))


def read(path: str) -> Any:
    """:func:`msgpack_restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


class FlaxTree(Mapping):
    """A read-only view of a restored state dict: ``tree["params"]``,
    ``tree.params`` and, for flax's tuple keys, ``tree[0]``."""

    __slots__ = ("_node",)

    def __init__(self, node: Mapping):
        object.__setattr__(self, "_node", node)

    def __getitem__(self, key):
        if isinstance(key, int) and not isinstance(key, bool):
            key = str(key)
        value = self._node[key]
        return FlaxTree(value) if isinstance(value, Mapping) else value

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"the checkpoint has no field {name!r} (fields: {sorted(self._node)})") from None

    def __setattr__(self, name, value):
        raise AttributeError("a FlaxTree is read-only")

    def __iter__(self):
        return iter(self._node)

    def __len__(self) -> int:
        return len(self._node)

    def __repr__(self) -> str:
        return f"FlaxTree({sorted(self._node)})"


def load(path: str) -> FlaxTree:
    """The checkpoint at ``path`` as a :class:`FlaxTree`."""
    tree = read(path)
    if not isinstance(tree, Mapping):
        raise FlaxMsgpackError(f"{path} holds a {type(tree).__name__}, not a state dict")
    return FlaxTree(tree)
