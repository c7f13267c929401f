"""A reader and a writer of flax's msgpack checkpoints, in pure Python.

Every checkpoint the JAX package writes (``zoo/``, ``--save-to``,
``AttributeSavingMixin.save``, ``save_state``) is
``flax.serialization.to_bytes`` of a state: msgpack of the state's
state-dict, with flax's ext types for arrays. This module reads those bytes
without flax or the ``msgpack`` package, so a checkpoint loads where only
torch and numpy are installed, and writes the same bytes as
``flax.serialization.msgpack_serialize`` (:func:`msgpack_serialize`,
:func:`write`), so that the JAX package reads what the port saves.

What it decodes:

- the msgpack types: maps, arrays, str, bin, ints, floats, nil, bools,
  fixext and ext;
- flax's ext codes: ``1`` an ndarray ``(shape, dtype name, bytes)``, ``2``
  a complex ``(real, imag)``, ``3`` a numpy scalar (an ndarray's encoding);
- flax's chunked arrays, ``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``, which it writes for an array above ``MAX_CHUNK_SIZE`` = 2^30
  bytes, back into one array.

The writer (:func:`packb`) encodes maps, lists and tuples, str, bytes,
ints, floats (as float64), None and bools with the msgpack package's
choices (the smallest encoding, ``use_bin_type``), numpy arrays and CPU
tensors as ext 1 and numpy scalars as ext 3. A ``torch.bfloat16`` tensor
is written under the dtype name ``"bfloat16"`` with its own bits, which is
what the reader gives back. An array above ``MAX_CHUNK_SIZE`` bytes inside
a map is written in flax's chunked form.

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


# --------------------------------------------------------------- the writer
def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack(">BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"{n} does not fit msgpack's 64-bit integers")


def _pack_sized(n: int, small: int, small_max: int, codes) -> bytes:
    """A header: a fix type below ``small_max``, else the 8-, 16- or 32-bit
    form whose codes are ``codes`` (None where msgpack has no such form)."""
    if n <= small_max:
        return struct.pack("B", small | n)
    for (code, fmt, top) in zip(codes, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack(fmt, code, n)
    raise OverflowError(f"{n} items or bytes exceed msgpack's 32-bit lengths")


def _pack_bin(data: bytes) -> bytes:
    return _pack_sized(len(data), 0, -1, (0xC4, 0xC5, 0xC6)) + data


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    head = struct.pack("B", fixed[n]) if n in fixed else _pack_sized(n, 0, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + data


def _ndarray_payload(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)``."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name, raw = tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        else:
            x = x.numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        shape, name, raw = x.shape, x.dtype.name, x.tobytes("C")
    return packb((list(shape), name, raw))


def _is_array(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    import torch

    return isinstance(x, torch.Tensor)


def packb(obj) -> bytes:
    """msgpack of ``obj`` as ``msgpack.packb(obj, default=flax's ext
    packer)`` writes it."""
    out = []
    _pack_into(obj, out)
    return b"".join(out)


def _pack_into(obj, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is int:
        out.append(_pack_int(obj))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        data = obj.encode("utf-8")
        out.append(_pack_sized(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data)
    elif t in (bytes, bytearray, memoryview):
        out.append(_pack_bin(bytes(obj)))
    elif t in (list, tuple):
        out.append(_pack_sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack_into(v, out)
    elif t is dict:
        out.append(_pack_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    elif _is_array(obj):
        out.append(_pack_ext(EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj))))
    elif t is complex:
        out.append(_pack_ext(EXT_COMPLEX, packb((obj.real, obj.imag))))
    else:
        raise TypeError(f"cannot write a {t.__name__} to msgpack")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if not isinstance(x, np.ndarray) else x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in pieces of ``MAX_CHUNK_SIZE``
    bytes, keyed ``"0"``, ``"1"``, ... like its shape."""
    itemsize = x.dtype.itemsize if isinstance(x, np.ndarray) else x.element_size()
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {
        CHUNKED_KEY: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))},
    }


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """The counterpart of ``flax.serialization.msgpack_serialize(tree,
    in_place=True)``, which ``to_bytes`` calls: an array above
    ``MAX_CHUNK_SIZE`` bytes in a map (or at the top) is chunked, then the
    tree is packed in its own key order. (Without ``in_place`` flax first
    copies the tree by a JAX tree map, which sorts every map's keys: the
    same bytes for a tree whose keys are sorted.)"""
    return packb(_chunk_leaves(tree))


def write(path: str, tree) -> None:
    """``tree`` (a state dict) into ``path`` as ``flax.serialization.to_bytes``
    writes it (:func:`msgpack_serialize`), atomically: a temporary file
    beside it, renamed into place."""
    import os
    import tempfile

    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    data = msgpack_serialize(tree)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
