"""Append-only CRC-checked chunked experience storage (counterpart of
``pfrl_tpu/collections_/persistent_collections.py``, a copy: the on-disk
format is the same byte for byte, so a queue written by either package
resumes in the other).

Reference parity: pfrl/collections/persistent_collections.py:16-401 — the
``chunk.N.idx`` / ``chunk.N.data`` file pair format with a struct-packed
index and CRC32-verified pickled records; resume scans chunks newest-first
up to maxlen. This gives crash-resumable experience storage for the
persistent replay buffers.
"""

import os
import pickle
import struct
import zlib
from typing import Any, List, Optional

_INDEX_FMT = "QQQIi"  # offset, length, timestamp(unused=0), crc32, flags
_INDEX_SIZE = struct.calcsize(_INDEX_FMT)


class _ChunkWriter:
    def __init__(self, basedir: str, chunk_id: int):
        self.data_path = os.path.join(basedir, f"chunk.{chunk_id}.data")
        self.idx_path = os.path.join(basedir, f"chunk.{chunk_id}.idx")
        self._data = open(self.data_path, "ab")
        self._idx = open(self.idx_path, "ab")

    def append(self, item: Any) -> None:
        blob = pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
        offset = self._data.tell()
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        self._data.write(blob)
        self._idx.write(struct.pack(_INDEX_FMT, offset, len(blob), 0, crc, 0))

    def flush(self) -> None:
        self._data.flush()
        self._idx.flush()

    def close(self) -> None:
        self._data.close()
        self._idx.close()


def _read_chunk(basedir: str, chunk_id: int) -> List[Any]:
    idx_path = os.path.join(basedir, f"chunk.{chunk_id}.idx")
    data_path = os.path.join(basedir, f"chunk.{chunk_id}.data")
    out: List[Any] = []
    if not (os.path.exists(idx_path) and os.path.exists(data_path)):
        return out
    with open(idx_path, "rb") as fi, open(data_path, "rb") as fd:
        while True:
            rec = fi.read(_INDEX_SIZE)
            if len(rec) < _INDEX_SIZE:
                break
            offset, length, _ts, crc, _flags = struct.unpack(_INDEX_FMT, rec)
            fd.seek(offset)
            blob = fd.read(length)
            if len(blob) != length or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
                # Torn write at crash time: stop at the last valid record.
                break
            out.append(pickle.loads(blob))
    return out


class PersistentRandomAccessQueue:
    """Disk-backed append-only queue with in-memory random access.

    All items live in memory (like the reference, which mirrors disk into a
    RandomAccessQueue on resume); disk is the crash-recovery source of
    truth. ``maxlen`` caps what is resumed, newest-first.
    """

    CHUNK_ITEMS = 5000

    def __init__(self, basedir: str, maxlen: Optional[int] = None):
        self.basedir = basedir
        self.maxlen = maxlen
        os.makedirs(basedir, exist_ok=True)
        self._memory: List[Any] = []
        self._chunk_id = 0
        self._items_in_chunk = 0
        self._resume()
        self._writer = _ChunkWriter(self.basedir, self._chunk_id)

    def _chunk_ids(self) -> List[int]:
        ids = []
        for name in os.listdir(self.basedir):
            if name.startswith("chunk.") and name.endswith(".idx"):
                try:
                    ids.append(int(name.split(".")[1]))
                except ValueError:
                    pass
        return sorted(ids)

    def _resume(self) -> None:
        ids = self._chunk_ids()
        if not ids:
            return
        # Newest-first until maxlen is satisfied (reference :20-92).
        collected: List[List[Any]] = []
        total = 0
        for cid in reversed(ids):
            items = _read_chunk(self.basedir, cid)
            collected.append(items)
            total += len(items)
            if self.maxlen is not None and total >= self.maxlen:
                break
        items_flat: List[Any] = []
        for chunk in reversed(collected):
            items_flat.extend(chunk)
        if self.maxlen is not None:
            items_flat = items_flat[-self.maxlen:]
        self._memory = items_flat
        self._chunk_id = ids[-1] + 1

    def append(self, item: Any) -> None:
        self._memory.append(item)
        if self.maxlen is not None and len(self._memory) > self.maxlen:
            self._memory.pop(0)
        self._writer.append(item)
        self._items_in_chunk += 1
        if self._items_in_chunk >= self.CHUNK_ITEMS:
            self._writer.close()
            self._chunk_id += 1
            self._items_in_chunk = 0
            self._writer = _ChunkWriter(self.basedir, self._chunk_id)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def __len__(self) -> int:
        return len(self._memory)

    def __getitem__(self, i: int):
        return self._memory[i]

    def sample(self, k: int):
        import random

        return [self._memory[i] for i in random.sample(range(len(self._memory)), k)]
