"""FIFO with O(1) amortized random access (counterpart of
``pfrl_tpu/collections_/random_access_queue.py``, a copy: it has no device
code).

Reference parity: pfrl/collections/random_access_queue.py:6-102 (two-list
queue with amortized compaction and ``sample(k)``).
"""

import random as _random
from typing import Any, List, Optional, Sequence


class RandomAccessQueue:
    def __init__(self, *args, maxlen: Optional[int] = None):
        assert maxlen is None or maxlen >= 0
        self.maxlen = maxlen
        self._queue_front: List[Any] = []
        self._queue_back: List[Any] = list(*args)
        self._apply_maxlen()

    def _apply_maxlen(self) -> None:
        if self.maxlen is not None:
            while len(self) > self.maxlen:
                self.popleft()

    def __iter__(self):
        return iter(list(reversed(self._queue_front)) + self._queue_back)

    def __repr__(self):
        return f"RandomAccessQueue({list(self)!r})"

    def __len__(self) -> int:
        return len(self._queue_front) + len(self._queue_back)

    def __getitem__(self, i: int):
        if i >= 0:
            nf = len(self._queue_front)
            if i < nf:
                return self._queue_front[nf - i - 1]
            i -= nf
            if i >= len(self._queue_back):
                raise IndexError("RandomAccessQueue index out of range")
            return self._queue_back[i]
        if i < -len(self):
            raise IndexError("RandomAccessQueue index out of range")
        return self[len(self) + i]

    def __setitem__(self, i: int, x) -> None:
        if i >= 0:
            nf = len(self._queue_front)
            if i < nf:
                self._queue_front[nf - i - 1] = x
                return
            i -= nf
            if i >= len(self._queue_back):
                raise IndexError("RandomAccessQueue index out of range")
            self._queue_back[i] = x
            return
        if i < -len(self):
            raise IndexError("RandomAccessQueue index out of range")
        self[len(self) + i] = x

    def append(self, x) -> None:
        self._queue_back.append(x)
        if self.maxlen is not None and len(self) > self.maxlen:
            self.popleft()

    def extend(self, xs: Sequence) -> None:
        self._queue_back.extend(xs)
        self._apply_maxlen()

    def popleft(self):
        if not self._queue_front:
            if not self._queue_back:
                raise IndexError("pop from empty RandomAccessQueue")
            self._queue_front = self._queue_back
            self._queue_front.reverse()
            self._queue_back = []
        return self._queue_front.pop()

    def sample(self, k: int) -> List[Any]:
        return [self[i] for i in _random.sample(range(len(self)), k)]
