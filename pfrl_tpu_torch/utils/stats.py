"""Host-side rolling statistics for ``Agent.get_statistics()`` (counterpart
of ``pfrl_tpu/utils/stats.py``): a fixed-window running mean over a numpy
ring. ``append`` reads its value on the host (``float``), so appending a
tensor on the card waits for the card, as it does in JAX."""

import numpy as np


class RunningStats:
    """Fixed-window running mean of a scalar series; NaN is skipped."""

    def __init__(self, maxlen: int = 100):
        self.maxlen = maxlen
        self._buf = np.zeros(maxlen, dtype=np.float64)
        self._n = 0
        self._i = 0

    def append(self, x) -> None:
        x = float(x)
        if np.isnan(x):
            return
        self._buf[self._i] = x
        self._i = (self._i + 1) % self.maxlen
        self._n = min(self._n + 1, self.maxlen)

    def mean(self) -> float:
        if self._n == 0:
            return float("nan")
        return float(self._buf[: self._n].mean())

    def __len__(self) -> int:
        return self._n
