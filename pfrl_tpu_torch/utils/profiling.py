"""Profiling helpers (counterpart of ``pfrl_tpu/utils/profiling.py``).

- :func:`trace` wraps a block in ``torch.profiler`` and writes a
  Chrome / TensorBoard trace (``*.pt.trace.json``) under ``logdir``: host
  operators always, and the CUDA kernels when a card is present.
- :class:`StepTimer` measures steady-state throughput; a ``fence`` (any
  nest of tensors) synchronizes the devices that hold its tensors before
  the clock is read, so queued kernels are counted.
"""

import contextlib
import time
from typing import Any, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``with profiling.trace("runs/trace"):`` — open the file in
    TensorBoard's profiler plugin or in a Chrome trace viewer."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()


def block_until_ready(fence: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``fence``."""
    for device in {t.device for t in _tensors(fence) if t.is_cuda}:
        torch.cuda.synchronize(device)


class StepTimer:
    def __init__(self):
        self._t0 = None
        self._steps = 0

    def start(self, fence: Any = None) -> None:
        if fence is not None:
            block_until_ready(fence)
        self._t0 = time.perf_counter()
        self._steps = 0

    def lap(self, n_steps: int, fence: Any = None) -> float:
        """Record ``n_steps`` more; returns the steps per second so far."""
        if fence is not None:
            block_until_ready(fence)
        self._steps += n_steps
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")
