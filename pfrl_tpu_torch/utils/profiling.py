"""Profiling helpers (counterpart of ``pfrl_tpu/utils/profiling.py``).

- :func:`trace` wraps a block in ``torch.profiler`` and writes a
  Chrome / TensorBoard trace (``*.pt.trace.json``) under ``logdir``: host
  operators always, the CUDA kernels when a card is present, and the
  program's spans as ``pfrl_tpu_torch.<name>`` ranges.
- :func:`span` and :func:`count` mark the program's layer boundaries (the
  off-policy runner's step, act, env, add, returns, sample, draw, gather,
  update, feedback and target sync, its ``init`` and the kernels' build).
  They record only under :func:`recording`, which installs a
  :class:`SpanRecorder`; with none installed a span is one shared null
  context that reads no clock and enters no ``record_function``.
- :class:`StepTimer` measures steady-state throughput; a ``fence`` (any
  nest of tensors) synchronizes the devices that hold its tensors before
  the clock is read, so queued kernels are counted.
"""

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

RANGE_PREFIX = "pfrl_tpu_torch."

# (name, parent, start_ns, end_ns): ``parent`` is the index in the
# recorder's ``spans`` of the innermost span open at entry, -1 for none.
Span = Tuple[str, int, int, int]


class SpanRecorder:
    """The spans and counters of one recording, kept in memory.

    Only the thread that installed the recorder is instrumented: spans and
    counts made on any other thread are not recorded. Timestamps are on the
    profiler's host clock (Unix-epoch ns, as Kineto's host events), so a
    span recorded under ``torch.profiler`` lines up with the device
    operations it launched. With ``ranges``, each span also opens a
    ``record_function`` range named ``pfrl_tpu_torch.<name>``."""

    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.spans: List[Optional[Span]] = []  # None while a span is open
        self.counters: Dict[str, int] = {}
        self._open: List[int] = []
        self._thread = threading.get_ident()
        # perf_counter_ns is monotonic; one pair of readings shifts it onto
        # the epoch clock of the profiler's host events.
        self._shift = time.time_ns() - time.perf_counter_ns()

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self._shift

    def summary(self) -> dict:
        """``{"spans": {name: {"seconds", "self_seconds", "calls"}},
        "counters": {...}, "raw": [...]}``: a span's self time is its
        duration less its children's."""
        done = [s for s in self.spans if s is not None]
        children = [0] * len(self.spans)
        for s in done:
            if s[1] >= 0:
                children[s[1]] += s[3] - s[2]
        out: Dict[str, Dict[str, float]] = {}
        for i, s in enumerate(self.spans):
            if s is None:
                continue
            per = out.setdefault(s[0], {"seconds": 0.0, "self_seconds": 0.0, "calls": 0})
            per["seconds"] += (s[3] - s[2]) / 1e9
            per["self_seconds"] += (s[3] - s[2] - children[i]) / 1e9
            per["calls"] += 1
        return {"spans": out, "counters": dict(self.counters), "raw": done}


class _Span:
    __slots__ = ("_rec", "_name", "_index", "_parent", "_start", "_range")

    def __init__(self, rec: SpanRecorder, name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        rec = self._rec
        self._parent = rec._open[-1] if rec._open else -1
        self._index = len(rec.spans)
        rec.spans.append(None)
        rec._open.append(self._index)
        self._start = rec.now_ns()
        self._range = None
        if rec.ranges:
            self._range = torch.autograd.profiler.record_function(RANGE_PREFIX + self._name)
            self._range.__enter__()

    def __exit__(self, *exc):
        rec = self._rec
        if self._range is not None:
            self._range.__exit__(*exc)
        rec.spans[self._index] = (self._name, self._parent, self._start, rec.now_ns())
        rec._open.pop()
        return False


_recorder: Optional[SpanRecorder] = None
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("update"):`` — a span of the installed recorder, or the
    shared null context when none is installed."""
    rec = _recorder
    if rec is None or rec._thread != threading.get_ident():
        return _OFF
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the installed recorder's counter ``name``; nothing when
    none is installed."""
    rec = _recorder
    if rec is not None and rec._thread == threading.get_ident():
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(ranges: bool = False) -> Iterator[SpanRecorder]:
    """Installs a :class:`SpanRecorder` for the block and yields it; one
    recorder at a time, for the whole process. The recorder keeps every
    span of the block, so its memory grows with the number of spans."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already installed")
    _recorder = SpanRecorder(ranges)
    try:
        yield _recorder
    finally:
        _recorder = None


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``with profiling.trace("runs/trace"):`` — open the file in
    TensorBoard's profiler plugin or in a Chrome trace viewer. The block's
    spans are ranges of the trace: inside a :func:`recording` its recorder
    opens them for the block, elsewhere the block runs under
    ``recording(ranges=True)``, whose spans are kept in memory until the
    block ends (so open a :func:`recording` outside ``trace``, not inside)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rec = _recorder
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        if rec is None:
            with recording(ranges=True):
                yield prof
        else:
            ranges, rec.ranges = rec.ranges, True
            try:
                yield prof
            finally:
                rec.ranges = ranges


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
