"""Reading a ``torch.profiler`` window: device operations, the device's busy
time as the union of their intervals, the operations launched under each of
the benchmark's ``record_function`` ranges, and the idle gaps by the range
the host was in.

An operation is attributed to a range by its launch: the runtime call
(``cudaLaunchKernel``, ``cudaMemcpyAsync`` ...) with the operation's
correlation id, made on the host inside the range. The pure functions take
plain tuples, so they are tested without a device.
"""

import bisect
import collections
from typing import Dict, List, Tuple

RANGE_PREFIX = "portbench."

# (name, start_ns, duration_ns, correlation id)
DeviceOp = Tuple[str, int, int, int]
Interval = Tuple[int, int]


def events_of(prof):
    """``(device ops, launches by correlation id, ranges by name)`` of a
    finished profiler run, from its raw records."""
    from torch.autograd import DeviceType

    ops: List[DeviceOp] = []
    launches: Dict[int, int] = {}
    ranges: Dict[str, List[Interval]] = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # The ranges are mirrored on the device's timeline; they are no
            # operations.
            if not name.startswith(RANGE_PREFIX):
                ops.append((name, e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif name.startswith(RANGE_PREFIX):
            ranges[name[len(RANGE_PREFIX):]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return ops, launches, dict(ranges)


def union(intervals: List[Interval]) -> List[Interval]:
    merged: List[List[int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


class _Ranges:
    """Which benchmark ranges were open on the host at a time."""

    def __init__(self, ranges: Dict[str, List[Interval]]):
        self.by_name = {k: sorted(v) for k, v in ranges.items()}
        self.starts = {k: [lo for lo, _ in v] for k, v in self.by_name.items()}

    def open_at(self, t: int) -> List[Tuple[int, str]]:
        """``(start, name)`` of each range open at ``t``."""
        out = []
        for name, starts in self.starts.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and self.by_name[name][i][1] >= t:
                out.append((starts[i], name))
        return out


def summarize(ops: List[DeviceOp], launches: Dict[int, int], ranges: Dict[str, List[Interval]],
              window_s: float) -> dict:
    """Counts and seconds of a traced window: ``device_ops``, ``busy_s``
    (the union of the operations' intervals), ``window_s``, per range the
    device seconds, operations and calls under it (``under``), the top
    operations by device time and the idle gaps by the innermost range open
    when the operation that ends the gap was launched (``breakdown``), and
    how many operations had no launch on record (``unattributed``)."""
    spans = union([(s, s + d) for _, s, d, _ in ops])
    busy_ns = sum(hi - lo for lo, hi in spans)
    open_ranges = _Ranges(ranges)
    under = {name: {"device_s": 0.0, "device_ops": 0, "calls": len(v)} for name, v in ranges.items()}
    by_name = collections.defaultdict(float)
    unattributed = 0
    inner_at_start = {}
    for name, start, dur, corr in ops:
        by_name[name] += dur / 1e9
        launched = launches.get(corr)
        if launched is None:
            unattributed += 1
            continue
        opened = open_ranges.open_at(launched)
        for _, r in opened:
            under[r]["device_s"] += dur / 1e9
            under[r]["device_ops"] += 1
        inner_at_start[start] = max(opened)[1] if opened else "outside the benchmark's ranges"
    gaps = collections.defaultdict(float)
    for (_, prev_hi), (lo, _) in zip(spans, spans[1:]):
        gaps[inner_at_start.get(lo, "unattributed")] += (lo - prev_hi) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_ops": len(ops),
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "under": under,
        "unattributed": unattributed,
        "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]},
    }
