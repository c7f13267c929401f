"""The program's own spans and counters (``pfrl_tpu_torch.utils.profiling``)
in a run of a cell, beside the harness's wrapped-method windows.

- :func:`recorded_set_up`: ``harness.set_up`` under a host recorder, which
  then covers the runner's ``init``, the replay warm-up's scan steps and the
  kernels' ``kernel_load``.
- :func:`program_profile_window`: scan steps under ``torch.profiler`` inside
  ``profiling.recording(ranges=True)``, with no wrapped method and no
  synchronization inside: device operations, launches and idle gaps by
  program span.
- :func:`host_span_window`: scan steps inside ``profiling.recording()``, no
  profiler, one synchronization before and one after: the host's issue
  time per span, which a synchronized span inflates.
- :func:`span_cost_us`: the host's cost of one span with no recorder and
  with one, which bounds the cost of recording per scan step.

Both windows advance the program through ``run_chunk``, so every draw is
logged and the reference replays them like the other steps.

The readers :func:`replay_add_ms`, :func:`feedback_ops`,
:func:`update_ops`, :func:`host_us_per_launch` and :func:`warmup_s` take a
record of the harness's kind with the keys ``setup_spans``,
``program_trace`` and ``host_spans`` added, and return ``None`` where their
record is missing or read nothing (a program without spans; the CPU, which
has no device operations). They divide by the counters ``updates`` and
``feedbacks``, never by span calls, so a fused or captured update that
keeps one span around its replay and counts the updates it replays reads
the same.

``python portbench/run_program_trace.py --workload <cell> --seed <n>``
prints them for one run on the CUDA device (see that file).
"""

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch

from pfrl_tpu_torch.utils import profiling
from portbench import devtrace, harness

PREFIX = profiling.RANGE_PREFIX
OUTSIDE = "outside the program's spans"

# (name, on the device, a user annotation, start_ns, duration_ns, correlation id)
Event = Tuple[str, bool, bool, int, int, int]


# -------------------------------------------------------------- the trace
def split_events(events: List[Event]):
    """``(device ops, launches by correlation id, program ranges by name)``.
    Every device-side mirror of a host range is dropped, whatever its name;
    the host ranges named ``pfrl_tpu_torch.<name>`` are kept."""
    ops: List[devtrace.DeviceOp] = []
    launches: Dict[int, int] = {}
    ranges: Dict[str, List[devtrace.Interval]] = collections.defaultdict(list)
    for name, on_device, annotation, start, dur, corr in events:
        if on_device:
            if not annotation:
                ops.append((name, start, dur, corr))
        elif name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((start, start + dur))
        elif name.startswith("cu"):
            launches[corr] = start
    return ops, launches, dict(ranges)


def program_events_of(prof):
    """:func:`split_events` of a finished profiler run's raw records."""
    from torch.autograd import DeviceType

    return split_events([(e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation(), e.start_ns(),
                          e.duration_ns(), e.correlation_id()) for e in prof.profiler.kineto_results.events()])


def launches_under(ops, launches, ranges) -> Dict[str, int]:
    """Per range name, the launches its operations came from: distinct
    correlation ids among the operations launched inside it."""
    open_ranges = devtrace._Ranges(ranges)
    ids = {name: set() for name in ranges}
    for _, _, _, corr in ops:
        launched = launches.get(corr)
        if launched is not None:
            for _, name in open_ranges.open_at(launched):
                ids[name].add(corr)
    return {name: len(v) for name, v in ids.items()}


def idle_gaps_by_span(ops, launches, ranges) -> Dict[str, float]:
    """Seconds of every gap between device operations, by the innermost
    range open when the operation that ends the gap was launched."""
    open_ranges = devtrace._Ranges(ranges)
    inner = {}
    for _, start, _, corr in ops:
        launched = launches.get(corr)
        if launched is not None:
            opened = open_ranges.open_at(launched)
            inner[start] = max(opened)[1] if opened else OUTSIDE
    spans = devtrace.union([(s, s + d) for _, s, d, _ in ops])
    gaps = collections.defaultdict(float)
    for (_, prev_hi), (lo, _) in zip(spans, spans[1:]):
        gaps[inner.get(lo, "unattributed")] += (lo - prev_hi) / 1e9
    return dict(gaps)


# -------------------------------------------------------------- the windows
def recorded_set_up(cell: dict, seed: int, device):
    """``(setup, the set-up's span summary)``: ``harness.set_up`` under a
    host recorder, with no range and no profiler."""
    with profiling.recording() as rec:
        setup = harness.set_up(cell, seed, device)
        harness.synchronize(device)
    return setup, rec.summary()


def program_profile_window(setup, steps: int) -> dict:
    """``steps`` scan steps under the profiler with the program's ranges:
    ``devtrace.summarize`` over them, with ``launches`` under each span, the
    idle gaps by span (all of them) and the recorder's counters."""
    from torch.profiler import ProfilerActivity, profile

    runner = setup.runner
    activities = [ProfilerActivity.CPU]
    if torch.device(runner.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        harness.synchronize(runner.device)
        t0 = time.perf_counter()
        with profiling.recording(ranges=True) as rec:
            runner.run_chunk(setup.state, steps)
        harness.synchronize(runner.device)
        window_s = time.perf_counter() - t0
    ops, launches, ranges = program_events_of(prof)
    summary = devtrace.summarize(ops, launches, ranges, window_s)
    summary["launches"] = launches_under(ops, launches, ranges)
    summary["idle_gaps_by_span"] = sorted(([k, v] for k, v in idle_gaps_by_span(ops, launches, ranges).items()),
                                          key=lambda kv: -kv[1])
    summary["counters"] = rec.summary()["counters"]
    summary["scan_steps"] = steps
    return summary


def host_span_window(setup, steps: int) -> dict:
    """``steps`` scan steps recorded on the host, synchronized only before
    and after: the recorder's summary (raw spans left out), the window's
    seconds and its scan steps."""
    runner = setup.runner
    harness.synchronize(runner.device)
    t0 = time.perf_counter()
    with profiling.recording() as rec:
        runner.run_chunk(setup.state, steps)
    harness.synchronize(runner.device)
    window_s = time.perf_counter() - t0
    summary = rec.summary()
    del summary["raw"]
    return dict(summary, window_s=window_s, scan_steps=steps)


def span_cost_us(n: int = 100_000) -> dict:
    """Host µs per span with no recorder and with one (a span and a count,
    empty), over ``n`` of each."""
    out = {}
    for side in ("off", "on"):
        with profiling.recording() if side == "on" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(n):
                with profiling.span("x"):
                    profiling.count("x")
            out[side] = 1e6 * (time.perf_counter() - t0) / n
    return out


# -------------------------------------------------------------- the readers
def _spans(rec: dict, key: str):
    record = rec.get(key)
    return record.get("spans", {}) if record else {}


def replay_add_ms(rec: dict):
    """The ring's add with PER's admission into the trees, per scan step,
    in the host-span window: ``add`` seconds over ``step`` calls."""
    s = _spans(rec, "host_spans")
    if not s.get("add") or not s.get("step", {}).get("calls"):
        return None
    return 1e3 * s["add"]["seconds"] / s["step"]["calls"]


def _ops_per(rec: dict, span: str, counter: str):
    trace = rec.get("program_trace")
    under = trace and trace["under"].get(span)
    n = trace and trace["counters"].get(counter)
    if not under or not under["device_ops"] or not n:
        return None
    return under["device_ops"] / n


def feedback_ops(rec: dict):
    """Device operations launched under ``feedback`` per priority feedback,
    in the program-profiled window."""
    return _ops_per(rec, "feedback", "feedbacks")


def update_ops(rec: dict):
    """Device operations launched under ``update`` per gradient step, in the
    program-profiled window."""
    return _ops_per(rec, "update", "updates")


def host_us_per_launch(rec: dict):
    """The host's issue time per launch: the host-span window's ``step``
    µs per scan step over the program-profiled window's launches under
    ``step`` per scan step."""
    s, trace = _spans(rec, "host_spans"), rec.get("program_trace")
    launches = trace and trace["launches"].get("step")
    if not s.get("step", {}).get("calls") or not launches:
        return None
    host_us = 1e6 * s["step"]["seconds"] / s["step"]["calls"]
    return host_us / (launches / trace["scan_steps"])


def warmup_s(rec: dict):
    """The replay warm-up's share of set-up: the seconds of the scan steps
    the set-up ran before its first update."""
    record = rec.get("setup_spans")
    if not record:
        return None
    raw = record["raw"]
    first = min((start for name, _, start, _ in raw if name == "update"), default=None)
    steps = [(start, end) for name, _, start, end in raw if name == "step" and (first is None or end <= first)]
    if not steps:
        return None
    return sum(end - start for start, end in steps) / 1e9


READERS = {f.__name__: f for f in (replay_add_ms, feedback_ops, update_ops, host_us_per_launch, warmup_s)}


# -------------------------------------------------------------- one run
def run(cell: dict, seed: int, device) -> dict:
    """One run of ``cell`` with the program's spans: the recorded set-up,
    the harness's wrapped profiled window, the program-profiled window, the
    host-span window and a last chunk observed; then the reference's
    judgement. The five readings, the wrapped window's operations per call
    beside ``update_ops`` and ``feedback_ops``, what the spans cover of the
    host-span window, the idle share outside every span, and the cost of
    recording per scan step from :func:`span_cost_us`."""
    traffic = cell["traffic"]
    steps = traffic["profile_steps"]
    setup, setup_spans = recorded_set_up(cell, seed, device)
    wrapped = harness.profile_window(setup, steps)
    traced = program_profile_window(setup, steps)
    host = host_span_window(setup, steps)
    harness.observed_chunk(setup, traffic["chunk_steps"])
    records = {"setup_spans": setup_spans, "program_trace": traced, "host_spans": host}
    readings = {name: read(records) for name, read in READERS.items()}

    def per_call(name):
        under = wrapped["under"].get(name)
        return under["device_ops"] / under["calls"] if under and under["device_ops"] else None

    idle = dict(traced["idle_gaps_by_span"])
    seconds_per_step = host["window_s"] / steps
    covered = sum(s["self_seconds"] for s in host["spans"].values())
    per_span = span_cost_us()
    spans_per_step = sum(s["calls"] for s in host["spans"].values()) / steps
    numbers = harness.judge(cell, setup, device)
    checked = harness.checks(numbers, cell["limits"])
    return {
        "correct": harness.is_correct(checked),
        "readings": readings,
        "wrapped_ops_per_call": {"update": per_call("update"), "feedback": per_call("feedback")},
        "host_window": {"seconds_per_step": seconds_per_step, "covered": covered / host["window_s"],
                        "spans": host["spans"], "counters": host["counters"]},
        "program_trace": {k: traced[k] for k in ("device_ops", "busy_s", "window_s", "unattributed", "under",
                                                 "launches", "counters", "idle_gaps_by_span")},
        "outside_idle_share": idle.get(OUTSIDE, 0.0) / sum(idle.values()) if idle else None,
        "set_up": {k: v for k, v in setup_spans.items() if k != "raw"},
        "span_cost": {"span_us": per_span, "spans_per_step": spans_per_step,
                      "share_on": spans_per_step * per_span["on"] / 1e6 / seconds_per_step,
                      "share_off": spans_per_step * per_span["off"] / 1e6 / seconds_per_step},
        "checks": checked,
    }
