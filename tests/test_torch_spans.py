"""The runner's spans and counters (``pfrl_tpu_torch/utils/profiling.py``)
on the CPU: a small PER-DQN runner and a uniform one, driven past the replay
start with two updates per scan step and across two target syncs.

A recorded run equals an unrecorded one to the bit; with no recorder a
span is the shared null context and no ``record_function`` is entered;
calls and counters follow the runner's cadence; children nest inside their
parents; under the profiler each ``pfrl_tpu_torch.<name>`` range lies on
its recorded span (the shared host clock); ``profiling.trace`` carries the
ranges, also inside a recording; and a kernel's load is a span."""

import glob
import json
import threading
import types

import pytest
import torch

from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
from pfrl_tpu_torch.ops import cuda_build
from pfrl_tpu_torch.utils import profiling

torch.set_num_threads(1)

L = 4
SIZES = dict(num_envs=L, capacity=128, replay_start_size=12, update_interval=2, target_update_interval=16,
             minibatch_size=4, frame_shape=(36, 36, 4), device="cpu")
UPDATES_PER_STEP = L // SIZES["update_interval"]
STEPS = 8  # t = 4 .. 32: updates from the third step on, syncs at 16 and 32
UPDATING_STEPS = STEPS - SIZES["replay_start_size"] // L + 1
KINDS = ["per", "uniform"]


def _runner(kind):
    return make_dqn_runner(prioritized=kind == "per", double=kind == "per", **SIZES)


def _run(kind, steps=STEPS):
    runner = _runner(kind)
    state = runner.init(3)
    _, metrics = runner.run_chunk(state, steps)
    return runner, state, metrics


def _recorded(kind, ranges=False, steps=STEPS):
    with profiling.recording(ranges=ranges) as rec:
        runner, state, metrics = _run(kind, steps)
    return rec.summary(), (runner, state, metrics)


def _leaves(state):
    return list(profiling._tensors([state.env_states, state.obs, state.train_state, state.replay_state,
                                    state.episode_return, state.recent_returns, state.recent_count]))


@pytest.mark.parametrize("kind", KINDS)
def test_a_recording_changes_nothing(kind):
    _, (_, state, metrics) = _recorded(kind)
    _, plain, plain_metrics = _run(kind)
    assert state.t == plain.t
    a, b = _leaves(state), _leaves(plain)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(state.draws.generator.get_state(), plain.draws.generator.get_state())
    assert metrics.keys() == plain_metrics.keys()
    for k in metrics:
        assert torch.equal(metrics[k], plain_metrics[k]), k
    assert float(metrics["loss"][-1]) != 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_no_recorder_enters_no_range(kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no recorder installed")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling._Span, "__init__", refuse)
    assert profiling._recorder is None
    assert profiling.span("step") is profiling.span("update") is profiling._OFF
    profiling.count("updates")
    _, state, _ = _run(kind, 5)
    assert state.t == 5 * L and profiling._recorder is None


@pytest.mark.parametrize("kind", KINDS)
def test_calls_and_counters_follow_the_cadence(kind):
    summary, _ = _recorded(kind)
    calls = {name: s["calls"] for name, s in summary["spans"].items()}
    updates = UPDATES_PER_STEP * UPDATING_STEPS
    expected = {"init": 1, "step": STEPS, "act": STEPS, "env": STEPS, "add": STEPS, "returns": STEPS,
                "update": updates, "sync": 2, "gather": updates}
    if kind == "per":
        expected.update(sample=updates, draw=updates, feedback=updates)
    else:
        expected.update(sample=UPDATING_STEPS)  # one id draw per scan step
    assert calls == expected
    counters = {"updates": updates}
    if kind == "per":
        counters["feedbacks"] = updates
    assert summary["counters"] == counters

    raw = summary["raw"]
    parents = {"init": None, "step": None, "draw": "sample", "gather": "sample" if kind == "per" else "step"}
    for name, p, _, _ in raw:
        assert (raw[p][0] if p >= 0 else None) == parents.get(name, "step"), name


@pytest.mark.parametrize("kind", KINDS)
def test_a_parent_covers_its_children(kind):
    summary, _ = _recorded(kind)
    raw = summary["raw"]
    for name, p, start, end in raw:
        assert start <= end
        if p >= 0:
            _, _, p_start, p_end = raw[p]
            assert p_start <= start and end <= p_end, name
    for name, s in summary["spans"].items():
        assert 0 <= s["self_seconds"] <= s["seconds"], name
    steps = summary["spans"]["step"]
    inside = sum(end - start for _, p, start, end in raw if p >= 0 and raw[p][0] == "step") / 1e9
    assert steps["self_seconds"] == pytest.approx(steps["seconds"] - inside, abs=1e-6)


def test_ranges_lie_on_their_spans():
    """The recorder's clock is the profiler's: each range's interval is its
    span's within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        summary, _ = _recorded("per", ranges=True, steps=4)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.RANGE_PREFIX):
            ranges.setdefault(e.name()[len(profiling.RANGE_PREFIX):], []).append((e.start_ns(), e.end_ns()))
    spans = {}
    for name, _, start, end in summary["raw"]:
        spans.setdefault(name, []).append((start, end))
    assert set(ranges) == set(spans) >= {"init", "step", "act", "env", "add", "returns", "sample", "draw",
                                          "gather", "update", "feedback"}
    for name in spans:
        assert len(ranges[name]) == len(spans[name]), name
        for (r0, r1), (s0, s1) in zip(sorted(ranges[name]), sorted(spans[name])):
            assert abs(r0 - s0) < 1e6 and abs(r1 - s1) < 1e6, (name, r0 - s0, r1 - s1)


def test_trace_writes_the_runners_ranges(tmp_path):
    runner = _runner("per")
    state = runner.init(3)
    runner.run_chunk(state, 2)
    with profiling.trace(str(tmp_path)):
        runner.run_chunk(state, 2)
    assert profiling._recorder is None
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in ("step", "act", "env", "add", "returns", "sample", "draw", "gather", "update", "feedback"):
        assert profiling.RANGE_PREFIX + name in names, name


def test_one_recorder_on_one_thread():
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass

        def elsewhere():
            with profiling.span("other"):
                profiling.count("other")

        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("n", 3)
            profiling.count("n")
    assert profiling._recorder is None
    summary = rec.summary()
    assert set(summary["spans"]) == {"outer", "inner"} and summary["counters"] == {"n": 4}
    assert [(n, p) for n, p, _, _ in summary["raw"]] == [("outer", -1), ("inner", 0)]


def test_a_trace_inside_a_recording_uses_its_recorder(tmp_path):
    """``trace`` inside a ``recording`` opens that recorder's ranges for its
    block, then leaves the recorder as it was; the spans stay recorded."""
    runner = _runner("per")
    state = runner.init(3)
    with profiling.recording() as rec:
        runner.run_chunk(state, 1)
        with profiling.trace(str(tmp_path)):
            assert profiling._recorder is rec and rec.ranges
            runner.run_chunk(state, 1)
        assert not rec.ranges
        runner.run_chunk(state, 1)
    assert profiling._recorder is None
    assert rec.summary()["spans"]["step"]["calls"] == 3
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        steps = [e for e in json.load(f)["traceEvents"] if e.get("name") == profiling.RANGE_PREFIX + "step"]
    assert len(steps) == 1


def test_a_kernel_load_is_a_span(monkeypatch):
    """``load`` is the span ``kernel_load``; a library already loaded opens
    none. A stand-in build and loader take the compiler's place."""
    monkeypatch.setattr(cuda_build, "build", lambda names: {n: f"lib{n}.so" for n in names})
    monkeypatch.setattr(cuda_build, "ctypes", types.SimpleNamespace(CDLL=lambda path: ("loaded", path)))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with profiling.recording() as rec:
        assert cuda_build.load("stand_in") == ("loaded", "libstand_in.so")
        cuda_build.load("stand_in")
    summary = rec.summary()
    assert set(summary["spans"]) == {"kernel_load"} and summary["spans"]["kernel_load"]["calls"] == 1
