"""One run of one cell: set-up, the measured window, the traced windows, and
the comparison with the reference that decides ``correct``.

Set-up builds the program's runner from the cell's configuration and
traffic files, makes the weights (one normal draw on the device) and the
draw source (a generator on the device, which keeps every draw) from the
seed, hands both to the runner (``OffPolicyRunner.init(seed, draws)``, the
weights copied into the online and target networks), drives ``run_chunk``
to the replay start, observes the first scan step that updates, and runs
``warm_steps`` more. Then the window: ``run_chunk`` in chunks of
``chunk_steps`` for ``seconds`` of host clock, with one synchronization
before and one after; its last chunk is observed.

To observe a chunk is to read the program's state, never to replace its
methods: before each of the chunk's draws (the draw source is the
benchmark's, and the port documents the order of its draws) and after the
chunk, the parameters, the target network, RMSprop's moments and the
trees; after the run, the ring. The reference judges what it read
(``reference/follow.py``).

The traced run (``trace=True``) puts two windows in place of the measured
one: ``profile_steps`` scan steps under ``torch.profiler`` with each of the
``spans/`` files' methods in a ``record_function`` range and no
synchronization, then ``seconds`` of scan steps with each of those methods
in a synchronized span, and a last chunk observed. The per-layer metrics'
readers take their numbers from these records.
"""

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import devtrace
from portbench.reference.draws import DrawMismatch, LoggedDraws, ReplayedDraws
from portbench.reference.follow import ROW_FIELDS, Chunk, Follower, Observation, Snap, first_update_step
from portbench.reference.nature_q import make_weights, param_spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ----------------------------------------------------------------- the files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the per-layer metrics that list it."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "name": name,
        "chips": cell["chips"],
        "config": load_json(root / config["file"]),
        "traffic": load_json(root / HERE.name / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / HERE.name / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read(records)``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def span_files() -> Dict[str, dict]:
    return {p.stem: load_json(p) for p in sorted((HERE / "spans").glob("*.json"))}


# ------------------------------------------------------------------ program
def build_runner(cfg: dict, traffic: dict, device):
    """The configuration's runner, built by the program's own recipe."""
    module, fn = cfg["builder"].split(":")
    build = dict(cfg["build"], frame_shape=tuple(cfg["build"]["frame_shape"]))
    return getattr(importlib.import_module(module), fn)(
        num_envs=traffic["num_envs"],
        minibatch_size=traffic["minibatch_size"],
        update_interval=traffic["update_interval"],
        device=device,
        **build,
    )


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of a run's streams (0: the weights,
    1: the draws), from a seed of any size."""
    return torch.Generator(device=device).manual_seed((seed * 2 + stream) % (1 << 63))


def inputs(cfg: dict, seed: int, device):
    """The weights and the draw source a run hands to both sides."""
    build, net = cfg["build"], cfg["network"]
    spec = param_spec(build["n_actions"], build["frame_shape"], net["convs"], net["hidden"], net["torso_bias"])
    return make_weights(spec, seeded(seed, 0, device)), LoggedDraws(seeded(seed, 1, device))


def load_weights(train_state, weights: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for model in (train_state.model, train_state.target_model):
            named = dict(model.named_parameters())
            if set(named) != set(weights):
                raise ValueError(f"the program's parameters {sorted(named)} are not the reference's {sorted(weights)}")
            for name, p in named.items():
                p.copy_(weights[name])


class Patches:
    """Instance attributes set over an object's methods, and taken away (the
    traced run's spans)."""

    def __init__(self):
        self._undo: List[tuple] = []

    def set(self, obj, attr: str, fn) -> None:
        self._undo.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, fn)

    def undo(self) -> None:
        for obj, attr, own in reversed(self._undo):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._undo = []


def ring_of(replay_state):
    """The ring's own state (a prioritized state holds it as ``base``)."""
    return getattr(replay_state, "base", replay_state)


def read_state(state) -> Snap:
    """The program's state, copied on the device in stream order: the
    online and target parameters, the optimizer's moments (one per
    parameter, in order) and, with prioritized replay, the leaf priorities,
    ``max_priority`` and ``beta``."""
    train, replay = state.train_state, state.replay_state
    params = {n: p.detach().clone() for n, p in train.model.named_parameters()}
    snap = Snap(params=params,
                target={n: p.detach().clone() for n, p in train.target_model.named_parameters()},
                nu={n: v.clone() for n, v in zip(params, train.opt_state)})
    if hasattr(replay, "tree"):
        snap.leaves = replay.tree[replay.tree.shape[0] // 2:].clone()
        snap.max_priority = replay.max_priority.clone()
        snap.beta = replay.beta.clone()
    return snap


@dataclasses.dataclass
class Setup:
    runner: object
    state: object
    weights: Dict[str, torch.Tensor]
    draws: LoggedDraws
    traffic: dict
    chunks: List[Chunk]


def observed_chunk(setup: Setup, steps: int) -> dict:
    """``run_chunk(state, steps)``, the window's own call, with the
    program's state read before each of its draws and after it, and the ring
    rows it wrote; returns its metrics. Nothing of the program is replaced:
    the draw source is the benchmark's own."""
    runner, state, draws = setup.runner, setup.state, setup.draws
    L = runner.config.num_envs
    first_step = state.t // L
    snaps = {}
    draws.observer = lambda i: snaps.__setitem__(i, read_state(state))
    try:
        _, metrics = runner.run_chunk(state, steps)
    finally:
        draws.observer = None
    ring = ring_of(state.replay_state)
    capacity = ring.storage["action"].shape[0]
    slots = torch.arange(first_step * L, (first_step + steps) * L, device=ring.cursor.device) % capacity
    rows = {f: ring.storage[f][slots].clone() for f in ROW_FIELDS}
    setup.chunks.append(Chunk(first_step, steps, snaps, read_state(state), metrics["loss"].clone(), rows,
                              ring.storage["action"].clone()))
    return metrics


def set_up(cell: dict, seed: int, device, faults=()) -> Setup:
    """Builds the runner, hands it the seed's weights and draws, drives it
    to the replay start, observes the first step that updates, then runs
    ``warm_steps`` scan steps more. ``faults``: functions ``(runner) ->
    None`` that break the program before it runs (the faults' checks)."""
    cfg, traffic = cell["config"], cell["traffic"]
    runner = build_runner(cfg, traffic, device)
    for fault in faults:
        fault(runner)
    weights, draws = inputs(cfg, seed, runner.device)
    state = runner.init(seed % (1 << 63), draws)
    load_weights(state.train_state, weights)
    setup = Setup(runner, state, weights, draws, traffic, [])
    runner.run_chunk(state, first_update_step(cfg, traffic))
    observed_chunk(setup, 1)
    setup.chunks[-1] = setup.chunks[-1].to("cpu")  # synchronizes; off the card's peak
    runner.run_chunk(state, traffic["warm_steps"])
    return setup


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(setup: Setup, seconds: float) -> dict:
    """``run_chunk`` in chunks for ``seconds`` of host clock, synchronized
    only before and after. The chunk that the mean chunk so far says would
    end the window is the last, and is observed (:func:`observed_chunk`)."""
    runner, state = setup.runner, setup.state
    chunk = setup.traffic["chunk_steps"]
    synchronize(runner.device)
    t0 = time.perf_counter()
    steps, losses, issued = 0, [], []
    while True:
        last = bool(issued) and issued[-1] * (1 + 1 / len(issued)) >= seconds
        if last:
            metrics = observed_chunk(setup, chunk)
        else:
            _, metrics = runner.run_chunk(state, chunk)
        losses.append(metrics["loss"])
        steps += chunk
        issued.append(time.perf_counter() - t0)
        if last:
            break
    synchronize(runner.device)
    elapsed = time.perf_counter() - t0
    losses = torch.cat(losses)
    return {"scan_steps": steps, "seconds": elapsed, "failed": int((~torch.isfinite(losses)).sum()),
            "issued_s": issued}


def _wrapped_spans(runner, make: Callable[[str, Callable], Callable]) -> Patches:
    owners = {"core": runner.core, "env": runner.env, "buffer": runner.buffer, "runner": runner}
    patches = Patches()
    for name, span in span_files().items():
        owner = owners[span["owner"]]
        fn = getattr(owner, span["method"], None)
        if fn is not None:
            patches.set(owner, span["method"], make(name, fn))
    return patches


def profile_window(setup: Setup, steps: int) -> dict:
    """``steps`` scan steps under the profiler, each span's method in a
    ``record_function`` range, with no synchronization inside."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def inner(*args, **kwargs):
            with record_function(devtrace.RANGE_PREFIX + name):
                return fn(*args, **kwargs)
        return inner

    runner = setup.runner
    patches = _wrapped_spans(runner, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            synchronize(runner.device)
            t0 = time.perf_counter()
            runner.run_chunk(setup.state, steps)
            synchronize(runner.device)
            window_s = time.perf_counter() - t0
    finally:
        patches.undo()
    summary = devtrace.summarize(*devtrace.events_of(prof), window_s)
    summary["scan_steps"] = steps
    return summary


def span_window(setup: Setup, seconds: float) -> dict:
    """Scan steps for ``seconds`` with each span's method synchronized and
    timed, then a last chunk observed as the window's is; seconds and calls
    per span."""
    runner = setup.runner
    spans = {}

    def timed(name, fn):
        spans[name] = {"seconds": 0.0, "calls": 0}

        def inner(*args, **kwargs):
            synchronize(runner.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            synchronize(runner.device)
            spans[name]["seconds"] += time.perf_counter() - t0
            spans[name]["calls"] += 1
            return out
        return inner

    patches = _wrapped_spans(runner, timed)
    try:
        t0 = time.perf_counter()
        steps, losses = 0, []
        while time.perf_counter() - t0 < seconds:
            _, metrics = runner.run_chunk(setup.state, 1)
            losses.append(metrics["loss"])
            steps += 1
    finally:
        patches.undo()
    losses.append(observed_chunk(setup, setup.traffic["chunk_steps"])["loss"])
    steps += setup.traffic["chunk_steps"]
    return {"spans": spans, "scan_steps": steps, "failed": int((~torch.isfinite(torch.cat(losses))).sum())}


# -------------------------------------------------------------- correctness
def judge(cell: dict, setup: Setup, device) -> dict:
    """The reference's numbers on a run: the draws replayed and the ring
    read while the program's state is alive, then, with it freed, every
    observed update judged. A draw asked for out of turn, or a state that
    cannot be read, reads ``inf`` in ``draw_mismatch``."""
    follower = Follower(cell["config"], cell["traffic"], setup.weights, device)
    L = cell["traffic"]["num_envs"]
    try:
        follower.replay(ReplayedDraws(setup.draws.log), setup.state.t // L)
        ring = ring_of(setup.state.replay_state)
        follower.check_ring(ring.storage, int(ring.cursor))
    except UNREADABLE as e:
        free(setup)
        return {"draw_mismatch": math.inf, "error": f"{type(e).__name__}: {e}"}
    observation = Observation(setup.state.t // L, setup.chunks)
    free(setup)
    return _judged(follower, observation)


UNREADABLE = (DrawMismatch, IndexError, KeyError, TypeError, AttributeError, RuntimeError, ValueError)


def _judged(follower: Follower, observation: Observation) -> dict:
    try:
        numbers = follower.judge(observation)
    except UNREADABLE as e:
        return {"draw_mismatch": math.inf, "error": f"{type(e).__name__}: {e}"}
    return numbers


def control_numbers(cell: dict, seed: int, device) -> dict:
    """The control: the reference in the program's place, in TF32, from the
    seed through the first update step, judged as a run is."""
    weights, draws = inputs(cell["config"], seed, device)
    observation, ring = Follower(cell["config"], cell["traffic"], weights, device, tf32=True).simulate(draws)
    follower = Follower(cell["config"], cell["traffic"], weights, device)
    follower.replay(ReplayedDraws(draws.log), observation.steps)
    follower.check_ring(ring, observation.steps * cell["traffic"]["num_envs"])
    return _judged(follower, observation)


def checks(numbers: dict, limits: dict) -> Dict[str, list]:
    """Each compared number beside its limit; a number that is missing or
    not finite reads ``None`` (JSON has no infinity) and fails."""
    def finite(v):
        return v if isinstance(v, (int, float)) and math.isfinite(v) else None

    return {name: [finite(numbers.get(name)), limit] for name, limit in limits.items()}


def is_correct(checked: Dict[str, list]) -> bool:
    return all(v is not None and v <= limit for v, limit in checked.values())


def free(setup: Setup) -> None:
    """Drops the program's state, so that the reference runs in the memory
    it gave back."""
    setup.runner = setup.state = None
    setup.chunks = [c.to("cpu") for c in setup.chunks]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
