"""Where the host-env object path's time goes: a shell driven one batch
step at a time, ``dqn-batch-ale-8`` (``experiments/atari_dqn_batch.py``,
``train_dqn_batch_ale.py``'s ``run_batch``) and the paths of
:data:`HOST_PATHS`.

:func:`run_host_batch` drives a shell through
``train_agent_batch_with_evaluation`` (a vector env) or
``train_agent_with_evaluation`` (a single env) and times, each call between
two synchronizations of the card: ``batch_act`` (observations up, the
forward, actions down), the env's ``step`` (the pipe round trip to the
workers, or a host simulator's step), ``batch_observe`` (the ring add or
the rollout row, and from the learning start its updates) and each update
(``_update_once``: an off-policy shell's sample, gradient step and the host
read of the loss; an on-policy shell's whole update over its rollout). It
marks every observe's ``t`` and update count, so it gives env-steps/s
before and after the learning start (the replay start, or an on-policy
shell's first full rollout) and updates/s, counts the ``sync_target``
calls, and records a window of batch steps under ``torch.profiler``:
kernels per batch step and per update and the device's busy share of that
window's wall time. The profiler's start and stop take seconds, so the
rates after the learning start, and the ms per batch step of each call,
are taken from the first batch step after that window on; the
synchronizing timers are in every rate.

:func:`count_host_ops` counts the aten ops of one ``batch_act``, one
``batch_observe`` without an update and one update (``count_ops.py``'s
counter), on observations made on the host, spawning no worker.

:data:`HOST_PATHS` holds the host paths of the MuJoCo reproduction
examples (``experiments/mujoco_host.py``, over ``MujocoSim`` at HalfCheetah's
and Hopper's sizes on the CPU) and of SlimeVolley Rainbow on its CartPole
backend (``experiments/slimevolley_rainbow.py``), at their scripts'
settings, each with the length that ``chip_smoke.py`` runs.
``profile_slice --config C`` and ``count_ops --config C`` run these for
``dqn-batch-ale-8`` and each path; ``chip_smoke.py`` runs them uncut.

One path of :data:`HOST_PATHS` has actor threads: ``dqn-actor-learner-ale-8``,
``train_dqn_batch_ale.py --actor-learner`` (``atari_dqn_batch.run_actor_learner``:
8 actor threads of one ``SyntheticALE`` lane, the inference server, the
poller and the learner over the 10^6-slot ring). :func:`run_actor_learner_path`
runs it with a step hook of the learner that starts and stops
``torch.profiler`` over a window of updates, on the learner's thread (a
profiler started from a thread that launches no kernel saw none of the
other threads' kernels on the card; started from the learner's, it holds
the other threads' card calls back, so the window counts the learner's
kernels alone, and the rates are taken outside it). It
marks every actor step's global ``t`` and the learner's update count, so
it gives env-steps/s before the replay start and after it (outside the
window, which slows the run), updates/s, the server's rows per forward and the act round trips (median
and p90; before the replay start, and after it apart by whether a learner
update ran during the act), the
poller's add and the learner's update ms, the publications and target
syncs, and kernels per update and the device's busy share over the
window. :func:`count_actor_learner_ops` counts the aten ops of one server
act of the padded batch, one poller add of a ring row and one update.
"""

import bisect
import collections
import dataclasses
import functools
import os
import statistics
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pfrl_tpu_torch.envs import synthetic_ale
from pfrl_tpu_torch.experiments import atari_dqn_batch, mujoco_host, slimevolley_rainbow
from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation


@dataclasses.dataclass(frozen=True)
class HostPath:
    """A host path: ``make_agent(**kw)`` (``device``, ``compute_dtype``,
    ``replay_start_size`` where the shell has one, ``update_burst``),
    ``make_env(seed)`` for one lane, the observation's size, the run's
    transitions and evaluation episodes, and the lanes of a
    ``SerialVectorEnv`` (1: a single env through the serial driver). A path
    with ``actors`` runs the actor-learner mode instead
    (:func:`run_actor_learner_path`): that many actor threads of one lane,
    ``make_env(idx, test)`` each, to ``steps`` transitions or ``n_updates``
    updates, whichever comes first."""

    make_agent: Callable
    make_env: Callable
    obs_size: int
    steps: int
    eval_n_episodes: int
    lanes: int = 1
    agent_kwargs: Tuple = ()
    actors: int = 0
    n_updates: Optional[int] = None


_CHEETAH, _HOPPER = mujoco_host.HALFCHEETAH, mujoco_host.HOPPER
HOST_PATHS = {
    # Through the replay start of 10,000 uncut to t = 11,000: 1,001 updates,
    # the truncation at step 1,000 crossed, then 2 evaluation episodes.
    "sac-halfcheetah-host-1": HostPath(functools.partial(mujoco_host.make_sac_agent, *_CHEETAH),
                                       mujoco_host.mujoco_sim_env(*_CHEETAH), 17, 11_000, 2),
    "td3-halfcheetah-host-1": HostPath(functools.partial(mujoco_host.make_td3_agent, *_CHEETAH),
                                       mujoco_host.mujoco_sim_env(*_CHEETAH), 17, 11_000, 2),
    "ddpg-halfcheetah-host-1": HostPath(functools.partial(mujoco_host.make_ddpg_agent, *_CHEETAH),
                                        mujoco_host.mujoco_sim_env(*_CHEETAH), 17, 11_000, 2),
    # --update-burst --num-envs 4: four updates per batch step, one burst.
    "td3-halfcheetah-host-4-burst": HostPath(functools.partial(mujoco_host.make_td3_agent, *_CHEETAH),
                                             mujoco_host.mujoco_sim_env(*_CHEETAH), 17, 11_000, 2, lanes=4,
                                             agent_kwargs=(("update_burst", True),)),
    # Three updates of 2,048 transitions (320 Adam steps each).
    "ppo-hopper-host-1": HostPath(functools.partial(mujoco_host.make_ppo_agent, *_HOPPER),
                                  mujoco_host.mujoco_sim_env(*_HOPPER), 11, 6_144, 2),
    # Two updates of 5,000 transitions.
    "trpo-hopper-host-1": HostPath(functools.partial(mujoco_host.make_trpo_agent, *_HOPPER),
                                   mujoco_host.mujoco_sim_env(*_HOPPER), 11, 10_000, 2),
    # The replay start of 1,600 uncut to t = 2,600: 1,001 updates through the
    # C = 2^20 ring, the target sync at 2,000 crossed; 10 evaluation episodes.
    "rainbow-slimevolley-cartpole-1": HostPath(functools.partial(slimevolley_rainbow.make_rainbow_agent, 4, 2),
                                               slimevolley_rainbow.cartpole_env, 4, 2_600, 10),
    # train_dqn_batch_ale.py --actor-learner: 8 actor threads through the
    # replay start of 50,000 uncut; the learner updates flat out, so the run
    # ends on its 640th update (past t = 52,032 at any learner rate up to
    # 4 updates per transition), or at 10^6 transitions.
    "dqn-actor-learner-ale-8": HostPath(atari_dqn_batch.make_dqn_batch_agent,
                                        functools.partial(synthetic_ale.make_ale_env, 0), 84 * 84 * 4, 10**6, 10,
                                        lanes=8, actors=8, n_updates=640),
}


def make_host_path(name: str, device=None, compute_dtype=None, **agent_kwargs):
    """``(agent, env, eval_env)`` of ``HOST_PATHS[name]`` on ``device``."""
    from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv

    path = HOST_PATHS[name]
    if path.actors:
        raise ValueError(f"{name} runs actor threads: run it with run_actor_learner_path")
    agent = path.make_agent(device=device, compute_dtype=compute_dtype, **dict(path.agent_kwargs), **agent_kwargs)
    if path.lanes == 1:
        return agent, path.make_env(0), path.make_env(100)
    envs = [SerialVectorEnv([path.make_env(seed + i) for i in range(path.lanes)]) for seed in (0, 100)]
    return agent, envs[0], envs[1]


def learning_start(agent) -> int:
    """The first ``t`` at which ``agent`` updates: its replay start, or an
    on-policy shell's first full rollout."""
    return getattr(agent, "replay_start_size", None) or agent.update_interval


def storage_bytes(agent) -> int:
    """The bytes of a shell's replay ring, or of an on-policy shell's rollout."""
    if getattr(agent, "replay_state", None) is not None:
        storage = getattr(agent.replay_state, "base", agent.replay_state).storage
        return sum(x.numel() * x.element_size() for x in storage.values())
    rollout = getattr(agent, "_rollout", None)
    if rollout is None:
        return 0
    return sum(x.numel() * x.element_size() for x in vars(rollout).values() if isinstance(x, torch.Tensor))


def _stats(calls, lo: int, batch_steps_after: int) -> dict:
    """Median, p90 and mean ms of ``calls`` (``(t, ms)`` pairs), and their
    ms per batch step from ``t = lo`` on."""
    ms = [m for _, m in calls]
    if not ms:
        return {"n": 0}
    ordered = sorted(ms)
    after = sum(m for t, m in calls if t >= lo)
    return {"n": len(ms), "median_ms": statistics.median(ms), "p90_ms": ordered[int(0.9 * (len(ms) - 1))],
            "mean_ms": sum(ms) / len(ms), "total_s": sum(ms) / 1e3,
            "ms_per_batch_step_after_replay_start": after / batch_steps_after if batch_steps_after else None}


def _rate(marks, lo: int, hi: int) -> Tuple[Optional[float], int, float]:
    """Transitions per second between the first mark ``(t, seconds, ...)``
    at or past ``lo`` and the last at or before ``hi``, with the transitions
    and seconds."""
    inside = [m[:2] for m in marks if lo <= m[0] <= hi]
    if len(inside) < 2:
        return None, 0, 0.0
    (t0, s0), (t1, s1) = inside[0], inside[-1]
    return (t1 - t0) / (s1 - s0), t1 - t0, s1 - s0


def run_host_batch(agent, env, eval_env, steps: int, eval_interval: int, eval_n_episodes: int, outdir: str,
                   profiled: Tuple[int, int] = (0, 0)) -> dict:
    """Trains ``agent`` for ``steps`` transitions over ``env`` with an
    evaluation every ``eval_interval``; ``profiled = (t, n)`` records ``n``
    batch steps under the profiler from the first observe at or past ``t``
    (on the card only). The driver saves the agent into ``outdir`` (the
    best and the finished one). Returns the record (see the module
    docstring)."""
    cuda = agent.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    lanes = getattr(env, "num_envs", 1)
    ms = collections.defaultdict(list)
    marks, syncs, updates, window = [], [0], [0], {}

    def timed(label, fn, training_only=False):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            if agent.training or not training_only:
                ms[label].append((agent.t, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    def observe(*args, **kwargs):
        before, t = updates[0], agent.t
        sync()
        t0 = time.perf_counter()
        batch_observe(*args, **kwargs)
        sync()
        now = time.perf_counter()
        if agent.training:
            ms["batch_observe with updates" if updates[0] > before else "batch_observe (ring add)"].append(
                (t, (now - t0) * 1e3))
            marks.append((agent.t, now, updates[0]))

    def update_once(update_once=agent._update_once):
        updates[0] += 1
        return update_once()

    def sync_target(state, sync_target=getattr(agent.core, "sync_target", None)):
        syncs[0] += 1
        return sync_target(state)

    # The card's activity only: recording every thread's CPU ops slowed the
    # run for good after the window.
    prof = profile(activities=[ProfilerActivity.CUDA]) if cuda and profiled[1] else None

    def profile_hook(env, agent, t):
        if prof is None:
            return
        if "start_t" not in window and t >= profiled[0]:
            sync()
            prof.start()
            window.update(start_t=t, start_s=time.perf_counter(), start_updates=updates[0])
        elif "start_t" in window and "end_t" not in window and t >= window["start_t"] + profiled[1] * lanes:
            sync()
            window.update(end_t=t, end_s=time.perf_counter(), end_updates=updates[0])
            prof.stop()

    batch_observe = agent.batch_observe
    agent.batch_act = timed("batch_act", agent.batch_act, training_only=True)
    agent.batch_observe = observe
    agent._update_once = timed("update", update_once)
    if hasattr(agent.core, "sync_target"):  # on-policy cores have no target
        agent.core.sync_target = sync_target
    env.step = timed("env round trip" if lanes > 1 else "env step", env.step)
    driver = train_agent_batch_with_evaluation if hasattr(env, "num_envs") else train_agent_with_evaluation
    t0 = time.perf_counter()
    try:
        _, history = driver(
            agent=agent, env=env, eval_env=eval_env, steps=steps, eval_n_steps=None,
            eval_n_episodes=eval_n_episodes, eval_interval=eval_interval, outdir=outdir,
            step_hooks=[profile_hook],
        )
    finally:
        for obj, attr in ((agent, "batch_act"), (agent, "batch_observe"), (agent, "_update_once"),
                          (agent.core, "sync_target"), (env, "step")):
            vars(obj).pop(attr, None)
    wall_s = time.perf_counter() - t0
    start = learning_start(agent)
    acting, acted, acting_s = _rate(marks, 0, start)
    # The profiler's start and stop take seconds: the rates after the
    # learning start are taken from the first batch step after its window.
    lo = window["end_t"] + lanes if "end_t" in window else start
    learning, learned, learning_s = _rate(marks, lo, steps)
    inside = [m for m in marks if lo <= m[0] <= steps]
    learned_updates = inside[-1][2] - inside[0][2] if len(inside) >= 2 else 0
    steps_after = learned // lanes
    record = {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "lanes": lanes, "steps": steps, "t": agent.t, "replay_start_size": start,
        "n_updates": updates[0], "target_syncs": syncs[0], "wall_s": wall_s,
        "worker_startup_s": {"train": getattr(env, "startup_s", None), "eval": getattr(eval_env, "startup_s", None)},
        "ring_bytes": storage_bytes(agent),
        "ring_slots": getattr(getattr(agent, "buffer", None), "capacity", None),
        "env_steps_per_s_before_replay_start": acting, "acting_transitions": acted, "acting_s": acting_s,
        "env_steps_per_s_after_replay_start": learning, "learning_from_t": lo, "learning_transitions": learned,
        "learning_s": learning_s,
        "updates_per_s_after_replay_start": learned_updates / learning_s if learning_s else None,
        "batch_step_ms_after_replay_start": learning_s / steps_after * 1e3 if steps_after else None,
        "timings": {label: _stats(v, lo, steps_after) for label, v in ms.items()},
        "eval": [{"step": h["step"], "mean": h["eval_score"]} for h in history],
        "statistics": dict(agent.get_statistics()),
        "scores_txt": open(os.path.join(outdir, "scores.txt")).read().splitlines(),
    }
    if prof is not None and "end_t" in window:
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        batch_steps = (window["end_t"] - window["start_t"]) // lanes
        window_updates = window["end_updates"] - window["start_updates"]
        seconds = window["end_s"] - window["start_s"]
        by_name = collections.defaultdict(float)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
        record["profiled"] = {
            "from_t": window["start_t"], "batch_steps": batch_steps, "updates": window_updates, "seconds": seconds,
            "kernels_per_batch_step": len(kernels) / batch_steps,
            "kernels_per_update": len(kernels) / window_updates if window_updates else None,
            "device_busy_ms_per_batch_step": busy_us / 1e3 / batch_steps,
            "device_busy_share": busy_us / 1e6 / seconds,
            "top_device_ops": [{"name": n, "ms_per_batch_step": us / 1e3 / batch_steps}
                               for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
        }
    return record


def _overlaps(spans, starts, a: float, b: float) -> bool:
    """Whether ``[a, b]`` overlaps one of ``spans``: sorted, disjoint
    ``(start, end)`` pairs with their ``starts``."""
    i = bisect.bisect_right(starts, b)
    return i > 0 and spans[i - 1][1] >= a


def run_actor_learner_path(agent, make_env, steps: int, eval_interval: int, eval_n_episodes: int, outdir: str,
                           actors: int = 8, n_updates: Optional[int] = None,
                           profiled: Tuple[int, int] = (0, 0)) -> dict:
    """Runs ``atari_dqn_batch.run_actor_learner`` with ``agent`` and
    ``actors`` actor threads of ``make_env(idx, test)``, to ``steps``
    transitions or ``n_updates`` updates; ``profiled = (u, n)`` records the
    updates ``u`` to ``u + n`` under the profiler (on the card only).
    Raises what the run raised. Returns the record (see the module
    docstring)."""
    cuda = agent.device.type == "cuda"
    marks, syncs, window = [], [0], {}
    start = agent.replay_start_size

    def mark(env, actor, t):
        marks.append((t, time.perf_counter(), agent.optim_t))

    sync_target = agent.core.sync_target

    def counted_sync(state):
        syncs[0] += 1
        return sync_target(state)

    # The card's activity only: recording every thread's CPU ops slowed the
    # run for good after the window.
    prof = profile(activities=[ProfilerActivity.CUDA]) if cuda and profiled[1] else None

    def profile_window(_, learner, t):
        """On the learner's thread, after its updates ``u`` and ``u + n``."""
        key = {profiled[0]: "start", profiled[0] + profiled[1]: "end"}.get(learner.optim_t)
        if prof is not None and key is not None:
            torch.cuda.synchronize()
            window[key] = (time.perf_counter(), learner.optim_t, learner.cumulative_steps)
            (prof.start if key == "start" else prof.stop)()

    agent.core.sync_target = counted_sync
    t0 = time.perf_counter()
    try:
        atari_dqn_batch.run_actor_learner(outdir, steps=steps, eval_interval=eval_interval,
                                          eval_n_episodes=eval_n_episodes, num_envs=actors, agent=agent,
                                          global_step_hooks=[mark], learner_step_hooks=[profile_window],
                                          n_updates=n_updates)
    finally:
        del agent.core.sync_target
        if "start" in window and "end" not in window:
            prof.stop()
    wall_s = time.perf_counter() - t0
    acting = [m for m in marks if m[2] == 0]
    learning = [m for m in marks if m[2] > 0]
    if "end" in window:  # the longer stretch of updates before or after the profiled window
        before = [m for m in learning if m[1] <= window["start"][0]]
        after = [m for m in learning if m[1] >= window["end"][0]]
        span = lambda ms: ms[-1][1] - ms[0][1] if len(ms) > 1 else 0.0  # noqa: E731
        learning = before if span(before) > span(after) else after

    def rate(ms):
        if len(ms) < 2:
            return None, None, 0.0
        (t_a, s_a, u_a), (t_b, s_b, u_b) = ms[0], ms[-1]
        return (t_b - t_a) / (s_b - s_a), (u_b - u_a) / (s_b - s_a), s_b - s_a

    server = agent._inference
    spans = sorted(agent.update_spans)
    span_starts = [a for a, _ in spans]
    first_update = spans[0][0] if spans else float("inf")
    trips = {"all": [], "before the replay start": [], "during an update": [], "between updates": []}
    for a, b in server.round_trips:
        trips["all"].append((0, (b - a) * 1e3))
        if b < first_update:
            label = "before the replay start"
        else:
            label = "during an update" if _overlaps(spans, span_starts, a, b) else "between updates"
        trips[label].append((0, (b - a) * 1e3))
    before, _, before_s = rate(acting)
    after, updates_per_s, after_s = rate(learning)
    record = {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "actors": actors, "steps": steps, "n_updates_limit": n_updates, "t": agent.cumulative_steps,
        "replay_start_size": start, "n_updates": agent.optim_t, "publications": agent.update_counter.value,
        "target_syncs": syncs[0], "wall_s": wall_s, "ring_bytes": storage_bytes(agent),
        "ring_slots": agent.buffer.capacity,
        "env_steps_per_s_before_replay_start": before, "acting_s": before_s,
        "env_steps_per_s_after_replay_start": after, "updates_per_s_after_replay_start": updates_per_s,
        "learning_s": after_s, "learning_from_update": learning[0][2] if learning else None,
        "learning_to_update": learning[-1][2] if learning else None,
        "rows_per_forward": sum(server.batch_rows) / len(server.batch_rows) if server.batch_rows else None,
        "forwards": len(server.batch_rows),
        "timings": {
            **{f"act round trip ({k})": _stats(v, 0, 0) for k, v in trips.items()},
            "poller add": _stats([(0, (b - a) * 1e3) for a, b in agent.add_spans], 0, 0),
            "learner update": _stats([(0, (b - a) * 1e3) for a, b in agent.update_spans], 0, 0),
        },
        "statistics": dict(agent.get_statistics()),
        "scores_txt": open(os.path.join(outdir, "scores.txt")).read().splitlines(),
    }
    if prof is not None and "end" in window:
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        (s_a, u_a, t_a), (s_b, u_b, t_b) = window["start"], window["end"]
        by_name = collections.defaultdict(float)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
        record["profiled"] = {
            "from_update": u_a, "updates": u_b - u_a, "env_steps": t_b - t_a, "seconds": s_b - s_a,
            "kernels_per_update": len(kernels) / (u_b - u_a) if u_b > u_a else None,
            "kernels_per_env_step": len(kernels) / (t_b - t_a) if t_b > t_a else None,
            "device_busy_share": busy_us / 1e6 / (s_b - s_a),
            "top_device_ops": [{"name": n, "ms": us / 1e3}
                               for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
        }
    return record


def count_actor_learner_ops(agent, actors: int = 8, rows: int = 16) -> dict:
    """Aten ops of one server act (the padded batch of ``actors`` rows), one
    poller add of a ring row and one update of ``agent``'s actor-learner
    mode, after ``rows`` rows of uint8 frames made on the host; the server
    and the threads are not started."""
    from pfrl_tpu_torch.experiments.count_ops import OpCounter

    rs = np.random.RandomState(0)
    agent.setup_actor_learner_training(n_actors=actors)
    agent._inference.stop()

    def row():
        return [dict(obs=_atari_frames(rs, 1)[0], action=np.int64(0), reward=np.float32(0.0),
                     next_obs=_atari_frames(rs, 1)[0], terminated=False, done=False) for _ in range(actors)]

    def add():
        transition = agent._rows_to_transition(row())
        if agent.replay_state is None:
            agent._init_ring(transition, actors)
        agent.replay_state = agent.buffer.add(agent.replay_state, transition)

    batch = _atari_frames(rs, actors)
    agent._actor_act_fn(1, batch, 0, True)
    for _ in range(rows):
        add()
    counts = {}
    for name, fn in (("act", lambda: agent._actor_act_fn(2, batch, 0, True)), ("add", add),
                     ("update", agent._update_once)):
        with OpCounter() as counter:
            fn()
        counts[name] = counter.counts
    return {
        "actors": actors,
        **{f"ops_per_{name}": sum(c.values()) for name, c in counts.items()},
        "top_ops_per_update": dict(counts["update"].most_common(10)),
    }


def _atari_frames(rs, lanes):
    return rs.randint(0, 256, (lanes, 84, 84, 4)).astype(np.uint8)


def count_host_ops(agent, batch_steps: int = 16, lanes: Optional[int] = None, obs: Callable = _atari_frames) -> dict:
    """Aten ops of one ``batch_act``, one ``batch_observe`` without an
    update and one update of ``agent`` (an on-policy shell's update over
    its rollout), after ``batch_steps`` batch steps of ``obs(rs, lanes)``
    observations made on the host (default: uint8 frames, and the ring's
    lanes) fill its ring or rollout; per env step at the shell's cadence
    (``n_times_update`` updates per ``update_interval`` transitions)."""
    from pfrl_tpu_torch.experiments.count_ops import OpCounter

    lanes = lanes or agent.buffer.num_lanes
    rs = np.random.RandomState(0)
    agent.replay_start_size = 10**12  # the counted steps update only when asked
    flags = np.zeros(lanes, bool)
    for _ in range(batch_steps):
        agent.batch_act(obs(rs, lanes))
        agent.batch_observe(obs(rs, lanes), np.zeros(lanes, np.float32), flags, flags)
    counts = {}
    batch = obs(rs, lanes)
    for name, fn in (("batch_act", lambda: agent.batch_act(batch)),
                     ("batch_observe", lambda: agent.batch_observe(batch, np.zeros(lanes, np.float32), flags, flags)),
                     ("update", agent._update_once)):
        with OpCounter() as counter:
            fn()
        counts[name] = counter.counts
    transitions_per_update = agent.update_interval / getattr(agent, "n_times_update", 1)
    per_env_step = (sum(counts["batch_act"].values()) + sum(counts["batch_observe"].values())) / lanes \
        + sum(counts["update"].values()) / transitions_per_update
    return {
        "lanes": lanes,
        **{f"ops_per_{name}": sum(c.values()) for name, c in counts.items()},
        "ops_per_env_step": per_env_step,
        "top_ops_per_update": dict(counts["update"].most_common(10)),
    }


def count_host_path_ops(name: str, device=None, compute_dtype=None, capacity: Optional[int] = None) -> dict:
    """:func:`count_host_ops` of ``HOST_PATHS[name]``'s shell, on
    observations drawn from a normal. ``capacity`` cuts its ring, which
    changes no op of a uniform ring; a prioritized ring's add and feedback
    take a few ops per level of its tree."""
    path = HOST_PATHS[name]
    kw = {"capacity": capacity} if capacity and "capacity" in _keywords(path.make_agent) else {}
    agent = path.make_agent(device=device, compute_dtype=compute_dtype, **dict(path.agent_kwargs), **kw)
    if path.actors:
        return count_actor_learner_ops(agent, path.actors)
    size = path.obs_size
    return count_host_ops(agent, lanes=path.lanes,
                          obs=lambda rs, lanes: rs.normal(size=(lanes, size)).astype(np.float32))


def _keywords(fn) -> set:
    import inspect

    return set(inspect.signature(fn).parameters)
