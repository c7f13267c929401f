"""Where the host-env object path's time goes: ``dqn-batch-ale-8``
(``experiments/atari_dqn_batch.py``, ``train_dqn_batch_ale.py``'s
``run_batch``), one batch step at a time.

:func:`run_host_batch` drives a shell through
``train_agent_batch_with_evaluation`` and times, each call between two
synchronizations of the card: ``batch_act`` (observations up, the forward,
actions down), the vector env's ``step`` (the pipe round trip to the
workers), ``batch_observe`` (the ring add, and from the replay start its
updates) and each update (sample, gradient step, the host read of the
loss). It marks every observe's ``t``, so it gives env-steps/s before and
after the replay start and updates/s, counts the target syncs, and records
a window of batch steps under ``torch.profiler``: kernels per batch step
and the device's busy share of that window's wall time. The profiler's
start and stop take seconds, so the rates after the replay start, and the
ms per batch step of each call, are taken from the first batch step after
that window on; the synchronizing timers are in every rate.

:func:`count_host_ops` counts the aten ops of one ``batch_act``, one
``batch_observe`` without an update and one update (``count_ops.py``'s
counter), on observations made on the host, spawning no worker.

``profile_slice --config dqn-batch-ale-8`` and ``count_ops --config
dqn-batch-ale-8`` run these; ``chip_smoke.py`` runs the recipe uncut.
"""

import collections
import os
import statistics
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation


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
    """Transitions per second between the first mark at or past ``lo`` and
    the last at or before ``hi``, with the transitions and seconds."""
    inside = [(t, s) for t, s in marks if lo <= t <= hi]
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
    best and the finished one: 27 MB each at full width). Returns the
    record (see the module docstring)."""
    cuda = agent.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ms = collections.defaultdict(list)
    marks, syncs, window = [], [0], {}

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
        before, t = agent.optim_t, agent.t
        sync()
        t0 = time.perf_counter()
        batch_observe(*args, **kwargs)
        sync()
        now = time.perf_counter()
        if agent.training:
            ms["batch_observe with updates" if agent.optim_t > before else "batch_observe (ring add)"].append(
                (t, (now - t0) * 1e3))
            marks.append((agent.t, now))

    def sync_target(state, sync_target=agent.core.sync_target):
        syncs[0] += 1
        return sync_target(state)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if cuda and profiled[1] else None

    def profile_hook(env, agent, t):
        if prof is None:
            return
        if "start_t" not in window and t >= profiled[0]:
            sync()
            prof.start()
            window.update(start_t=t, start_s=time.perf_counter())
        elif "start_t" in window and "end_t" not in window and t >= window["start_t"] + profiled[1] * env.num_envs:
            sync()
            window.update(end_t=t, end_s=time.perf_counter())
            prof.stop()

    batch_observe = agent.batch_observe
    agent.batch_act = timed("batch_act", agent.batch_act, training_only=True)
    agent.batch_observe = observe
    agent._update_once = timed("update", agent._update_once)
    agent.core.sync_target = sync_target
    env.step = timed("env round trip", env.step)
    t0 = time.perf_counter()
    try:
        _, history = train_agent_batch_with_evaluation(
            agent=agent, env=env, eval_env=eval_env, steps=steps, eval_n_steps=None,
            eval_n_episodes=eval_n_episodes, eval_interval=eval_interval, outdir=outdir,
            step_hooks=[profile_hook],
        )
    finally:
        for obj, attr in ((agent, "batch_act"), (agent, "batch_observe"), (agent, "_update_once"),
                          (agent.core, "sync_target"), (env, "step")):
            vars(obj).pop(attr, None)
    wall_s = time.perf_counter() - t0
    start = agent.replay_start_size
    acting, acted, acting_s = _rate(marks, 0, start)
    # The profiler's start and stop take seconds: the rates after the replay
    # start are taken from the first batch step after its window.
    lo = window["end_t"] + env.num_envs if "end_t" in window else start
    learning, learned, learning_s = _rate(marks, lo, steps)
    storage = getattr(agent.replay_state, "base", agent.replay_state).storage
    steps_after = learned // env.num_envs
    record = {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "lanes": env.num_envs, "steps": steps, "t": agent.t, "replay_start_size": start,
        "n_updates": agent.optim_t, "target_syncs": syncs[0], "wall_s": wall_s,
        "worker_startup_s": {"train": getattr(env, "startup_s", None), "eval": getattr(eval_env, "startup_s", None)},
        "ring_bytes": sum(x.numel() * x.element_size() for x in storage.values()),
        "ring_slots": agent.buffer.capacity,
        "env_steps_per_s_before_replay_start": acting, "acting_transitions": acted, "acting_s": acting_s,
        "env_steps_per_s_after_replay_start": learning, "learning_from_t": lo, "learning_transitions": learned,
        "learning_s": learning_s,
        "updates_per_s_after_replay_start": learned / agent.update_interval / learning_s if learning_s else None,
        "batch_step_ms_after_replay_start": learning_s / steps_after * 1e3 if steps_after else None,
        "timings": {label: _stats(v, lo, steps_after) for label, v in ms.items()},
        "eval": [{"step": h["step"], "mean": h["eval_score"]} for h in history],
        "statistics": dict(agent.get_statistics()),
        "scores_txt": open(os.path.join(outdir, "scores.txt")).read().splitlines(),
    }
    if prof is not None and "end_t" in window:
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        batch_steps = (window["end_t"] - window["start_t"]) // env.num_envs
        seconds = window["end_s"] - window["start_s"]
        by_name = collections.defaultdict(float)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
        record["profiled"] = {
            "from_t": window["start_t"], "batch_steps": batch_steps, "seconds": seconds,
            "kernels_per_batch_step": len(kernels) / batch_steps,
            "device_busy_ms_per_batch_step": busy_us / 1e3 / batch_steps,
            "device_busy_share": busy_us / 1e6 / seconds,
            "top_device_ops": [{"name": n, "ms_per_batch_step": us / 1e3 / batch_steps}
                               for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
        }
    return record


def count_host_ops(agent, batch_steps: int = 16) -> dict:
    """Aten ops of one ``batch_act``, one ``batch_observe`` without an
    update and one update of ``agent``, after ``batch_steps`` batch steps
    of uint8 frames made on the host fill its ring; per env step at the
    shell's cadence (one update per ``update_interval`` transitions)."""
    from pfrl_tpu_torch.experiments.count_ops import OpCounter

    lanes = agent.buffer.num_lanes
    rs = np.random.RandomState(0)
    agent.replay_start_size = 10**12  # the counted steps update only when asked
    obs = lambda: rs.randint(0, 256, (lanes, 84, 84, 4)).astype(np.uint8)  # noqa: E731
    flags = np.zeros(lanes, bool)
    for _ in range(batch_steps):
        agent.batch_act(obs())
        agent.batch_observe(obs(), np.zeros(lanes, np.float32), flags, flags)
    counts = {}
    frames = obs()
    for name, fn in (("batch_act", lambda: agent.batch_act(frames)),
                     ("batch_observe", lambda: agent.batch_observe(frames, np.zeros(lanes, np.float32), flags, flags)),
                     ("update", agent._update_once)):
        with OpCounter() as counter:
            fn()
        counts[name] = counter.counts
    per_env_step = (sum(counts["batch_act"].values()) + sum(counts["batch_observe"].values())) / lanes \
        + sum(counts["update"].values()) / agent.update_interval
    return {
        "lanes": lanes,
        **{f"ops_per_{name}": sum(c.values()) for name, c in counts.items()},
        "ops_per_env_step": per_env_step,
        "top_ops_per_update": dict(counts["update"].most_common(10)),
    }
