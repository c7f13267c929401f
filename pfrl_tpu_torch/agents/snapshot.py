"""Whole training-state snapshots for resumable runs (counterpart of
``pfrl_tpu/agents/snapshot.py``; reference parity: pfrl/agents/dqn.py:794-810,
save_snapshot/load_snapshot: the model and optimizer state, ``t`` and the
replay buffer).

A shell's snapshot is ``train_state.pt`` and ``replay_state.pt``
(:func:`~pfrl_tpu_torch.replay.persistent.save_state`) and a small json of
``t``. A runner's snapshot is one ``runner_state.pt`` of its whole
:class:`~pfrl_tpu_torch.experiments.runner.RunnerState`: the env states and
observations, the train and replay states, ``t``, the returns ring, a
recurrent core's carry (``act_state``) and the draw source's generator
state (a CUDA generator's seed and offset too), so a resumed run draws the
numbers the uninterrupted one draws, as the JAX ``RunnerState`` carries its
key.
"""

import json
import os
from typing import Any

from pfrl_tpu_torch.replay.persistent import load_state, save_state


def save_snapshot(agent: Any, dirname: str) -> None:
    """Snapshot a shell (DQN, actor-critic or on-policy family): its
    ``train_state``, its ``replay_state`` where it has one, and ``t``.

    Like the JAX package's, it does not save the shell's draw source: a
    loaded shell draws on from its own generator, not from the saved one's
    state. A runner snapshot (:func:`save_runner_snapshot`) saves it."""
    os.makedirs(dirname, exist_ok=True)
    save_state(agent.train_state, os.path.join(dirname, "train_state.pt"))
    if getattr(agent, "replay_state", None) is not None:
        save_state(agent.replay_state, os.path.join(dirname, "replay_state.pt"))
    with open(os.path.join(dirname, "snapshot_meta.json"), "w") as f:
        json.dump({"t": agent.t}, f)


def load_snapshot(agent: Any, dirname: str) -> None:
    """Restore a snapshot of :func:`save_snapshot` into ``agent``, which
    must have built its state already (acted once), as in the JAX package:
    its live state is the template."""
    if agent.train_state is None:
        raise RuntimeError("the shell has no train_state yet: act once before load_snapshot")
    agent.train_state = load_state(agent.train_state, os.path.join(dirname, "train_state.pt"))
    replay_path = os.path.join(dirname, "replay_state.pt")
    if os.path.exists(replay_path) and getattr(agent, "replay_state", None) is not None:
        agent.replay_state = load_state(agent.replay_state, replay_path)
    with open(os.path.join(dirname, "snapshot_meta.json")) as f:
        agent.t = int(json.load(f)["t"])


def _check_draws(runner_state: Any) -> None:
    if not hasattr(runner_state.draws, "state_dict"):
        raise TypeError(f"the draw source {type(runner_state.draws).__name__} has no state_dict: it cannot be saved")


def save_runner_snapshot(runner_state: Any, dirname: str) -> None:
    """Snapshot a whole ``RunnerState`` (or ``OnPolicyRunnerState``), its
    draw source's generator state included."""
    _check_draws(runner_state)
    save_state(runner_state, os.path.join(dirname, "runner_state.pt"))


def load_runner_snapshot(template: Any, dirname: str) -> Any:
    """Loads a runner snapshot into ``template`` (``runner.init(seed)`` of a
    runner built like the saved one), in place; returns it."""
    _check_draws(template)
    return load_state(template, os.path.join(dirname, "runner_state.pt"))
