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

A runner under a mesh (``mesh=``) holds its lanes' env states, carry and
buffer rows and the replicated rest. Each rank writes its own
``runner_state.rank<r>.pt``: its rows, the replicated state, the shared
draw source's state, and its rank and the world size. Each rank reads
back only its own file, so the ranks may save to directories of their own.
Loading checks the rank and the world size and raises
:class:`~pfrl_tpu_torch.agent.CheckpointMismatchError` naming them where
they differ or where the rank's file is missing (the rows would belong to
other lanes), and where a snapshot saved with a mesh is loaded without one
or the other way round (``runner_state.pt`` against the rank files).
"""

import json
import os
from typing import Any, Optional

import torch

from pfrl_tpu_torch.agent import CheckpointMismatchError, restore_saved
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


def _rank_file(dirname: str, rank: int) -> str:
    return os.path.join(dirname, f"runner_state.rank{rank}.pt")


def save_runner_snapshot(runner_state: Any, dirname: str, mesh: Optional[Any] = None) -> None:
    """Snapshot a whole ``RunnerState`` (or ``OnPolicyRunnerState``), its
    draw source's generator state included; under ``mesh``, this rank's
    part (see the module's note)."""
    _check_draws(runner_state)
    if mesh is None:
        save_state(runner_state, os.path.join(dirname, "runner_state.pt"))
        return
    save_state({"rank": mesh.rank, "world": mesh.size, "state": runner_state}, _rank_file(dirname, mesh.rank))


def load_runner_snapshot(template: Any, dirname: str, mesh: Optional[Any] = None) -> Any:
    """Loads a runner snapshot into ``template`` (``runner.init(seed)`` of a
    runner built like the saved one, under the same ``mesh``), in place;
    returns it."""
    _check_draws(template)
    whole = os.path.join(dirname, "runner_state.pt")
    if mesh is None:
        if not os.path.exists(whole) and os.path.exists(_rank_file(dirname, 0)):
            raise CheckpointMismatchError(f"{dirname}: the snapshot was saved under a mesh; load it under one")
        return load_state(template, whole)
    path = _rank_file(dirname, mesh.rank)
    if not os.path.exists(path):
        if os.path.exists(whole):
            raise CheckpointMismatchError(f"{dirname}: the snapshot was saved without a mesh; load it without one")
        raise CheckpointMismatchError(f"{dirname}: no {os.path.basename(path)} for rank {mesh.rank} of a world size "
                                      f"of {mesh.size}")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if saved["world"] != mesh.size:
        raise CheckpointMismatchError(f"{dirname}: saved by a world size of {saved['world']}, loaded by one of "
                                      f"{mesh.size}")
    if saved["rank"] != mesh.rank:
        raise CheckpointMismatchError(f"{dirname}: {os.path.basename(path)} was saved by rank {saved['rank']}, "
                                      f"loaded by rank {mesh.rank}")
    return restore_saved(template, saved["state"], os.path.basename(path))
