"""Persistent (disk-backed) replay buffers and whole-state snapshots
(counterpart of ``pfrl_tpu/replay/persistent.py``; reference parity:
pfrl/replay_buffers/persistent.py:10-165 and replay_buffer.py:85-94).

- :func:`save_state` / :func:`load_state` snapshot any state of the port
  (a buffer's, a core's, a runner's): ``torch.save`` of the plain data
  :func:`~pfrl_tpu_torch.agent.to_saved` makes, written atomically, and
  loaded back into a live template, in place, with every tensor's shape
  and dtype checked (:class:`~pfrl_tpu_torch.agent.CheckpointMismatchError`).
  Bytes come back bit for bit: a ring's padded rows, its int32 cursor, a
  sum tree, ``beta``.
- :class:`PersistentReplayBuffer` and :class:`PersistentEpisodicReplayBuffer`
  snapshot their state to ``<dirname>/replay_state.pt`` every
  ``snapshot_interval`` adds and resume from it with ``restore``.

A prioritized ring has no persistent class, as in the JAX package: it is
saved with the runner's snapshot (:mod:`pfrl_tpu_torch.agents.snapshot`).
The reference's ``distributed=True`` mode raises ``NotImplementedError``,
as it does in JAX.
"""

import os
import tempfile
from typing import Any, Optional

import torch

from pfrl_tpu_torch.agent import restore_saved, to_saved
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.replay.uniform import ReplayBuffer


def save_state(state: Any, path: str) -> None:
    """Atomic snapshot of any state: written to a temporary file in the
    target directory, then renamed over ``path``."""
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(to_saved(state), f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(template: Any, path: str) -> Any:
    """Loads the snapshot at ``path`` into ``template`` (a live state of the
    same structure, on the device it should land on), in place where the
    leaves are tensors or modules; returns the restored state. A missing
    file raises ``FileNotFoundError``; a leaf of another shape or dtype
    raises ``CheckpointMismatchError``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return restore_saved(template, saved, os.path.basename(path))


class _PersistentMixin:
    """``add`` that snapshots every ``snapshot_interval`` adds; ``restore``
    to resume."""

    def _persist_setup(self, dirname: str, snapshot_interval: int):
        self.dirname = dirname
        self.snapshot_interval = snapshot_interval
        self._adds_since_snapshot = 0
        os.makedirs(dirname, exist_ok=True)

    @property
    def _snapshot_path(self) -> str:
        return os.path.join(self.dirname, "replay_state.pt")

    def add(self, state, batch):
        state = super().add(state, batch)
        self._adds_since_snapshot += 1
        if self._adds_since_snapshot >= self.snapshot_interval:
            save_state(state, self._snapshot_path)
            self._adds_since_snapshot = 0
        return state

    def restore(self, example) -> Optional[Any]:
        """The newest snapshot in a state built from ``example``, or None if
        there is none."""
        if not os.path.exists(self._snapshot_path):
            return None
        return load_state(self.init(example), self._snapshot_path)

    def checkpoint(self, state) -> None:
        save_state(state, self._snapshot_path)


def _no_distributed(distributed: bool) -> None:
    if distributed:
        raise NotImplementedError(
            "the reference's distributed persistence needs the private pfrlmn package "
            "(persistent.py:54-73); snapshot each process's buffer instead"
        )


class PersistentReplayBuffer(_PersistentMixin, ReplayBuffer):
    def __init__(
        self,
        dirname: str,
        capacity: int,
        *,
        snapshot_interval: int = 1000,
        distributed: bool = False,
        **kwargs,
    ):
        _no_distributed(distributed)
        super().__init__(capacity, **kwargs)
        self._persist_setup(dirname, snapshot_interval)


class PersistentEpisodicReplayBuffer(_PersistentMixin, EpisodicReplayBuffer):
    def __init__(
        self,
        dirname: str,
        max_episodes: int,
        max_episode_len: int,
        *,
        snapshot_interval: int = 1000,
        distributed: bool = False,
        **kwargs,
    ):
        _no_distributed(distributed)
        super().__init__(max_episodes, max_episode_len, **kwargs)
        self._persist_setup(dirname, snapshot_interval)
