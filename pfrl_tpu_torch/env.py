"""Environment protocols (counterpart of ``pfrl_tpu/env.py``'s ``Env``,
``TimeStep``, ``JaxEnv`` and ``VectorEnv``).

A :class:`TorchEnv` is batched over lanes directly: its state is a set of
``[L]`` tensors and ``reset``/``step`` act on all lanes at once, where the
JAX package writes one lane and vmaps it. Random draws come from a draw
source (:mod:`pfrl_tpu_torch.utils.draws`) in place of a PRNG key.
:class:`Env` is the host protocol (numpy observations, the gym 4-tuple) of
the Atari wrappers, ``SyntheticALE`` and the host-env drivers, and
:class:`VectorEnv` its vectorized form (``envs/serial_vector_env.py``,
``envs/multiprocess_vector_env.py``).

The module imports no torch (the annotations stay strings): the Atari
pipeline's actor processes and the workers of ``MultiprocessVectorEnv``
import it through the wrappers, and they never load torch.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Tuple

if TYPE_CHECKING:
    import torch


class Env:
    """Host RL environment (reference parity: pfrl/env.py:4-20)."""

    observation_space = None
    action_space = None

    def step(self, action) -> Tuple[Any, float, bool, dict]:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def close(self):
        pass


class VectorEnv:
    """Host vectorized env (reference parity: pfrl/env.py:23-55).

    ``reset(mask)`` resets only the envs where ``mask`` is falsy; envs with
    a true mask keep running and return their last observation.
    """

    observation_space = None
    action_space = None

    @property
    def num_envs(self) -> int:
        raise NotImplementedError

    def step(self, actions):
        raise NotImplementedError

    def reset(self, mask=None):
        raise NotImplementedError

    def seed(self, seeds=None):
        raise NotImplementedError

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self


@dataclasses.dataclass
class TimeStep:
    """One step's env output for all lanes, before auto-reset.

    ``obs`` is the true next observation (the terminal one on episode end).
    """

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class TorchEnv:
    """Batched device environment: ``reset(draws, num_envs) -> (state, obs)``
    and ``step(state, actions) -> (state, TimeStep)``."""

    observation_space = None
    action_space = None
    device: torch.device

    def reset(self, draws, num_envs: int) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step(self, state: Any, actions: torch.Tensor) -> Tuple[Any, TimeStep]:
        raise NotImplementedError
