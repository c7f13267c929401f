"""Device environment protocol (counterpart of ``pfrl_tpu/env.py``'s
``TimeStep`` and ``JaxEnv``).

A :class:`TorchEnv` is batched over lanes directly: its state is a set of
``[L]`` tensors and ``reset``/``step`` act on all lanes at once, where the
JAX package writes one lane and vmaps it. Random draws come from a draw
source (:mod:`pfrl_tpu_torch.utils.draws`) in place of a PRNG key.
"""

import dataclasses
from typing import Any, Tuple

import torch


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
