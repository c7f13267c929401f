"""Synthetic MuJoCo-shaped env for continuous control (counterpart of
``pfrl_tpu/envs/mujoco_sim.py``).

HalfCheetah-like shapes: observations ``[17]`` float32, actions ``[6]`` in
[-1, 1], episodes that only end by truncation after 1,000 steps, from cheap
fixed-matrix dynamics, batched over lanes. The reward is forward progress
minus a control cost.

The JAX env draws its two mixing matrices from a JAX key; this one draws
its own from a CPU ``torch.Generator`` at the same scales
(``0.9 / sqrt(obs_dim)`` and ``0.4``), or takes them as arrays (``A``
``[obs_dim, obs_dim]``, ``B`` ``[action_dim, obs_dim]``). ``reset`` takes
one ``draws.normal`` of ``num_envs * obs_dim`` values.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv
from pfrl_tpu_torch.utils import draws as draw_fns


@dataclasses.dataclass
class MujocoSimState:
    x: torch.Tensor  # [L, obs_dim] latent = observed state
    t: torch.Tensor  # [L] int32 step within episode


class MujocoSim(TorchEnv):
    def __init__(
        self,
        obs_dim: int = 17,
        action_dim: int = 6,
        episode_len: int = 1000,
        A=None,
        B=None,
        device=None,
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.episode_len = episode_len
        self.observation_space = spaces.box(-np.inf, np.inf, (obs_dim,))
        self.action_space = spaces.box(-1.0, 1.0, (action_dim,))
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(17)
        if A is None:
            A = torch.randn(obs_dim, obs_dim, generator=generator) * (0.9 / obs_dim**0.5)
        if B is None:
            B = torch.randn(action_dim, obs_dim, generator=generator) * 0.4
        self._A = torch.tensor(np.asarray(A), dtype=torch.float32).to(self.device)
        self._B = torch.tensor(np.asarray(B), dtype=torch.float32).to(self.device)
        if self._A.shape != (obs_dim, obs_dim) or self._B.shape != (action_dim, obs_dim):
            raise ValueError("A must be [obs_dim, obs_dim] and B [action_dim, obs_dim]")

    def reset(self, draws, num_envs: int) -> Tuple[MujocoSimState, torch.Tensor]:
        x = 0.1 * draw_fns.normal(draws, (num_envs, self.obs_dim))
        t = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        return MujocoSimState(x=x, t=t), x

    def step(self, state: MujocoSimState, actions: torch.Tensor) -> Tuple[MujocoSimState, TimeStep]:
        a = torch.clamp(actions, -1.0, 1.0)
        x = torch.tanh(state.x @ self._A + a @ self._B)
        t = state.t + 1
        reward = x[:, 0] - 0.05 * torch.sum(a * a, dim=-1)
        truncated = t >= self.episode_len
        ts = TimeStep(
            obs=x, reward=reward, terminated=torch.zeros_like(truncated), truncated=truncated
        )
        return MujocoSimState(x=x, t=t), ts
