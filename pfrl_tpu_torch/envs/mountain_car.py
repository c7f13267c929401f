"""Continuous MountainCar on the device (counterpart of
``pfrl_tpu/envs/mountain_car.py``), batched over lanes.

The sparse-reward testbed of NAF: obs = (pos, vel), one force in [-1, 1].
float32 arithmetic in the JAX env's order: the force is clipped, the
velocity updated and clipped, then the position; the left wall zeroes a
negative velocity; the episode terminates at ``pos >= 0.45``, and the
reward is ``100 * terminated - 0.1 * force**2``. ``reset`` draws the
positions from ``uniform`` over [-0.6, -0.4) at zero velocity.
``torch.cos`` and XLA's float32 ``cos`` may differ by an ulp (ROADMAP C28).
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv
from pfrl_tpu_torch.utils.draws import uniform_between


@dataclasses.dataclass
class MCState:
    pos: torch.Tensor  # [L]
    vel: torch.Tensor  # [L]


class MountainCarContinuous(TorchEnv):
    min_pos = -1.2
    max_pos = 0.6
    max_speed = 0.07
    goal_pos = 0.45
    power = 0.0015
    max_episode_steps = 999

    def __init__(self, device=None):
        self.observation_space = spaces.Box(
            low=np.array([self.min_pos, -self.max_speed], dtype=np.float32),
            high=np.array([self.max_pos, self.max_speed], dtype=np.float32),
        )
        self.action_space = spaces.box(-1.0, 1.0, (1,))
        self.device = resolve_device(device)

    def _obs(self, s: MCState) -> torch.Tensor:
        return torch.stack([s.pos, s.vel], dim=-1)

    def reset(self, draws, num_envs: int) -> Tuple[MCState, torch.Tensor]:
        pos = uniform_between(draws, -0.6, -0.4, (num_envs,))
        s = MCState(pos=pos, vel=torch.zeros_like(pos))
        return s, self._obs(s)

    def step(self, state: MCState, actions: torch.Tensor) -> Tuple[MCState, TimeStep]:
        force = torch.clamp(actions[:, 0], -1.0, 1.0)
        vel = state.vel + force * self.power - 0.0025 * torch.cos(3 * state.pos)
        vel = torch.clamp(vel, -self.max_speed, self.max_speed)
        pos = torch.clamp(state.pos + vel, self.min_pos, self.max_pos)
        vel = torch.where((pos == self.min_pos) & (vel < 0), 0.0, vel)
        terminated = pos >= self.goal_pos
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        s = MCState(pos=pos, vel=vel)
        never = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
        return s, TimeStep(obs=self._obs(s), reward=reward, terminated=terminated, truncated=never)
