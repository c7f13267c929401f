"""Pendulum-v1 dynamics on the device (counterpart of
``pfrl_tpu/envs/pendulum.py``), batched over lanes.

Torque-limited swing-up: obs = (cos th, sin th, thdot), reward =
-(th**2 + 0.1 thdot**2 + 0.001 u**2) with th normalized to [-pi, pi). It
never terminates; :class:`~pfrl_tpu_torch.envs.wrappers.TimeLimit`
truncates it after 200 steps. ``reset`` draws the angles first
(``uniform`` over [-pi, pi)), then the speeds (over [-1, 1)).
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv
from pfrl_tpu_torch.utils.draws import uniform_between


@dataclasses.dataclass
class PendulumState:
    th: torch.Tensor     # [L]
    thdot: torch.Tensor  # [L]


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Pendulum(TorchEnv):
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0
    max_episode_steps = 200

    def __init__(self, device=None):
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = spaces.Box(low=-high, high=high)
        self.action_space = spaces.box(-self.max_torque, self.max_torque, (1,))
        self.device = resolve_device(device)

    def _obs(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.th), torch.sin(s.th), s.thdot], dim=-1)

    def reset(self, draws, num_envs: int) -> Tuple[PendulumState, torch.Tensor]:
        th = uniform_between(draws, -math.pi, math.pi, (num_envs,))
        thdot = uniform_between(draws, -1.0, 1.0, (num_envs,))
        s = PendulumState(th=th, thdot=thdot)
        return s, self._obs(s)

    def step(self, state: PendulumState, actions: torch.Tensor) -> Tuple[PendulumState, TimeStep]:
        u = torch.clamp(actions[:, 0], -self.max_torque, self.max_torque)
        th, thdot = state.th, state.thdot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3.0 * self.g / (2.0 * self.length) * torch.sin(th)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        s = PendulumState(th=newth, thdot=newthdot)
        never = torch.zeros(th.shape, dtype=torch.bool, device=th.device)
        ts = TimeStep(obs=self._obs(s), reward=-cost, terminated=never, truncated=never)
        return s, ts
