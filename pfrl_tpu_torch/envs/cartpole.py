"""CartPole-v1 dynamics on the device (counterpart of
``pfrl_tpu/envs/cartpole.py``), batched over lanes.

Euler integration at dt = 0.02, reward 1 per step, termination once
``|x| > 2.4`` or ``|theta| > 12 degrees``; the 500-step limit comes from
:class:`~pfrl_tpu_torch.envs.wrappers.TimeLimit`. ``reset`` draws the four
state variables of every lane uniformly over [-0.05, 0.05) in one
``draws.uniform``, lane by lane.
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
class CartPoleState:
    x: torch.Tensor  # [L, 4]: cart position and velocity, pole angle and angular velocity


class CartPole(TorchEnv):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5  # half the pole's length
    force_mag = 10.0
    dt = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4
    max_episode_steps = 500

    def __init__(self, device=None):
        high = np.array([4.8, 1e4, 0.418, 1e4], dtype=np.float32)
        self.observation_space = spaces.Box(low=-high, high=high)
        self.action_space = spaces.Discrete(2)
        self.device = resolve_device(device)

    def reset(self, draws, num_envs: int) -> Tuple[CartPoleState, torch.Tensor]:
        x = uniform_between(draws, -0.05, 0.05, (num_envs, 4))
        return CartPoleState(x=x), x

    def step(self, state: CartPoleState, actions: torch.Tensor) -> Tuple[CartPoleState, TimeStep]:
        x, x_dot, theta, theta_dot = state.x.unbind(-1)
        force = torch.where(actions == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * xacc
        theta = theta + self.dt * theta_dot
        theta_dot = theta_dot + self.dt * thetaacc
        obs = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = (torch.abs(x) > self.x_threshold) | (torch.abs(theta) > self.theta_threshold)
        ts = TimeStep(
            obs=obs,
            reward=torch.ones_like(x),
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )
        return CartPoleState(x=obs), ts
