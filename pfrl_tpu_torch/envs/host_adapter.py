"""Host-protocol adapter over a device env of the port (counterpart of
``pfrl_tpu/envs/host_adapter.py``'s ``HostJaxEnv``).

:class:`HostTorchEnv` runs one lane of a :class:`~pfrl_tpu_torch.env.TorchEnv`
behind the host :class:`~pfrl_tpu_torch.env.Env` protocol (numpy
observation, float reward, ``done`` for termination and
``info["needs_reset"]`` for truncation), so the host drivers and the agent
shells run on the port's envs: the stand-in for gym envs in the tests and
on the card. It steps one env at a time and reads every step on the host.
"""

import numpy as np
import torch

from pfrl_tpu_torch.env import Env, TorchEnv
from pfrl_tpu_torch.utils.draws import Draws


class HostTorchEnv(Env):
    """``draws`` is the env's own draw source (its resets, and the steps of
    an env that draws on each step); by default a generator on the env's
    device seeded with ``seed``."""

    def __init__(self, env: TorchEnv, seed: int = 0, draws=None):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.device = env.device
        self.draws = draws if draws is not None else Draws(torch.Generator(device=env.device).manual_seed(seed))
        self._draws_on_step = getattr(env, "draws_on_step", False)
        self._state = None

    def seed(self, seed=None):
        if seed is not None:
            self.draws = Draws(torch.Generator(device=self.device).manual_seed(seed))

    def reset(self):
        self._state, obs = self.env.reset(self.draws, 1)
        return obs[0].cpu().numpy()

    def step(self, action):
        actions = torch.as_tensor(np.asarray(action)).to(self.device).unsqueeze(0)
        if self._draws_on_step:
            self._state, ts = self.env.step(self._state, actions, self.draws)
        else:
            self._state, ts = self.env.step(self._state, actions)
        info = {}
        if bool(ts.truncated[0]):
            info["needs_reset"] = True
        return ts.obs[0].cpu().numpy(), float(ts.reward[0]), bool(ts.terminated[0]), info

    def close(self):
        pass
