"""Wrappers for device envs (counterpart of ``pfrl_tpu/envs/wrappers.py``).

Each wrapper is a :class:`TorchEnv` around another; all live on the inner
env's device. :class:`TimeLimit`'s state nests the inner env's, which
``VectorTorchEnv`` selects lane by lane through both levels.
"""

import dataclasses
from typing import Any, Tuple

import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch.env import TimeStep, TorchEnv


class _Wrapper(TorchEnv):
    def __init__(self, env: TorchEnv):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.max_episode_steps = getattr(env, "max_episode_steps", None)
        self.device = env.device

    def reset(self, draws, num_envs: int):
        return self.env.reset(draws, num_envs)

    def step(self, state, actions):
        return self.env.step(state, actions)


@dataclasses.dataclass
class TimeLimitState:
    inner: Any
    t: torch.Tensor  # [L] int32


class TimeLimit(_Wrapper):
    """Truncate episodes after ``max_steps`` without marking termination:
    the agent bootstraps through a time-limit reset, so the flag surfaces as
    ``truncated``, never ``terminated``."""

    def __init__(self, env: TorchEnv, max_steps: int = None):
        super().__init__(env)
        self.max_steps = max_steps if max_steps is not None else self.max_episode_steps
        if self.max_steps is None:
            raise ValueError("TimeLimit needs max_steps or an env with max_episode_steps")
        self.max_episode_steps = self.max_steps

    def reset(self, draws, num_envs: int) -> Tuple[TimeLimitState, Any]:
        state, obs = self.env.reset(draws, num_envs)
        t = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        return TimeLimitState(inner=state, t=t), obs

    def step(self, state: TimeLimitState, actions) -> Tuple[TimeLimitState, TimeStep]:
        inner, ts = self.env.step(state.inner, actions)
        t = state.t + 1
        truncated = ts.truncated | ((t >= self.max_steps) & ~ts.terminated)
        return TimeLimitState(inner=inner, t=t), dataclasses.replace(ts, truncated=truncated)


class ScaleReward(_Wrapper):
    """Multiply rewards by a constant."""

    def __init__(self, env: TorchEnv, scale: float):
        super().__init__(env)
        self.scale = scale

    def step(self, state, actions):
        state, ts = self.env.step(state, actions)
        return state, dataclasses.replace(ts, reward=ts.reward * self.scale)


class CastObservationToFloat32(_Wrapper):
    def reset(self, draws, num_envs: int):
        state, obs = self.env.reset(draws, num_envs)
        return state, obs.to(torch.float32)

    def step(self, state, actions):
        state, ts = self.env.step(state, actions)
        return state, dataclasses.replace(ts, obs=ts.obs.to(torch.float32))


class NormalizeActionSpace(_Wrapper):
    """Present a [-1, 1] action space, mapped affinely onto the inner env's
    ``[low, high]``."""

    def __init__(self, env: TorchEnv):
        super().__init__(env)
        inner = env.action_space
        self._low = torch.as_tensor(inner.low, dtype=torch.float32).to(self.device)
        self._high = torch.as_tensor(inner.high, dtype=torch.float32).to(self.device)
        self.action_space = spaces.box(-1.0, 1.0, inner.shape)

    def step(self, state, actions):
        a = torch.clamp(actions, -1.0, 1.0)
        scaled = self._low + (a + 1.0) * 0.5 * (self._high - self._low)
        return self.env.step(state, scaled)
