"""Small host wrappers (counterpart of ``pfrl_tpu/wrappers/misc.py``;
reference parity: the pfrl/wrappers misc set). Numpy only: the module
imports no torch, so the workers of ``MultiprocessVectorEnv`` can build
them."""

import numpy as np

from pfrl_tpu_torch.env import Env


class _Wrapper(Env):
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def close(self):
        self.env.close()

    def __getattr__(self, name):
        return getattr(self.env, name)


class CastObservation(_Wrapper):
    """Cast observations to a given dtype
    (pfrl/wrappers/cast_observation.py:4-28)."""

    def __init__(self, env, dtype):
        super().__init__(env)
        self.dtype = dtype

    def reset(self):
        self.original_observation = self.env.reset()
        return np.asarray(self.original_observation, dtype=self.dtype)

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self.original_observation = obs
        return np.asarray(obs, dtype=self.dtype), r, done, info


class CastObservationToFloat32(CastObservation):
    """pfrl/wrappers/cast_observation.py:31-39."""

    def __init__(self, env):
        super().__init__(env, np.float32)


class ScaleReward(_Wrapper):
    """pfrl/wrappers/scale_reward.py."""

    def __init__(self, env, scale: float):
        super().__init__(env)
        self.scale = scale

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        return obs, r * self.scale, done, info


class NormalizeActionSpace(_Wrapper):
    """Map agent actions in [-1, 1] to the env's Box bounds
    (pfrl/wrappers/normalize_action_space.py)."""

    def step(self, action):
        low = self.env.action_space.low
        high = self.env.action_space.high
        scaled = low + (np.asarray(action) + 1.0) * 0.5 * (high - low)
        return self.env.step(scaled.astype(np.float32))


class RandomizeAction(_Wrapper):
    """Evaluation-time epsilon-random actions, the Atari evaluation protocol
    (pfrl/wrappers/randomize_action.py:5-40)."""

    def __init__(self, env, random_fraction: float):
        super().__init__(env)
        assert 0 <= random_fraction <= 1
        self.random_fraction = random_fraction
        self._rng = np.random.RandomState()

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)
        if hasattr(self.env, "seed"):
            return self.env.seed(seed)

    def step(self, action):
        if self._rng.rand() < self.random_fraction:
            action = self._rng.randint(self.env.action_space.n)
        return self.env.step(action)
