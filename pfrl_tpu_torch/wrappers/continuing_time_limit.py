"""ContinuingTimeLimit (counterpart of
``pfrl_tpu/wrappers/continuing_time_limit.py``; reference parity:
pfrl/wrappers/continuing_time_limit.py:4-41).

Signals the time limit through ``info["needs_reset"]`` and never through
``done``, so that agents bootstrap through a timeout. The counter restarts
only in ``reset``. Unknown attributes reach the inner env: ``env.seed(...)``
on the outer ``wrap_deepmind`` stack reaches ``GymnasiumEnv.seed`` this way.

The module imports no torch: the workers of ``MultiprocessVectorEnv`` build
``make_atari``'s chain.
"""

from pfrl_tpu_torch.env import Env


class ContinuingTimeLimit(Env):
    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps = None
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def step(self, action):
        assert self._elapsed_steps is not None, "Call reset before step"
        obs, reward, done, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            info["needs_reset"] = True
        return obs, reward, done, info

    def reset(self):
        self._elapsed_steps = 0
        return self.env.reset()

    def close(self):
        self.env.close()

    def __getattr__(self, name):
        # A half-built object (unpickling, ``copy``) has no ``env`` yet: raise
        # instead of looking ``env`` up through this method again.
        env = self.__dict__.get("env")
        if env is None:
            raise AttributeError(name)
        return getattr(env, name)
