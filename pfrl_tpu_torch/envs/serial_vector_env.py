"""In-process host vector env (counterpart of
``pfrl_tpu/envs/serial_vector_env.py``; reference parity:
pfrl/envs/serial_vector_env.py:6-48)."""

import numpy as np

from pfrl_tpu_torch.env import VectorEnv


class SerialVectorEnv(VectorEnv):
    """Steps a list of host envs one after another, in this process."""

    def __init__(self, envs):
        self.envs = list(envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self.last_obs = [None] * len(self.envs)

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    def step(self, actions):
        results = [env.step(a) for env, a in zip(self.envs, actions)]
        obss, rews, dones, infos = zip(*results)
        self.last_obs = list(obss)
        return obss, np.asarray(rews, dtype=np.float32), np.asarray(dones, dtype=bool), infos

    def reset(self, mask=None):
        if mask is None:
            mask = np.zeros(len(self.envs), dtype=bool)
        obss = []
        for m, env, last in zip(mask, self.envs, self.last_obs):
            obss.append(last if m else env.reset())
        self.last_obs = obss
        return obss

    def seed(self, seeds=None):
        if seeds is None:
            seeds = [None] * len(self.envs)
        elif np.isscalar(seeds):
            seeds = [seeds] * len(self.envs)
        for env, s in zip(self.envs, seeds):
            if hasattr(env, "seed"):
                env.seed(s)

    def close(self):
        for env in self.envs:
            env.close()
