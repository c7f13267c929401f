"""Vector-env-side frame stacking (counterpart of
``pfrl_tpu/wrappers/vector_frame_stack.py``; reference parity:
pfrl/wrappers/vector_frame_stack.py).

Stacks on the vector env's side, so that the workers of a
``MultiprocessVectorEnv`` ship single frames and not stacks (the
reference's rationale, vector_frame_stack.py:66-71). Each observation is a
:class:`LazyFrames` (the one of :mod:`.atari_wrappers`: the frames are
concatenated along ``stack_axis`` when materialized). A masked ``reset``
refills only the lanes whose mask is False. No torch.
"""

from collections import deque

import numpy as np

from pfrl_tpu_torch.env import VectorEnv
from pfrl_tpu_torch.wrappers.atari_wrappers import LazyFrames


class VectorFrameStack(VectorEnv):
    def __init__(self, env: VectorEnv, k: int, stack_axis: int = 0):
        self.env = env
        self.k = k
        self.stack_axis = stack_axis
        self.frames = [deque([], maxlen=k) for _ in range(env.num_envs)]
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def num_envs(self):
        return self.env.num_envs

    def _stacks(self):
        return [LazyFrames(list(f), stack_axis=self.stack_axis) for f in self.frames]

    def reset(self, mask=None):
        batch_ob = self.env.reset(mask)
        if mask is None:
            mask = np.zeros(self.num_envs, dtype=bool)
        for m, frames, ob in zip(mask, self.frames, batch_ob):
            if not m:
                for _ in range(self.k):
                    frames.append(ob)
        return self._stacks()

    def step(self, actions):
        batch_ob, reward, done, info = self.env.step(actions)
        for frames, ob in zip(self.frames, batch_ob):
            frames.append(ob)
        return self._stacks(), reward, done, info

    def seed(self, seeds=None):
        return self.env.seed(seeds)

    def close(self):
        self.env.close()
