"""Delayed-cue memory env on the device (counterpart of
``pfrl_tpu/envs/delayed_cue.py``), batched over lanes.

An episode of ``episode_len`` steps. The observation is the one-hot of the
step index plus one cue channel, which reads ``+-1`` at ``reveal_step`` and
0 elsewhere. At the last step the reward is +1 if the action matches the
cue and -1 otherwise; every other reward is 0. ``reset`` draws each lane's
cue as ``u < 0.5`` from one ``draws.uniform``, as ``jax.random.bernoulli``
draws it.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv


@dataclasses.dataclass
class DelayedCueState:
    t: torch.Tensor    # [L] int32 step index (the obs of step t is shown)
    cue: torch.Tensor  # [L] int32 0/1, drawn at reset


class DelayedCue(TorchEnv):
    def __init__(self, episode_len: int = 12, reveal_step: int = 8, device=None):
        if not 0 <= reveal_step < episode_len - 1:
            raise ValueError("need 0 <= reveal_step < episode_len - 1")
        self.episode_len = episode_len
        self.reveal_step = reveal_step
        self.max_episode_steps = episode_len
        self.n_dim_obs = episode_len + 1
        self.observation_space = spaces.box(-1.0, 1.0, (self.n_dim_obs,))
        self.action_space = spaces.Discrete(2)
        self.device = resolve_device(device)

    def _observe(self, t: torch.Tensor, cue: torch.Tensor) -> torch.Tensor:
        phase = F.one_hot(t.to(torch.int64), self.episode_len).to(torch.float32)
        cue_chan = torch.where(t == self.reveal_step, 2.0 * cue.to(torch.float32) - 1.0, 0.0)
        return torch.cat([phase, cue_chan[:, None]], dim=1)

    def reset(self, draws, num_envs: int) -> Tuple[DelayedCueState, torch.Tensor]:
        cue = (draws.uniform(num_envs) < 0.5).to(torch.int32)
        state = DelayedCueState(t=torch.zeros(num_envs, dtype=torch.int32, device=self.device), cue=cue)
        return state, self._observe(state.t, cue)

    def step(self, state: DelayedCueState, actions: torch.Tensor) -> Tuple[DelayedCueState, TimeStep]:
        last = state.t == self.episode_len - 1
        match = actions.to(torch.int32) == state.cue
        reward = torch.where(last, torch.where(match, 1.0, -1.0), 0.0)
        t = state.t + 1
        ts = TimeStep(
            obs=self._observe(torch.clamp_max(t, self.episode_len - 1), state.cue),
            reward=reward,
            terminated=last,
            truncated=torch.zeros_like(last),
        )
        return DelayedCueState(t=t, cue=state.cue), ts
