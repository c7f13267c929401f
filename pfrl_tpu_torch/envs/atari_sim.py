"""Synthetic Atari-shaped env (counterpart of ``pfrl_tpu/envs/atari_sim.py``).

84x84x4 uint8 frames from a cheap procedural pattern, geometric episode
lengths and a sparse reward, batched over lanes. The pattern, reward and
episode-length arithmetic are the JAX env's, op for op.
"""

import dataclasses
from typing import Tuple

import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv


@dataclasses.dataclass
class AtariSimState:
    t: torch.Tensor       # [L] int32 step within episode
    seed: torch.Tensor    # [L] int32 per-episode pattern seed
    ep_len: torch.Tensor  # [L] int32 sampled episode length


class AtariSim(TorchEnv):
    def __init__(
        self,
        n_actions: int = 6,
        mean_episode_len: int = 1000,
        frame_shape: Tuple[int, int, int] = (84, 84, 4),
        device=None,
    ):
        self.n_actions = n_actions
        self.mean_episode_len = mean_episode_len
        self.frame_shape = tuple(frame_shape)
        self.observation_space = spaces.box(0, 255, frame_shape)
        self.action_space = spaces.Discrete(n_actions)
        self.device = resolve_device(device)
        h, w, c = self.frame_shape
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=self.device)  # noqa: E731
        # rows*31 + cols*17 + chans*97, the time-invariant part of the mix.
        # int64 where JAX wraps int32: the low 8 bits, all that is kept, agree.
        self._pattern = (
            ar(h)[:, None, None] * 31 + ar(w)[None, :, None] * 17 + ar(c) * 97
        )

    def _obs(self, state: AtariSimState) -> torch.Tensor:
        shift = state.t.to(torch.int64) * 13 + state.seed.to(torch.int64) * 7919
        mix = self._pattern[None] + shift[:, None, None, None]
        return (mix & 0xFF).to(torch.uint8)

    def reset(self, draws, num_envs: int) -> Tuple[AtariSimState, torch.Tensor]:
        seed = draws.randint(1 << 20, num_envs)
        u = draws.uniform(num_envs)
        ep_len = (1.0 + -torch.log1p(-u) * self.mean_episode_len).to(torch.int32)
        state = AtariSimState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            seed=seed,
            ep_len=ep_len,
        )
        return state, self._obs(state)

    def step(
        self, state: AtariSimState, actions: torch.Tensor
    ) -> Tuple[AtariSimState, TimeStep]:
        t = state.t + 1
        new_state = AtariSimState(t=t, seed=state.seed, ep_len=state.ep_len)
        lucky = ((state.seed + t) % 37) == (actions.to(torch.int32) % 37 % 7)
        reward = lucky.to(torch.float32)
        terminated = t >= state.ep_len
        ts = TimeStep(
            obs=self._obs(new_state),
            reward=reward,
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )
        return new_state, ts
