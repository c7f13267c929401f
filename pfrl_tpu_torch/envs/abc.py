"""The ABC chain MDP on the device (counterpart of ``pfrl_tpu/envs/abc.py``),
batched over lanes.

On state ``n`` only action ``n`` advances; completing the chain of ``size``
states gives reward +1. Episodic: a wrong action or the goal ends the
episode (state ``size``); continuing: the goal returns to state 0.
``partially_observable`` shifts each episode's one-hot observation by an
offset: with ``deterministic`` it is ``episode % 2`` of an episode counter
that every reset sets to 1, as the JAX env's does (so the offset is always
1); otherwise one ``draws.randint(2, L)`` per reset. Continuous actions are
``size`` logits clipped to [-1, 1]: ``deterministic`` takes their argmax,
otherwise each lane draws its inner action by ``categorical`` over them, one
uniform of ``[L, size]`` per step (the JAX env's ``categorical(rng_a,
clip(a, -1, 1))``). That form asks for a draw source on ``step``
(``draws_on_step``), which :class:`~pfrl_tpu_torch.envs.vector_env.
VectorTorchEnv` passes before it draws the lanes' resets, as the JAX vector
env splits its step keys before its reset keys.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.env import TimeStep, TorchEnv
from pfrl_tpu_torch.utils.draws import categorical


@dataclasses.dataclass
class ABCState:
    s: torch.Tensor        # [L] int32 chain position (size == terminal)
    offset: torch.Tensor   # [L] int32 observation shift of a PO episode
    episode: torch.Tensor  # [L] int32 episode counter (the deterministic PO offset)


class ABC(TorchEnv):
    def __init__(
        self,
        size: int = 2,
        discrete: bool = True,
        partially_observable: bool = False,
        episodic: bool = True,
        deterministic: bool = False,
        device=None,
    ):
        self.size = size
        self.discrete = discrete
        self.partially_observable = partially_observable
        self.episodic = episodic
        self.deterministic = deterministic
        self.n_max_offset = 1
        self.n_dim_obs = size + 1 + self.n_max_offset
        self.observation_space = spaces.box(-math.inf, math.inf, (self.n_dim_obs,))
        self.action_space = spaces.Discrete(size) if discrete else spaces.box(-1.0, 1.0, (size,))
        self.device = resolve_device(device)

    @property
    def draws_on_step(self) -> bool:
        """The stochastic continuous form draws its inner action each step."""
        return not self.discrete and not self.deterministic

    def _observe(self, s: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return F.one_hot((s + offset).to(torch.int64), self.n_dim_obs).to(torch.float32)

    def reset(self, draws, num_envs: int) -> Tuple[ABCState, torch.Tensor]:
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        episode = zeros + 1
        if not self.partially_observable:
            offset = zeros
        elif self.deterministic:
            offset = episode % (self.n_max_offset + 1)
        else:
            offset = draws.randint(self.n_max_offset + 1, num_envs)
        state = ABCState(s=zeros, offset=offset, episode=episode)
        return state, self._observe(state.s, offset)

    def step(self, state: ABCState, actions: torch.Tensor, draws=None) -> Tuple[ABCState, TimeStep]:
        """``draws`` is needed by the stochastic continuous form only."""
        if self.discrete:
            inner = actions.to(torch.int32)
        elif self.deterministic:
            inner = torch.argmax(torch.clamp(actions, -1.0, 1.0), dim=-1).to(torch.int32)
        else:
            if draws is None:
                raise ValueError("the stochastic continuous ABC draws its action on each step: pass draws")
            inner = categorical(draws, torch.clamp(actions, -1.0, 1.0)).to(torch.int32)
        correct = inner == state.s
        at_goal = correct & (state.s == self.size - 1)
        reward = torch.where(at_goal, 1.0, 0.0)
        advanced = torch.where(correct, state.s + 1, state.s)
        if self.episodic:
            terminated = at_goal | ~correct
            next_s = torch.where(terminated, self.size, advanced).to(torch.int32)
        else:
            terminated = torch.zeros_like(correct)
            next_s = torch.where(at_goal, 0, advanced).to(torch.int32)
        new_state = ABCState(s=next_s, offset=state.offset, episode=state.episode)
        ts = TimeStep(
            obs=self._observe(next_s, state.offset),
            reward=reward,
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )
        return new_state, ts
