"""Ornstein-Uhlenbeck action noise (counterpart of
``pfrl_tpu/explorers/additive_ou.py``).

The process's state is an explicit tensor the caller carries
(``init_state`` / ``select_action_stateful``); ``select_action``, for
callers that cannot thread state, falls back to plain Gaussian noise of
scale ``sigma``. One ``draws.normal`` per call either way.
"""

import torch

from pfrl_tpu_torch.utils import draws as draw_fns


class AdditiveOU:
    def __init__(self, mu: float = 0.0, theta: float = 0.15, sigma: float = 0.3):
        self.mu = mu
        self.theta = theta
        self.sigma = sigma

    def init_state(self, shape, device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def select_action_stateful(self, draws, state: torch.Tensor, greedy_actions: torch.Tensor):
        noise = draw_fns.normal(draws, state.shape)
        new_state = state + self.theta * (self.mu - state) + self.sigma * noise
        return greedy_actions + new_state, new_state

    def select_action(self, draws, t: int, greedy_actions: torch.Tensor, action_value=None):
        return greedy_actions + draw_fns.normal(draws, greedy_actions.shape) * self.sigma
