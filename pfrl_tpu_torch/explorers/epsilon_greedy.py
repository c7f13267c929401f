"""Epsilon-greedy (counterpart of ``pfrl_tpu/explorers/epsilon_greedy.py``).

The schedule is a function of the host step counter ``t``, computed in
float32 with the JAX package's arithmetic, so both packages take the same
epsilon at every step. The draws come from the caller's draw source.
"""

import numpy as np
import torch


def epsilon_greedy(draws, epsilon: float, greedy_actions: torch.Tensor, n_actions: int):
    """Per lane: a random action where ``u < epsilon``, else the greedy one.

    Draws ``u`` first, then the random actions, as the JAX explorer splits
    its key.
    """
    batch = greedy_actions.shape[0]
    explore = draws.uniform(batch) < epsilon
    random_actions = draws.randint(n_actions, batch).to(greedy_actions.dtype)
    return torch.where(explore, random_actions, greedy_actions)


class _EpsilonSchedule:
    """Acts by :func:`epsilon_greedy` at the subclass's ``epsilon_at(t)``."""

    n_actions: int

    def select_action(self, draws, t: int, greedy_actions, action_value=None):
        return epsilon_greedy(draws, self.epsilon_at(t), greedy_actions, self.n_actions)


class ConstantEpsilonGreedy(_EpsilonSchedule):
    """A fixed epsilon. At 0 it still draws its uniforms and random
    actions, as the JAX explorer does, so the draws stay in step."""

    def __init__(self, epsilon: float, n_actions: int):
        self.epsilon = epsilon
        self.n_actions = n_actions

    def epsilon_at(self, t: int) -> float:
        return float(np.float32(self.epsilon))


class LinearDecayEpsilonGreedy(_EpsilonSchedule):
    """Linear anneal start -> end over ``decay_steps`` transitions."""

    def __init__(self, start_epsilon: float, end_epsilon: float, decay_steps: int, n_actions: int):
        if not 0 <= end_epsilon <= start_epsilon <= 1:
            raise ValueError("need 0 <= end_epsilon <= start_epsilon <= 1")
        self.start_epsilon = start_epsilon
        self.end_epsilon = end_epsilon
        self.decay_steps = decay_steps
        self.n_actions = n_actions

    def epsilon_at(self, t: int) -> float:
        f32 = np.float32
        frac = np.clip(f32(t) / f32(self.decay_steps), f32(0.0), f32(1.0))
        eps = f32(self.start_epsilon) + frac * f32(self.end_epsilon - self.start_epsilon)
        return float(eps)


class ExponentialDecayEpsilonGreedy(_EpsilonSchedule):
    """``max(end, start * decay ** t)``, the power taken in float32 of a
    float32 ``t`` (``t`` above 2**24 rounds, as in the JAX package)."""

    def __init__(self, start_epsilon: float, end_epsilon: float, decay: float, n_actions: int):
        self.start_epsilon = start_epsilon
        self.end_epsilon = end_epsilon
        self.decay = decay
        self.n_actions = n_actions

    def epsilon_at(self, t: int) -> float:
        f32 = np.float32
        eps = f32(self.start_epsilon) * np.power(f32(self.decay), f32(t))
        return float(np.maximum(eps, f32(self.end_epsilon)))
