"""Action values returned by Q-networks (counterpart of
``pfrl_tpu/action_value.py``): the :class:`ActionValue` interface, the
discrete, the categorical distributional and the quantile variants, NAF's
quadratic one and the per-action :class:`SingleActionValue`. ``params``
is the tuple of tensors a variant is made of."""

import dataclasses
from typing import Callable, Optional

import torch


class ActionValue:
    """The interface: ``greedy_actions``, ``max``, ``evaluate_actions``."""

    def greedy_actions(self) -> torch.Tensor:
        raise NotImplementedError

    def max(self) -> torch.Tensor:
        raise NotImplementedError

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class DiscreteActionValue(ActionValue):
    """Plain Q-values over discrete actions ``[B, A]``."""

    q_values: torch.Tensor

    @property
    def n_actions(self) -> int:
        return self.q_values.shape[-1]

    def greedy_actions(self) -> torch.Tensor:
        """int32 argmax; ties go to the first index, as with ``jnp.argmax``."""
        return torch.argmax(self.q_values, dim=-1).to(torch.int32)

    def max(self) -> torch.Tensor:
        return torch.amax(self.q_values, dim=-1)

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        idx = actions.to(torch.int64).unsqueeze(-1)
        return torch.gather(self.q_values, -1, idx).squeeze(-1)

    @property
    def params(self):
        return (self.q_values,)


def _take_action(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``x[b, actions[b]]`` over a leading batch: ``[B, A, ...] -> [B, ...]``."""
    idx = actions.to(torch.int64).view(-1, *([1] * (x.dim() - 1)))
    return torch.gather(x, 1, idx.expand(-1, 1, *x.shape[2:])).squeeze(1)


@dataclasses.dataclass
class DistributionalDiscreteActionValue(ActionValue):
    """C51-style categorical return distributions: ``q_dist`` ``[B, A, N]``
    probabilities over the support ``z_values`` ``[N]``."""

    q_dist: torch.Tensor
    z_values: torch.Tensor

    @property
    def q_values(self) -> torch.Tensor:
        return torch.sum(self.q_dist * self.z_values, dim=-1)

    def greedy_actions(self) -> torch.Tensor:
        return torch.argmax(self.q_values, dim=-1).to(torch.int32)

    def max(self) -> torch.Tensor:
        return torch.amax(self.q_values, dim=-1)

    def max_as_distribution(self) -> torch.Tensor:
        """Return distribution of the greedy action, ``[B, N]``."""
        return _take_action(self.q_dist, self.greedy_actions())

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        return _take_action(self.q_values, actions)

    def evaluate_actions_as_distribution(self, actions: torch.Tensor) -> torch.Tensor:
        return _take_action(self.q_dist, actions)

    @property
    def params(self):
        return (self.q_dist,)


@dataclasses.dataclass
class QuantileDiscreteActionValue(ActionValue):
    """IQN's quantile estimates ``quantiles`` ``[B, n_taus, A]``; the
    Q-values are their mean over the taus."""

    quantiles: torch.Tensor

    @property
    def q_values(self) -> torch.Tensor:
        return torch.mean(self.quantiles, dim=1)

    def greedy_actions(self) -> torch.Tensor:
        return torch.argmax(self.q_values, dim=-1).to(torch.int32)

    def max(self) -> torch.Tensor:
        return torch.amax(self.q_values, dim=-1)

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        return _take_action(self.q_values, actions)

    def evaluate_actions_as_quantiles(self, actions: torch.Tensor) -> torch.Tensor:
        """The quantiles of the given actions, ``[B, n_taus]``."""
        idx = actions.to(torch.int64).view(-1, 1, 1).expand(-1, self.quantiles.shape[1], 1)
        return torch.gather(self.quantiles, 2, idx).squeeze(2)

    @property
    def params(self):
        return (self.quantiles,)


@dataclasses.dataclass
class QuadraticActionValue(ActionValue):
    """NAF's quadratic Q: ``Q(s, a) = v - 1/2 (a - mu)^T mat (a - mu)``.

    ``mu`` ``[B, d]``, ``mat`` ``[B, d, d]`` (positive semi-definite), ``v``
    ``[B]``; optional bounds ``min_action``/``max_action`` ``[d]`` clip the
    greedy action, and then ``max()`` evaluates the clipped action (equal
    to ``v`` only up to rounding where ``mu`` lies inside the bounds), as
    the JAX class does; without bounds it is ``v``."""

    mu: torch.Tensor
    mat: torch.Tensor
    v: torch.Tensor
    min_action: Optional[torch.Tensor] = None
    max_action: Optional[torch.Tensor] = None

    def greedy_actions(self) -> torch.Tensor:
        a = self.mu
        if self.min_action is not None:
            a = torch.maximum(a, self.min_action)
        if self.max_action is not None:
            a = torch.minimum(a, self.max_action)
        return a

    def max(self) -> torch.Tensor:
        if self.min_action is None and self.max_action is None:
            return self.v
        return self.evaluate_actions(self.greedy_actions())

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        d = actions - self.mu
        return self.v - 0.5 * torch.einsum("bi,bij,bj->b", d, self.mat, d)

    @property
    def params(self):
        return (self.mu, self.mat, self.v)


class SingleActionValue(ActionValue):
    """Q-values computable only per action, through ``evaluator(actions)``;
    ``maximizer()`` gives the greedy actions (a continuous actor-critic's
    policy). Not a dataclass: it wraps callables and is never cast or
    stacked."""

    def __init__(self, evaluator: Callable[[torch.Tensor], torch.Tensor],
                 maximizer: Optional[Callable[[], torch.Tensor]] = None):
        self.evaluator = evaluator
        self.maximizer = maximizer

    def greedy_actions(self) -> torch.Tensor:
        if self.maximizer is None:
            raise RuntimeError("SingleActionValue without maximizer")
        return self.maximizer()

    def max(self) -> torch.Tensor:
        return self.evaluator(self.greedy_actions())

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        return self.evaluator(actions)
