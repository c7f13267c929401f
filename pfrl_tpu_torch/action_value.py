"""Action values returned by Q-networks (counterpart of
``pfrl_tpu/action_value.py``; the discrete, the categorical distributional
and the quantile variants so far)."""

import dataclasses

import torch


@dataclasses.dataclass
class DiscreteActionValue:
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


def _take_action(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``x[b, actions[b]]`` over a leading batch: ``[B, A, ...] -> [B, ...]``."""
    idx = actions.to(torch.int64).view(-1, *([1] * (x.dim() - 1)))
    return torch.gather(x, 1, idx.expand(-1, 1, *x.shape[2:])).squeeze(1)


@dataclasses.dataclass
class DistributionalDiscreteActionValue:
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


@dataclasses.dataclass
class QuantileDiscreteActionValue:
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
