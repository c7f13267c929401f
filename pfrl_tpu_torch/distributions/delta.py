"""Deterministic (Dirac delta) distribution (counterpart of
``pfrl_tpu/distributions/delta.py``), behind ``DeterministicHead``."""

import dataclasses

import torch

from pfrl_tpu_torch.distributions.base import Distribution


@dataclasses.dataclass
class Delta(Distribution):
    loc: torch.Tensor

    def sample(self, draws) -> torch.Tensor:
        return self.loc

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """0 where ``value`` equals ``loc`` in every event dim, else -inf."""
        eq = torch.all(value == self.loc, dim=-1)
        zero = torch.zeros((), dtype=self.loc.dtype, device=self.loc.device)
        return torch.where(eq, zero, -torch.inf)

    def entropy(self) -> torch.Tensor:
        return self.loc.new_zeros(self.loc.shape[:-1])

    def mode(self) -> torch.Tensor:
        return self.loc

    def mean(self) -> torch.Tensor:
        return self.loc
