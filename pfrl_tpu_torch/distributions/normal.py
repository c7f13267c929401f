"""Diagonal Gaussian over action vectors (counterpart of
``pfrl_tpu/distributions/normal.py``)."""

import dataclasses
import math

import torch

from pfrl_tpu_torch.distributions.base import Distribution
from pfrl_tpu_torch.utils import draws as draw_fns

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass
class Normal(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor

    def sample(self, draws) -> torch.Tensor:
        return self.rsample(draws)

    def rsample(self, draws) -> torch.Tensor:
        """One ``draws.normal`` of ``loc``'s element count, reshaped."""
        eps = draw_fns.normal(draws, self.loc.shape)
        return self.loc + self.scale * eps

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        per_dim = -0.5 * z * z - torch.log(self.scale) - _LOG_SQRT_2PI
        return per_dim.sum(-1)

    def entropy(self) -> torch.Tensor:
        return (0.5 + _LOG_SQRT_2PI + torch.log(self.scale)).sum(-1)

    def mode(self) -> torch.Tensor:
        return self.loc

    def mean(self) -> torch.Tensor:
        return self.loc

    def kl(self, other: "Normal") -> torch.Tensor:
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return (0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))).sum(-1)
