"""Tanh-squashed diagonal Gaussian, SAC's policy distribution (counterpart
of ``pfrl_tpu/distributions/squashed_normal.py``).

The squash's log-det Jacobian is the fused stable form
``log(1 - tanh(u)**2) = 2 * (log 2 - u - softplus(-2u))`` on the pre-squash
value. ``softplus`` is ``torch.nn.functional.softplus``: ``log1p(exp(x))``
up to its threshold of 20 and the identity above it, where
``jax.nn.softplus`` (``logaddexp(x, 0)``) exceeds the identity by under
3e-9, less than half a float32 ulp at 20.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F

from pfrl_tpu_torch.distributions.base import Distribution
from pfrl_tpu_torch.distributions.normal import Normal

_LOG2 = math.log(2.0)


def _log_det(u: torch.Tensor) -> torch.Tensor:
    return (2.0 * (_LOG2 - u - F.softplus(-2.0 * u))).sum(-1)


@dataclasses.dataclass
class SquashedNormal(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor

    def _base(self) -> Normal:
        return Normal(loc=self.loc, scale=self.scale)

    def sample(self, draws) -> torch.Tensor:
        return self.rsample(draws)

    def rsample(self, draws) -> torch.Tensor:
        return torch.tanh(self._base().rsample(draws))

    def sample_and_log_prob(self, draws):
        """The log-prob comes from the pre-squash value: ``atanh`` of the
        sample would lose precision near 1."""
        base = self._base()
        u = base.rsample(draws)
        return torch.tanh(u), base.log_prob(u) - _log_det(u)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        eps = 1e-6
        u = torch.atanh(torch.clamp(value, -1.0 + eps, 1.0 - eps))
        return self._base().log_prob(u) - _log_det(u)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    def mean(self) -> torch.Tensor:
        return torch.tanh(self.loc)  # an approximation: no closed form

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError(
            "SquashedNormal entropy has no closed form; use -log_prob(sample)."
        )
