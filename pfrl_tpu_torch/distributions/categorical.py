"""Categorical distribution over discrete actions (counterpart of
``pfrl_tpu/distributions/categorical.py``), behind ``SoftmaxCategoricalHead``.

Samples and modes are int64 indices: they go straight into ``gather``, where
an int32 index would be widened first.
"""

import dataclasses

import torch
import torch.nn.functional as F

from pfrl_tpu_torch.distributions.base import Distribution
from pfrl_tpu_torch.utils import draws as draw_fns


@dataclasses.dataclass
class Categorical(Distribution):
    """Parameterized by unnormalized logits ``[..., n]``."""

    logits: torch.Tensor

    @property
    def log_probs(self) -> torch.Tensor:
        return F.log_softmax(self.logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, dim=-1)

    def sample(self, draws) -> torch.Tensor:
        """Gumbel-max over one ``draws.uniform`` of the logits' element count."""
        return draw_fns.categorical(draws, self.logits)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self.log_probs.gather(-1, value.long().unsqueeze(-1)).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs
        return -torch.sum(torch.exp(lp) * lp, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def mean(self) -> torch.Tensor:
        """The mode: the mean of an index is not defined."""
        return self.mode()

    def kl(self, other: "Categorical") -> torch.Tensor:
        lp, lq = self.log_probs, other.log_probs
        return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)
