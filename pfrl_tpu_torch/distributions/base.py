"""Distribution protocol (counterpart of ``pfrl_tpu/distributions/base.py``)."""

from typing import Tuple

import torch


class Distribution:
    """Every method maps over the leading dimensions of the parameters."""

    def sample(self, draws) -> torch.Tensor:
        raise NotImplementedError

    def rsample(self, draws) -> torch.Tensor:
        """Reparameterized sample (falls back to ``sample``)."""
        return self.sample(draws)

    def sample_and_log_prob(self, draws) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.rsample(draws)
        return x, self.log_prob(x)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError

    def mode(self) -> torch.Tensor:
        raise NotImplementedError

    def mean(self) -> torch.Tensor:
        raise NotImplementedError
