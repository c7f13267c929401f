"""Categorical policy head (counterpart of ``pfrl_tpu/policies/softmax_policy.py``)."""

import torch
from torch import nn

from pfrl_tpu_torch.distributions import Categorical


class SoftmaxCategoricalHead(nn.Module):
    """Logits -> :class:`Categorical`; no parameters."""

    def forward(self, logits: torch.Tensor) -> Categorical:
        return Categorical(logits=logits)
