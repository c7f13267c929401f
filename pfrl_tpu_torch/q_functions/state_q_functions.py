"""State-input Q-functions (counterpart of
``pfrl_tpu/q_functions/state_q_functions.py``; only the head so far)."""

import torch
from torch import nn

from pfrl_tpu_torch.action_value import DiscreteActionValue


class DiscreteActionValueHead(nn.Module):
    """[B, A] raw Q-values -> DiscreteActionValue."""

    def forward(self, q: torch.Tensor) -> DiscreteActionValue:
        return DiscreteActionValue(q_values=q)
