"""Deterministic policy head (counterpart of
``pfrl_tpu/policies/deterministic_policy.py``)."""

import torch
from torch import nn

from pfrl_tpu_torch.distributions import Delta


class DeterministicHead(nn.Module):
    def forward(self, loc: torch.Tensor) -> Delta:
        return Delta(loc=loc)
