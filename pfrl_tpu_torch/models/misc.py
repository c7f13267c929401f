"""Small glue modules (counterpart of ``pfrl_tpu/models/misc.py``)."""

from typing import Sequence

import torch
from torch import nn


class BoundByTanh(nn.Module):
    """Squash into ``[low, high]`` by tanh. As in the JAX module, the bounds
    are float32 and ``(high - low) / 2`` and ``(high + low) / 2`` are taken
    in float32: ``tanh(x) * scale + center``. The function form is
    :func:`pfrl_tpu_torch.functions.bound_by_tanh`."""

    def __init__(self, low: Sequence[float], high: Sequence[float]):
        super().__init__()
        low = torch.as_tensor(low, dtype=torch.float32)
        high = torch.as_tensor(high, dtype=torch.float32)
        self.register_buffer("scale", (high - low) / 2.0)
        self.register_buffer("center", (high + low) / 2.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x) * self.scale + self.center


class ConcatObsAndAction(nn.Module):
    """Concatenate ``(obs, action)`` along the feature axis."""

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return torch.cat([obs, action], dim=-1)
