"""A function as a module (counterpart of ``pfrl_tpu/models/lmbda.py``)."""

from typing import Callable

from torch import nn


class Lambda(nn.Module):
    """Wrap any function of tensors as a module with no parameters."""

    def __init__(self, f: Callable):
        super().__init__()
        self.f = f

    def forward(self, *args, **kwargs):
        return self.f(*args, **kwargs)
