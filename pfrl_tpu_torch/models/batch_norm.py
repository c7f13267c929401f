"""Batch normalization with flax's semantics (counterpart of
``flax.linen.BatchNorm`` at its defaults, as ``pfrl_tpu/models/mlp.py::MLPBN``
uses it), not ``torch.nn.BatchNorm1d``'s.

Over every axis but the last, in float32:

    mean = mean(x)
    var  = max(0, mean(x * x) - mean * mean)          (biased, "fast" variance)
    y    = (x - mean) * (rsqrt(var + epsilon) * scale) + bias

With ``train=True`` the batch's statistics normalize and the running ones
move, in this order, ``ra = momentum * ra + (1 - momentum) * batch_stat``
(``momentum = 0.99``; the running variance takes the biased batch
variance); with ``train=False`` the running statistics normalize and
nothing moves. The running statistics start at 0 and 1 and are buffers
(flax's ``batch_stats`` collection: ``mean`` and ``var``); ``scale`` and
``bias`` are parameters (flax's ``params``). ``torch.nn.BatchNorm1d`` keeps
the unbiased variance, reads its momentum as ``1 - 0.99`` and computes its
statistics in another order, so it rounds apart from flax.
"""

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initial values, drawing nothing: scale 1, bias 0, running
        mean 0 and running variance 1."""
        self.scale.fill_(1.0)
        self.bias.fill_(0.0)
        self.mean.fill_(0.0)
        self.var.fill_(1.0)

    def batch_stats(self, x: torch.Tensor):
        """``(mean, var)`` of ``x`` over every axis but the last, in float32."""
        x = x.float()
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=axes)
        mean2 = torch.mean(x * x, dim=axes)
        return mean, torch.clamp_min(mean2 - mean * mean, 0.0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return y * mul + self.bias
