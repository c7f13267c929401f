"""Parameter synchronization (counterpart of ``pfrl_tpu/utils/copy_param.py``),
in place on the target module's parameters."""

import torch
from torch import nn


@torch.no_grad()
def copy_param(target: nn.Module, source: nn.Module) -> None:
    """Hard copy of every parameter."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(s)


@torch.no_grad()
def soft_copy_param(target: nn.Module, source: nn.Module, tau: float) -> None:
    """Polyak averaging ``target <- (1 - tau) * target + tau * source``.

    Both products are rounded to float32 before the sum, as the JAX
    package computes them: neither ``torch.lerp`` (``t + tau * (s - t)``)
    nor ``add_(s, alpha=tau)`` (which may fuse the product into the add)
    rounds the same way, and over thousands of updates the targets would
    drift apart.
    """
    for t, s in zip(target.parameters(), source.parameters()):
        t.mul_(1.0 - tau).add_(s * tau)
