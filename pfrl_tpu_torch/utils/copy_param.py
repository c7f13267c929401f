"""Parameter synchronization (counterpart of ``pfrl_tpu/utils/copy_param.py``),
in place on the target module's parameters.

A :class:`~pfrl_tpu_torch.models.batch_norm.BatchNorm`'s running
statistics travel with the parameters, as the JAX functions carry a flax
``batch_stats`` collection when they are given the whole variables.
"""

from typing import Iterator

import torch
from torch import nn

from pfrl_tpu_torch.models.batch_norm import BatchNorm


def _synced_tensors(module: nn.Module) -> Iterator[torch.Tensor]:
    yield from module.parameters()
    for m in module.modules():
        if isinstance(m, BatchNorm):
            yield m.mean
            yield m.var


@torch.no_grad()
def copy_param(target: nn.Module, source: nn.Module) -> None:
    """Hard copy of every parameter."""
    for t, s in zip(_synced_tensors(target), _synced_tensors(source)):
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
    for t, s in zip(_synced_tensors(target), _synced_tensors(source)):
        t.mul_(1.0 - tau).add_(s * tau)


def synchronize_parameters(src: nn.Module, dst: nn.Module, method: str = "hard", tau: float = 1e-2) -> nn.Module:
    """``dst`` made a hard copy of ``src`` (``method="hard"``) or moved
    toward it by :func:`soft_copy_param` (``"soft"``), in place; returns
    ``dst``. Any other method raises ``ValueError``."""
    if method == "hard":
        copy_param(dst, src)
    elif method == "soft":
        soft_copy_param(dst, src, tau)
    else:
        raise ValueError(f"Unknown method {method!r}")
    return dst
