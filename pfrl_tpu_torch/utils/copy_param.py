"""Parameter synchronization (counterpart of ``pfrl_tpu/utils/copy_param.py``),
in place on the target module's parameters.

A :class:`~pfrl_tpu_torch.models.batch_norm.BatchNorm`'s running
statistics travel with the parameters, as the JAX functions carry a flax
``batch_stats`` collection when they are given the whole variables.

Both copies raise ``ValueError`` when the two modules differ in the number
of synced tensors or in a pair's shape, as the JAX ``jax.tree.map`` over
two trees does, and check the whole structure before writing anything, so
that a mismatch never leaves a target half copied.
"""

from typing import List, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.models.batch_norm import BatchNorm


def _synced_tensors(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    named = list(module.named_parameters())
    for prefix, m in module.named_modules():
        if isinstance(m, BatchNorm):
            named += [(f"{prefix}.mean", m.mean), (f"{prefix}.var", m.var)]
    return named


def _paired(target: nn.Module, source: nn.Module) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (target, source) tensor pairs; raises ``ValueError`` naming the
    first tensor one side lacks, or else the first pair of other shapes."""
    t_named, s_named = _synced_tensors(target), _synced_tensors(source)
    if len(t_named) != len(s_named):
        side, (name, _) = (("target", t_named[len(s_named)]) if len(t_named) > len(s_named)
                           else ("source", s_named[len(t_named)]))
        raise ValueError(f"the modules differ in structure: target has {len(t_named)} synced tensors, "
                         f"source {len(s_named)}; {side} {name} has no counterpart")
    for (t_name, t), (s_name, s) in zip(t_named, s_named):
        if t.shape != s.shape:
            raise ValueError(f"parameter shapes differ: target {t_name} {tuple(t.shape)}, "
                             f"source {s_name} {tuple(s.shape)}")
    return [(t, s) for (_, t), (_, s) in zip(t_named, s_named)]


@torch.no_grad()
def copy_param(target: nn.Module, source: nn.Module) -> None:
    """Hard copy of every parameter."""
    for t, s in _paired(target, source):
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
    for t, s in _paired(target, source):
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
