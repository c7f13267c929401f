"""Global-norm gradient clipping (counterpart of
``pfrl_tpu/utils/clip_l2_grad_norm.py``; reference parity:
pfrl/utils/clip_l2_grad_norm.py:5-38).

The function form, for code that clips explicitly: the norm is a Python
``sum`` of per-leaf sums of squares, taken in ``jax.tree.leaves`` order
(dict keys sorted), and every leaf is scaled by ``min(1, max_norm / (norm +
1e-6))``. This is not ``optimizers.ClipByGlobalNorm`` (optax's
``clip_by_global_norm``, which leaves gradients within the bound untouched
and divides by the norm itself, ROADMAP C17).
"""

from typing import Any

import torch


def _leaves(tree: Any) -> list:
    """The tensors of a dict, list or tuple structure in ``jax.tree.leaves``
    order: a dict's items by sorted key, ``None`` no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _scaled(tree: Any, scale: torch.Tensor) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _scaled(v, scale) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scaled(x, scale) for x in tree)
    return tree * scale


def clip_l2_grad_norm(grads: Any, max_norm: float) -> Any:
    """``grads`` (a tensor, or a dict, list or tuple structure of them)
    scaled so that its global L2 norm is at most about ``max_norm``; a new
    structure, ``grads`` unchanged."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in _leaves(grads)))
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    return _scaled(grads, scale)
