"""Tree helpers (counterpart of ``pfrl_tpu/utils/pytree.py``).

A tree is a tensor, ``None``, or a tuple (named or not), list, dict or
dataclass of trees; :func:`tree_map` maps over its tensors and keeps the
rest of its structure.
"""

import dataclasses
from typing import Any, Callable, Sequence

import torch


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the leaves of trees of one structure (``None`` stays)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return type(first)((k, tree_map(fn, *(t[k] for t in trees))) for k in first)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        names = [f.name for f in dataclasses.fields(first) if f.init]
        return dataclasses.replace(first, **{n: tree_map(fn, *(getattr(t, n) for t in trees)) for n in names})
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_replace(obj: Any, **changes: Any) -> Any:
    """``dataclasses.replace``."""
    return dataclasses.replace(obj, **changes)


def tree_where(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """Elementwise select between two trees of one structure. ``cond`` is
    broadcast against each leaf's leading dimensions: a scalar selects whole
    trees, a ``[B]`` bool vector selects rows."""

    def sel(x, y):
        c = cond
        while c.dim() < x.dim():
            c = c[..., None]
        return torch.where(c, x, y)

    return tree_map(sel, a, b)


def tree_select(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """Whole-tree select on a scalar bool."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def tree_stack(trees: Sequence[Any], axis: int = 0) -> Any:
    """Stack a list of trees of one structure along ``axis``."""
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_unstack(tree: Any, axis: int = 0) -> list:
    """Inverse of :func:`tree_stack`: a list of trees."""
    n = tree_leaves(tree)[0].shape[axis]
    return [tree_map(lambda x: x.select(axis, i), tree) for i in range(n)]


def tree_zeros_like_batched(tree: Any, batch: int) -> Any:
    """Zeros with an extra leading ``batch`` dimension per leaf."""
    return tree_map(lambda x: torch.zeros((batch,) + tuple(x.shape), dtype=x.dtype, device=x.device), tree)
