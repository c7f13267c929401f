"""bf16 compute over float32 master parameters (counterpart of
``pfrl_tpu/utils/precision.py``).

Parameters, optimizer state and the loss and target arithmetic stay
float32; the network's forward and backward run in ``compute_dtype`` (e.g.
``torch.bfloat16``) by casting the parameters and the floating inputs at
the apply boundary and the outputs back to float32. The casts are part of
the autograd graph: a cast's backward is an up-cast, so gradients reach the
float32 masters.

This is not ``torch.autocast``: autocast picks a dtype per op from lists
of its own (softmax and reductions in float32, for one), which the JAX
package does not do. Inside the forward every op runs in the promoted dtype
of its inputs, as ``jnp`` and flax's ``promote_dtype`` have it; the layers
do so through :mod:`pfrl_tpu_torch.models.layers`, and :func:`softmax` and
:func:`softplus` spell the JAX functions op by op below float32.

Buffers (the C51 supports) are not cast: the JAX package builds them in the
forward in float32, and they are not parameters there.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def check_compute_dtype(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """``None`` (plain float32) or a floating torch dtype; raises otherwise."""
    if dtype is not None and not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise ValueError(f"compute_dtype must be None or a floating torch dtype, not {dtype!r}")
    return dtype


def map_floating(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every floating tensor of ``tree``: tensors, tuples,
    lists, dicts and dataclasses (the action values and the distributions
    of the port are dataclasses of tensors). Anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_floating(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_floating(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = {f.name: map_floating(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init}
        return dataclasses.replace(tree, **fields)
    return tree


def cast_floating(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """Floating tensors of ``tree`` to ``dtype`` (``None``: ``tree`` as it
    is). uint8 frames, int actions and bool flags pass through."""
    if dtype is None:
        return tree
    return map_floating(lambda x: x if x.dtype == dtype else x.to(dtype), tree)


def cast_to_float32(tree: Any) -> Any:
    """Floating tensors of ``tree`` back to float32."""
    return map_floating(lambda x: x if x.dtype == torch.float32 else x.to(torch.float32), tree)


def apply_cast(module: nn.Module, dtype: Optional[torch.dtype], *args, uncast_argnums=(), **kwargs) -> Any:
    """``module(*args, **kwargs)`` with ``dtype`` compute.

    The module's floating parameters and every floating positional argument
    (but those at ``uncast_argnums``) are cast to ``dtype``; keyword
    arguments and buffers never are. The output comes back float32.
    ``dtype=None`` is the plain call.
    """
    if dtype is None:
        return module(*args, **kwargs)
    params = {name: p.to(dtype) if p.is_floating_point() else p for name, p in module.named_parameters()}
    args = tuple(a if i in uncast_argnums else cast_floating(a, dtype) for i, a in enumerate(args))
    return cast_to_float32(torch.func.functional_call(module, params, args, kwargs))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: ``e = exp(x - max); e / sum(e)``, each op in
    ``x``'s dtype. float32 takes ``torch.softmax``; below float32 the fused
    kernel computes in float32 and rounds once, where JAX rounds each op."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``). float32 takes
    ``F.softplus`` (within half an ulp of it); below float32 JAX's
    ``max(x, 0) + log1p(exp(-|x|))``, each op in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return F.softplus(x)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
