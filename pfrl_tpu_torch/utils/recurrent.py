"""Recurrent-state helpers (counterpart of ``pfrl_tpu/utils/recurrent.py``).

A carry is a tensor, or a tuple or list of carries (``()`` for a stateless
branch), with the batch on the leading axis. Sequences are time-major
``[T, B, ...]``; :func:`unroll` is a Python loop over T.
"""

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the tensors of carries of one structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a carry: {type(first).__name__}")


def tree_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return []


def tree_where(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per row of the leading axis, ``a`` where ``mask [B]`` else ``b``."""
    return tree_map(lambda x, y: torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y), a, b)


def mask_recurrent_state_at(state: Any, mask: torch.Tensor, zero_state: Optional[Any] = None) -> Any:
    """Reset the carry's rows where ``mask`` is True (an episode boundary)."""
    if zero_state is None:
        zero_state = tree_map(torch.zeros_like, state)
    return tree_where(mask, zero_state, state)


def stack(trees: Sequence[Any], dim: int = 0) -> Any:
    """Stack a sequence of outputs of one structure: tensors, tuples and
    lists, and dataclasses of tensors (action values, distributions)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees), dim=dim)
    if isinstance(first, (tuple, list)):
        return type(first)(stack(xs, dim) for xs in zip(*trees))
    if dataclasses.is_dataclass(first):
        fields = [f.name for f in dataclasses.fields(first) if f.init]
        return dataclasses.replace(first, **{f: stack([getattr(t, f) for t in trees], dim) for f in fields})
    raise TypeError(f"cannot stack {type(first).__name__}")


def unroll(
    apply_fn: Callable,
    xs: Any,
    initial_state: Any,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[Any, Any]:
    """Run ``apply_fn(x [B, ...], carry) -> (y, carry)`` over time-major
    ``xs`` ``[T, B, ...]`` from ``initial_state``. ``resets`` ``[T, B]``:
    True zeroes the carry's row *before* step t consumes its input.
    Returns ``(ys [T, B, ...], final carry)``."""
    zero_state = tree_map(torch.zeros_like, initial_state)
    carry, ys = initial_state, []
    for t in range(tree_leaves(xs)[0].shape[0]):
        if resets is not None:
            carry = tree_where(resets[t], zero_state, carry)
        y, carry = apply_fn(tree_map(lambda x: x[t], xs), carry)
        ys.append(y)
    return stack(ys), carry


def flatten_sequences_time_first(seqs: Any) -> Any:
    """``[T, B, ...] -> [T * B, ...]``."""
    return tree_map(lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])), seqs)


def detach_recurrent_state(state: Any) -> Any:
    """Stop gradients flowing into a stored carry (truncated BPTT)."""
    return tree_map(torch.Tensor.detach, state)


def get_recurrent_state_at(state: Any, index, detach: bool = False) -> Any:
    out = tree_map(lambda x: x[index], state)
    return detach_recurrent_state(out) if detach else out


def concatenate_recurrent_states(states: Sequence[Any]) -> Any:
    """Stack carries along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *states)
