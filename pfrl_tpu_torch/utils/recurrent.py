"""Recurrent-state helpers (counterpart of ``pfrl_tpu/utils/recurrent.py``).

A carry is a tensor, or a tuple or list of carries (``()`` for a stateless
branch), with the batch on the leading axis. Sequences are time-major
``[T, B, ...]``; :func:`unroll` is a Python loop over T.
"""

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_stack, tree_where  # noqa: F401  (re-exported)


def mask_recurrent_state_at(state: Any, mask: torch.Tensor, zero_state: Optional[Any] = None) -> Any:
    """Reset the carry's rows where ``mask`` is True (an episode boundary)."""
    if zero_state is None:
        zero_state = tree_map(torch.zeros_like, state)
    return tree_where(mask, zero_state, state)


def stack(trees: Sequence[Any], dim: int = 0) -> Any:
    """Stack a sequence of outputs of one structure: tensors, tuples and
    lists, and dataclasses of tensors (action values, distributions)."""
    return tree_stack(trees, dim)


def one_step_forward(apply_fn: Callable, x: Any, recurrent_state: Any) -> Tuple[Any, Any]:
    """One recurrent step, ``apply_fn(x [B, ...], carry) -> (y, carry)``
    (the JAX function's ``apply_fn(params, x, carry)``; here the parameters
    live in the module)."""
    return apply_fn(x, recurrent_state)


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
    return tree_stack(states, 0)
