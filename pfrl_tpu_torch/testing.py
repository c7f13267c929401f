"""Test helpers (counterpart of ``pfrl_tpu/testing.py``; reference parity:
pfrl/testing.py).

:func:`torch_assert_allclose` is the reference pfrl's name: an
``assert_allclose`` that first converts tensors, and nested lists and
tuples of them, to numpy. :func:`tree_assert_allclose` compares two
structures of dicts, lists and tuples leaf by leaf, their structure too.
"""

import numpy as np
import torch


def _as_numpy_recursive(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, (list, tuple)):
        return [_as_numpy_recursive(y) for y in x]
    return x


def torch_assert_allclose(actual, desired, *args, **kwargs):
    """``numpy.testing.assert_allclose`` accepting tensors and nested lists
    and tuples of them; ragged nests compare element by element. Dicts are
    refused with a pointer to :func:`tree_assert_allclose`, which checks
    the structure too."""
    if isinstance(actual, dict) or isinstance(desired, dict):
        raise TypeError(
            "torch_assert_allclose does not accept dicts; use "
            "tree_assert_allclose for dict-bearing structures (it also "
            "checks their structure)"
        )
    _assert_allclose_nested(_as_numpy_recursive(actual), _as_numpy_recursive(desired), *args, **kwargs)


def _assert_allclose_nested(actual, desired, *args, **kwargs):
    # Element by element, so that ragged nests (sub-arrays of differing
    # shapes, which np.asarray refuses) still compare.
    a_seq = isinstance(actual, list)
    d_seq = isinstance(desired, list)
    if a_seq or d_seq:
        a = list(actual) if a_seq else [actual]
        d = list(desired) if d_seq else [desired]
        if a_seq and d_seq and len(a) != len(d):
            raise AssertionError(f"length mismatch: {len(a)} vs {len(d)}")
        if not (a_seq and d_seq):
            # One side a scalar or an array, the other a list: broadcast the lone side.
            n = max(len(a), len(d))
            a = a * n if len(a) == 1 else a
            d = d * n if len(d) == 1 else d
        for x, y in zip(a, d):
            _assert_allclose_nested(x, y, *args, **kwargs)
        return
    np.testing.assert_allclose(actual, desired, *args, **kwargs)


def _tree_map(fn, actual, desired, path="tree"):
    """``fn(a, b)`` over the leaves of two structures, which must match:
    ``ValueError`` otherwise, as ``jax.tree.map`` raises."""
    if isinstance(actual, dict):
        if not isinstance(desired, dict) or sorted(actual) != sorted(desired):
            raise ValueError(f"{path}: structures differ: {actual!r} vs {desired!r}")
        for k in sorted(actual):
            _tree_map(fn, actual[k], desired[k], f"{path}[{k!r}]")
    elif isinstance(actual, (list, tuple)):
        if type(desired) is not type(actual) or len(desired) != len(actual):
            raise ValueError(f"{path}: structures differ: {type(actual).__name__} of {len(actual)} vs {desired!r}")
        for i, (a, d) in enumerate(zip(actual, desired)):
            _tree_map(fn, a, d, f"{path}[{i}]")
    elif isinstance(desired, (dict, list, tuple)):
        raise ValueError(f"{path}: structures differ: a leaf vs {type(desired).__name__}")
    else:
        fn(actual, desired)


def tree_assert_allclose(actual, desired, *args, **kwargs):
    """Leaf-wise :func:`torch_assert_allclose` over two structures of dicts,
    lists and tuples whose structure matches."""
    _tree_map(lambda a, b: torch_assert_allclose(a, b, *args, **kwargs), actual, desired)
