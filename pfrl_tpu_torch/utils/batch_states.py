"""Observation collation and upload, and the Atari feature map (counterpart
of ``pfrl_tpu/utils/batch_states.py``).

:func:`batch_states` collates a list of observations, each an array or a
structure (tuple, list or dict) of arrays and scalars, leaf by leaf into
numpy, as the JAX package's does. :func:`to_device_like_jax` uploads such
a numpy structure with the dtypes ``jnp.asarray`` gives with x64 off:
64-bit floats and integers become 32-bit (ROADMAP C, F3); every host shell
uploads its observations through it.
"""

from typing import Any, Callable, Sequence

import numpy as np
import torch

# ``jnp.asarray``'s dtype with x64 off, for the dtypes it changes.
_X64_OFF = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
}


def map_structure(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *matching)`` over the leaves of ``tree``, a leaf or a
    tuple, list or dict of them; ``others`` follow ``tree``'s structure
    down to its leaves, where their node (an item shape, say) is passed as
    it is."""
    if isinstance(tree, dict):
        return {k: map_structure(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_structure(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def leaves(tree: Any) -> list:
    """The leaves of a tuple, list or dict structure, in order."""
    out = []
    map_structure(out.append, tree)
    return out


def first_leaf(tree: Any) -> Any:
    """The first leaf of a structure (a batch's leading size, its device)."""
    return leaves(tree)[0]


def jax_dtype(dtype) -> np.dtype:
    """The dtype ``jnp.asarray`` gives a numpy array of ``dtype`` with x64 off."""
    dtype = np.dtype(dtype)
    return _X64_OFF.get(dtype, dtype)


def to_device_like_jax(obs: Any, device) -> Any:
    """A numpy batch, or a structure of them, as tensors on ``device``: one
    copy per leaf, float64 -> float32, int64 -> int32 and uint64 -> uint32
    as ``jnp.asarray`` has them with x64 off; other dtypes unchanged."""

    def leaf(x):
        x = np.asarray(x)
        want = jax_dtype(x.dtype)
        if want != x.dtype:
            x = x.astype(want)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return map_structure(leaf, obs)


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs])


def _collate(features: Sequence[Any]) -> Any:
    first = features[0]
    if isinstance(first, dict):
        return {k: _collate([f[k] for f in features]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_collate([f[i] for f in features]) for i in range(len(first)))
    return _stack(features)


def batch_states(states: Sequence[Any], phi: Callable[[Any], Any] = lambda x: x) -> Any:
    """Collate a sequence of observations (arrays, or tuples, lists or dicts
    of them), applying ``phi`` to each first: numpy, one stacked array per
    leaf (a python int becomes int64, a float float64, as ``np.stack``
    has them). The upload is :func:`to_device_like_jax`."""
    return _collate([phi(s) for s in states])


def atari_phi(x: torch.Tensor) -> torch.Tensor:
    """Dtype-aware Atari feature map: ``uint8 -> float32 / 255``.

    Float input passes through unchanged: the replay gather already
    dequantized it with ``x * (1/255)`` (``fused_dequant_scale``). The two
    ops differ in the last ulp, so each path keeps its own, as the JAX
    package does.
    """
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x
