"""Dense sum and min trees (counterpart of ``pfrl_tpu/replay/sum_tree.py``).

A tree over a power-of-two ``capacity`` is one ``[2 * capacity]`` float32
tensor, leaves at ``[capacity, 2 * capacity)``, root at 1. ``update`` and
``update_min`` write **in place** (and return the tree): leaves first, then
every ancestor level, each parent recomputed from both children, so parents
stay consistent when siblings change together. With *duplicate* leaf
indices in one update, which value lands is unspecified in both packages
(JAX ``.at[].set``, torch ``index_put_``).
"""

import math

import torch


def tree_capacity(n: int) -> int:
    """Round up to a power of two."""
    return 1 << max(1, math.ceil(math.log2(n)))


def _levels(tree: torch.Tensor) -> int:
    return int(math.log2(tree.shape[0] // 2))


def init_tree(capacity: int, device=None) -> torch.Tensor:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    return torch.zeros(2 * capacity, dtype=torch.float32, device=device)


def init_min_tree(capacity: int, device=None) -> torch.Tensor:
    """Unwritten leaves are +inf so they never win the min."""
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    return torch.full((2 * capacity,), math.inf, dtype=torch.float32, device=device)


def update(tree: torch.Tensor, leaf_indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set leaves and repair all ancestor sums, in place."""
    nodes = leaf_indices + tree.shape[0] // 2
    tree[nodes] = values
    for _ in range(_levels(tree)):
        nodes = nodes >> 1
        tree[nodes] = tree[2 * nodes] + tree[2 * nodes + 1]
    return tree


def update_min(tree: torch.Tensor, leaf_indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set leaves and repair all ancestor minima, in place."""
    nodes = leaf_indices + tree.shape[0] // 2
    tree[nodes] = values
    for _ in range(_levels(tree)):
        nodes = nodes >> 1
        tree[nodes] = torch.minimum(tree[2 * nodes], tree[2 * nodes + 1])
    return tree


def total(tree: torch.Tensor) -> torch.Tensor:
    return tree[1]


def min_value(tree: torch.Tensor) -> torch.Tensor:
    return tree[1]


def get(tree: torch.Tensor, leaf_indices: torch.Tensor) -> torch.Tensor:
    return tree[leaf_indices + tree.shape[0] // 2]


def sample_from_prefix(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Root-to-leaf descent: for each target u in [0, total) the leaf i with
    ``sum(leaves[:i]) <= u < sum(leaves[:i+1])``, int32."""
    nodes = torch.ones_like(targets, dtype=torch.int32)
    u = targets
    for _ in range(_levels(tree)):
        left = tree[2 * nodes]
        go_right = u >= left
        u = torch.where(go_right, u - left, u)
        nodes = 2 * nodes + go_right.to(torch.int32)
    return nodes - tree.shape[0] // 2


def stratified_targets(total_mass: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One target per equal-mass segment of ``[0, total_mass)``.

    ``u`` is the ``[B]`` uniform draw (the JAX function draws it from its
    key). The segment bounds are ``jnp.linspace(0, 1, B + 1)``'s float32
    values: ``iota / B``, then 1.
    """
    b = u.shape[0]
    bounds = torch.cat([
        torch.arange(b, dtype=torch.float32, device=u.device) / b,
        torch.ones(1, dtype=torch.float32, device=u.device),
    ])
    targets = (bounds[:-1] + u * (bounds[1:] - bounds[:-1])) * total_mass
    # Guard the open upper end (u == 1 would fall off the last leaf).
    return torch.minimum(targets, total_mass * (1.0 - 1e-7))


def stratified_sample(tree: torch.Tensor, draws, batch_size: int) -> torch.Tensor:
    """int32 leaves by stratified prefix-sum sampling: one target per
    equal-mass segment from one ``draws.uniform(batch_size)``, then the
    tree descent (``pfrl_tpu/replay/sum_tree.py::stratified_sample``)."""
    return sample_from_prefix(tree, stratified_targets(total(tree), draws.uniform(batch_size)))
