"""C51 categorical projection (counterpart of ``pfrl_tpu/ops/categorical.py``).

Plain tensor ops, as in the JAX package, where the projection is a one-hot
contraction outside any Pallas kernel.
"""

import torch


def categorical_projection(y: torch.Tensor, y_probs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Project atom values ``y`` with probabilities ``y_probs`` (both
    ``[B, N]``) onto the sorted, evenly spaced support ``z`` ``[N]``.

    Mass goes to the atoms below and above each value in proportion to the
    distance; the ``1 - (bj - low)`` form puts all of it on one atom where a
    value lies exactly on it (``low == up``).
    """
    n_atoms = z.shape[0]
    delta_z = z[1] - z[0]
    v_min, v_max = z[0], z[-1]
    y = torch.clamp(y, v_min, v_max)
    bj = torch.clamp((y - v_min) / delta_z, 0.0, n_atoms - 1)
    low = torch.floor(bj)
    up = torch.ceil(bj)
    w_low = y_probs * (1.0 - (bj - low))  # mass to the floor atom
    w_up = y_probs * (bj - low)           # mass to the ceil atom

    # One-hot contraction [B, source, target], no scatter.
    atoms = torch.arange(n_atoms, dtype=bj.dtype, device=bj.device)
    onehot_low = (low[..., None] == atoms).to(y_probs.dtype)
    onehot_up = (up[..., None] == atoms).to(y_probs.dtype)
    return torch.einsum("bs,bst->bt", w_low, onehot_low) + torch.einsum(
        "bs,bst->bt", w_up, onehot_up
    )
