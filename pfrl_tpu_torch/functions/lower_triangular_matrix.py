"""Lower-triangular matrices from packed entries (counterpart of
``pfrl_tpu/functions/lower_triangular_matrix.py``): NAF's Cholesky factor.
"""

import torch


def lower_triangular_matrix(diag: torch.Tensor, non_diag: torch.Tensor) -> torch.Tensor:
    """``[B, n, n]`` lower-triangular matrices from ``diag`` ``[B, n]`` and
    the strictly-lower entries ``non_diag`` ``[B, n(n-1)/2]`` in row-major
    order, ``np.tril_indices(n, -1)``'s (which ``torch.tril_indices(n, n,
    -1)`` gives too). For n = 1, ``non_diag`` is empty."""
    b, n = diag.shape
    rows, cols = torch.tril_indices(n, n, -1, device=diag.device)
    out = torch.zeros((b, n, n), dtype=diag.dtype, device=diag.device)
    out[:, rows, cols] = non_diag.to(diag.dtype)
    idx = torch.arange(n, device=diag.device)
    out[:, idx, idx] = diag
    return out
