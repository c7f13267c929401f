"""Bound values into [low, high] by tanh (counterpart of
``pfrl_tpu/functions/bound_by_tanh.py``)."""

import torch


def bound_by_tanh(x: torch.Tensor, low, high) -> torch.Tensor:
    """``tanh(x)`` rescaled affinely so that its range is ``[low, high]``,
    elementwise; ``low`` and ``high`` broadcast against ``x``."""
    if low is None or high is None:
        raise ValueError("bound_by_tanh needs both bounds")
    low = torch.as_tensor(low, dtype=x.dtype, device=x.device)
    high = torch.as_tensor(high, dtype=x.dtype, device=x.device)
    scale = (high - low) / 2
    loc = (high + low) / 2
    return torch.tanh(x) * scale + loc
