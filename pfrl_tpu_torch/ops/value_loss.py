"""TD value losses (counterpart of ``pfrl_tpu/ops/value_loss.py``).

``batch_accumulator`` in {"mean", "sum"}: Nature DQN sums over the batch.
"""

import torch


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: quadratic within |x| <= delta, linear outside."""
    abs_x = torch.abs(x)
    quad = 0.5 * x * x
    lin = delta * (abs_x - 0.5 * delta)
    return torch.where(abs_x <= delta, quad, lin)


def _per_sample(y, t, clip_delta: bool, batch_accumulator: str):
    if batch_accumulator not in ("mean", "sum"):
        raise ValueError(f"batch_accumulator must be 'mean' or 'sum', got {batch_accumulator!r}")
    diff = y - t
    return huber_loss(diff) if clip_delta else 0.5 * diff * diff


def compute_value_loss(
    y: torch.Tensor,
    t: torch.Tensor,
    clip_delta: bool = True,
    batch_accumulator: str = "mean",
) -> torch.Tensor:
    per = _per_sample(y, t, clip_delta, batch_accumulator)
    return per.sum() if batch_accumulator == "sum" else per.mean()


def compute_weighted_value_loss(
    y: torch.Tensor,
    t: torch.Tensor,
    weights: torch.Tensor,
    clip_delta: bool = True,
    batch_accumulator: str = "mean",
) -> torch.Tensor:
    """Per-sample-weighted loss for PER: "mean" divides the weighted sum by
    the batch size (the buffer pre-normalizes the weights)."""
    weighted = _per_sample(y, t, clip_delta, batch_accumulator) * weights
    if batch_accumulator == "mean":
        return weighted.sum() / y.shape[0]
    return weighted.sum()
