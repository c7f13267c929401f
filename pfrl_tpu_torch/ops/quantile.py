"""IQN's quantile machinery (counterpart of ``pfrl_tpu/ops/quantile.py``):
the cosine embedding of the taus and the pairwise quantile Huber loss with
its accumulations. Plain tensor ops, as in the JAX package."""

import math
from typing import Optional

import torch

from pfrl_tpu_torch.ops.value_loss import huber_loss


def cosine_basis_functions(x: torch.Tensor, n_basis_functions: int = 64) -> torch.Tensor:
    """``cos(i * pi * x)`` for ``i = 1 .. n``: ``[...] -> [..., n]``. The
    factors ``i * pi`` are rounded to float32 first, as in the JAX package;
    the cosines of arguments up to ``n * pi`` may differ from XLA's by a
    few ulps."""
    i_pi = torch.arange(1, n_basis_functions + 1, dtype=torch.float32, device=x.device) * math.pi
    return torch.cos(x[..., None] * i_pi)


def eltwise_huber_quantile_loss(y: torch.Tensor, t: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Pairwise loss ``[B, N, N']`` of predictions ``y`` ``[B, N]`` at the
    thresholds ``taus`` ``[B, N]`` against targets ``t`` ``[B, N']``:
    ``|tau - 1{t < y}| * huber(y - t)``, the indicator strict."""
    y_, t_, taus_ = y[:, :, None], t[:, None, :], taus[:, :, None]
    indicator = (t_ < y_).to(y.dtype)
    return torch.abs(taus_ - indicator) * huber_loss(y_ - t_)


def _check(batch_accumulator: str) -> None:
    if batch_accumulator not in ("mean", "sum"):
        raise ValueError(f"batch_accumulator must be 'mean' or 'sum', got {batch_accumulator!r}")


def quantile_loss_accumulate(eltwise_loss: torch.Tensor, batch_accumulator: str = "mean") -> torch.Tensor:
    """``[B, N, N']`` to a scalar: the sum over N of the mean over N' (and,
    for "mean", over the batch)."""
    _check(batch_accumulator)
    if batch_accumulator == "sum":
        return torch.sum(torch.mean(eltwise_loss, dim=2))
    return torch.sum(torch.mean(eltwise_loss, dim=(0, 2)))


def weighted_quantile_loss_accumulate(
    eltwise_loss: torch.Tensor, weights: torch.Tensor, batch_accumulator: str = "mean"
) -> torch.Tensor:
    """The per-example loss (sum over N of the mean over N') dotted with the
    PER weights; "mean" divides by the batch size, not by the weights' sum."""
    _check(batch_accumulator)
    per_example = torch.sum(torch.mean(eltwise_loss, dim=2), dim=1)
    loss_sum = torch.dot(per_example, weights)
    if batch_accumulator == "mean":
        return loss_sum / eltwise_loss.shape[0]
    return loss_sum


def quantile_huber_loss(
    y: torch.Tensor,
    t: torch.Tensor,
    taus: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    batch_accumulator: str = "mean",
) -> torch.Tensor:
    """The pairwise loss against the targets held constant, accumulated."""
    el = eltwise_huber_quantile_loss(y, t.detach(), taus)
    if weights is not None:
        return weighted_quantile_loss_accumulate(el, weights, batch_accumulator)
    return quantile_loss_accumulate(el, batch_accumulator)
