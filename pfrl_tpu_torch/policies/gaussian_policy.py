"""Gaussian policy heads (counterpart of ``pfrl_tpu/policies/gaussian_policy.py``)."""

from typing import Callable, Dict

import torch
from torch import nn

from pfrl_tpu_torch.distributions import Normal, SquashedNormal
from pfrl_tpu_torch.utils.precision import softplus


class GaussianHeadWithStateIndependentCovariance(nn.Module):
    """Mean from the input; the log-std is a learned parameter that does
    not depend on the state: one value (``"spherical"``) or one per action
    dimension (``"diagonal"``)."""

    def __init__(self, action_size: int, var_type: str = "spherical", init_log_std: float = 0.0):
        super().__init__()
        if var_type not in ("spherical", "diagonal"):
            raise ValueError(f"var_type: {var_type!r}")
        self.init_log_std = init_log_std
        self.log_std = nn.Parameter(torch.empty(1 if var_type == "spherical" else action_size))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.log_std.fill_(self.init_log_std)

    def flax_names(self) -> Dict[str, str]:
        """A bare parameter leaf: neither ``kernel`` nor ``bias``."""
        return {"log_std": "log_std"}

    def forward(self, mean: torch.Tensor) -> Normal:
        return Normal(loc=mean, scale=torch.exp(self.log_std).expand(mean.shape))


class GaussianHeadWithDiagonalCovariance(nn.Module):
    """The input is (mean, pre-scale) concatenated; the variance is
    ``var_func(pre-scale) + 1e-8``; the default is ``jax.nn.softplus``'s
    arithmetic in every dtype (:func:`~pfrl_tpu_torch.utils.precision.softplus`)."""

    def __init__(self, var_func: Callable = softplus):
        super().__init__()
        self.var_func = var_func

    def forward(self, mean_and_var: torch.Tensor) -> Normal:
        mean, pre = torch.chunk(mean_and_var, 2, dim=-1)
        return Normal(loc=mean, scale=torch.sqrt(self.var_func(pre) + 1e-8))


class GaussianHeadWithFixedCovariance(nn.Module):
    """A fixed scalar std."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, mean: torch.Tensor) -> Normal:
        return Normal(loc=mean, scale=torch.full_like(mean, self.scale))


class SquashedGaussianHead(nn.Module):
    """Tanh-squashed Gaussian head for SAC: the input is
    ``[B, 2 * action_size]`` (mean, then log-std clipped to [-20, 2])."""

    def __init__(self, action_size: int, log_std_min: float = -20.0, log_std_max: float = 2.0):
        super().__init__()
        self.action_size = action_size
        self.log_std_min = log_std_min
        self.log_std_max = log_std_max

    def forward(self, out: torch.Tensor) -> SquashedNormal:
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, self.log_std_min, self.log_std_max)
        return SquashedNormal(loc=mean, scale=torch.exp(log_std))
