"""Factorized NoisyNet linear layer (counterpart of
``pfrl_tpu/models/noisy_linear.py``).

The flax layer draws its noise from the ``'noise'`` rng stream on every
call. Here the noise comes from the draw source handed down the forward
(:mod:`pfrl_tpu_torch.utils.draws`): ``eps_in`` first, then ``eps_out``,
fresh on every forward, both per-parameter draws (under a mesh every rank
takes the same noise, at act time and in the update).

The noise is float32, as the JAX layer draws it. Under bf16 parameters
``w_mu + w_sigma * outer(...)`` therefore promotes to float32, and so does
the product with the input: a noisy layer computes in float32 whatever the
compute dtype, as the flax layer does. Only the deterministic branch
computes in the parameters' dtype.
"""

from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.models.layers import promoted
from pfrl_tpu_torch.utils.draws import per_parameter


def _f(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.sqrt(torch.abs(x))


class FactorizedNoisyLinear(nn.Module):
    """``y = x @ (w_mu + w_sigma * outer(f(eps_out), f(eps_in))).T
    + b_mu + b_sigma * f(eps_out)`` with weights stored ``[out, in]``.

    Init as the JAX layer: both ``mu`` uniform in ``+-sqrt(3 / fan_in)``,
    both ``sigma`` the constant ``sigma_scale / sqrt(fan_in)``.
    """

    flax_scope = "FactorizedNoisyDense"

    def __init__(self, in_features: int, out_features: int, sigma_scale: float = 0.4):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.sigma_scale = sigma_scale
        self.w_mu = nn.Parameter(torch.empty(out_features, in_features))
        self.b_mu = nn.Parameter(torch.empty(out_features))
        self.w_sigma = nn.Parameter(torch.empty(out_features, in_features))
        self.b_sigma = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = (3.0 / self.in_features) ** 0.5
        self.w_mu.uniform_(-bound, bound, generator=generator)
        self.b_mu.uniform_(-bound, bound, generator=generator)
        sigma0 = self.sigma_scale / self.in_features**0.5
        self.w_sigma.fill_(sigma0)
        self.b_sigma.fill_(sigma0)

    def forward(self, x: torch.Tensor, draws=None, deterministic: bool = False) -> torch.Tensor:
        if deterministic:
            x, w_mu, b_mu = promoted(x, self.w_mu, self.b_mu)
            return x @ w_mu.T + b_mu
        if draws is None:
            raise ValueError("a noisy layer needs a draw source unless deterministic=True")
        # Per-parameter draws: every rank of a mesh takes the same noise.
        eps_in = _f(per_parameter(draws, "normal", self.in_features))
        eps_out = _f(per_parameter(draws, "normal", self.out_features))
        w = self.w_mu + self.w_sigma * torch.outer(eps_out, eps_in)
        b = self.b_mu + self.b_sigma * eps_out
        x, w, b = promoted(x, w, b)
        return x @ w.T + b


def to_factorized_noisy(module_cls: Any = None, sigma_scale: float = 0.4) -> Callable[[int, int], FactorizedNoisyLinear]:
    """A ``dense_cls`` factory ``(in_features, out_features) ->``
    :class:`FactorizedNoisyLinear` at ``sigma_scale``, for the models that
    take one (``NatureQ``, the dueling heads). ``module_cls``, the layer
    class being replaced, is accepted for the JAX signature and unused."""
    del module_cls

    def factory(in_features: int, out_features: int) -> FactorizedNoisyLinear:
        return FactorizedNoisyLinear(in_features, out_features, sigma_scale=sigma_scale)

    return factory
