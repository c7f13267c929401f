"""The implicit quantile Q-functions of IQN (counterpart of
``pfrl_tpu/q_functions/quantile_q_functions.py``), feed-forward and
recurrent.

``quantiles(x, tau) = f(psi(x) * phi(tau))`` with ``phi = ReLU(Dense(cos
basis of tau))`` and ``f`` a Dense head, both Chainer-default with zero
biases. torch has no lazy shapes: the width of ``psi``'s features is given.
"""

from typing import Dict, Optional

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.action_value import QuantileDiscreteActionValue
from pfrl_tpu_torch.models.layers import Linear
from pfrl_tpu_torch.models.mlp import scoped_names
from pfrl_tpu_torch.ops.quantile import cosine_basis_functions


class ImplicitQuantileQFunction(nn.Module):
    """``psi``: any module ``obs -> [B, feature_size]`` (its flax scope is
    ``psi``); the taus ``[B, n_taus]`` give quantiles ``[B, n_taus, A]``."""

    def __init__(self, psi: nn.Module, feature_size: int, n_actions: int, n_basis_functions: int = 64):
        super().__init__()
        self.psi = psi
        self.n_basis_functions = n_basis_functions
        self.phi = Linear(n_basis_functions, feature_size)
        self.head = Linear(feature_size, n_actions)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.psi.reset_parameters(generator)
        initializers.chainer_default_(self.phi, generator=generator)
        initializers.chainer_default_(self.head, generator=generator)

    def flax_names(self) -> Dict[str, str]:
        names = scoped_names("psi", "psi", self.psi)
        names.update(phi="Dense_0", head="Dense_1")
        return names

    def forward(self, x: torch.Tensor, taus: torch.Tensor, draws=None) -> QuantileDiscreteActionValue:
        h = self.psi(x)
        phi = torch.relu(self.phi(cosine_basis_functions(taus, self.n_basis_functions)))
        return QuantileDiscreteActionValue(quantiles=self.head(h[:, None, :] * phi))


class RecurrentImplicitQuantileQFunction(nn.Module):
    """Recurrent IQN: ``psi(x, carry) -> ([B, feature_size], carry)``
    carries the memory (its flax scope is ``psi``); the tau embedding and
    the head are those of :class:`ImplicitQuantileQFunction`.
    ``forward(x, taus, carry)`` gives ``(quantiles [B, n_taus, A], carry)``;
    with ``sequence=True`` the inputs are time-major ``[T, B, ...]`` (the
    taus ``[T, B, n_taus]``) and ``psi`` unrolls them itself."""

    def __init__(self, psi: nn.Module, feature_size: int, n_actions: int, n_basis_functions: int = 64):
        super().__init__()
        self.psi = psi
        self.n_basis_functions = n_basis_functions
        self.phi = Linear(n_basis_functions, feature_size)
        self.head = Linear(feature_size, n_actions)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.psi.reset_parameters(generator)
        initializers.chainer_default_(self.phi, generator=generator)
        initializers.chainer_default_(self.head, generator=generator)

    def flax_names(self) -> Dict[str, str]:
        names = scoped_names("psi", "psi", self.psi)
        names.update(phi="Dense_0", head="Dense_1")
        return names

    def initial_carry(self, batch_size: int, device=None):
        return self.psi.initial_carry(batch_size, device)

    def forward(self, x: torch.Tensor, taus: torch.Tensor, carry, sequence: bool = False):
        h, new_carry = self.psi(x, carry, sequence=sequence)
        phi = torch.relu(self.phi(cosine_basis_functions(taus, self.n_basis_functions)))
        return QuantileDiscreteActionValue(quantiles=self.head(h[..., None, :] * phi)), new_carry
