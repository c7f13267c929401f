"""The implicit quantile Q-function of IQN (counterpart of
``pfrl_tpu/q_functions/quantile_q_functions.py``; the recurrent one is not
ported yet).

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
