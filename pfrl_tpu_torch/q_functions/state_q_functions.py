"""State-input Q-functions (counterpart of
``pfrl_tpu/q_functions/state_q_functions.py``): the discrete ones and
NAF's quadratic one for continuous actions.

Input widths are explicit. Each module takes the draw source of the DQN
cores' forward and ignores it: none of these has noise of its own.
"""

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from pfrl_tpu_torch.action_value import (
    DiscreteActionValue,
    DistributionalDiscreteActionValue,
    QuadraticActionValue,
)
from pfrl_tpu_torch.functions.lower_triangular_matrix import lower_triangular_matrix
from pfrl_tpu_torch.models.mlp import MLP, scoped_names
from pfrl_tpu_torch.q_functions.dueling_dqn import support
from pfrl_tpu_torch.utils.precision import softmax


class DiscreteActionValueHead(nn.Module):
    """[B, A] raw Q-values -> DiscreteActionValue."""

    def forward(self, q: torch.Tensor) -> DiscreteActionValue:
        return DiscreteActionValue(q_values=q)


class FCStateQFunctionWithDiscreteAction(nn.Module):
    """MLP Q-function: ``obs_size -> n_hidden_channels x n_hidden_layers ->
    n_actions``, Chainer-default init."""

    def __init__(
        self,
        obs_size: int,
        n_actions: int,
        n_hidden_layers: int = 2,
        n_hidden_channels: int = 64,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        self.mlp = MLP(
            obs_size, n_actions, (n_hidden_channels,) * n_hidden_layers,
            nonlinearity=nonlinearity, last_wscale=last_wscale,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, x: torch.Tensor, draws=None) -> DiscreteActionValue:
        return DiscreteActionValue(q_values=self.mlp(x))


class DistributionalFCStateQFunctionWithDiscreteAction(nn.Module):
    """C51 MLP Q-function: ``[B, A, n_atoms]`` logits, a softmax over the
    atoms, on the support ``jnp.linspace(v_min, v_max, n_atoms)`` that the
    flax module builds in its forward (rebuilt to the bit by
    :func:`~pfrl_tpu_torch.q_functions.dueling_dqn.support`)."""

    def __init__(
        self,
        obs_size: int,
        n_actions: int,
        n_atoms: int,
        v_min: float,
        v_max: float,
        n_hidden_layers: int = 2,
        n_hidden_channels: int = 64,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        self.n_actions = n_actions
        self.n_atoms = n_atoms
        self.mlp = MLP(
            obs_size, n_actions * n_atoms, (n_hidden_channels,) * n_hidden_layers,
            nonlinearity=nonlinearity, last_wscale=last_wscale,
        )
        self.register_buffer("z_values", support(v_min, v_max, n_atoms))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, x: torch.Tensor, draws=None) -> DistributionalDiscreteActionValue:
        logits = self.mlp(x).reshape(x.shape[0], self.n_actions, self.n_atoms)
        return DistributionalDiscreteActionValue(q_dist=softmax(logits, dim=-1), z_values=self.z_values)


class SingleModelStateQFunctionWithDiscreteAction(nn.Module):
    """Wraps any ``x -> [B, A]`` module; its flax scope is ``model``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("model", "model", self.model)

    def forward(self, x: torch.Tensor, draws=None) -> DiscreteActionValue:
        return DiscreteActionValue(q_values=self.model(x))


class DistributionalSingleModelStateQFunctionWithDiscreteAction(nn.Module):
    """Wraps any ``x -> [B, A, n_atoms]`` module of probabilities over the
    fixed atoms ``z_values`` (float32, as ``jnp.asarray(z, float32)``)."""

    def __init__(self, model: nn.Module, z_values: Sequence[float]):
        super().__init__()
        self.model = model
        self.register_buffer("z_values", torch.tensor(tuple(z_values), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("model", "model", self.model)

    def forward(self, x: torch.Tensor, draws=None) -> DistributionalDiscreteActionValue:
        return DistributionalDiscreteActionValue(q_dist=self.model(x), z_values=self.z_values)


class FCQuadraticStateQFunction(nn.Module):
    """NAF's quadratic Q-function (Gu et al. 2016): an MLP ``obs_size ->
    n_hidden_channels x n_hidden_layers -> 1 + 2d + d(d-1)/2`` gives ``v``,
    ``mu``, the log of the diagonal of a Cholesky factor ``L`` and its
    strictly-lower entries (row-major); ``mat = L L^T``, and ``mu`` is
    ``tanh(mu) * scale + center`` of the action bounds when ``scale_mu``.
    The bounds are float32 buffers (constants of the flax forward, never
    cast) and clip the greedy action. flax's scope: ``MLP_0``."""

    def __init__(
        self,
        n_input_channels: int,
        n_dim_action: int,
        n_hidden_channels: int,
        n_hidden_layers: int,
        action_space_low: Sequence[float],
        action_space_high: Sequence[float],
        scale_mu: bool = True,
    ):
        super().__init__()
        d = n_dim_action
        self.n_dim_action = d
        self.scale_mu = scale_mu
        self.mlp = MLP(n_input_channels, 1 + 2 * d + d * (d - 1) // 2, (n_hidden_channels,) * n_hidden_layers)
        self.register_buffer("low", torch.tensor(tuple(action_space_low), dtype=torch.float32))
        self.register_buffer("high", torch.tensor(tuple(action_space_high), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, x: torch.Tensor, draws=None) -> QuadraticActionValue:
        d = self.n_dim_action
        out = self.mlp(x)
        v = out[:, 0]
        mu = out[:, 1 : 1 + d]
        diag = torch.exp(out[:, 1 + d : 1 + 2 * d])
        non_diag = out[:, 1 + 2 * d :]
        if self.scale_mu:
            scale = (self.high - self.low) / 2.0
            center = (self.high + self.low) / 2.0
            mu = torch.tanh(mu) * scale + center
        tril = lower_triangular_matrix(diag, non_diag)
        mat = torch.einsum("bij,bkj->bik", tril, tril)  # L L^T
        return QuadraticActionValue(mu=mu, mat=mat, v=v, min_action=self.low, max_action=self.high)
