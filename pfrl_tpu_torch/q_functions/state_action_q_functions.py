"""(state, action)-input Q-functions (counterpart of
``pfrl_tpu/q_functions/state_action_q_functions.py``). Each returns one
value per row, ``q[..., 0]``. Input widths are explicit.

The batch-norm variants take flax's explicit ``train`` argument
(``forward(obs, action, train=True)``: batch statistics, and the running
ones move) over :class:`~pfrl_tpu_torch.models.mlp.MLPBN`. The LSTM variant
follows the recurrent protocol of :mod:`pfrl_tpu_torch.models.recurrent`:
``forward(obs, action, carry, sequence=False) -> (q, (new_carry,))`` and
``initial_carry(batch_size)``.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.models.mlp import MLP, MLPBN, scoped_names
from pfrl_tpu_torch.models.recurrent import LSTMCellModule


class FCSAQFunction(nn.Module):
    """MLP over concat(obs, action) -> scalar Q."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        n_hidden_channels: int = 64,
        n_hidden_layers: int = 2,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        self.mlp = MLP(
            obs_size + action_size, 1, (n_hidden_channels,) * n_hidden_layers,
            nonlinearity=nonlinearity, last_wscale=last_wscale,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([obs, action], dim=-1))[..., 0]


class FCBNSAQFunction(nn.Module):
    """:class:`MLPBN` over concat(obs, action) -> scalar Q."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        n_hidden_channels: int = 64,
        n_hidden_layers: int = 2,
        normalize_input: bool = True,
    ):
        super().__init__()
        self.mlp = MLPBN(
            obs_size + action_size, 1, (n_hidden_channels,) * n_hidden_layers, normalize_input=normalize_input,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLPBN_0", self.mlp)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.mlp(torch.cat([obs, action], dim=-1), train)[..., 0]


class SingleModelStateActionQFunction(nn.Module):
    """Wrap any ``(obs, action) -> Q`` module; a trailing dimension of one
    is dropped."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("model", "model", self.model)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        q = self.model(obs, action)
        return q[..., 0] if q.dim() > obs.dim() - 1 and q.shape[-1] == 1 else q


class FCLateActionSAQFunction(nn.Module):
    """The DDPG paper's architecture: the observation passes through the
    first hidden layer alone, the action joins at the second."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        n_hidden_channels: int = 64,
        n_hidden_layers: int = 2,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        if n_hidden_layers < 1:
            raise ValueError("n_hidden_layers must be at least 1")
        self.nonlinearity = nonlinearity
        self.obs_mlp = MLP(obs_size, n_hidden_channels)
        self.mlp = MLP(
            n_hidden_channels + action_size, 1, (n_hidden_channels,) * (n_hidden_layers - 1),
            nonlinearity=nonlinearity, last_wscale=last_wscale,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.obs_mlp.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return {
            **scoped_names("obs_mlp", "MLP_0", self.obs_mlp),
            **scoped_names("mlp", "MLP_1", self.mlp),
        }

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        h = self.nonlinearity(self.obs_mlp(obs))
        return self.mlp(torch.cat([h, action], dim=-1))[..., 0]


class FCBNLateActionSAQFunction(nn.Module):
    """The late-action architecture with batch normalization on the
    observation's path only: ``MLPBN(hidden_sizes=(), normalize_output=True)``
    and the nonlinearity, then the action joins, never normalized, and an
    :class:`MLP` with ``n_hidden_layers - 1`` hidden layers."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        n_hidden_channels: int = 64,
        n_hidden_layers: int = 2,
        normalize_input: bool = True,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        if n_hidden_layers < 1:
            raise ValueError("n_hidden_layers must be at least 1")
        self.nonlinearity = nonlinearity
        self.obs_mlp = MLPBN(obs_size, n_hidden_channels, normalize_input=normalize_input, normalize_output=True)
        self.mlp = MLP(
            n_hidden_channels + action_size, 1, (n_hidden_channels,) * (n_hidden_layers - 1),
            nonlinearity=nonlinearity, last_wscale=last_wscale,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.obs_mlp.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return {
            **scoped_names("obs_mlp", "MLPBN_0", self.obs_mlp),
            **scoped_names("mlp", "MLP_0", self.mlp),
        }

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = self.nonlinearity(self.obs_mlp(obs, train))
        return self.mlp(torch.cat([h, action], dim=-1))[..., 0]


class FCLSTMSAQFunction(nn.Module):
    """Recurrent (obs, action)-input Q-function: concat -> :class:`MLP`
    (``n_hidden_layers`` hidden layers, ``n_hidden_channels`` out) ->
    nonlinearity -> one LSTM layer -> a linear head. pfrl stubs this class;
    the JAX package's working version is the counterpart. The carry is
    ``((c, h),)``."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        n_hidden_channels: int = 64,
        n_hidden_layers: int = 2,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        self.nonlinearity = nonlinearity
        self.n_hidden_channels = n_hidden_channels
        self.mlp = MLP(
            obs_size + action_size, n_hidden_channels, (n_hidden_channels,) * n_hidden_layers,
            nonlinearity=nonlinearity,
        )
        self.lstm = LSTMCellModule(n_hidden_channels, n_hidden_channels)
        self.head = MLP(n_hidden_channels, 1, last_wscale=last_wscale)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)
        self.lstm.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def flax_names(self) -> Dict[str, Any]:
        return {
            **scoped_names("mlp", "MLP_0", self.mlp),
            **scoped_names("lstm", "LSTMCellModule_0", self.lstm),
            **scoped_names("head", "MLP_1", self.head),
        }

    def initial_carry(self, batch_size: int, device=None) -> Tuple[Any]:
        return (self.lstm.initial_carry(batch_size, device),)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, carry, sequence: bool = False):
        """One step on ``[B, ...]`` inputs, or with ``sequence`` a whole
        time-major window ``[T, B, ...]`` with no resets."""
        h = self.nonlinearity(self.mlp(torch.cat([obs, action], dim=-1)))
        h, new_carry = self.lstm(h, carry[0], sequence=sequence)
        return self.head(h)[..., 0], (new_carry,)
