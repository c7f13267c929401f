"""(state, action)-input Q-functions (counterpart of
``pfrl_tpu/q_functions/state_action_q_functions.py``). Each returns one
value per row, ``q[..., 0]``. Input widths are explicit. The batch-norm and
LSTM variants are not ported yet.
"""

from typing import Callable, Dict, Optional

import torch
from torch import nn

from pfrl_tpu_torch.models.mlp import MLP, scoped_names


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
