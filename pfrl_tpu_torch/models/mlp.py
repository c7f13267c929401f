"""MLP building block (counterpart of ``pfrl_tpu/models/mlp.py::MLP``).

Chainer-default init (untruncated LeCun normal weights, zero biases); the
last layer's weights are scaled by ``last_wscale`` (variance scale
``last_wscale**2``) and its bias set to ``last_bias_init`` when given.
torch has no lazy shapes, so the input width is explicit. ``MLPBN`` is not
ported yet.
"""

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.models.layers import Linear


class MLP(nn.Module):
    def __init__(
        self,
        in_size: int,
        out_size: int,
        hidden_sizes: Sequence[int] = (),
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
        last_bias_init: Optional[float] = None,
    ):
        super().__init__()
        sizes = [in_size, *hidden_sizes, out_size]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.nonlinearity = nonlinearity
        self.last_wscale = last_wscale
        self.last_bias_init = last_bias_init
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers[:-1]:
            initializers.chainer_default_(layer, generator=generator)
        last = self.layers[-1]
        initializers.lecun_normal_(last.weight, scale=self.last_wscale**2, generator=generator)
        last.bias.fill_(0.0 if self.last_bias_init is None else self.last_bias_init)

    def flax_names(self) -> Dict[str, str]:
        """flax numbers the Dense layers of one compact scope in call order."""
        return {f"layers.{i}": f"Dense_{i}" for i in range(len(self.layers))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.nonlinearity(layer(x))
        return self.layers[-1](x)


def scoped_names(prefix: str, scope: str, module: nn.Module) -> Dict[str, str]:
    """``module.flax_names()`` one level down: the submodule named ``prefix``
    here is the flax scope ``scope`` there."""
    def under(v):
        return [f"{scope}/{p}" for p in v] if isinstance(v, (list, tuple)) else f"{scope}/{v}"

    return {f"{prefix}.{k}": under(v) for k, v in module.flax_names().items()}
