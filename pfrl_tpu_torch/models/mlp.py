"""MLP building blocks (counterpart of ``pfrl_tpu/models/mlp.py``).

Chainer-default init (untruncated LeCun normal weights, zero biases); the
last layer's weights are scaled by ``last_wscale`` (variance scale
``last_wscale**2``) and its bias set to ``last_bias_init`` when given.
torch has no lazy shapes, so the input width is explicit.

``MLPBN`` adds flax-exact batch normalization
(:class:`~pfrl_tpu_torch.models.batch_norm.BatchNorm`): on the input, after
each hidden Dense (before the nonlinearity) and, if asked, on the output.
``forward(x, train=True)`` keeps flax's explicit ``train`` argument.
"""

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.models.batch_norm import BatchNorm
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


class MLPBN(nn.Module):
    """BatchNorm on the input, then Dense -> BatchNorm -> nonlinearity per
    hidden layer, the last Dense, then BatchNorm on the output if asked."""

    def __init__(
        self,
        in_size: int,
        out_size: int,
        hidden_sizes: Sequence[int] = (),
        normalize_input: bool = True,
        normalize_output: bool = False,
        nonlinearity: Callable = torch.relu,
        last_wscale: float = 1.0,
    ):
        super().__init__()
        sizes = [in_size, *hidden_sizes, out_size]
        self.input_bn = BatchNorm(in_size) if normalize_input else None
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.hidden_bns = nn.ModuleList(BatchNorm(h) for h in hidden_sizes)
        self.output_bn = BatchNorm(out_size) if normalize_output else None
        self.nonlinearity = nonlinearity
        self.last_wscale = last_wscale
        self.reset_parameters()

    def batch_norm_names(self):
        """The BatchNorms' names in call order, which is flax's numbering."""
        named = [("input_bn", self.input_bn), *((f"hidden_bns.{i}", bn) for i, bn in enumerate(self.hidden_bns)),
                 ("output_bn", self.output_bn)]
        return [name for name, bn in named if bn is not None]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers[:-1]:
            initializers.chainer_default_(layer, generator=generator)
        last = self.layers[-1]
        initializers.lecun_normal_(last.weight, scale=self.last_wscale**2, generator=generator)
        last.bias.fill_(0.0)
        for name in self.batch_norm_names():
            self.get_submodule(name).reset_parameters()

    def flax_names(self) -> Dict[str, str]:
        """flax numbers Dense and BatchNorm separately, each in call order:
        the input BatchNorm is ``BatchNorm_0``, and without it the first
        hidden layer's is."""
        names = {f"layers.{i}": f"Dense_{i}" for i in range(len(self.layers))}
        names.update({name: f"BatchNorm_{i}" for i, name in enumerate(self.batch_norm_names())})
        return names

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.input_bn is not None:
            x = self.input_bn(x, train)
        for layer, bn in zip(self.layers[:-1], self.hidden_bns):
            x = self.nonlinearity(bn(layer(x), train))
        x = self.layers[-1](x)
        if self.output_bn is not None:
            x = self.output_bn(x, train)
        return x


def scoped_names(prefix: str, scope: str, module: nn.Module) -> Dict[str, str]:
    """``module.flax_names()`` one level down: the submodule named ``prefix``
    here is the flax scope ``scope`` there."""
    def under(v):
        return [f"{scope}/{p}" for p in v] if isinstance(v, (list, tuple)) else f"{scope}/{v}"

    return {f"{prefix}.{k}": under(v) for k, v in module.flax_names().items()}
