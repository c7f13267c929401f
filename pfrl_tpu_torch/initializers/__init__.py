"""Weight initializers (counterpart of ``pfrl_tpu/initializers``).

Chainer's default, which pfrl trained with, is an *untruncated* LeCun
normal: std = sqrt(scale / fan_in). torch's layer default
(kaiming-uniform) is another distribution, so every layer of the port is
re-initialized through these functions.
"""

from typing import Optional

import torch
from torch import nn

# flax's truncated LeCun normal rescales by the std of a unit normal cut at
# +-2 so the result keeps variance scale / fan_in.
_TRUNCATED_STD = 0.87962566103423978


def fan_in(weight: torch.Tensor) -> int:
    """Input fan of a Linear ``[out, in]`` or Conv ``[out, in, kh, kw]`` weight."""
    n = weight.shape[1]
    for s in weight.shape[2:]:
        n *= s
    return n


@torch.no_grad()
def lecun_normal_(
    weight: torch.Tensor, scale: float = 1.0, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Untruncated LeCun normal (``chainer_default_w``)."""
    std = (scale / fan_in(weight)) ** 0.5
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def truncated_lecun_normal_(
    weight: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax ``nn.Dense``'s default kernel init: LeCun normal cut at 2 std."""
    std = (1.0 / fan_in(weight)) ** 0.5 / _TRUNCATED_STD
    return nn.init.trunc_normal_(
        weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
    )


@torch.no_grad()
def chainer_default_(
    layer: nn.Module, bias: float = 0.0, generator: Optional[torch.Generator] = None
) -> nn.Module:
    """Chainer-default weights and a constant bias on a Conv/Linear layer."""
    lecun_normal_(layer.weight, generator=generator)
    layer.bias.fill_(bias)
    return layer
