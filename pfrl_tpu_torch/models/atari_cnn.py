"""Atari CNN torsos (counterpart of ``pfrl_tpu/models/atari_cnn.py``).

The public layout is the JAX package's NHWC: inputs are ``[B, 84, 84, C]``
floats in [0, 1]. The module permutes to NCHW for the convolutions (the
permuted view is channels-last in memory, which cuDNN takes as it is) and
back to NHWC before the flatten, so the first Linear sees flax's (H, W, C)
feature order and the weight converter only transposes kernels. Each layer
computes in the promoted dtype of its input and weights, as flax's do
(:mod:`~pfrl_tpu_torch.models.layers`). Every layer has Chainer's default
weights and a constant bias, VALID padding and ``activation`` after it
(``torch.relu`` by default; any callable, as the flax modules' field).
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.models.layers import Conv2d, Linear


class _AtariCNN(nn.Module):
    """Convolutions ``(features, kernel, stride)``, then one dense layer;
    the flax scopes are ``Conv_<i>`` and ``Dense_0``."""

    convs_spec: Sequence[Tuple[int, int, int]] = ()

    def __init__(self, n_input_channels: int, n_output_channels: int, bias: float, input_hw,
                 activation: Callable):
        super().__init__()
        self.bias = bias
        self.activation = activation
        convs, c, (h, w) = [], n_input_channels, input_hw
        for features, k, s in self.convs_spec:
            convs.append(Conv2d(c, features, k, stride=s))
            c, h, w = features, (h - k) // s + 1, (w - k) // s + 1
        self.convs = nn.ModuleList(convs)
        self.dense = Linear(h * w * c, n_output_channels)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (*self.convs, self.dense):
            initializers.chainer_default_(layer, self.bias, generator)

    def flax_names(self) -> Dict[str, str]:
        """Submodule name -> flax scope name, for :mod:`pfrl_tpu_torch.convert`."""
        names = {f"convs.{i}": f"Conv_{i}" for i in range(len(self.convs))}
        names["dense"] = "Dense_0"
        return names

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs:
            x = self.activation(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's HWC order
        return self.activation(self.dense(x))


class LargeAtariCNN(_AtariCNN):
    """The Nature-DQN torso: 32x8x8/4, 64x4x4/2, 64x3x3/1, dense 512."""

    convs_spec = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, n_input_channels: int = 4, n_output_channels: int = 512, bias: float = 0.1,
                 input_hw=(84, 84), activation: Callable = torch.relu):
        super().__init__(n_input_channels, n_output_channels, bias, input_hw, activation)


class SmallAtariCNN(_AtariCNN):
    """The NIPS'13 DQN torso: 16x8x8/4, 32x4x4/2, dense 256."""

    convs_spec = ((16, 8, 4), (32, 4, 2))

    def __init__(self, n_input_channels: int = 4, n_output_channels: int = 256, bias: float = 0.1,
                 input_hw=(84, 84), activation: Callable = torch.relu):
        super().__init__(n_input_channels, n_output_channels, bias, input_hw, activation)
