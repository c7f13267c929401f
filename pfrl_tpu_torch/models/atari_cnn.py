"""Nature-DQN torso (counterpart of ``pfrl_tpu/models/atari_cnn.py``).

The public layout is the JAX package's NHWC: inputs are ``[B, 84, 84, 4]``
floats in [0, 1]. The module permutes to NCHW for the convolutions (the
permuted view is channels-last in memory, which cuDNN takes as it is) and
back to NHWC before the flatten, so the first Linear sees flax's (H, W, C)
feature order and the weight converter only transposes kernels. Each layer
computes in the promoted dtype of its input and weights, as flax's do
(:mod:`~pfrl_tpu_torch.models.layers`).
"""

from typing import Dict, Optional

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.models.layers import Conv2d, Linear


class LargeAtariCNN(nn.Module):
    """32x8x8/4, 64x4x4/2, 64x3x3/1, dense 512, ReLU after each."""

    def __init__(
        self,
        n_input_channels: int = 4,
        n_output_channels: int = 512,
        bias: float = 0.1,
        input_hw=(84, 84),
    ):
        super().__init__()
        self.bias = bias
        layers = [(32, 8, 4), (64, 4, 2), (64, 3, 1)]
        convs, c, (h, w) = [], n_input_channels, input_hw
        for features, k, s in layers:
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
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's HWC order
        return torch.relu(self.dense(x))
