"""Additive Gaussian action noise (counterpart of
``pfrl_tpu/explorers/additive_gaussian.py``)."""

import torch

from pfrl_tpu_torch.utils import draws as draw_fns


class AdditiveGaussian:
    """``greedy + scale * normal``, clipped to ``[low, high]`` where a bound
    is given. One ``draws.normal`` of the actions' element count per call."""

    def __init__(self, scale: float, low=None, high=None):
        self.scale = scale
        self.low = low
        self.high = high

    def select_action(self, draws, t: int, greedy_actions: torch.Tensor, action_value=None):
        a = greedy_actions + draw_fns.normal(draws, greedy_actions.shape) * self.scale
        if self.low is not None or self.high is not None:
            a = torch.clamp(a, self.low, self.high)
        return a
