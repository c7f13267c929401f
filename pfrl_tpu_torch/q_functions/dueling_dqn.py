"""Dueling Q-network heads (counterpart of
``pfrl_tpu/q_functions/dueling_dqn.py``).

Value and advantage streams with mean-subtracted advantages over a
:class:`LargeAtariCNN` torso, which takes the head's ``activation``.
``dense_cls`` lets Rainbow swap in :class:`FactorizedNoisyLinear`. The
advantage layer is built and called before the value layer, as in the
flax modules: flax numbers the scopes in that order (``..._0`` advantage,
``..._1`` value) and noise is consumed in that order.
"""

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.action_value import (
    DiscreteActionValue,
    DistributionalDiscreteActionValue,
)
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.models.layers import Linear
from pfrl_tpu_torch.utils.precision import softmax


class Dense(Linear):
    """The default stream layer: Chainer-default weights, zero bias. It
    takes and ignores the draw source, like any layer without noise."""

    flax_scope = "Dense"

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        initializers.chainer_default_(self, 0.0, generator)

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        return super().forward(x)


def support(v_min: float, v_max: float, n_atoms: int) -> torch.Tensor:
    """``jnp.linspace(v_min, v_max, n_atoms, dtype=float32)`` to the bit, as
    XLA compiles it on the CPU: with ``r = 1 / (n - 1)`` in float32, atom
    ``i`` is ``fma(i, v_max * r, v_min * (1 - i * r))`` and the last atom is
    ``v_max``. ``torch.linspace`` rounds otherwise, and the categorical
    projection floors ``(y - v_min) / delta_z``: an ulp in an atom moves
    mass between neighbours wherever a return lands on an atom."""
    f32, f64 = np.float32, np.float64
    i = np.arange(n_atoms - 1, dtype=f32)
    r = f32(1.0) / f32(n_atoms - 1)
    low = f32(v_min) * (f32(1.0) - i * r)
    # float32 products are exact in float64: one rounding, as an fma has.
    z = (i.astype(f64) * f64(f32(v_max) * r) + low.astype(f64)).astype(f32)
    return torch.from_numpy(np.concatenate([z, [f32(v_max)]]).astype(f32))


class _Dueling(nn.Module):
    """Torso and the two streams; subclasses combine them."""

    def __init__(
        self,
        advantage_features: int,
        value_features: int,
        dense_cls: Optional[Callable[[int, int], nn.Module]],
        frame_shape: Tuple[int, int, int],
        activation: Callable,
    ):
        super().__init__()
        dense = dense_cls or Dense
        h, w, c = frame_shape
        self.torso = LargeAtariCNN(n_input_channels=c, n_output_channels=512, input_hw=(h, w),
                                   activation=activation)
        width = self.torso.dense.out_features
        self.advantage = dense(width, advantage_features)
        self.value = dense(width, value_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.torso.reset_parameters(generator)
        self.advantage.reset_parameters(generator)
        self.value.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        """Submodule name -> flax scope path; flax numbers the two streams
        of one layer class ``Cls_0`` and ``Cls_1`` in construction order."""
        names = {f"torso.{k}": f"LargeAtariCNN_0/{v}" for k, v in self.torso.flax_names().items()}
        names["advantage"] = f"{self.advantage.flax_scope}_0"
        names["value"] = f"{self.value.flax_scope}_1"
        return names

    def _streams(self, x: torch.Tensor, draws) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.torso(x)
        a = self.advantage(h, draws)
        v = self.value(h, draws)
        return a, v


class DuelingDQN(_Dueling):
    """``Q = V + A - mean_a A``."""

    def __init__(self, n_actions: int, dense_cls=None, frame_shape=(84, 84, 4), activation: Callable = torch.relu):
        super().__init__(n_actions, 1, dense_cls, frame_shape, activation)

    def forward(self, x: torch.Tensor, draws=None) -> DiscreteActionValue:
        a, v = self._streams(x, draws)
        return DiscreteActionValue(q_values=v + (a - a.mean(dim=-1, keepdim=True)))


class DistributionalDuelingDQN(_Dueling):
    """Distributional dueling head for Rainbow: per-action logits over
    ``n_atoms`` atoms, a softmax over the atoms."""

    def __init__(
        self,
        n_actions: int,
        n_atoms: int,
        v_min: float,
        v_max: float,
        dense_cls=None,
        frame_shape=(84, 84, 4),
        activation: Callable = torch.relu,
    ):
        super().__init__(n_actions * n_atoms, n_atoms, dense_cls, frame_shape, activation)
        self.n_actions = n_actions
        self.n_atoms = n_atoms
        self.register_buffer("z_values", support(v_min, v_max, n_atoms))

    def forward(self, x: torch.Tensor, draws=None) -> DistributionalDiscreteActionValue:
        a, v = self._streams(x, draws)
        a = a.reshape(-1, self.n_actions, self.n_atoms)
        logits = v[:, None, :] + (a - a.mean(dim=1, keepdim=True))
        return DistributionalDiscreteActionValue(
            q_dist=softmax(logits, dim=-1), z_values=self.z_values
        )
