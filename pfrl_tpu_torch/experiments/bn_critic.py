"""The batch-norm (state, action) critics at the DDPG example's widths.

``examples/mujoco/reproduction/ddpg/train_ddpg.py:98,106`` builds its critic
over HalfCheetah's 17 observations and 6 actions with 400 channels in 2
layers and trains it on batches of 100; here the critic is
:class:`~pfrl_tpu_torch.q_functions.FCBNLateActionSAQFunction` or
:class:`~pfrl_tpu_torch.q_functions.FCBNSAQFunction` in place of
``FCSAQFunction``. :func:`train_step` is one train-mode step of Adam(1e-3)
on the mean squared error to a fixed target: the forward moves the
BatchNorms' running statistics, as flax's ``mutable=["batch_stats"]``
does. ``chip_smoke.py`` (phase 23) runs it on the card against the CPU, and
``profile_slice --config bn-late-action-q-halfcheetah-100`` splits it into
forward, backward and optimizer.
"""

from typing import Tuple

import numpy as np
import torch

from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCBNLateActionSAQFunction, FCBNSAQFunction

OBS, ACT, CHANNELS, LAYERS, BATCH = 17, 6, 400, 2, 100
CRITICS = {"late-action": FCBNLateActionSAQFunction, "concat": FCBNSAQFunction}


def make_critic(kind: str = "late-action", seed: int = 0, device=None) -> torch.nn.Module:
    """The critic ``kind`` with weights drawn from ``seed``, on ``device``
    (default: the CUDA device)."""
    critic = CRITICS[kind](OBS, ACT, CHANNELS, LAYERS)
    critic.reset_parameters(torch.Generator().manual_seed(seed))
    return critic.to(resolve_device(device))


def make_batches(steps: int, seed: int = 0, batch: int = BATCH) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``steps`` batches of observations ``[steps, batch, 17]``, actions in
    ``[-1, 1]`` ``[steps, batch, 6]`` and the fixed target
    ``sin(sum(obs)) + mean(action)`` ``[steps, batch]``, float32, from
    ``seed``."""
    rs = np.random.RandomState(seed)
    obs = (rs.normal(size=(steps, batch, OBS)) * 2.0 + 0.5).astype(np.float32)
    act = np.tanh(rs.normal(size=(steps, batch, ACT))).astype(np.float32)
    target = (np.sin(obs.sum(-1)) + act.mean(-1)).astype(np.float32)
    return obs, act, target


def make_optimizer(critic: torch.nn.Module):
    optimizer = Adam(1e-3)
    return optimizer, optimizer.init(list(critic.parameters()))


def loss(critic, obs: torch.Tensor, act: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The train-mode forward (the running statistics move) and the mean
    squared error to ``target``."""
    q = critic(obs, act, train=True)
    return torch.mean((q - target) ** 2)


def train_step(critic, optimizer, opt_state, obs, act, target) -> torch.Tensor:
    """One step: forward, backward, Adam. Returns the loss."""
    params = list(critic.parameters())
    value = loss(critic, obs, act, target)
    grads = torch.autograd.grad(value, params)
    optimizer.update(params, grads, opt_state)
    return value.detach()
