"""The discrete value family on the time-limited CartPole, through
``OffPolicyRunner``: the recipes of ``tools/record_curves.py`` and the JAX
package's "hello world", ``examples/gym/train_dqn_cartpole.py``.

Every ``make_*`` returns ``(runner, eval_loop)`` at the JAX package's
widths, on the CUDA device unless given ``device="cpu"``. The first five
run 32 lanes of ``TimeLimit(CartPole(), 500)`` with one batch-64 update per
4 transitions (8 per scan step) from 1,024 on, hard target syncs every
1,024, a 100,000-slot ring, gamma 0.99, linear epsilon-greedy 1 -> 0.05
over 50,000 transitions (Rainbow: none beyond its noise), and evaluate
with ``EvalLoop`` 10 x 501:

- :func:`make_dqn_cartpole_runner` (``run_dqn_cartpole``): FC 4 -> 100 ->
  100 -> 2, ``DQNCore``, Adam(1e-3) after clipping the global norm at 10;
- :func:`make_c51_cartpole_runner` (``run_c51_cartpole``): the
  distributional FC with 51 atoms on [0, 500], ``CategoricalDQNCore``,
  Adam(1e-3);
- :func:`make_rainbow_cartpole_runner` (``run_rainbow_cartpole``):
  :class:`RainbowCartPoleHead`, ``CategoricalDoubleDQNCore``, Adam(1e-3,
  eps 1.5e-4), ``ConstantEpsilonGreedy(0)``, 3-step prioritized replay
  (alpha 0.5, beta 0.4 annealed over 300,000 samples): it samples through
  the prefix-sample kernel;
- :func:`make_al_cartpole_runner` (``run_al_cartpole``): the DQN recipe
  with ``ALCore`` (alpha 0.9);
- :func:`make_iqn_cartpole_runner` (``run_iqn_cartpole``): psi = ReLU(MLP
  4 -> 100 -> 64), 64 cosine bases, ``IQNCore`` with N = N' = K = 32,
  Adam(1e-3).

:func:`make_dqn_cartpole_example_runner` is the example's defaults: 128
lanes of ``TimeLimit(CartPole())``, FC 4 -> 128 -> 128 -> 2, Adam(1e-3),
epsilon 1 -> 0.05 over half of 200,000 transitions, one batch-128 update
per 32 transitions (4 per scan step) from 1,000 on, syncs every 2,000, and
``EvalLoop`` 16 x 500. Its ``compute_dtype`` is the example's ``--bf16``.

:func:`make_dqn_cartpole_bf16_runner` is ``run_dqn_cartpole_bf16``, the
recipe of the ``zoo/dqn_bf16/cartpole`` checkpoint: the DQN recipe with
``compute_dtype=torch.bfloat16``; ``record_curves.py`` seeds it with 3
(``runner.init(DQN_BF16_SEED)``).

Every recipe takes ``compute_dtype`` (``None``: float32). Widths are
arguments (``hidden``; IQN's ``feature_size`` and ``n_taus``)
and so are the ring and cadence (``**sizes``: any key of
:data:`CURVE_SIZES` or :data:`EXAMPLE_SIZES`), so that tests run them
small; the recipes' values are the defaults. ``TimeLimit(CartPole())`` is
the 500-step limit.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.agents.al import ALCore
from pfrl_tpu_torch.agents.categorical_dqn import CategoricalDoubleDQNCore, CategoricalDQNCore
from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.agents.iqn import IQNCore
from pfrl_tpu_torch.env import TorchEnv
from pfrl_tpu_torch.experiments.onpolicy import time_limited_cartpole
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.experiments.slimevolley_rainbow import DistributionalDuelingMLPHead
from pfrl_tpu_torch.explorers.epsilon_greedy import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models.mlp import MLP, scoped_names
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm
from pfrl_tpu_torch.q_functions.quantile_q_functions import ImplicitQuantileQFunction
from pfrl_tpu_torch.q_functions.state_q_functions import (
    DistributionalFCStateQFunctionWithDiscreteAction,
    FCStateQFunctionWithDiscreteAction,
)
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from pfrl_tpu_torch.replay.uniform import ReplayBuffer

OBS, ACTIONS = 4, 2
Recipe = Tuple[OffPolicyRunner, EvalLoop]


class RainbowCartPoleHead(DistributionalDuelingMLPHead):
    """``run_rainbow_cartpole``'s ``RainbowHead``: ReLU(MLP(4 -> hidden ->
    hidden)) split in two halves; the first feeds a noisy advantage stream
    (``n_actions * n_atoms``, mean-centred over the actions), the second a
    noisy value stream (``n_atoms``), both at sigma scale 0.5; a softmax
    over the atoms of ``[0, 500]``. flax's scopes: ``MLP_0``, then
    ``FactorizedNoisyDense_0`` (advantage) and ``_1`` (value), called, and
    drawing their noise, in that order."""

    def __init__(self, hidden: int = 128, n_atoms: int = 51, sigma_scale: float = 0.5):
        super().__init__(OBS, ACTIONS, n_atoms, 0.0, 500.0, hidden, sigma_scale)


class ReLUMLP(nn.Module):
    """``run_iqn_cartpole``'s ``Psi``: ReLU(MLP(in -> hidden -> out))."""

    def __init__(self, in_size: int, out_size: int, hidden: int):
        super().__init__()
        self.mlp = MLP(in_size, out_size, (hidden,))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.mlp(x))


# The cadence and ring the ``record_curves`` recipes share (``sizes``
# overrides any of them).
CURVE_SIZES = dict(num_envs=32, capacity=100_000, replay_start_size=1_024, update_interval=4,
                   target_update_interval=1_024, minibatch_size=64)
EXAMPLE_SIZES = dict(num_envs=128, capacity=100_000, replay_start_size=1_000, update_interval=32,
                     target_update_interval=2_000, minibatch_size=128)


def _recipe(core, env: Optional[TorchEnv], device, sizes: dict, eval_loop=(10, 501),
            buffer_cls=ReplayBuffer, **buffer_kw) -> Recipe:
    env = time_limited_cartpole(device) if env is None else env
    sizes = dict(sizes)
    num_envs, capacity = sizes.pop("num_envs"), sizes.pop("capacity")
    buffer = buffer_cls(capacity, gamma=0.99, num_lanes=num_envs, device=env.device, **buffer_kw)
    runner = OffPolicyRunner(env, core, buffer, RunnerConfig(num_envs=num_envs, **sizes), device=env.device)
    return runner, EvalLoop(env, core, *eval_loop, device=env.device)


def _epsilon(decay_steps: int) -> LinearDecayEpsilonGreedy:
    return LinearDecayEpsilonGreedy(1.0, 0.05, decay_steps, ACTIONS)


def _fc(hidden: int) -> FCStateQFunctionWithDiscreteAction:
    return FCStateQFunctionWithDiscreteAction(OBS, ACTIONS, n_hidden_layers=2, n_hidden_channels=hidden)


def make_dqn_cartpole_runner(hidden: int = 100, decay_steps: int = 50_000, env: Optional[TorchEnv] = None,
                             device=None, compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    core = DQNCore(model=_fc(hidden), optimizer=ClipByGlobalNorm(10.0, Adam(1e-3)),
                   explorer=_epsilon(decay_steps), gamma=0.99, compute_dtype=compute_dtype)
    return _recipe(core, env, device, {**CURVE_SIZES, **sizes})


DQN_BF16_SEED = 3  # ``run_dqn_cartpole_bf16``'s seed


def make_dqn_cartpole_bf16_runner(**kwargs) -> Recipe:
    """:func:`make_dqn_cartpole_runner` at ``compute_dtype=torch.bfloat16``."""
    return make_dqn_cartpole_runner(compute_dtype=torch.bfloat16, **kwargs)


def make_c51_cartpole_runner(hidden: int = 100, decay_steps: int = 50_000, env: Optional[TorchEnv] = None,
                             device=None, compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    model = DistributionalFCStateQFunctionWithDiscreteAction(
        OBS, ACTIONS, n_atoms=51, v_min=0.0, v_max=500.0, n_hidden_layers=2, n_hidden_channels=hidden)
    core = CategoricalDQNCore(model=model, optimizer=Adam(1e-3), explorer=_epsilon(decay_steps), gamma=0.99,
                              compute_dtype=compute_dtype)
    return _recipe(core, env, device, {**CURVE_SIZES, **sizes})


def make_rainbow_cartpole_runner(hidden: int = 128, betasteps: float = 300_000, env: Optional[TorchEnv] = None,
                                 device=None, compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    core = CategoricalDoubleDQNCore(
        model=RainbowCartPoleHead(hidden), optimizer=Adam(1e-3, eps=1.5e-4),
        explorer=ConstantEpsilonGreedy(0.0, ACTIONS), gamma=0.99,  # the noisy layers explore
        compute_dtype=compute_dtype,
    )
    return _recipe(core, env, device, {**CURVE_SIZES, **sizes}, buffer_cls=PrioritizedReplayBuffer,
                   alpha=0.5, beta0=0.4, betasteps=betasteps, num_steps=3)


def make_al_cartpole_runner(hidden: int = 100, decay_steps: int = 50_000, env: Optional[TorchEnv] = None,
                            device=None, compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    core = ALCore(model=_fc(hidden), optimizer=ClipByGlobalNorm(10.0, Adam(1e-3)),
                  explorer=_epsilon(decay_steps), gamma=0.99, alpha=0.9, compute_dtype=compute_dtype)
    return _recipe(core, env, device, {**CURVE_SIZES, **sizes})


def make_iqn_cartpole_runner(hidden: int = 100, feature_size: int = 64, n_taus: int = 32,
                             decay_steps: int = 50_000, env: Optional[TorchEnv] = None, device=None,
                             compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    model = ImplicitQuantileQFunction(ReLUMLP(OBS, feature_size, hidden), feature_size, ACTIONS,
                                      n_basis_functions=64)
    core = IQNCore(model=model, optimizer=Adam(1e-3), explorer=_epsilon(decay_steps), gamma=0.99,
                   compute_dtype=compute_dtype, quantile_thresholds_N=n_taus, quantile_thresholds_N_prime=n_taus, quantile_thresholds_K=n_taus)
    return _recipe(core, env, device, {**CURVE_SIZES, **sizes})


def make_dqn_cartpole_example_runner(hidden: int = 128, steps: int = 200_000, env: Optional[TorchEnv] = None,
                                     device=None, compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    """``steps`` is the run's length (``--steps``): epsilon decays over half."""
    core = DQNCore(model=_fc(hidden), optimizer=Adam(1e-3), explorer=_epsilon(steps // 2), gamma=0.99,
                   compute_dtype=compute_dtype)
    return _recipe(core, env, device, {**EXAMPLE_SIZES, **sizes}, eval_loop=(16, 500))


# ``--config`` name -> recipe, for the tools that run them by name.
RECIPES = {
    "dqn-cartpole": make_dqn_cartpole_runner,
    "c51-cartpole": make_c51_cartpole_runner,
    "rainbow-cartpole": make_rainbow_cartpole_runner,
    "al-cartpole": make_al_cartpole_runner,
    "iqn-cartpole": make_iqn_cartpole_runner,
    "dqn-cartpole-example": make_dqn_cartpole_example_runner,
}
