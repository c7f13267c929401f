"""Off-policy actor-critic for continuous control: SAC and TD3 on MujocoSim
and DDPG on Pendulum, through ``OffPolicyRunner``.

:func:`make_sac_runner` and :func:`make_td3_runner` are ``bench.py``'s
``bench_sac`` and ``bench_td3`` workloads: 32 lanes of MujocoSim (obs 17,
action 6 in [-1, 1], truncation after 1,000 steps); policy
``MLP(17 -> 256 -> 256 -> 12)`` + squashed-Gaussian head (SAC) or
``MLP(17 -> 256 -> 256 -> 6)`` + tanh + deterministic head with additive
Gaussian noise 0.1 (TD3); twin ``FCSAQFunction(2 x 256)``; optax-semantics
Adam(3e-4) for every network (and SAC's temperature, entropy target -6);
gamma 0.99, tau 5e-3; a 100,000-slot uniform ring that stores ``next_obs``;
one batch-256 update per transition from 1,000 on (32 per scan step); TD3
steps its actor every 2nd update.

:func:`make_ddpg_runner` is ``tools/record_curves.py``'s
``run_ddpg_pendulum``: 16 lanes of
``NormalizeActionSpace(TimeLimit(Pendulum(), 200))``, policy
``MLP(3 -> 64 -> 64 -> 1)`` + tanh, ``FCSAQFunction(2 x 64)``, Adam(1e-3)
twice, additive Gaussian noise 0.1, uniform burn-in actions for the first
1,000 transitions, batch-128 updates every 4 transitions from 1,000 on;
its evaluation is ``EvalLoop(pendulum_env(), runner.core, 10, 201)``.

:func:`make_sac_pendulum_runner` is ``run_sac_pendulum``: the same 16
lanes, policy ``MLP(3 -> 256 -> 256 -> 2)`` + squashed-Gaussian head, twin
``FCSAQFunction(2 x 256)``, Adam(3e-4) for each network and the
temperature (entropy target -1), uniform burn-in actions for the first
1,000 transitions, batch-128 updates every 4 transitions from 1,000 on;
:func:`make_sac_pendulum_bf16_runner` is ``run_sac_pendulum_bf16``, its
``compute_dtype=torch.bfloat16`` twin, the recipe of
``zoo/sac_bf16/pendulum``. Every recipe takes ``compute_dtype`` (the
examples' ``--bf16``; ``None``: float32).
"""

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from pfrl_tpu_torch.agents.ddpg import DDPGCore
from pfrl_tpu_torch.agents.soft_actor_critic import SACCore
from pfrl_tpu_torch.agents.td3 import TD3Core
from pfrl_tpu_torch.env import TorchEnv
from pfrl_tpu_torch.envs.mujoco_sim import MujocoSim
from pfrl_tpu_torch.envs.pendulum import Pendulum
from pfrl_tpu_torch.envs.wrappers import NormalizeActionSpace, TimeLimit
from pfrl_tpu_torch.experiments.runner import OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.additive_gaussian import AdditiveGaussian
from pfrl_tpu_torch.models.mlp import MLP, scoped_names
from pfrl_tpu_torch.optimizers.adam import Adam
from pfrl_tpu_torch.policies import DeterministicHead, SquashedGaussianHead
from pfrl_tpu_torch.q_functions.state_action_q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.draws import uniform_between


class MLPPolicy(nn.Module):
    """``head(squash(MLP(obs)))``: the ``Policy`` that ``bench.py`` and
    ``tools/record_curves.py`` define in flax as a compact wrapper, whose
    parameters sit under ``MLP_0``."""

    def __init__(
        self,
        obs_size: int,
        out_size: int,
        hidden_sizes: Sequence[int],
        head: nn.Module,
        squash: Optional[Callable] = None,
    ):
        super().__init__()
        self.mlp = MLP(obs_size, out_size, hidden_sizes)
        self.head = head
        self.squash = squash

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return scoped_names("mlp", "MLP_0", self.mlp)

    def forward(self, x: torch.Tensor):
        h = self.mlp(x)
        return self.head(h if self.squash is None else self.squash(h))


def squashed_gaussian_policy(obs_size: int, action_size: int, hidden: int) -> MLPPolicy:
    return MLPPolicy(obs_size, 2 * action_size, (hidden, hidden), SquashedGaussianHead(action_size))


def deterministic_policy(obs_size: int, action_size: int, hidden: int) -> MLPPolicy:
    return MLPPolicy(obs_size, action_size, (hidden, hidden), DeterministicHead(), squash=torch.tanh)


def uniform_burnin(action_size: int) -> Callable:
    """Burn-in actions uniform over [-1, 1): one ``draws.uniform`` per call."""
    return lambda draws, batch: uniform_between(draws, -1.0, 1.0, (batch, action_size))


def _sizes(env: TorchEnv):
    return env.observation_space.shape[0], env.action_space.shape[0]


def _runner(env, core, num_envs, capacity, replay_start_size, update_interval, minibatch_size):
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=update_interval,
        n_times_update=1,
        minibatch_size=minibatch_size,
    )
    buffer = ReplayBuffer(capacity, gamma=0.99, num_lanes=num_envs, device=env.device)
    return OffPolicyRunner(env, core, buffer, config, device=env.device)


def make_sac_runner(
    num_envs: int = 32,
    capacity: int = 100_000,
    replay_start_size: int = 1_000,
    update_interval: int = 1,
    minibatch_size: int = 256,
    hidden: int = 256,
    burnin_steps: int = 0,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OffPolicyRunner:
    """SAC at the given sizes (defaults: ``bench_sac``'s) on ``device``
    (default: the CUDA device); ``env`` defaults to ``MujocoSim()``."""
    env = MujocoSim(device=device) if env is None else env
    obs_size, action_size = _sizes(env)
    qf = lambda: FCSAQFunction(obs_size, action_size, hidden, 2)  # noqa: E731
    core = SACCore(
        policy=squashed_gaussian_policy(obs_size, action_size, hidden),
        q_func1=qf(),
        q_func2=qf(),
        policy_optimizer=Adam(3e-4),
        q_func1_optimizer=Adam(3e-4),
        q_func2_optimizer=Adam(3e-4),
        gamma=0.99,
        entropy_target=-float(action_size),
        burnin_action_func=uniform_burnin(action_size) if burnin_steps else None,
        burnin_steps=burnin_steps,
        compute_dtype=compute_dtype,
    )
    return _runner(env, core, num_envs, capacity, replay_start_size, update_interval, minibatch_size)


def make_td3_runner(
    num_envs: int = 32,
    capacity: int = 100_000,
    replay_start_size: int = 1_000,
    update_interval: int = 1,
    minibatch_size: int = 256,
    hidden: int = 256,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OffPolicyRunner:
    """TD3 at the given sizes (defaults: ``bench_td3``'s)."""
    env = MujocoSim(device=device) if env is None else env
    obs_size, action_size = _sizes(env)
    qf = lambda: FCSAQFunction(obs_size, action_size, hidden, 2)  # noqa: E731
    core = TD3Core(
        policy=deterministic_policy(obs_size, action_size, hidden),
        q_func1=qf(),
        q_func2=qf(),
        policy_optimizer=Adam(3e-4),
        q_func1_optimizer=Adam(3e-4),
        q_func2_optimizer=Adam(3e-4),
        explorer=AdditiveGaussian(0.1, low=-1.0, high=1.0),
        gamma=0.99,
        policy_update_delay=2,
        compute_dtype=compute_dtype,
    )
    return _runner(env, core, num_envs, capacity, replay_start_size, update_interval, minibatch_size)


def pendulum_env(device=None) -> TorchEnv:
    return NormalizeActionSpace(TimeLimit(Pendulum(device=device), 200))


def make_ddpg_runner(
    num_envs: int = 16,
    capacity: int = 100_000,
    replay_start_size: int = 1_000,
    update_interval: int = 4,
    minibatch_size: int = 128,
    hidden: int = 64,
    burnin_steps: int = 1_000,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OffPolicyRunner:
    """DDPG at the given sizes (defaults: ``run_ddpg_pendulum``'s);
    ``env`` defaults to the time-limited, action-normalized Pendulum."""
    env = pendulum_env(device) if env is None else env
    obs_size, action_size = _sizes(env)
    core = DDPGCore(
        policy=deterministic_policy(obs_size, action_size, hidden),
        q_func=FCSAQFunction(obs_size, action_size, hidden, 2),
        policy_optimizer=Adam(1e-3),
        q_optimizer=Adam(1e-3),
        explorer=AdditiveGaussian(0.1, low=-1.0, high=1.0),
        gamma=0.99,
        burnin_action_func=uniform_burnin(action_size),
        burnin_steps=burnin_steps,
        compute_dtype=compute_dtype,
    )
    return _runner(env, core, num_envs, capacity, replay_start_size, update_interval, minibatch_size)


def make_sac_pendulum_runner(
    num_envs: int = 16,
    capacity: int = 100_000,
    replay_start_size: int = 1_000,
    update_interval: int = 4,
    minibatch_size: int = 128,
    hidden: int = 256,
    burnin_steps: int = 1_000,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OffPolicyRunner:
    """SAC at the given sizes (defaults: ``run_sac_pendulum``'s); ``env``
    defaults to the time-limited, action-normalized Pendulum."""
    env = pendulum_env(device) if env is None else env
    return make_sac_runner(
        num_envs=num_envs, capacity=capacity, replay_start_size=replay_start_size,
        update_interval=update_interval, minibatch_size=minibatch_size, hidden=hidden,
        burnin_steps=burnin_steps, env=env, compute_dtype=compute_dtype,
    )


def make_sac_pendulum_bf16_runner(**sizes) -> OffPolicyRunner:
    """:func:`make_sac_pendulum_runner` at ``compute_dtype=torch.bfloat16``."""
    return make_sac_pendulum_runner(compute_dtype=torch.bfloat16, **sizes)
