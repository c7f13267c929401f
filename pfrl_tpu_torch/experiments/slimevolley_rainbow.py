"""``examples/slimevolley/train_rainbow.py`` at the example's own settings:
data-efficient Rainbow over a host env.

:class:`DistributionalDuelingMLPHead` is the example's head
(``train_rainbow.py:62-85``): ReLU(MLP(obs -> 512 -> 512)) split in two
halves, a noisy advantage stream (``n_actions * 51`` atoms, mean-centred
over the actions) and a noisy value stream (51), ``FactorizedNoisyLinear``
at sigma scale 0.5, and a softmax over the atoms of [-1, 1]
(:func:`~pfrl_tpu_torch.q_functions.dueling_dqn.support`, C8/C24).
:func:`make_rainbow_agent` is its ``CategoricalDoubleDQN`` over a
``PrioritizedReplayBuffer`` of 10^6 transitions (2^20 leaves: the
prefix-sample kernel draws each minibatch on the card), alpha 0.5, beta
0.4 annealed over ``steps``, 3-step returns at gamma 0.98;
``ConstantEpsilonGreedy(0.0)`` (the noisy layers explore), Adam(1e-4, eps
1.5e-4), batch-32 updates every transition from 1,600 on, and a hard
target sync every 2,000.

:func:`make_env` is the example's: ``--torch-env`` gives the port's
CartPole, limited to its 500 steps, on the CPU behind ``HostTorchEnv``
(the example's ``--jax-env`` backend); otherwise ``slimevolleygym``'s
``SlimeVolley-v0`` through legacy ``gym``, with
:class:`MultiBinaryAsDiscreteAction`, or a ``RuntimeError`` naming what is
missing. :func:`run` is the example's ``main``.
"""

import argparse
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch.action_value import DistributionalDiscreteActionValue
from pfrl_tpu_torch.agents.categorical_dqn import CategoricalDoubleDQN
from pfrl_tpu_torch.env import Env
from pfrl_tpu_torch.envs.cartpole import CartPole
from pfrl_tpu_torch.envs.host_adapter import HostTorchEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.env_cli import add_env_backend_args
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation
from pfrl_tpu_torch.explorers.epsilon_greedy import ConstantEpsilonGreedy
from pfrl_tpu_torch.models.mlp import MLP, scoped_names
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.dueling_dqn import support
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from pfrl_tpu_torch.utils.precision import softmax


class MultiBinaryAsDiscreteAction(Env):
    """A ``MultiBinary(n)`` action space as ``Discrete(2**n)``
    (``train_rainbow.py:32-59``): bit ``i`` of the action index is the
    ``i``-th binary action. The inner space is told by its class's name, so
    neither gym nor slimevolleygym is imported here."""

    def __init__(self, env):
        if type(env.action_space).__name__ != "MultiBinary":
            raise TypeError(f"needs a MultiBinary action space, not {env.action_space!r}")
        self.env = env
        self.n_bits = int(env.action_space.n)
        self.action_space = spaces.Discrete(2**self.n_bits)
        self.observation_space = env.observation_space

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step([(int(action) >> i) % 2 for i in range(self.n_bits)])

    def close(self):
        self.env.close()

    def seed(self, seed=None):
        return self.env.seed(seed)


class DistributionalDuelingMLPHead(nn.Module):
    """See the module docstring. flax's scopes: ``MLP_0``, then
    ``FactorizedNoisyDense_0`` (advantage) and ``_1`` (value), called, and
    drawing their noise, in that order."""

    def __init__(self, obs_size: int, n_actions: int, n_atoms: int = 51, v_min: float = -1.0, v_max: float = 1.0,
                 hidden: int = 512, sigma_scale: float = 0.5):
        super().__init__()
        self.n_actions = n_actions
        self.n_atoms = n_atoms
        self.mlp = MLP(obs_size, hidden, (hidden,))
        half = hidden // 2
        self.advantage = FactorizedNoisyLinear(half, n_actions * n_atoms, sigma_scale)
        self.value = FactorizedNoisyLinear(hidden - half, n_atoms, sigma_scale)
        self.register_buffer("z_values", support(v_min, v_max, n_atoms))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)
        self.advantage.reset_parameters(generator)
        self.value.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        names = scoped_names("mlp", "MLP_0", self.mlp)
        names.update(advantage="FactorizedNoisyDense_0", value="FactorizedNoisyDense_1")
        return names

    def forward(self, x: torch.Tensor, draws=None) -> DistributionalDiscreteActionValue:
        h_a, h_v = torch.chunk(torch.relu(self.mlp(x)), 2, dim=-1)
        a = self.advantage(h_a, draws).reshape(-1, self.n_actions, self.n_atoms)
        a = a - torch.mean(a, dim=1, keepdim=True)
        v = self.value(h_v, draws)[:, None, :]
        return DistributionalDiscreteActionValue(q_dist=softmax(a + v, dim=-1), z_values=self.z_values)


def make_rainbow_agent(
    obs_size: int,
    n_actions: int,
    steps: int = 2 * 10**6,
    gamma: float = 0.98,
    replay_start_size: int = 1600,
    capacity: int = 10**6,
    compute_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
    draws=None,
    target_update_interval: int = 2000,
) -> CategoricalDoubleDQN:
    """The example's agent (``train_rainbow.py:128-151``); ``steps`` is the
    run's length, over which beta anneals."""
    return CategoricalDoubleDQN(
        DistributionalDuelingMLPHead(obs_size, n_actions),
        Adam(1e-4, eps=1.5e-4),
        PrioritizedReplayBuffer(capacity, alpha=0.5, beta0=0.4, betasteps=steps, num_steps=3, gamma=gamma,
                                device=device),
        gamma,
        ConstantEpsilonGreedy(0.0, n_actions),
        replay_start_size=replay_start_size,
        minibatch_size=32,
        update_interval=1,
        target_update_interval=target_update_interval,
        compute_dtype=compute_dtype,
        seed=seed,
        device=device,
        draws=draws,
    )


def cartpole_env(seed: int) -> HostTorchEnv:
    """The example's ``--jax-env`` backend on the port: ``HostJaxEnv(TimeLimit(CartPole()), seed=seed)``."""
    return HostTorchEnv(TimeLimit(CartPole(device="cpu")), seed=seed)


def make_env(args, seed: int):
    if args.torch_env:
        return cartpole_env(seed)
    try:
        import gym
        import slimevolleygym  # noqa: F401  (registers SlimeVolley-v0)
    except ImportError as e:
        raise RuntimeError(
            f"slimevolleygym unavailable ({e}); pass --torch-env to train the in-repo CartPole explicitly"
        ) from e
    from pfrl_tpu_torch.wrappers.misc import CastObservationToFloat32

    env = gym.make("SlimeVolley-v0")
    env.seed(seed)
    return MultiBinaryAsDiscreteAction(CastObservationToFloat32(env))


def run(argv=None, device=None):
    """The example's ``main``: returns ``(agent, (agent, history))`` after
    training, or ``(agent, stats)`` with ``--demo``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    add_env_backend_args(parser)
    parser.add_argument("--steps", type=int, default=2 * 10**6)
    parser.add_argument("--gamma", type=float, default=0.98)
    parser.add_argument("--replay-start-size", type=int, default=1600)
    parser.add_argument("--eval-interval", type=int, default=100_000)
    parser.add_argument("--outdir", default="results/slimevolley_rainbow")
    parser.add_argument("--load", metavar="PATH", default=None, help="a directory the shell's save wrote")
    parser.add_argument("--demo", action="store_true", help="evaluate the (loaded) agent and exit")
    args = parser.parse_args(argv)

    env = make_env(args, args.seed)
    eval_env = make_env(args, args.seed + 100)
    agent = make_rainbow_agent(
        int(np.prod(env.observation_space.shape)), env.action_space.n, steps=args.steps, gamma=args.gamma,
        replay_start_size=args.replay_start_size, compute_dtype=torch.bfloat16 if args.bf16 else None,
        seed=args.seed, device=device,
    )
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return agent, stats
    return agent, train_agent_with_evaluation(
        agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=10, eval_interval=args.eval_interval,
        outdir=args.outdir, eval_env=eval_env,
    )


if __name__ == "__main__":
    run()
