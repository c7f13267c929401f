"""``examples/gym/train_categorical_dqn_gym.py``, both of its backends: C51
with the distributional FC Q-function (51 atoms, 2 x 100).

- The device runner (``--env cartpole``): :func:`make_c51_gym_runner`, the
  500-step CartPole on the support [0, 500], ``CategoricalDQNCore``,
  Adam(1e-3), epsilon 1 -> 0.05 over half of ``steps``, 32 lanes, a
  10^5-slot ring, a batch-64 update per 32 transitions from 1,024 on, a
  hard target sync every 2,048 and ``EvalLoop`` 10 x 500 (the script's
  ``--update-per`` and the rest of its defaults; not the ``record_curves``
  recipe of ``cartpole_value``).
- The host mode (any other ``--env``, ``:39-96``): :func:`make_c51_agent`,
  the ``CategoricalDQN`` shell on ``CastObservationToFloat32`` of the env
  with the support ``[--v-min, --v-max]``, a 10^5-slot ring, an update per
  transition, the same epsilon, replay start and sync, through
  ``train_agent_with_evaluation`` with 10 evaluation episodes.
  ``env_factory(seed)`` replaces ``make_gymnasium_env(--env)``.

:func:`run` is the script's ``main``.
"""

import argparse
from typing import Callable, Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.categorical_dqn import CategoricalDQN, CategoricalDQNCore
from pfrl_tpu_torch.experiments import dqn_gym
from pfrl_tpu_torch.experiments.demo_cli import add_demo_args
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.state_q_functions import DistributionalFCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer

ENVS = {"cartpole": (dqn_gym.ENVS["cartpole"], 0.0, 500.0)}


def _q_function(obs_size: int, n_actions: int, n_atoms: int, v_min: float, v_max: float):
    return DistributionalFCStateQFunctionWithDiscreteAction(obs_size, n_actions, n_atoms, v_min, v_max,
                                                            n_hidden_layers=2, n_hidden_channels=100)


def make_c51_gym_runner(env_name: str = "cartpole", steps: int = 200_000, n_atoms: int = 51, lr: float = 1e-3,
                        device=None, compute_dtype: Optional[torch.dtype] = None, env=None,
                        **sizes) -> Tuple[OffPolicyRunner, EvalLoop]:
    """The device runner of ``--env env_name`` and its ``EvalLoop`` 10 x 500."""
    make_env, v_min, v_max = ENVS[env_name]
    env = make_env(device) if env is None else env
    n_actions = env.action_space.n
    core = CategoricalDQNCore(
        model=_q_function(env.observation_space.shape[0], n_actions, n_atoms, v_min, v_max), optimizer=Adam(lr),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.05, steps // 2, n_actions), gamma=0.99,
        compute_dtype=compute_dtype)
    sizes = {**dqn_gym.RUNNER_SIZES, **sizes}
    num_envs = sizes.pop("num_envs")
    buffer = ReplayBuffer(10**5, gamma=0.99, num_lanes=num_envs, device=env.device)
    runner = OffPolicyRunner(env, core, buffer, RunnerConfig(num_envs=num_envs, **sizes), device=env.device)
    return runner, EvalLoop(env, core, 10, 500, device=env.device)


def make_c51_agent(obs_size: int, n_actions: int, steps: int = 200_000, n_atoms: int = 51, v_min: float = 0.0,
                   v_max: float = 500.0, lr: float = 1e-3, replay_start_size: int = 1_024,
                   minibatch_size: int = 64, target_update_interval: int = 2_048,
                   compute_dtype: Optional[torch.dtype] = None, seed: int = 0, device=None,
                   draws=None) -> CategoricalDQN:
    """The host mode's shell (``:39-78``)."""
    return CategoricalDQN(
        _q_function(obs_size, n_actions, n_atoms, v_min, v_max), Adam(lr),
        ReplayBuffer(10**5, gamma=0.99, device=device), 0.99,
        LinearDecayEpsilonGreedy(1.0, 0.05, steps // 2, n_actions), replay_start_size=replay_start_size,
        minibatch_size=minibatch_size, update_interval=1, target_update_interval=target_update_interval,
        seed=seed, compute_dtype=compute_dtype, device=device, draws=draws,
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="cartpole",
                   help="'cartpole' for the device runner, or any gymnasium env id with a discrete action space")
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--n-atoms", type=int, default=51)
    p.add_argument("--v-min", type=float, default=0.0, help="return-support lower bound (gymnasium backend)")
    p.add_argument("--v-max", type=float, default=500.0, help="return-support upper bound (gymnasium backend)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--replay-start-size", type=int, default=1024)
    p.add_argument("--update-per", type=int, default=32)
    p.add_argument("--target-update-interval", type=int, default=2048)
    p.add_argument("--minibatch-size", type=int, default=64)
    p.add_argument("--eval-interval", type=int, default=50_000)
    p.add_argument("--outdir", default="results/c51_gym")
    add_demo_args(p)
    return p


def run_gymnasium(args, env_factory: Optional[Callable] = None, device=None):
    """The host mode: returns ``(agent, stats)`` with ``--demo``, else
    ``(agent, (agent, history))`` from the driver."""
    from pfrl_tpu_torch.wrappers.misc import CastObservationToFloat32

    factory = env_factory or dqn_gym._gymnasium_env(args.env)

    def make_env(seed):
        return CastObservationToFloat32(factory(seed))

    env = make_env(args.seed)
    agent = make_c51_agent(
        env.observation_space.shape[0], env.action_space.n, args.steps, args.n_atoms, args.v_min, args.v_max,
        args.lr, args.replay_start_size, args.minibatch_size, args.target_update_interval,
        compute_dtype=torch.bfloat16 if args.bf16 else None, seed=args.seed, device=device)
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=make_env(args.seed + 100), agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return agent, stats
    return agent, train_agent_with_evaluation(
        agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=10, eval_interval=args.eval_interval,
        outdir=args.outdir, eval_env=make_env(args.seed + 100))


def run(argv: Optional[Sequence[str]] = None, device=None, env_factory: Optional[Callable] = None):
    """The script's ``main``: the device runner for ``cartpole`` (``(runner,
    state)``; its ``--n-atoms`` and ``--lr`` are the recipe's), else
    :func:`run_gymnasium`."""
    args = parser().parse_args(argv)
    if args.env not in ENVS:
        return run_gymnasium(args, env_factory, device)
    return dqn_gym.run_device(args, device, make_runner=lambda *a, **kw: make_c51_gym_runner(
        *a, n_atoms=args.n_atoms, lr=args.lr, **kw))
