"""``examples/gym/train_dqn_gym.py`` at its own settings: DQN with an FC
Q-function for a discrete action space, NAF (``FCQuadraticStateQFunction``,
Gu et al. 2016) for a continuous one, chosen from the env's action space.

Two backends, as in the script:

- the device runner (``--env cartpole|mountaincar|pendulum``, :data:`ENVS`:
  the 500-step CartPole, the 200-step ``MountainCarContinuous`` and the
  200-step Pendulum): :func:`make_dqn_gym_runner` returns ``(runner,
  eval_loop)`` at the script's defaults, 32 lanes, FC 2 x 100, a batch-64
  update per 32 transitions (one per scan step) from 1,024 on, a hard
  target sync every 2,048, a 10^5-slot ring, Adam(1e-3), gamma 0.99,
  epsilon 1 -> 0.05 over half of ``steps`` (discrete) or
  ``AdditiveGaussian(0.3)`` within the action bounds (NAF), and
  ``EvalLoop`` 10 x 500;
- :func:`run_gymnasium` (any other ``--env``): the ``DQN`` shell (``--double``:
  ``DoubleDQNCore``) on ``CastObservationToFloat32`` of the env, with
  ``NormalizeActionSpace`` for a continuous one, an update per transition,
  a ``SerialVectorEnv`` of ``--num-envs`` lanes and
  ``train_agent_batch_with_evaluation`` (one lane:
  ``train_agent_with_evaluation``). ``env_factory(seed)`` replaces
  ``make_gymnasium_env(--env)``: the card's machine has no gymnasium, and
  drives it over ``HostTorchEnv``.

As in the JAX script, ``NormalizeActionSpace`` leaves the action space as
it is, so NAF's bounds are the env's own (Pendulum's [-2, 2]) while the
wrapper maps [-1, 1] onto them. :func:`run` is the script's ``main``.
"""

import argparse
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.double_dqn import DoubleDQNCore
from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.envs.cartpole import CartPole
from pfrl_tpu_torch.envs.mountain_car import MountainCarContinuous
from pfrl_tpu_torch.envs.pendulum import Pendulum
from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.demo_cli import (
    add_demo_args,
    maybe_load_train_state,
    run_demo_if_requested,
    save_train_state_if_requested,
)
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.explorers.additive_gaussian import AdditiveGaussian
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.state_q_functions import (
    FCQuadraticStateQFunction,
    FCStateQFunctionWithDiscreteAction,
)
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.draws import Draws

ENVS = {
    "cartpole": lambda device=None: TimeLimit(CartPole(device=device), 500),
    "mountaincar": lambda device=None: TimeLimit(MountainCarContinuous(device=device), 200),
    "pendulum": lambda device=None: TimeLimit(Pendulum(device=device), 200),
}

# The script's defaults for the device runner (``--num-envs``,
# ``--replay-start-size``, ``--update-per``, ``--target-update-interval``,
# ``--minibatch-size``); ``sizes`` overrides any of them.
RUNNER_SIZES = dict(num_envs=32, replay_start_size=1_024, update_interval=32, target_update_interval=2_048,
                    minibatch_size=64)


def make_core(obs_size: int, space, steps: int = 200_000, final_epsilon: float = 0.05,
              n_hidden_channels: int = 100, n_hidden_layers: int = 2, lr: float = 1e-3, gamma: float = 0.99,
              compute_dtype: Optional[torch.dtype] = None) -> DQNCore:
    """The script's ``make_core`` (``:54-87``) for observations of
    ``obs_size`` and the action space ``space``."""
    if hasattr(space, "n"):
        model = FCStateQFunctionWithDiscreteAction(obs_size, space.n, n_hidden_layers=n_hidden_layers,
                                                   n_hidden_channels=n_hidden_channels)
        explorer = LinearDecayEpsilonGreedy(1.0, final_epsilon, steps // 2, space.n)
    else:
        model = FCQuadraticStateQFunction(
            obs_size, space.shape[0], n_hidden_channels, n_hidden_layers,
            tuple(map(float, space.low)), tuple(map(float, space.high)),
        )
        explorer = AdditiveGaussian(0.3, low=float(space.low[0]), high=float(space.high[0]))
    return DQNCore(model=model, optimizer=Adam(lr), explorer=explorer, gamma=gamma, compute_dtype=compute_dtype)


def make_dqn_gym_runner(env_name: str = "cartpole", steps: int = 200_000, capacity: int = 10**5, device=None,
                        compute_dtype: Optional[torch.dtype] = None, env=None, **sizes) -> Tuple[OffPolicyRunner,
                                                                                                 EvalLoop]:
    """The device runner of ``--env env_name`` (``:211-250``) and its
    ``EvalLoop`` 10 x 500; ``env`` replaces ``ENVS[env_name](device)``."""
    env = ENVS[env_name](device) if env is None else env
    sizes = {**RUNNER_SIZES, **sizes}
    num_envs = sizes.pop("num_envs")
    core = make_core(env.observation_space.shape[0], env.action_space, steps, compute_dtype=compute_dtype)
    buffer = ReplayBuffer(capacity, gamma=0.99, num_lanes=num_envs, device=env.device)
    runner = OffPolicyRunner(env, core, buffer, RunnerConfig(num_envs=num_envs, **sizes), device=env.device)
    return runner, EvalLoop(env, core, 10, 500, device=env.device)


def make_agent(obs_size: int, action_space, steps: int = 200_000, num_envs: int = 32, buffer_size: int = 10**5,
               replay_start_size: int = 1_024, minibatch_size: int = 64, update_interval: int = 1,
               target_update_interval: int = 2_048, lr: float = 1e-3, gamma: float = 0.99,
               final_epsilon: float = 0.05, eps_decay_steps: Optional[int] = None, n_hidden_channels: int = 100,
               n_hidden_layers: int = 2, double: bool = False, compute_dtype: Optional[torch.dtype] = None,
               seed: int = 0, device=None, draws=None) -> DQN:
    """``run_gymnasium``'s shell (``:88-131``) for an env of ``obs_size``
    observations and ``action_space``, on ``device``."""
    core = make_core(obs_size, action_space, steps, final_epsilon, n_hidden_channels, n_hidden_layers, lr, gamma,
                     compute_dtype)
    if hasattr(action_space, "n"):
        explorer = LinearDecayEpsilonGreedy(1.0, final_epsilon, eps_decay_steps or steps // 2, action_space.n)
    else:
        explorer = core.explorer
    return DQN(
        core.model, Adam(lr), ReplayBuffer(buffer_size, gamma=gamma, num_lanes=max(1, num_envs), device=device),
        gamma, explorer, replay_start_size=replay_start_size, minibatch_size=minibatch_size,
        update_interval=update_interval, target_update_interval=target_update_interval, seed=seed,
        core_cls=DoubleDQNCore if double else DQNCore, compute_dtype=compute_dtype, device=device, draws=draws,
    )


def _gymnasium_env(env_id: str) -> Callable:
    def make(seed):
        from pfrl_tpu_torch.envs.gymnasium_env import make_gymnasium_env

        return make_gymnasium_env(env_id, seed=seed)

    return make


def wrapped_env(env_factory: Callable, seed: int):
    """The script's ``make_env``: ``CastObservationToFloat32`` of
    ``env_factory(seed)``, and ``NormalizeActionSpace`` for a continuous
    action space."""
    from pfrl_tpu_torch.wrappers.misc import CastObservationToFloat32, NormalizeActionSpace

    env = CastObservationToFloat32(env_factory(seed))
    if not hasattr(env.action_space, "n"):
        env = NormalizeActionSpace(env)
    return env


def run_gymnasium(args, env_factory: Optional[Callable] = None, device=None):
    """``run_gymnasium`` (``:88-168``): returns ``(agent, stats)`` with
    ``--demo``, else ``(agent, (agent, history))`` from the driver."""
    factory = env_factory or _gymnasium_env(args.env)
    probe = wrapped_env(factory, args.seed)
    agent = make_agent(
        probe.observation_space.shape[0], probe.action_space, steps=args.steps, num_envs=args.num_envs,
        buffer_size=args.buffer_size, replay_start_size=args.replay_start_size,
        minibatch_size=args.minibatch_size, update_interval=args.update_interval,
        target_update_interval=args.target_update_interval, lr=args.lr, gamma=args.gamma,
        final_epsilon=args.final_epsilon, eps_decay_steps=args.eps_decay_steps,
        n_hidden_channels=args.n_hidden_channels, n_hidden_layers=args.n_hidden_layers, double=args.double,
        compute_dtype=torch.bfloat16 if args.bf16 else None, seed=args.seed, device=device,
    )
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=wrapped_env(factory, args.seed + 100), agent=agent, n_steps=None,
                                 n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return agent, stats
    if args.num_envs > 1:
        env = SerialVectorEnv([wrapped_env(factory, args.seed * args.num_envs + i) for i in range(args.num_envs)])
        eval_env = SerialVectorEnv([wrapped_env(factory, args.seed + 100 + i) for i in range(10)])
        return agent, train_agent_batch_with_evaluation(
            agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=10,
            eval_interval=args.eval_interval, outdir=args.outdir, eval_env=eval_env)
    return agent, train_agent_with_evaluation(
        agent, probe, steps=args.steps, eval_n_steps=None, eval_n_episodes=10, eval_interval=args.eval_interval,
        outdir=args.outdir, eval_env=wrapped_env(factory, args.seed + 100))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="cartpole",
                   help="an in-repo simulator name (%s) for the device runner, or any gymnasium env id"
                   % "/".join(sorted(ENVS)))
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--final-epsilon", type=float, default=0.05)
    p.add_argument("--eps-decay-steps", type=int, default=None, help="epsilon decay horizon (default: steps/2)")
    p.add_argument("--n-hidden-channels", type=int, default=100)
    p.add_argument("--n-hidden-layers", type=int, default=2)
    p.add_argument("--replay-start-size", type=int, default=1024)
    p.add_argument("--buffer-size", type=int, default=10**5)
    p.add_argument("--double", action="store_true", help="Double DQN target (gymnasium backend)")
    p.add_argument("--update-per", type=int, default=32,
                   help="env transitions per gradient step (device backend)")
    p.add_argument("--update-interval", type=int, default=1,
                   help="env transitions per gradient step (gymnasium backend)")
    p.add_argument("--target-update-interval", type=int, default=2048)
    p.add_argument("--minibatch-size", type=int, default=64)
    p.add_argument("--eval-interval", type=int, default=50_000)
    p.add_argument("--outdir", default="results/dqn_gym")
    add_demo_args(p)
    return p


def run_device(args, device=None, make_runner: Callable = make_dqn_gym_runner):
    """The script's device branch: the runner in chunks of
    ``eval_interval // num_envs`` scan steps, an evaluation on a generator
    seeded with ``t`` at each ``eval_interval``, ``--load``/``--demo``/
    ``--save-to``. Returns ``(runner, state)``."""
    runner, evaluator = make_runner(
        args.env, args.steps, device=device, compute_dtype=torch.bfloat16 if args.bf16 else None,
        num_envs=args.num_envs, replay_start_size=args.replay_start_size, update_interval=args.update_per,
        target_update_interval=args.target_update_interval, minibatch_size=args.minibatch_size)
    state = runner.init(args.seed)
    state = maybe_load_train_state(state, args.load, runner.core)
    if run_demo_if_requested(args, evaluator, state.train_state, seed=args.seed):
        return runner, state
    chunk = max(1, args.eval_interval // args.num_envs)
    t0, next_eval = time.time(), args.eval_interval
    while state.t < args.steps:
        state, _ = runner.run_chunk(state, chunk)
        if state.t >= next_eval:
            next_eval += args.eval_interval
            draws = Draws(torch.Generator(device=runner.device).manual_seed(state.t))
            returns = evaluator.evaluate(state.train_state, draws)
            print(f"step {state.t:>8} | {state.t / (time.time() - t0):>10.0f} env-steps/s"
                f" | eval mean R {returns.mean():7.1f} | recent train R {runner.recent_return_mean(state):7.1f}")
    print(f"done: {state.t} transitions in {time.time() - t0:.1f}s")
    save_train_state_if_requested(state.train_state, args.save_to, runner.core)
    return runner, state


def run(argv: Optional[Sequence[str]] = None, device=None, env_factory: Optional[Callable] = None):
    """The script's ``main``: the device runner for an ``ENVS`` name (``(runner,
    state)``), else :func:`run_gymnasium`."""
    args = parser().parse_args(argv)
    if args.env not in ENVS:
        return run_gymnasium(args, env_factory, device)
    return run_device(args, device)
