"""``examples/quickstart/quickstart.py`` (``:34-125``): DQN on CartPole in the
script's two styles, both over ``FCStateQFunctionWithDiscreteAction(4, 2,
n_hidden_layers=2, n_hidden_channels=64)`` and optax-semantics Adam(1e-3),
gamma 0.99.

- The device runner (:func:`make_device_runner`, :func:`run_device`):
  ``DQNCore`` with epsilon 1 -> 0.05 over ``steps // 2`` transitions; 32
  lanes of ``TimeLimit(CartPole(), 500)``; a 10^5-slot uniform ring; a
  batch-64 update per 32 transitions (one per scan step) from 1,024 on; a
  hard target sync every 2,048; ``EvalLoop`` 10 x 500. The script runs
  chunks of 200 scan steps until ``steps`` and evaluates once at the end
  from its own key.
- The host loop (:func:`make_hostloop_agent`, :func:`run_hostloop`): the
  ``DQN`` shell with a 10^4-slot ring, ``ConstantEpsilonGreedy(0.1)``, an
  update per transition from 500 on and a hard target sync every 100,
  driven by the script's own ``act``/``observe`` loop over one
  ``HostTorchEnv(TimeLimit(CartPole(), 500))`` on the CPU.

``--bf16`` is ``compute_dtype=torch.bfloat16`` in both. :func:`run` is the
script's ``__main__``, with ``--hostloop``, ``--load``, ``--demo`` and
``--save-to``.
"""

import argparse
from typing import Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.envs.cartpole import CartPole
from pfrl_tpu_torch.envs.host_adapter import HostTorchEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.state_q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.draws import Draws


def q_function() -> FCStateQFunctionWithDiscreteAction:
    return FCStateQFunctionWithDiscreteAction(4, 2, n_hidden_layers=2, n_hidden_channels=64)


def make_device_runner(steps: int = 100_000, compute_dtype: Optional[torch.dtype] = None, device=None,
                       num_envs: int = 32, capacity: int = 10**5, replay_start_size: int = 1024,
                       update_interval: int = 32, target_update_interval: int = 2048,
                       minibatch_size: int = 64, env=None) -> Tuple[OffPolicyRunner, EvalLoop]:
    """``run_device``'s runner and evaluator for a run of ``steps``
    transitions, on ``device`` (default: the CUDA device); ``env`` replaces
    the 500-step CartPole of training."""
    core = DQNCore(model=q_function(), optimizer=Adam(1e-3),
                   explorer=LinearDecayEpsilonGreedy(1.0, 0.05, steps // 2, 2), gamma=0.99,
                   compute_dtype=compute_dtype)
    env = TimeLimit(CartPole(device=device), 500) if env is None else env
    runner = OffPolicyRunner(
        env, core, ReplayBuffer(capacity, gamma=0.99, num_lanes=num_envs, device=env.device),
        RunnerConfig(num_envs=num_envs, replay_start_size=replay_start_size, update_interval=update_interval,
                     target_update_interval=target_update_interval, minibatch_size=minibatch_size),
        device=env.device,
    )
    return runner, EvalLoop(TimeLimit(CartPole(device=env.device), 500), core, 10, 500, device=env.device)


def run_device(steps: int, seed: int, args=None, device=None) -> dict:
    """The script's ``run_device``: returns ``{"runner", "state",
    "returns"}`` (the final evaluation's, from a generator seeded 1)."""
    from pfrl_tpu_torch.experiments.demo_cli import (
        maybe_load_train_state,
        run_demo_if_requested,
        save_train_state_if_requested,
    )

    runner, evaluator = make_device_runner(
        steps, torch.bfloat16 if args is not None and args.bf16 else None, device)
    state = runner.init(seed)
    out = {"runner": runner, "state": state}
    if args is not None:
        state = out["state"] = maybe_load_train_state(state, args.load, runner.core)
        if run_demo_if_requested(args, evaluator, state.train_state, seed=seed):
            return out
    while state.t < steps:
        state, _ = runner.run_chunk(state, 200)
        print(f"t={state.t:>7}  recent return {runner.recent_return_mean(state):6.1f}")
    out["returns"] = evaluator.evaluate(state.train_state, Draws(torch.Generator(device=runner.device).manual_seed(1)))
    print("final eval returns:", out["returns"])
    if args is not None:
        save_train_state_if_requested(state.train_state, args.save_to, runner.core)
    return out


def make_hostloop_agent(seed: int = 0, compute_dtype: Optional[torch.dtype] = None, device=None, draws=None,
                        replay_start_size: int = 500) -> DQN:
    """``run_hostloop``'s agent on ``device`` (default: the CUDA device)."""
    return DQN(
        q_function=q_function(), optimizer=Adam(1e-3), replay_buffer=ReplayBuffer(10**4, device=device),
        gamma=0.99, explorer=ConstantEpsilonGreedy(0.1, 2), replay_start_size=replay_start_size,
        update_interval=1, target_update_interval=100, compute_dtype=compute_dtype, seed=seed, device=device,
        draws=draws,
    )


def cartpole_env(seed: int) -> HostTorchEnv:
    return HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), seed=seed)


def run_hostloop(steps: int, seed: int, args=None, device=None):
    """The script's ``run_hostloop``: ``act``/``observe`` over one env for
    ``steps`` transitions, printing each episode's return. Returns the
    agent (with ``--demo``, ``(agent, stats)``)."""
    agent = make_hostloop_agent(seed, torch.bfloat16 if args is not None and args.bf16 else None, device)
    if args is not None and args.load:
        agent.load(args.load)
    if args is not None and args.demo:
        from pfrl_tpu_torch.experiments.evaluator import eval_performance

        stats = eval_performance(env=cartpole_env(seed + 10**6), agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']}")
        return agent, stats
    env = cartpole_env(seed)
    obs = env.reset()
    episode_return, t = 0.0, 0
    while t < steps:
        action = agent.act(obs)
        obs, reward, done, info = env.step(action)
        episode_return += reward
        t += 1
        reset = info.get("needs_reset", False)
        agent.observe(obs, reward, done, reset)
        if done or reset:
            print(f"t={t:>6}  R={episode_return:6.1f}")
            episode_return = 0.0
            obs = env.reset()
    print("statistics:", agent.get_statistics())
    return agent


def run(argv: Optional[Sequence[str]] = None, device=None):
    """The script's ``__main__``."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hostloop", action="store_true")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    add_demo_args(parser)
    args = parser.parse_args(argv)
    if args.hostloop:
        return run_hostloop(args.steps, args.seed, args=args, device=device)
    return run_device(args.steps, args.seed, args=args, device=device)
