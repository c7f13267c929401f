"""PPO on Pendulum at two examples' own settings.

- ``examples/mujoco/reproduction/ppo/train_ppo.py --jax-env pendulum``
  (``run_device``, ``:63-102``): :func:`make_ppo_pendulum_device_runner`
  returns ``(runner, eval_loop)``: ``PPOCore`` over the script's ``PiV``
  (:class:`~.onpolicy.GaussianPiV` with one action: independent 64 x 64
  tanh towers, the mean layer at ``variance_scaling(1e-4, "fan_in",
  "normal")``, a state-independent Gaussian head) with Adam(3e-4), gamma
  0.99, lambda 0.95, 10 epochs of batch-64 minibatches, clip 0.2 and the
  JAX core's defaults for the rest: **an entropy bonus of 0.01**, value
  loss weight 1 and standardized advantages; 64 lanes of
  ``TimeLimit(Pendulum())`` (200 steps) x 128 collect steps (8,192
  transitions, 1,280 Adam steps per iteration); ``EvalLoop`` 10 x 200.
  ``onpolicy.make_ppo_pendulum_runner`` is ``tools/record_curves.py``'s
  recipe, with no entropy bonus: not this one. :func:`run_device` is the
  script's device branch.
- ``examples/gym/train_ppo_pendulum.py`` (``:52-130``): :func:`make_agent`
  is the ``PPO`` shell over the same ``PiV`` with Adam(3e-4), gamma 0.99,
  lambda 0.95, 2,048 transitions per update, 10 epochs of batch-64
  minibatches, clip 0.2, no entropy bonus, standardized advantages;
  :func:`make_vector_env` a ``SerialVectorEnv`` of ``num_envs`` (8)
  ``HostTorchEnv(TimeLimit(Pendulum()))`` lanes on the CPU, seeded ``seed0
  + i``; :func:`run` the script's ``main``, through
  ``train_agent_batch_with_evaluation`` (10 evaluation episodes every
  20,000 transitions, logs every 10,000), ``--load`` and ``--demo``.
"""

import argparse
import time
from typing import Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.ppo import PPO, PPOCore
from pfrl_tpu_torch.envs.host_adapter import HostTorchEnv
from pfrl_tpu_torch.envs.pendulum import Pendulum
from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, time_limited_pendulum
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.optimizers import Adam


def pi_v(action_size: int = 1) -> GaussianPiV:
    """Both scripts' ``PiV``."""
    return GaussianPiV(3, action_size, 64, mean_scale=1e-4)


def make_ppo_pendulum_device_runner(
    num_envs: int = 64,
    rollout_len: int = 128,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    env=None,
) -> Tuple[OnPolicyRunner, EvalLoop]:
    """``train_ppo.py --jax-env pendulum [--bf16]`` on ``device`` (default:
    the CUDA device); ``env`` replaces the 200-step Pendulum of training."""
    env = time_limited_pendulum(device) if env is None else env
    core = PPOCore(pi_v(), Adam(3e-4), gamma=0.99, lambd=0.95, epochs=10, minibatch_size=64, clip_eps=0.2,
                   compute_dtype=compute_dtype)
    runner = OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)
    return runner, EvalLoop(time_limited_pendulum(env.device), core, 10, 200, device=env.device)


def run_device(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_ppo.py --jax-env pendulum``'s loop: 10 iterations per print
    until ``--steps`` (default 2 x 10^6) transitions. Returns ``{"runner",
    "eval_loop", "state"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2 * 10**6)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    args = parser.parse_args(argv)
    runner, eval_loop = make_ppo_pendulum_device_runner(
        args.num_envs, compute_dtype=torch.bfloat16 if args.bf16 else None, device=device)
    state = runner.init(args.seed)
    t0 = time.time()
    while state.t < args.steps:
        state, _ = runner.run_iterations(state, 10)
        print(f"step {state.t:>9d} | {state.t / (time.time() - t0):>8.0f} steps/s | "
              f"recent R {runner.recent_return_mean(state):8.1f}")
    return {"runner": runner, "eval_loop": eval_loop, "state": state}


def make_agent(action_size: int = 1, compute_dtype: Optional[torch.dtype] = None, seed: int = 0, device=None,
               draws=None) -> PPO:
    """``train_ppo_pendulum.py``'s agent."""
    return PPO(
        pi_v(action_size), Adam(3e-4), gamma=0.99, lambd=0.95, update_interval=2048, minibatch_size=64, epochs=10,
        clip_eps=0.2, entropy_coef=0.0, standardize_advantages=True, compute_dtype=compute_dtype, seed=seed,
        device=device, draws=draws,
    )


def pendulum_env(seed: int) -> HostTorchEnv:
    """One lane: the script's ``HostJaxEnv(TimeLimit(Pendulum()), seed=seed)``."""
    return HostTorchEnv(TimeLimit(Pendulum(device="cpu")), seed=seed)


def make_vector_env(num_envs: int = 8, seed0: int = 0) -> SerialVectorEnv:
    return SerialVectorEnv([pendulum_env(seed0 + i) for i in range(num_envs)])


def run(argv: Optional[Sequence[str]] = None, device=None):
    """``train_ppo_pendulum.py``'s ``main`` (``--env pendulum``): returns
    ``(agent, history)`` after training, or ``(agent, stats)`` with
    ``--demo``. Another ``--env`` is a gymnasium id, cast to float32 and
    action-normalized as the script wraps it."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args
    from pfrl_tpu_torch.experiments.evaluator import eval_performance
    from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="pendulum")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=100_000)
    parser.add_argument("--num-envs", type=int, default=8)
    parser.add_argument("--eval-interval", type=int, default=20_000)
    parser.add_argument("--outdir", type=str, default="results/ppo_pendulum")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    add_demo_args(parser, save=False)
    args = parser.parse_args(argv)
    if args.env == "pendulum":
        make_one, action_size = pendulum_env, 1
    else:
        from pfrl_tpu_torch.envs.gymnasium_env import make_gymnasium_env
        from pfrl_tpu_torch.wrappers import CastObservationToFloat32, NormalizeActionSpace

        def make_one(seed):
            return NormalizeActionSpace(CastObservationToFloat32(make_gymnasium_env(args.env, seed=seed)))

        action_size = make_one(args.seed).action_space.shape[0]

    def make_vec(seed0):
        return SerialVectorEnv([make_one(seed0 + i) for i in range(args.num_envs)])

    agent = make_agent(action_size, torch.bfloat16 if args.bf16 else None, args.seed, device)
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=make_vec(args.seed * 100 + 50), agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return agent, stats
    return train_agent_batch_with_evaluation(
        agent, make_vec(args.seed * 100), steps=args.steps, eval_n_steps=None, eval_n_episodes=10,
        eval_interval=args.eval_interval, outdir=args.outdir, eval_env=make_vec(args.seed * 100 + 50),
        log_interval=10_000,
    )
