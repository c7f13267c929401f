"""``examples/atlas/train_soft_actor_critic_atlas.py`` at its own settings
(``:46-164``), on its in-repo backend (``--jax-env`` there, ``--torch-env``
here).

:func:`make_agent` is the script's ``SoftActorCritic`` shell: the policy an
``MLP`` of (256, 256) into ``SquashedGaussianHead``; twin
``FCSAQFunction(256, 2)``; Adam(3e-4, eps 0.1) for the policy and both
critics and the temperature learned at 3e-4 against the target entropy
-|A|; gamma 0.98; 3-step returns in a 10^6-slot ring on the device; batch
256; an update per transition from the replay start of 10^4 on, and
uniform burn-in actions in [-1, 1] until then; soft targets at tau 5e-3.

:func:`make_env` is one lane: with ``--torch-env`` the port's
``TimeLimit(Pendulum())`` (200 steps) on the CPU behind ``HostTorchEnv``;
otherwise the script's Roboschool/PyBullet Atlas walker, which raises by
name here as the script's factory does when neither is installed.
:func:`make_batch_env` is ``--num-envs`` (4) lanes seeded ``seed *
num_envs + i`` (+10,000 for evaluation) through ``MultiprocessVectorEnv``
(spawned workers), or a ``SerialVectorEnv`` with ``--serial-envs``; ``run``
builds the training and the evaluation envs together.
:func:`run` is the script's ``main``: ``train_agent_batch_with_evaluation``
with 20 evaluation episodes every 10^5 transitions, logs every 1,000;
``--load`` and ``--demo``.
"""

import argparse
import functools
from typing import Optional, Sequence

import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch.agents.soft_actor_critic import SoftActorCritic
from pfrl_tpu_torch.envs.multiprocess_vector_env import make_together
from pfrl_tpu_torch.experiments.mujoco_actor_critic import MLPPolicy, uniform_burnin
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.policies import SquashedGaussianHead
from pfrl_tpu_torch.q_functions.state_action_q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer


def make_agent(obs_size: int = 3, action_size: int = 1, replay_start_size: int = 10**4, capacity: int = 10**6,
               minibatch_size: int = 256, update_interval: int = 1, gamma: float = 0.98, n_step_return: int = 3,
               lr: float = 3e-4, adam_eps: float = 1e-1, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
               device=None, draws=None) -> SoftActorCritic:
    """The script's agent (its flags' defaults) on ``device`` (default: the
    CUDA device)."""
    qf = lambda: FCSAQFunction(obs_size, action_size, 256, 2)  # noqa: E731
    adam = lambda: Adam(lr, eps=adam_eps)  # noqa: E731
    return SoftActorCritic(
        MLPPolicy(obs_size, 2 * action_size, (256, 256), SquashedGaussianHead(action_size)),
        qf(), qf(), adam(), adam(), adam(),
        ReplayBuffer(capacity, gamma=gamma, num_steps=n_step_return, device=device), gamma,
        action_space=spaces.box(-1.0, 1.0, (action_size,)), replay_start_size=replay_start_size,
        minibatch_size=minibatch_size, update_interval=update_interval, soft_update_tau=5e-3,
        entropy_target=-float(action_size), temperature_optimizer_lr=lr,
        burnin_action_func=uniform_burnin(action_size), burnin_steps=replay_start_size,
        compute_dtype=compute_dtype, seed=seed, device=device, draws=draws,
    )


def make_env(args, seed: int, test: bool):
    """One lane (module level: ``MultiprocessVectorEnv`` pickles it)."""
    if args.torch_env:
        from pfrl_tpu_torch.envs import HostTorchEnv, Pendulum, TimeLimit

        return HostTorchEnv(TimeLimit(Pendulum(device="cpu")), seed=int(seed))
    try:
        import gym  # noqa: F401

        try:
            import roboschool  # noqa: F401
        except ImportError:
            import pybullet_envs  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"env backend for {args.env!r} unavailable ({e}); pass --torch-env to train the in-repo "
            "simulator explicitly") from e
    raise NotImplementedError(f"{args.env!r} through gym's Roboschool/PyBullet backend is not ported")


def make_batch_env(args, test: bool):
    from pfrl_tpu_torch.envs import MultiprocessVectorEnv, SerialVectorEnv

    seeds = [args.seed * args.num_envs + i + (10_000 if test else 0) for i in range(args.num_envs)]
    fns = [functools.partial(make_env, args, s, test) for s in seeds]
    if args.serial_envs:
        return SerialVectorEnv([fn() for fn in fns])
    return MultiprocessVectorEnv(fns)


def parser() -> argparse.ArgumentParser:
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args
    from pfrl_tpu_torch.experiments.env_cli import add_env_backend_args

    p = argparse.ArgumentParser()
    p.add_argument("--env", default="RoboschoolAtlasForwardWalk-v1")
    add_env_backend_args(p)
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--serial-envs", action="store_true", help="Run the vector env in-process (debug).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    p.add_argument("--steps", type=int, default=10**7)
    p.add_argument("--eval-n-runs", type=int, default=20)
    p.add_argument("--eval-interval", type=int, default=100_000)
    p.add_argument("--update-interval", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--replay-start-size", type=int, default=10**4)
    p.add_argument("--discount", type=float, default=0.98)
    p.add_argument("--n-step-return", type=int, default=3)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--adam-eps", type=float, default=1e-1)
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--outdir", default="results/sac_atlas")
    add_demo_args(p, save=False)
    return p


def run(argv: Optional[Sequence[str]] = None, device=None):
    """The script's ``main``: ``(agent, history)`` after training, or
    ``(agent, stats)`` with ``--demo``. The vector envs are closed after."""
    from pfrl_tpu_torch.experiments.evaluator import eval_performance
    from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation

    args = parser().parse_args(argv)
    sample_env = make_env(args, args.seed, test=False)
    obs_size, action_size = sample_env.observation_space.shape[0], sample_env.action_space.shape[0]
    sample_env.close()
    agent = make_agent(
        obs_size, action_size, replay_start_size=args.replay_start_size, minibatch_size=args.batch_size,
        update_interval=args.update_interval, gamma=args.discount, n_step_return=args.n_step_return, lr=args.lr,
        adam_eps=args.adam_eps, compute_dtype=torch.bfloat16 if args.bf16 else None, seed=args.seed, device=device,
    )
    if args.load:
        agent.load(args.load)
    if args.demo:
        env = make_batch_env(args, test=True)
        try:
            stats = eval_performance(env=env, agent=agent, n_steps=None, n_episodes=args.eval_n_runs)
        finally:
            env.close()
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return agent, stats
    env, eval_env = make_together(functools.partial(make_batch_env, args, False),
                                  functools.partial(make_batch_env, args, True))
    try:
        return train_agent_batch_with_evaluation(
            agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=args.eval_n_runs,
            eval_interval=args.eval_interval, outdir=args.outdir, eval_env=eval_env, log_interval=1000,
        )
    finally:
        env.close()
        eval_env.close()
