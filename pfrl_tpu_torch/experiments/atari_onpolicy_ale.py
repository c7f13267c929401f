"""``examples/atari/train_a2c_ale.py`` and ``train_ppo_ale.py`` at the
examples' own settings: :func:`run_a2c_ale` and :func:`run_ppo_ale` are
their ``main``. Run either as ``python -m
pfrl_tpu_torch.experiments.atari_onpolicy_ale {a2c,ppo} <the example's
flags>``.

With ``--sim`` (``run_sim``) each trains on AtariSim through
``OnPolicyRunner``: A2C by ``onpolicy.make_a2c_atarisim_runner``
(``--num-envs`` lanes x ``--update-steps``, ``--lr``, ``--use-gae``,
``--tau``), in turns of ``10,000 // (lanes x update steps)`` iterations;
PPO by ``make_ppo_atarisim_runner`` (rollouts of ``--update-interval //
--num-envs`` steps, ``--epochs``, ``--minibatch-size``, ``--lr``), in turns
of 4 iterations; ``--bf16`` is ``compute_dtype``; ``EvalLoop`` 5 x 500 for
``--demo``; ``--load``/``--save-to`` through ``demo_cli``.

Without it, the host paths (their ``run_ale``):

Both train over ``MultiprocessVectorEnv`` of ``--num-envs`` spawned workers
(16 for A2C, 8 for PPO), each ``wrap_deepmind(make_atari(--env))`` (84x84x4
uint8 stacks; lives end training episodes and rewards are clipped in
training), seeded ``seed + idx`` (``+ 10**6`` for the evaluation envs), with
:class:`~pfrl_tpu_torch.experiments.onpolicy.AtariPiV` (``SmallAtariCNN``,
a softmax head over ``Dense(n_actions)`` and a ``Dense(1)`` value) and
``atari_phi``, through ``train_agent_batch_with_evaluation`` with 10
evaluation episodes every ``--eval-interval``:

- :func:`run_a2c_ale` (``train_a2c_ale.py:92-155``): the ``A2C`` shell,
  RMSprop(``--lr`` 7e-4, decay 0.99, eps 1e-5) after clipping the
  gradients' global norm at 40, ``--update-steps`` 5, n-step returns or
  with ``--use-gae`` GAE (tau ``--tau``);
- :func:`run_ppo_ale` (``train_ppo_ale.py:86-149``): the ``PPO`` shell,
  Adam(``--lr`` 2.5e-4, eps 1e-5), updates every ``--update-interval``
  1,024 transitions, ``--epochs`` 4 of ``--minibatch-size`` 256, clip 0.1,
  entropy bonus 0.01, standardized advantages (the example gives this
  shell no ``--bf16``).

``--load`` loads the shell's saved state; ``--demo`` evaluates 10 episodes
on the evaluation envs and prints the example's line.
"""

import argparse
import functools
from typing import Optional, Sequence

import torch

from pfrl_tpu_torch import runtime
from pfrl_tpu_torch.agents.a2c import A2C
from pfrl_tpu_torch.agents.ppo import PPO
from pfrl_tpu_torch.envs.multiprocess_vector_env import MultiprocessVectorEnv, make_together
from pfrl_tpu_torch.experiments.onpolicy import AtariPiV, make_a2c_atarisim_runner, make_ppo_atarisim_runner
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.optimizers import Adam, RMSprop
from pfrl_tpu_torch.utils.batch_states import atari_phi
from pfrl_tpu_torch.wrappers import atari_wrappers


def make_vector_envs(env_id: str, num_envs: int, seed: int):
    """The training and the evaluation ``MultiprocessVectorEnv`` of the
    examples' ``make_env(idx, test)``, their workers started together (the
    frame ops built before any spawns)."""
    runtime.build()
    make = atari_wrappers.make_atari_deepmind
    return make_together(*(functools.partial(MultiprocessVectorEnv, [
        functools.partial(make, env_id, test, seed + i + (10**6 if test else 0)) for i in range(num_envs)])
        for test in (False, True)))


def _parser(num_envs: int, steps: int, lr: float, outdir: str) -> argparse.ArgumentParser:
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=steps)
    parser.add_argument("--num-envs", type=int, default=num_envs)
    parser.add_argument("--lr", type=float, default=lr)
    parser.add_argument("--eval-interval", type=int, default=10**6)
    parser.add_argument("--outdir", default=outdir)
    add_demo_args(parser)
    return parser


def a2c_parser() -> argparse.ArgumentParser:
    """``train_a2c_ale.py``'s flags (``:158-173``)."""
    parser = _parser(16, 5 * 10**7, 7e-4, "results/a2c_ale")
    parser.add_argument("--update-steps", type=int, default=5)
    parser.add_argument("--use-gae", action="store_true")
    parser.add_argument("--tau", type=float, default=0.95)
    return parser


def ppo_parser() -> argparse.ArgumentParser:
    """``train_ppo_ale.py``'s flags (``:152-166``)."""
    parser = _parser(8, 10**7, 2.5e-4, "results/ppo_ale")
    parser.add_argument("--update-interval", type=int, default=128 * 8)
    parser.add_argument("--minibatch-size", type=int, default=32 * 8)
    parser.add_argument("--epochs", type=int, default=4)
    return parser


def make_a2c_agent(n_actions: int, args, device=None) -> A2C:
    return A2C(
        AtariPiV(n_actions), RMSprop(args.lr, decay=0.99, eps=1e-5), gamma=0.99, num_processes=args.num_envs,
        update_steps=args.update_steps, use_gae=args.use_gae, tau=args.tau, max_grad_norm=40.0, phi=atari_phi,
        compute_dtype=torch.bfloat16 if args.bf16 else None, seed=args.seed, device=device,
    )


def make_ppo_agent(n_actions: int, args, device=None) -> PPO:
    return PPO(
        AtariPiV(n_actions), Adam(args.lr, eps=1e-5), gamma=0.99, lambd=0.95, clip_eps=0.1, entropy_coef=0.01,
        update_interval=args.update_interval, minibatch_size=args.minibatch_size, epochs=args.epochs,
        standardize_advantages=True, phi=atari_phi, seed=args.seed, device=device,
    )


def _run(args, make_agent, device) -> dict:
    from pfrl_tpu_torch._device import resolve_device
    from pfrl_tpu_torch.experiments.evaluator import eval_performance

    device = resolve_device(device)  # before any worker spawns
    env, eval_env = make_vector_envs(args.env, args.num_envs, args.seed)
    try:
        agent = make_agent(env.action_space.n, args, device)
        if args.load:
            agent.load(args.load)
        if args.demo:
            stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=10)
            print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} "
                  f"median: {stats['median']} stdev: {stats['stdev']}")
            return {"agent": agent, "stats": stats}
        agent, history = train_agent_batch_with_evaluation(
            agent=agent, env=env, eval_env=eval_env, steps=args.steps, eval_n_steps=None, eval_n_episodes=10,
            eval_interval=args.eval_interval, outdir=args.outdir,
        )
        return {"agent": agent, "history": history}
    finally:
        for e in (env, eval_env):
            if not e.closed:
                e.close()


def _run_sim(args, runner, chunk: int) -> dict:
    from pfrl_tpu_torch.envs.atari_sim import AtariSim
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    eval_loop = EvalLoop(AtariSim(n_actions=6, device=runner.device), runner.core, 5, 500, device=runner.device)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_iterations(state, chunk)[0])


def run_a2c_ale(argv: Optional[Sequence[str]] = None, device=None, chunk: Optional[int] = None) -> dict:
    """``train_a2c_ale.py``'s ``main`` with ``argv``'s flags on ``device``
    (default: the CUDA device). With ``--sim``, turns of ``chunk``
    iterations (the example's ``max(1, 10,000 // (lanes x update
    steps))``) and :func:`~.demo_cli.run_device_example`'s dict; else the
    ALE path's ``{"agent", "history"}`` (``{"agent", "stats"}`` with
    ``--demo``), its envs closed."""
    args = a2c_parser().parse_args(argv)
    if not args.sim:
        return _run(args, make_a2c_agent, device)
    runner = make_a2c_atarisim_runner(
        args.num_envs, args.update_steps, use_gae=args.use_gae, lr=args.lr, tau=args.tau,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device)
    return _run_sim(args, runner, chunk or max(1, 10_000 // (args.num_envs * args.update_steps)))


def run_ppo_ale(argv: Optional[Sequence[str]] = None, device=None, chunk: int = 4) -> dict:
    """``train_ppo_ale.py``'s ``main``, as :func:`run_a2c_ale`; ``--sim``
    runs turns of ``chunk`` iterations (the example's 4) of rollouts of
    ``--update-interval // --num-envs`` steps."""
    args = ppo_parser().parse_args(argv)
    if not args.sim:
        return _run(args, make_ppo_agent, device)
    runner = make_ppo_atarisim_runner(
        args.num_envs, args.update_interval // args.num_envs, epochs=args.epochs,
        minibatch_size=args.minibatch_size, lr=args.lr, compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=device)
    return _run_sim(args, runner, chunk)


COMMANDS = {"a2c": run_a2c_ale, "ppo": run_ppo_ale}


if __name__ == "__main__":
    from pfrl_tpu_torch.experiments.demo_cli import run_command

    run_command(COMMANDS)
