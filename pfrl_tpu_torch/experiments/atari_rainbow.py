"""The Rainbow configuration on AtariSim frames (counterpart of
``examples/atari/reproduction/rainbow/train_rainbow.py --sim``).

Double + distributional (C51) + dueling + noisy + prioritized + 3-step:
64 lanes of 84x84x4 uint8 frames; a distributional dueling network with
factorized noisy streams (sigma scale 0.5) and 51 atoms on [-10, 10];
``CategoricalDoubleDQNCore`` with a mean cross-entropy loss; optax-semantics
Adam(6.25e-5, eps 1.5e-4); no explorer beyond the noisy layers; a
100,000-slot uint8 prioritized ring (alpha 0.5, beta 0.4 annealed over
1.25e7 samples) read by adjacency with 3-step returns; one batch-32 update
per 4 transitions after 20,000; hard target syncs every 32,000. Frames are
scaled by ``phi`` on the act path and after the gather alike
(``x / 255``; the ring does not dequantize). ``compute_dtype`` is
``--bf16``: the torso and the softmax compute in bf16; the noisy streams
compute in float32 by promotion (their noise is float32), as in JAX.

:func:`run` is the example's ``main`` (its 9 flags, ``--load``/``--demo``/
``--save-to``, ``EvalLoop`` 5 x 500); the 10^5-slot ring puts the
prefix-sample kernel at C = 2^17, B = 32.
"""

import argparse
from typing import Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.categorical_dqn import CategoricalDoubleDQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.greedy import Greedy
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear
from pfrl_tpu_torch.optimizers.adam import Adam
from pfrl_tpu_torch.q_functions.dueling_dqn import DistributionalDuelingDQN
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

CHUNK = 500  # scan steps per turn of the example's loop


def phi(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 255.0


def noisy_dense(in_features: int, out_features: int) -> FactorizedNoisyLinear:
    return FactorizedNoisyLinear(in_features, out_features, sigma_scale=0.5)


def make_rainbow_core(
    n_actions: int = 6,
    frame_shape: Tuple[int, int, int] = (84, 84, 4),
    compute_dtype: Optional[torch.dtype] = None,
) -> CategoricalDoubleDQNCore:
    model = DistributionalDuelingDQN(
        n_actions, n_atoms=51, v_min=-10.0, v_max=10.0,
        dense_cls=noisy_dense, frame_shape=frame_shape,
    )
    return CategoricalDoubleDQNCore(
        model=model,
        optimizer=Adam(6.25e-5, eps=1.5e-4),
        explorer=Greedy(),  # the noisy layers explore
        gamma=0.99,
        phi=phi,
        compute_dtype=compute_dtype,
    )


def make_rainbow_runner(
    num_envs: int = 64,
    capacity: int = 100_000,
    replay_start_size: int = 20_000,
    update_interval: int = 4,
    target_update_interval: int = 32_000,
    minibatch_size: int = 32,
    steps: float = 5e7,
    n_actions: int = 6,
    frame_shape: Tuple[int, int, int] = (84, 84, 4),
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OffPolicyRunner:
    """Rainbow at the given sizes (defaults: the recipe's) on ``device``
    (default: the CUDA device). ``steps`` is the length of the run the
    importance-sampling exponent anneals over."""
    env = AtariSim(n_actions=n_actions, frame_shape=frame_shape, device=device)
    buffer = PrioritizedReplayBuffer(
        capacity,
        alpha=0.5,
        beta0=0.4,
        betasteps=steps / 4,
        num_steps=3,
        gamma=0.99,
        num_lanes=num_envs,
        store_next_obs=False,
        device=env.device,
    )
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        minibatch_size=minibatch_size,
    )
    core = make_rainbow_core(n_actions, frame_shape, compute_dtype)
    return OffPolicyRunner(env, core, buffer, config, device=env.device)


def build_parser() -> argparse.ArgumentParser:
    """``train_rainbow.py``'s flags (``:55-66``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--replay-capacity", type=int, default=10**5)
    parser.add_argument("--replay-start-size", type=int, default=2 * 10**4)
    parser.add_argument("--target-update-interval", type=int, default=32_000)
    parser.add_argument("--outdir", default="results/rainbow")
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None, chunk: int = CHUNK) -> dict:
    """``train_rainbow.py``'s ``main`` with ``argv``'s flags on ``device``
    (default: the CUDA device): AtariSim with or without ``--sim``, as the
    example runs it, in turns of ``chunk`` scan steps (the example's 500)
    until ``--steps`` transitions. Returns
    :func:`~.demo_cli.run_device_example`'s dict."""
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example

    args = build_parser().parse_args(argv)
    runner = make_rainbow_runner(
        num_envs=args.num_envs, capacity=args.replay_capacity, replay_start_size=args.replay_start_size,
        target_update_interval=args.target_update_interval, steps=args.steps,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device,
    )
    eval_loop = EvalLoop(AtariSim(n_actions=6, device=runner.device), runner.core, 5, 500, device=runner.device)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_chunk(state, chunk)[0])


if __name__ == "__main__":
    run()
