"""``examples/atari/train_dqn_ale.py --sim`` at the example's own settings.

:func:`make_dqn_ale_runner` returns ``(runner, eval_loop)``: 64 lanes of
AtariSim (84x84x4 uint8 frames, 6 actions); the model of ``--arch``
(``build_model``, ``train_dqn_ale.py:55-67``): ``nature`` is
:class:`~pfrl_tpu_torch.experiments.atari_per_dqn.NatureQ` (``ConvQ`` with
``LargeAtariCNN``), ``nips`` is :class:`ConvQ` with the NIPS'13
``SmallAtariCNN`` -> Dense(n_actions), ``dueling`` is
:class:`~pfrl_tpu_torch.q_functions.dueling_dqn.DuelingDQN` over
``LargeAtariCNN(512)``; ``--noisy-net-sigma`` makes the head (both streams
of the dueling net) factorized noisy layers and the explorer ``Greedy``;
``DoubleDQNCore`` with ``--double``, else ``DQNCore`` with the ``"mean"``
accumulator and optax-semantics Adam(2.5e-4, eps 1.5e-4);
``LinearDecayEpsilonGreedy`` 1.0 -> 0.01 over 10^6 transitions; a ring of
10^6 slots (``store_next_obs=False``, n-step returns of
``--num-step-return``, dequantized in the gather), or with
``--prioritized`` the proportional PER ring (alpha 0.6, beta 0.4 annealed
over ``steps / update_interval`` samples): at 10^6 slots its sum tree has
2^20 leaves, so the prefix-sample kernel runs at C = 2^20, B = 32; one
batch-32 update per 4 transitions from 50,000 on, hard target syncs every
10^4; ``EvalLoop`` 5 x 500. Sizes are arguments, so that tests run the
recipe small; the example's values are the defaults.

``make_dqn_runner`` (``atari_per_dqn.py``) stays ``bench.py``'s
``bench_dqn`` (RMSprop, a summed loss, a 10^5-slot ring); this module is
the example itself.

:func:`run_sim` is the example's ``--sim`` command line
(``train_dqn_ale.py:128-144``): it builds the recipe from its flags,
``--load``s a train state (the port's ``train_state.pt`` or a JAX
``train_state.msgpack``), ``--demo``s it (the evaluation loop, 5 x 500,
on a generator seeded with ``--seed``), or trains ``--steps`` transitions
in chunks of ``--chunk`` scan steps and ``--save-to``s the train state.
"""

import argparse
import time
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.agents.double_dqn import DoubleDQNCore
from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.explorers.greedy import Greedy
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN, SmallAtariCNN
from pfrl_tpu_torch.models.noisy_linear import to_factorized_noisy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.dueling_dqn import DuelingDQN
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi

ARCHS = ("nature", "nips", "dueling")
TORSOS = {"nature": LargeAtariCNN, "nips": SmallAtariCNN}


class ConvQ(NatureQ):
    """``train_dqn_ale.py``'s ``ConvQ``: a torso (``nature``:
    ``LargeAtariCNN``, ``nips``: ``SmallAtariCNN``) -> Dense(n_actions) ->
    ``DiscreteActionValueHead``; flax scopes ``<Torso>_0`` and ``Dense_0``
    (or ``FactorizedNoisyDense_0``)."""

    def __init__(self, n_actions: int = 6, torso: str = "nature", dense_cls=None,
                 frame_shape: Tuple[int, int, int] = (84, 84, 4)):
        super().__init__(n_actions, frame_shape, dense_cls, torso_cls=TORSOS[torso])


def build_model(arch: str, n_actions: int = 6, noisy_net_sigma: Optional[float] = None) -> nn.Module:
    """``train_dqn_ale.py:55-67``."""
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is none of {ARCHS}")
    dense_cls = None if noisy_net_sigma is None else to_factorized_noisy(nn.Linear, sigma_scale=noisy_net_sigma)
    if arch == "dueling":
        return DuelingDQN(n_actions, dense_cls=dense_cls)
    return ConvQ(n_actions, arch, dense_cls)


def make_dqn_ale_runner(
    arch: str = "nature",
    double: bool = False,
    prioritized: bool = False,
    num_step_return: int = 1,
    noisy_net_sigma: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    num_envs: int = 64,
    capacity: int = 10**6,
    replay_start_size: int = 5 * 10**4,
    update_interval: int = 4,
    target_update_interval: int = 10**4,
    minibatch_size: int = 32,
    steps: float = 5 * 10**7,
    final_exploration_frames: int = 10**6,
    n_actions: int = 6,
) -> Tuple[OffPolicyRunner, EvalLoop]:
    """``train_dqn_ale.py --sim [--arch A] [--double] [--prioritized]
    [--num-step-return N] [--noisy-net-sigma S] [--bf16]`` on ``device``
    (default: the CUDA device)."""
    env = AtariSim(n_actions=n_actions, device=device)
    noisy = noisy_net_sigma is not None
    core = (DoubleDQNCore if double else DQNCore)(
        model=build_model(arch, n_actions, noisy_net_sigma),
        optimizer=Adam(2.5e-4, eps=1.5e-4),
        explorer=Greedy() if noisy else LinearDecayEpsilonGreedy(1.0, 0.01, final_exploration_frames, n_actions),
        gamma=0.99,
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    ring = dict(num_steps=num_step_return, gamma=0.99, num_lanes=num_envs, store_next_obs=False,
                fused_dequant_scale=1.0 / 255.0, device=env.device)
    if prioritized:
        buffer = PrioritizedReplayBuffer(capacity, alpha=0.6, beta0=0.4, betasteps=steps / update_interval, **ring)
    else:
        buffer = ReplayBuffer(capacity, **ring)
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        minibatch_size=minibatch_size,
    )
    runner = OffPolicyRunner(env, core, buffer, config, device=env.device)
    return runner, EvalLoop(AtariSim(n_actions=n_actions, device=env.device), core, 5, 500, device=env.device)


def build_parser() -> argparse.ArgumentParser:
    """``train_dqn_ale.py``'s flags that the ``--sim`` path reads."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--sim", action="store_true", help="run against AtariSim (the only mode ported)")
    parser.add_argument("--arch", choices=ARCHS, default="nature")
    parser.add_argument("--double", action="store_true")
    parser.add_argument("--prioritized", action="store_true")
    parser.add_argument("--noisy-net-sigma", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--num-step-return", type=int, default=1)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--update-interval", type=int, default=4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--final-exploration-frames", type=int, default=10**6)
    parser.add_argument("--chunk", type=int, default=500, help="scan steps per chunk")
    add_demo_args(parser)
    return parser


def run_sim(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_dqn_ale.py --sim`` with ``argv``'s flags on ``device``
    (default: the CUDA device). Returns ``{"runner", "eval_loop", "state"}``
    and, with ``--demo``, ``"demo_returns"`` (the printed line's returns)
    or, after training, ``"saved_to"``."""
    from pfrl_tpu_torch.experiments.demo_cli import (
        demo_returns,
        maybe_load_train_state,
        print_demo_line,
        save_train_state_if_requested,
    )

    args = build_parser().parse_args(argv)
    if not args.sim:
        raise NotImplementedError("the real ALE (make_atari) is not ported: pass --sim")
    runner, eval_loop = make_dqn_ale_runner(
        args.arch, double=args.double, prioritized=args.prioritized, num_step_return=args.num_step_return,
        noisy_net_sigma=args.noisy_net_sigma, compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=device, num_envs=args.num_envs, capacity=args.replay_capacity,
        replay_start_size=args.replay_start_size, update_interval=args.update_interval,
        target_update_interval=args.target_update_interval, minibatch_size=args.batch_size, steps=args.steps,
        final_exploration_frames=args.final_exploration_frames,
    )
    state = maybe_load_train_state(runner.init(args.seed), args.load, runner.core)
    out = {"runner": runner, "eval_loop": eval_loop, "state": state}
    if args.demo:
        out["demo_returns"] = demo_returns(eval_loop, state.train_state, args.seed)
        print_demo_line(out["demo_returns"])
        return out
    t0 = time.time()
    while state.t < args.steps:
        state, metrics = runner.run_chunk(state, args.chunk)
        print(f"step {state.t:>9} | {state.t / (time.time() - t0):>8.0f} env-steps/s"
              f" | loss {float(metrics['loss'][-1]):.4f}")
    print(f"done: {state.t} transitions in {time.time() - t0:.1f}s")
    out["saved_to"] = save_train_state_if_requested(state.train_state, args.save_to)
    return out
