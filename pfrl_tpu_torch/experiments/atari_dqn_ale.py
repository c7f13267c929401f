"""``examples/atari/train_dqn_ale.py`` at the example's own settings: the
``--sim`` recipe over AtariSim and, without ``--sim``, the host path over an
ALE game (``run_ale``).

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
Without ``--sim`` it runs :func:`run_ale`, as the example's ``main`` does.

:func:`run_ale` is the example's host path (``train_dqn_ale.py:147-204``):
the training env is ``wrap_deepmind(make_atari(--env, --max-frames))``
with lives ending episodes and rewards clipped (84x84x4 uint8 stacks), the
evaluation env the same without either and with 5% random actions
(``RandomizeAction``). The agent (:func:`make_ale_agent`, the example's
``build_core_and_buffer`` then ``DQN``) is the :class:`DQN` shell over the
network of ``--arch``, ``DoubleDQNCore`` with ``--double``, optax-semantics
Adam(``--lr``, eps 1.5e-4), ``LinearDecayEpsilonGreedy`` 1.0 ->
``--final-epsilon`` (or ``Greedy`` under ``--noisy-net-sigma``), the ring
of ``--replay-capacity`` slots (``store_next_obs=False``, dequantized by
1/255 in the gather) or with ``--prioritized`` the PER ring (alpha 0.6,
beta 0.4 annealed over ``steps / update_interval`` samples), both
``configure_lanes(1)``: at 10^6 slots the ring is 28.3 GB on the card and
the sum tree has 2^20 leaves, so the prefix-sample kernel runs at C = 2^20,
B = 32 once per update. ``train_agent_with_evaluation`` drives it, one env
step per ``act``, with evaluations of 125,000 steps every
``--eval-interval``.
"""

import argparse
import functools
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.agents.double_dqn import DoubleDQNCore
from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
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
from pfrl_tpu_torch.wrappers import atari_wrappers

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


def _explorer(noisy_net_sigma, final_epsilon, final_exploration_frames, n_actions):
    if noisy_net_sigma is not None:
        return Greedy()  # NoisyNet replaces epsilon-greedy
    return LinearDecayEpsilonGreedy(1.0, final_epsilon, final_exploration_frames, n_actions)


def _buffer(prioritized, capacity, num_step_return, num_lanes, steps, update_interval, device):
    """``build_core_and_buffer``'s ring (``train_dqn_ale.py:84-107``)."""
    ring = dict(num_steps=num_step_return, gamma=0.99, num_lanes=num_lanes, store_next_obs=False,
                fused_dequant_scale=1.0 / 255.0, device=device)
    if prioritized:
        return PrioritizedReplayBuffer(capacity, alpha=0.6, beta0=0.4, betasteps=steps / update_interval, **ring)
    return ReplayBuffer(capacity, **ring)


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
    lr: float = 2.5e-4,
    final_epsilon: float = 0.01,
) -> Tuple[OffPolicyRunner, EvalLoop]:
    """``train_dqn_ale.py --sim [--arch A] [--double] [--prioritized]
    [--num-step-return N] [--noisy-net-sigma S] [--bf16]`` on ``device``
    (default: the CUDA device)."""
    env = AtariSim(n_actions=n_actions, device=device)
    core = (DoubleDQNCore if double else DQNCore)(
        model=build_model(arch, n_actions, noisy_net_sigma),
        optimizer=Adam(lr, eps=1.5e-4),
        explorer=_explorer(noisy_net_sigma, final_epsilon, final_exploration_frames, n_actions),
        gamma=0.99,
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    buffer = _buffer(prioritized, capacity, num_step_return, num_envs, steps, update_interval, env.device)
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
    """``train_dqn_ale.py``'s flags (``:207-236``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true", help="run against AtariSim")
    parser.add_argument("--arch", choices=ARCHS, default="nature")
    parser.add_argument("--double", action="store_true")
    parser.add_argument("--prioritized", action="store_true")
    parser.add_argument("--noisy-net-sigma", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--num-step-return", type=int, default=1)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--update-interval", type=int, default=4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--final-epsilon", type=float, default=0.01)
    parser.add_argument("--final-exploration-frames", type=int, default=10**6)
    parser.add_argument("--eval-interval", type=int, default=10**5)
    parser.add_argument("--chunk", type=int, default=500, help="scan steps per chunk (sim mode)")
    parser.add_argument("--max-frames", type=int, default=atari_wrappers.MAX_FRAMES)
    parser.add_argument("--outdir", default="results/dqn_ale")
    add_demo_args(parser)
    return parser


def run_sim(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_dqn_ale.py --sim`` with ``argv``'s flags on ``device``
    (default: the CUDA device). Returns ``{"runner", "eval_loop", "state"}``
    and, with ``--demo``, ``"demo_returns"`` (the printed line's returns)
    or, after training, ``"saved_to"``. Without ``--sim`` it returns
    :func:`run_ale`'s result, as the example's ``main`` dispatches."""
    from pfrl_tpu_torch.experiments.demo_cli import (
        demo_returns,
        maybe_load_train_state,
        print_demo_line,
        save_train_state_if_requested,
    )

    args = build_parser().parse_args(argv)
    if not args.sim:
        return run_ale(argv, device)
    runner, eval_loop = make_dqn_ale_runner(
        args.arch, double=args.double, prioritized=args.prioritized, num_step_return=args.num_step_return,
        noisy_net_sigma=args.noisy_net_sigma, compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=device, num_envs=args.num_envs, capacity=args.replay_capacity,
        replay_start_size=args.replay_start_size, update_interval=args.update_interval,
        target_update_interval=args.target_update_interval, minibatch_size=args.batch_size, steps=args.steps,
        final_exploration_frames=args.final_exploration_frames, lr=args.lr, final_epsilon=args.final_epsilon,
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
    out["saved_to"] = save_train_state_if_requested(state.train_state, args.save_to, runner.core)
    return out


def make_ale_env(env_id: str, test: bool, max_frames: int = atari_wrappers.MAX_FRAMES,
                 make_atari: Callable = atari_wrappers.make_atari):
    """``train_dqn_ale.py``'s ``make_env(test)`` (``:153-163``): unseeded,
    as in the example. ``make_atari`` builds the ALE chain."""
    return atari_wrappers.make_atari_deepmind(env_id, test=test, max_frames=max_frames, randomize_action=0.05,
                                             make=make_atari)


def make_ale_agent(
    n_actions: int,
    arch: str = "nature",
    double: bool = False,
    prioritized: bool = False,
    num_step_return: int = 1,
    noisy_net_sigma: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    lr: float = 2.5e-4,
    final_epsilon: float = 0.01,
    final_exploration_frames: int = 10**6,
    capacity: int = 10**6,
    num_envs: int = 64,
    steps: float = 5 * 10**7,
    replay_start_size: int = 5 * 10**4,
    minibatch_size: int = 32,
    update_interval: int = 4,
    target_update_interval: int = 10**4,
    seed: int = 0,
    device=None,
    draws=None,
) -> DQN:
    """``run_ale``'s agent (``train_dqn_ale.py:165-183``) on ``device``
    (default: the CUDA device): the ring is built for ``num_envs`` lanes, as
    ``build_core_and_buffer`` builds it, then ``configure_lanes(1)``."""
    from pfrl_tpu_torch._device import resolve_device

    device = resolve_device(device)
    buffer = _buffer(prioritized, capacity, num_step_return, num_envs, steps, update_interval, device)
    return DQN(
        q_function=build_model(arch, n_actions, noisy_net_sigma),
        optimizer=Adam(lr, eps=1.5e-4),
        replay_buffer=buffer.configure_lanes(1),
        gamma=0.99,
        explorer=_explorer(noisy_net_sigma, final_epsilon, final_exploration_frames, n_actions),
        replay_start_size=replay_start_size,
        minibatch_size=minibatch_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        phi=atari_phi,
        seed=seed,
        core_cls=DoubleDQNCore if double else DQNCore,
        compute_dtype=compute_dtype,
        device=device,
        draws=draws,
    )


def run_ale(argv: Optional[Sequence[str]] = None, device=None, make_atari: Optional[Callable] = None, draws=None,
            step_hooks=()) -> dict:
    """``train_dqn_ale.py`` without ``--sim`` (``run_ale``) with ``argv``'s
    flags on ``device`` (default: the CUDA device). ``make_atari`` builds
    the ALE chain (default: ``atari_wrappers.make_atari``); ``draws`` is the
    shell's draw source (default: one seeded with ``--seed``); ``step_hooks``
    go to the driver. ``--load`` loads the port's ``train_state.pt`` or a
    JAX shell's ``train_state.msgpack``; ``--demo`` evaluates 10 episodes on
    the evaluation env, prints the example's line and returns ``{"agent",
    "stats"}``; otherwise it trains and returns ``{"agent", "env",
    "history"}``."""
    from pfrl_tpu_torch.experiments.evaluator import eval_performance
    from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation

    args = build_parser().parse_args(argv)
    make_env = functools.partial(make_ale_env, args.env, max_frames=args.max_frames,
                                 make_atari=make_atari or atari_wrappers.make_atari)
    env = make_env(False)
    agent = make_ale_agent(
        env.action_space.n, args.arch, double=args.double, prioritized=args.prioritized,
        num_step_return=args.num_step_return, noisy_net_sigma=args.noisy_net_sigma,
        compute_dtype=torch.bfloat16 if args.bf16 else None, lr=args.lr, final_epsilon=args.final_epsilon,
        final_exploration_frames=args.final_exploration_frames, capacity=args.replay_capacity,
        num_envs=args.num_envs, steps=args.steps, replay_start_size=args.replay_start_size,
        minibatch_size=args.batch_size, update_interval=args.update_interval,
        target_update_interval=args.target_update_interval, seed=args.seed, device=device, draws=draws,
    )
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=make_env(True), agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} "
              f"median: {stats['median']} stdev: {stats['stdev']}")
        return {"agent": agent, "stats": stats}
    agent, history = train_agent_with_evaluation(
        agent=agent, env=env, eval_env=make_env(True), steps=args.steps, eval_n_steps=125_000,
        eval_n_episodes=None, eval_interval=args.eval_interval, outdir=args.outdir, step_hooks=step_hooks,
    )
    return {"agent": agent, "env": env, "history": history}
