"""``examples/atari/reproduction/iqn/train_iqn.py --sim``: IQN on the Nature
CNN at the script's own settings (``main``, ``:28-87``).

:func:`make_iqn_atarisim_runner` returns ``(runner, eval_loop)``: 64 lanes
of AtariSim (84x84x4 uint8 frames, 6 actions);
``ImplicitQuantileQFunction(psi=LargeAtariCNN(), n_actions=6)`` (the
psi's 512 features times ``ReLU(Dense(cos-basis of 64))`` of each tau, then
``Dense(6)``; the tau embedding and the head Chainer-default); ``IQNCore``
with N = N' = 64 and K = 32, optax-semantics Adam(5e-5, eps 1e-2 / 32),
gamma 0.99, ``LinearDecayEpsilonGreedy`` 1.0 -> 0.01 over 10^6
transitions and the script's ``phi``, the uint8 frames divided by 255.0 on
the act path and after the gather alike (ROADMAP C3: the ring does not
dequantize); a 10^5-slot uniform ring read by adjacency
(``store_next_obs=False``: 10^5 x 28,288 B = 2.83 GB of frames on the
card, C56); one batch-32 update per 4 transitions from 50,000 on; hard
target syncs every 10^4; ``EvalLoop`` 5 x 500. ``--bf16`` is
``compute_dtype=torch.bfloat16`` (the taus and the cosine basis stay
float32, C32). Sizes are arguments; the script's values are the defaults.
:func:`run_sim` is the script's ``main``.
"""

import argparse
import time
from typing import Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch.agents.iqn import IQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.atari_rainbow import phi
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.quantile_q_functions import ImplicitQuantileQFunction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer

N_ACTIONS = 6


def make_iqn_model(n_actions: int = N_ACTIONS) -> ImplicitQuantileQFunction:
    """``ImplicitQuantileQFunction(psi=LargeAtariCNN(), n_actions)``: flax
    scopes ``psi``, ``Dense_0`` (the tau embedding) and ``Dense_1`` (the head)."""
    return ImplicitQuantileQFunction(LargeAtariCNN(), 512, n_actions, n_basis_functions=64)


def make_iqn_core(n_actions: int = N_ACTIONS, minibatch_size: int = 32, final_exploration_frames: int = 10**6,
                  compute_dtype: Optional[torch.dtype] = None) -> IQNCore:
    """The script's core; Adam's eps is ``1e-2 / minibatch_size``."""
    return IQNCore(
        model=make_iqn_model(n_actions),
        optimizer=Adam(5e-5, eps=1e-2 / minibatch_size),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.01, final_exploration_frames, n_actions),
        gamma=0.99,
        quantile_thresholds_N=64,
        quantile_thresholds_N_prime=64,
        quantile_thresholds_K=32,
        phi=phi,
        compute_dtype=compute_dtype,
    )


def make_iqn_atarisim_runner(
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    num_envs: int = 64,
    capacity: int = 10**5,
    replay_start_size: int = 5 * 10**4,
    target_update_interval: int = 10**4,
    minibatch_size: int = 32,
    final_exploration_frames: int = 10**6,
    n_actions: int = N_ACTIONS,
) -> Tuple[OffPolicyRunner, EvalLoop]:
    """``train_iqn.py --sim [--bf16]`` on ``device`` (default: the CUDA
    device)."""
    env = AtariSim(n_actions=n_actions, device=device)
    core = make_iqn_core(n_actions, minibatch_size, final_exploration_frames, compute_dtype)
    buffer = ReplayBuffer(capacity, gamma=0.99, num_lanes=num_envs, store_next_obs=False, device=env.device)
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=4,
        target_update_interval=target_update_interval,
        minibatch_size=minibatch_size,
    )
    runner = OffPolicyRunner(env, core, buffer, config, device=env.device)
    return runner, EvalLoop(AtariSim(n_actions=n_actions, device=env.device), core, 5, 500, device=env.device)


def build_parser() -> argparse.ArgumentParser:
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--replay-capacity", type=int, default=10**5)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--outdir", default="results/iqn")
    add_demo_args(parser)
    return parser


def run_sim(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_iqn.py --sim`` with ``argv``'s flags on ``device``: chunks of
    500 scan steps, each printing env-steps/s, the last loss and the recent
    return; ``--load``/``--demo``/``--save-to``. Returns ``{"runner",
    "eval_loop", "state"}`` and ``"demo_returns"`` or ``"saved_to"``."""
    from pfrl_tpu_torch.experiments.demo_cli import (
        demo_returns,
        maybe_load_train_state,
        print_demo_line,
        save_train_state_if_requested,
    )

    args = build_parser().parse_args(argv)
    if not args.sim:
        raise NotImplementedError("the real ALE is not ported: pass --sim")
    runner, eval_loop = make_iqn_atarisim_runner(
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device, num_envs=args.num_envs,
        capacity=args.replay_capacity, replay_start_size=args.replay_start_size,
        target_update_interval=args.target_update_interval,
    )
    state = maybe_load_train_state(runner.init(args.seed), args.load, runner.core)
    out = {"runner": runner, "eval_loop": eval_loop, "state": state}
    if args.demo:
        out["demo_returns"] = demo_returns(eval_loop, state.train_state, args.seed)
        print_demo_line(out["demo_returns"])
        return out
    t0 = time.time()
    while state.t < args.steps:
        state, metrics = runner.run_chunk(state, 500)
        print(f"step {state.t:>10d} | {state.t / (time.time() - t0):>8.0f} steps/s | "
              f"loss {float(metrics['loss'][-1]):.4f} | recent R {runner.recent_return_mean(state):.1f}")
    out["saved_to"] = save_train_state_if_requested(state.train_state, args.save_to, runner.core)
    return out
