"""``examples/atari/train_dqn_pipeline_ale.py``: Nature DQN through the
actor-learner pipeline (:mod:`pfrl_tpu_torch.parallel.atari_pipeline`) at
the example's own settings.

:func:`make_dqn_pipeline` returns the (not yet started) pipeline: 3
spawned actor processes x 96 lanes of ``SyntheticALE`` through
MaxAndSkip -> ClipReward -> WarpFrame on the C++ frame ops
(``envs/synthetic_ale.make_warped``: 84x84x1 uint8 planes, 6 actions);
``NatureQ`` (``LargeAtariCNN`` -> Dense(6)); ``DQNCore`` with a summed
Huber loss and optax-semantics RMSprop(2.5e-4, decay 0.95, eps 1e-2);
``LinearDecayEpsilonGreedy`` 1.0 -> 0.1 over 10^6 transitions; a plane
ring of 10^6 rows, 999,936 after rounding down to whole rows of 288 lanes
(7.06 GB of planes on the card); bursts of 64 batch-32 updates paced at
one per 4 transitions from 50,000 on, target syncs every 10^4 (in
transitions of updates x 4). Sizes are arguments, so that tests run it
small; the example's values are the defaults.

:func:`run` is the example's command line
(``train_dqn_pipeline_ale.py:106-123,159``). Without ``--sim`` the actors
step ``--env`` through ``atari_wrappers.make_ale_plane_env`` (the example's
``make_ale_plane_env``: ``make_atari``, then a second MaxAndSkip, ClipReward
and WarpFrame, so that each action spans 16 raw frames, as in the
example), and the action count comes from a probe env. With ``--load`` or ``--demo``
it builds the core's train state, loads the saved one into it (the port's
``train_state.pt`` or a JAX ``train_state.msgpack``) and, with
``--demo``, evaluates it on ``EvalLoop(AtariSim(6), 5 x 500)`` and
returns. Otherwise it trains the pipeline for ``--steps`` acted
transitions, starting from the loaded state where ``--load`` gave one,
and ``--save-to``s the train state.
"""

import argparse
import functools
import time
from typing import Callable, Optional, Sequence

import torch

from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.envs.synthetic_ale import make_warped
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.parallel.atari_pipeline import AtariActorLearnerPipeline
from pfrl_tpu_torch.utils.batch_states import atari_phi
from pfrl_tpu_torch.wrappers import atari_wrappers


def make_pipeline_core(n_actions: int = 6, compute_dtype: Optional[torch.dtype] = None, lr: float = 2.5e-4) -> DQNCore:
    return DQNCore(
        model=NatureQ(n_actions),
        optimizer=RMSprop(lr, decay=0.95, eps=1e-2),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.1, 10**6, n_actions),
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )


def make_dqn_pipeline(
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    env_factory: Callable = make_warped,
    n_workers: int = 3,
    lanes_per_worker: int = 96,
    capacity: int = 10**6,
    minibatch_size: int = 32,
    update_interval: int = 4,
    target_update_interval: int = 10**4,
    replay_start_size: int = 5 * 10**4,
    burst: int = 64,
    seed: int = 0,
    n_actions: int = 6,
    lr: float = 2.5e-4,
) -> AtariActorLearnerPipeline:
    """``train_dqn_pipeline_ale.py [--sim] [--bf16]`` on ``device`` (default:
    the CUDA device)."""
    return AtariActorLearnerPipeline(
        core=make_pipeline_core(n_actions, compute_dtype=compute_dtype, lr=lr),
        env_factory=env_factory,
        n_workers=n_workers,
        lanes_per_worker=lanes_per_worker,
        capacity=capacity,
        minibatch_size=minibatch_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        replay_start_size=replay_start_size,
        burst=burst,
        seed=seed,
        device=device,
    )


def build_parser() -> argparse.ArgumentParser:
    """``train_dqn_pipeline_ale.py``'s flags."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true", help="SyntheticALE frames instead of ALE (no ROMs)")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--workers", type=int, default=3)
    parser.add_argument("--lanes", type=int, default=96)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--update-interval", type=int, default=4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--burst", type=int, default=64)
    parser.add_argument("--log-interval", type=float, default=30.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None, env_factory: Optional[Callable] = None) -> dict:
    """``train_dqn_pipeline_ale.py`` with ``argv``'s flags on ``device``
    (default: the CUDA device). The actors' ``env_factory(seed)`` is, unless
    given, ``make_warped`` with ``--sim`` and ``make_ale_plane_env`` of
    ``--env`` without. With ``--demo`` returns ``{"train_state",
    "demo_returns"}``; after training ``{"train_state", "pipeline"``
    (stopped) ``, "saved_to"}``."""
    from pfrl_tpu_torch.envs.atari_sim import AtariSim
    from pfrl_tpu_torch.experiments.demo_cli import (
        demo_returns,
        load_train_state,
        print_demo_line,
        save_train_state_if_requested,
    )
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    args = build_parser().parse_args(argv)
    if args.sim:
        env_factory = env_factory or make_warped
        n_actions = 6
    else:
        env_factory = env_factory or functools.partial(atari_wrappers.make_ale_plane_env, args.env)
        probe = env_factory(0)
        n_actions = probe.action_space.n
        probe.close()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.demo:
        core = make_pipeline_core(n_actions, compute_dtype=compute_dtype, lr=args.lr)
        eval_loop = EvalLoop(AtariSim(n_actions=n_actions, device=device), core, 5, 500, device=device)
        example = torch.zeros((1, 84, 84, 4), dtype=torch.uint8, device=eval_loop.device)
        train_state = core.init(torch.Generator().manual_seed(0), example)
        if args.load:
            train_state = load_train_state(train_state, args.load, core, eval_loop.device)
        returns = demo_returns(eval_loop, train_state, args.seed)
        print_demo_line(returns)
        return {"train_state": train_state, "demo_returns": returns}
    pipe = make_dqn_pipeline(
        compute_dtype=compute_dtype, device=device, env_factory=env_factory, n_workers=args.workers,
        lanes_per_worker=args.lanes, capacity=args.replay_capacity, minibatch_size=args.batch_size,
        update_interval=args.update_interval, target_update_interval=args.target_update_interval,
        replay_start_size=args.replay_start_size, burst=args.burst, seed=args.seed, n_actions=n_actions,
        lr=args.lr,
    )
    if args.load:
        pipe.load(args.load)  # kept by ``start``
    pipe.start()
    try:
        last_t, last_steps = time.time(), 0
        while pipe.acted_steps < args.steps:
            if pipe.exception_event.is_set():
                raise RuntimeError("pipeline failed (see logs)")
            time.sleep(args.log_interval)
            now, steps = time.time(), pipe.acted_steps
            stats = dict(pipe.get_statistics())
            print(f"step {steps} | {(steps - last_steps) / (now - last_t):,.0f} env-steps/s | "
                  f"{stats['n_updates']} updates | loss {stats['average_loss']:.4f} | "
                  f"avg Q {stats['average_q']:.2f}", flush=True)
            last_t, last_steps = now, steps
    finally:
        pipe.stop()
    saved_to = save_train_state_if_requested(pipe.train_state, args.save_to, pipe.core)
    return {"train_state": pipe.train_state, "pipeline": pipe, "saved_to": saved_to}


if __name__ == "__main__":
    run()
