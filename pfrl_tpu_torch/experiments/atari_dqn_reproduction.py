"""The host path of ``examples/atari/reproduction/dqn/train_dqn.py`` (its
``run_ale``, ``:103-164``), Nature DQN at the reproduction's settings.

The training env is ``wrap_deepmind(make_atari(--env, --max-frames))``
with lives ending episodes and rewards clipped (84x84x4 uint8 stacks); the
evaluation env the same without either, under ``RandomizeAction(0.05)``
(the Atari evaluation protocol). The agent is the :class:`DQN` shell over
``NatureQ`` (``LargeAtariCNN`` -> Dense(n_actions)), optax-semantics
RMSprop(2.5e-4, decay 0.95, eps 1e-2), ``LinearDecayEpsilonGreedy`` 1.0 ->
``--final-epsilon`` 0.1 over ``--final-exploration-frames`` 10^6, a uniform
ring of ``--replay-capacity`` 10^5 slots that stores next observations
(the example's ``ReplayBuffer(capacity, gamma=0.99)``), a summed Huber
loss, batch-32 updates every 4 transitions from ``--replay-start-size``
50,000 on, hard syncs every ``--target-update-interval`` 10^4 and the
observations scaled by 1/255 (``atari_phi``); ``train_agent_with_evaluation``
evaluates 125,000 steps every 250,000. ``--load``/``--demo`` as the
example's. The ``--sim`` recipe is not this module's.
"""

import argparse
import functools
from typing import Optional, Sequence

from pfrl_tpu_torch.agents.dqn import DQN
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi
from pfrl_tpu_torch.wrappers import atari_wrappers


def build_parser() -> argparse.ArgumentParser:
    """``train_dqn.py``'s flags but ``--sim``, ``--num-envs`` and ``--bf16``
    (``:167-187``), which its ``run_ale`` does not read."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--replay-capacity", type=int, default=10**5)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--final-epsilon", type=float, default=0.1)
    parser.add_argument("--final-exploration-frames", type=int, default=10**6)
    parser.add_argument("--max-frames", type=int, default=atari_wrappers.MAX_FRAMES)
    parser.add_argument("--outdir", default="results/dqn")
    add_demo_args(parser)
    return parser


def make_agent(n_actions: int, args, device=None) -> DQN:
    return DQN(
        NatureQ(n_actions),
        RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        ReplayBuffer(args.replay_capacity, gamma=0.99, device=device),
        0.99,
        LinearDecayEpsilonGreedy(1.0, args.final_epsilon, args.final_exploration_frames, n_actions),
        replay_start_size=args.replay_start_size,
        minibatch_size=32,
        update_interval=4,
        target_update_interval=args.target_update_interval,
        batch_accumulator="sum",
        phi=atari_phi,
        seed=args.seed,
        device=device,
    )


def run_ale(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_dqn.py`` without ``--sim`` with ``argv``'s flags on
    ``device`` (default: the CUDA device). Returns ``{"agent", "history"}``
    (``{"agent", "stats"}`` with ``--demo``)."""
    from pfrl_tpu_torch._device import resolve_device
    from pfrl_tpu_torch.experiments.evaluator import eval_performance
    from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    make = functools.partial(atari_wrappers.make_atari_deepmind, args.env, max_frames=args.max_frames,
                             randomize_action=0.05)
    env, eval_env = make(test=False), make(test=True)
    agent = make_agent(env.action_space.n, args, device)
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} "
              f"median: {stats['median']} stdev: {stats['stdev']}")
        return {"agent": agent, "stats": stats}
    agent, history = train_agent_with_evaluation(
        agent, env, steps=args.steps, eval_n_steps=125_000, eval_n_episodes=None, eval_interval=250_000,
        outdir=args.outdir, eval_env=eval_env,
    )
    return {"agent": agent, "history": history}
