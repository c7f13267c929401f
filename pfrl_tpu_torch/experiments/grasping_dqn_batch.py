"""``examples/grasping/train_dqn_batch_grasping.py`` at its own settings: the
host-env object path over structured ``(image, elapsed_steps)``
observations.

:class:`GraspingQFunction` is the script's network (``:32-54``): the
Nature-CNN convolutions (32 8x8/4, 64 4x4/2, 64 3x3/1, VALID, ReLU after
the first two) on the 84x84x3 image, flattened in flax's NHWC order (7 x 7
x 64 = 3,136 features), times ``sigmoid`` of a learned embedding of the
elapsed steps (``max_episode_steps + 1`` rows of 3,136, flax's ``Embed``),
then Dense 512 with ReLU and Dense ``n_actions``: 1,715,434 parameters at
10 actions and 8 steps. The gate multiplies the NHWC-ordered features, so
the permutation back to NHWC comes before it, not only before the Dense
(ROADMAP C). Weights follow flax's defaults (truncated LeCun normal, zero
biases; the embedding a truncated normal of variance 1 / 3,136); the
converter carries a JAX network across exactly in any case
(``Embed_0/embedding`` copied as it is).

:func:`make_grasping_agent` is the script's agent (``:216-240``):
``DoubleDQN`` over a ``PrioritizedReplayBuffer`` (alpha 0.6, beta0 0.4,
``betasteps = steps``; its proportional draw runs the prefix-sample kernel
once per update on the card), Adam(6.25e-5), gamma 0.99,
``LinearDecayEpsilonGreedy`` 1 -> 0.2 over 5 x 10^5 transitions, batch 32,
an update per transition from 5 x 10^4 on and a hard target sync every
10^4, on the CUDA device unless given ``device="cpu"``. The ring stores
both leaves of ``obs`` and ``next_obs``: the image as 21,248 float32 (21,168
padded to a multiple of 128: 84,992 B) and the steps as int32 (uploaded
from numpy's int64 as ``jnp.asarray`` has it, ROADMAP C F3).

:func:`run` is the script's ``main``: its flags, ``--jax-env`` (the in-repo
:class:`~pfrl_tpu_torch.envs.synthetic_grasping.SyntheticGraspingEnv`; the
pybullet env otherwise, which raises by name where pybullet is missing),
``--load``, ``--demo`` and ``train_agent_batch_with_evaluation`` with
``log_interval=1000`` over a ``MultiprocessVectorEnv`` of ``--num-envs``
spawned workers (``--serial-envs``: a ``SerialVectorEnv``).
"""

import argparse
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.action_value import DiscreteActionValue
from pfrl_tpu_torch.agents.double_dqn import DoubleDQN
from pfrl_tpu_torch.envs.multiprocess_vector_env import MultiprocessVectorEnv
from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv
from pfrl_tpu_torch.envs.synthetic_grasping import make_grasping_env
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models.layers import Conv2d, Linear
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

IMAGE_SHAPE = (84, 84, 3)
# The ring's slots on one 80 GB card: 400,000 x 2 x 84,992 B of images is
# 68.0 GB (the script's 10^6 would take 170 GB); the PER tree's C is 2^19.
CARD_CAPACITY = 400_000


class GraspingQFunction(nn.Module):
    """The script's ``GraspingQFunction``: input ``(image [B, 84, 84, 3]
    float, steps [B] int)``; flax's scopes ``Conv_0..2``, ``Embed_0``,
    ``Dense_0``, ``Dense_1``."""

    convs_spec = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, n_actions: int = 10, max_episode_steps: int = 8):
        super().__init__()
        convs, c, h = [], IMAGE_SHAPE[2], IMAGE_SHAPE[0]
        for features, k, s in self.convs_spec:
            convs.append(Conv2d(c, features, k, stride=s))
            c, h = features, (h - k) // s + 1
        self.convs = nn.ModuleList(convs)
        n_features = h * h * c
        self.embedding = nn.Parameter(torch.empty(max_episode_steps + 1, n_features))
        self.dense = Linear(n_features, 512)
        self.out = Linear(512, n_actions)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (*self.convs, self.dense, self.out):
            initializers.truncated_lecun_normal_(layer.weight, generator=generator)
            layer.bias.zero_()
        # variance_scaling(1, "fan_in", "normal", out_axis=0): fan in 3,136.
        initializers.truncated_lecun_normal_(self.embedding, generator=generator)

    def flax_names(self) -> Dict[str, str]:
        names = {f"convs.{i}": f"Conv_{i}" for i in range(len(self.convs))}
        names.update({"embedding": "Embed_0/embedding", "dense": "Dense_0", "out": "Dense_1"})
        return names

    def forward(self, x, draws=None) -> DiscreteActionValue:
        image, steps = x
        h = image.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if i < len(self.convs) - 1:
                h = torch.relu(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's HWC order, before the gate
        gate = nn.functional.embedding(steps, self.embedding)
        h = h * torch.sigmoid(gate)
        h = torch.relu(self.dense(h))
        return DiscreteActionValue(q_values=self.out(h))


def make_grasping_agent(
    n_actions: int = 10,
    max_episode_steps: int = 8,
    capacity: int = 10**6,
    replay_start_size: int = 5 * 10**4,
    steps: int = 2 * 10**6,
    final_exploration_steps: int = 5 * 10**5,
    final_epsilon: float = 0.2,
    target_update_interval: int = 10**4,
    update_interval: int = 1,
    minibatch_size: int = 32,
    lr: float = 6.25e-5,
    gamma: float = 0.99,
    compute_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
    draws=None,
) -> DoubleDQN:
    """The script's agent (``:216-240``); ``steps`` is the run's length,
    PER's ``betasteps``."""
    return DoubleDQN(
        GraspingQFunction(n_actions, max_episode_steps),
        Adam(lr),
        PrioritizedReplayBuffer(capacity, alpha=0.6, beta0=0.4, betasteps=steps, gamma=gamma, device=device),
        gamma,
        LinearDecayEpsilonGreedy(1.0, final_epsilon, final_exploration_steps, n_actions),
        replay_start_size=replay_start_size,
        minibatch_size=minibatch_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        compute_dtype=compute_dtype,
        seed=seed,
        device=device,
        draws=draws,
    )


def make_batch_env(num_envs: int = 1, seed: int = 0, test: bool = False, serial: bool = False,
                   jax_env: bool = True, max_episode_steps: int = 8, render: bool = False, demo: bool = False):
    """The script's ``make_batch_env``: env ``i`` seeded ``seed * num_envs +
    i`` (``+ 10,000`` for evaluation), in a ``MultiprocessVectorEnv`` of
    spawned workers or, with ``serial``, a ``SerialVectorEnv``."""
    fns = [functools.partial(make_grasping_env, jax_env, max_episode_steps,
                             seed * num_envs + i + (10_000 if test else 0), test, render, demo)
           for i in range(num_envs)]
    if serial:
        return SerialVectorEnv([fn() for fn in fns])
    return MultiprocessVectorEnv(fns)


def make_vector_envs(num_envs: int = 1, seed: int = 0):
    """The training and the evaluation ``MultiprocessVectorEnv`` of
    ``--jax-env``'s synthetic env, as :func:`run` builds them, their
    workers started together."""
    from pfrl_tpu_torch.envs.multiprocess_vector_env import make_together

    return make_together(*(functools.partial(make_batch_env, num_envs, seed, test=test) for test in (False, True)))


def random_observations(rs: np.random.RandomState, lanes: int, max_episode_steps: int = 8) -> list:
    """``lanes`` observations as the vector envs hand them to the shell: a
    list of ``(float32 image in [0, 1.1), python int steps)`` tuples."""
    images = rs.uniform(0.0, 1.1, (lanes,) + IMAGE_SHAPE).astype(np.float32)
    return [(images[i], int(s)) for i, s in enumerate(rs.randint(0, max_episode_steps + 1, lanes))]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--outdir", default="results/grasping")
    parser.add_argument("--jax-env", "--torch-env", dest="jax_env", action="store_true",
                        help="train on the in-repo synthetic grasping simulator instead of pybullet's "
                             "KukaDiverseObjectEnv (without this flag a missing pybullet is a hard error)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--load", default=None)
    parser.add_argument("--final-exploration-steps", type=int, default=5 * 10**5)
    parser.add_argument("--final-epsilon", type=float, default=0.2)
    parser.add_argument("--steps", type=int, default=2 * 10**6)
    parser.add_argument("--max-episode-steps", type=int, default=8)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--eval-interval", type=int, default=10**5)
    parser.add_argument("--update-interval", type=int, default=1)
    parser.add_argument("--eval-n-runs", type=int, default=100)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--lr", type=float, default=6.25e-5)
    parser.add_argument("--num-envs", type=int, default=1)
    parser.add_argument("--serial-envs", action="store_true")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--gamma", type=float, default=0.99)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None):
    """The script's ``main``: returns ``(agent, stats)`` with ``--demo``,
    else ``(agent, (agent, history))`` from the driver. Closes the envs."""
    args = _parser().parse_args(argv)
    sample_env = make_grasping_env(args.jax_env, args.max_episode_steps, args.seed, False)
    n_actions = sample_env.action_space.n
    sample_env.close()
    agent = make_grasping_agent(
        n_actions, args.max_episode_steps, capacity=args.replay_capacity,
        replay_start_size=args.replay_start_size, steps=args.steps,
        final_exploration_steps=args.final_exploration_steps, final_epsilon=args.final_epsilon,
        target_update_interval=args.target_update_interval, update_interval=args.update_interval,
        minibatch_size=args.batch_size, lr=args.lr, gamma=args.gamma,
        compute_dtype=torch.bfloat16 if args.bf16 else None, seed=args.seed, device=device,
    )
    if args.load:
        agent.load(args.load)
    make = functools.partial(make_batch_env, args.num_envs, args.seed, serial=args.serial_envs, jax_env=args.jax_env,
                             max_episode_steps=args.max_episode_steps, render=args.render, demo=args.demo)
    if args.demo:
        env = make(test=True)
        try:
            stats = eval_performance(env=env, agent=agent, n_steps=None, n_episodes=args.eval_n_runs)
        finally:
            env.close()
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']}")
        return agent, stats
    env = make(test=False)
    try:
        eval_env = make(test=True)
    except BaseException:
        env.close()
        raise
    try:
        return agent, train_agent_batch_with_evaluation(
            agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=args.eval_n_runs,
            eval_interval=args.eval_interval, outdir=args.outdir, eval_env=eval_env, log_interval=1000,
        )
    finally:
        for e in (env, eval_env):
            if not getattr(e, "closed", False):
                e.close()
