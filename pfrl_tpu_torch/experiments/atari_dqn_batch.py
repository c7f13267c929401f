"""``examples/atari/train_dqn_batch_ale.py``'s default mode, ``run_batch``
(``:45-123``), at the example's own settings: the host-env object path.

The agent (:func:`make_dqn_batch_agent`, the example's ``build_agent``) is
the :class:`~pfrl_tpu_torch.agents.dqn.DQN` shell over ``NatureQ``
(``LargeAtariCNN`` -> Dense(n_actions) -> ``DiscreteActionValueHead``) with
optax-semantics Adam(2.5e-4, eps 1.5e-4), a uniform ring of 10^6 slots on
the card (``store_next_obs=False``, dequantized by 1/255 in the gather:
28,224-byte stacks padded to 28,288: 28.288 GB), ``LinearDecayEpsilonGreedy``
1.0 -> 0.01 over 10^6 transitions, ``atari_phi``, batch-32 updates once per
4 transitions from 50,000 on, and a hard target sync every 10^4.

The envs (:func:`make_vector_envs`) are two ``MultiprocessVectorEnv`` of 8
spawned workers each, one for training and one for evaluation, over
``envs.synthetic_ale.make_ale_env``: ``wrap_deepmind`` around
``MaxAndSkipEnv(SyntheticALE(seed), skip=4)`` in place of
``make_atari(args.env)`` (ALE is not installed). SyntheticALE has no lives,
so training runs with ``episode_life=False``: the one change from the
example. :func:`run_batch` drives them through
``train_agent_batch_with_evaluation`` with 10 evaluation episodes, one
batch step at a time: observations go up to the card and actions come
down on every step. Sizes are arguments, so that tests run it small.

:func:`run_actor_learner` is the example's ``--actor-learner`` mode
(``:126-152``) at the same settings: the same agent, its actor-learner half
(``DQN.setup_actor_learner_training(n_actors=8)``: one actor thread per
env, one batched inference server, the poller and the learner threads,
publications every 8 updates) driven by ``train_agent_async``; actor ``i``
builds its training env (seed ``seed + i``) and its evaluation env (seed
``seed + i + 10**6``, ``RandomizeAction(0.05)``) in its own thread, with
the same one cut, ``episode_life=False``.
"""

import functools
from typing import Optional, Tuple

import torch

from pfrl_tpu_torch import runtime
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.agents.dqn import DQN
from pfrl_tpu_torch.envs import synthetic_ale
from pfrl_tpu_torch.envs.multiprocess_vector_env import MultiprocessVectorEnv
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.experiments.train_agent_async import train_agent_async
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi


def make_dqn_batch_agent(
    n_actions: int = 6,
    num_envs: int = 8,
    capacity: int = 10**6,
    replay_start_size: int = 5 * 10**4,
    update_interval: int = 4,
    target_update_interval: int = 10**4,
    minibatch_size: int = 32,
    lr: float = 2.5e-4,
    final_exploration_frames: int = 10**6,
    compute_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
    draws=None,
) -> DQN:
    """``build_agent`` (``train_dqn_batch_ale.py:54-73``) on ``device``
    (default: the CUDA device)."""
    device = resolve_device(device)
    return DQN(
        q_function=NatureQ(n_actions),
        optimizer=Adam(lr, eps=1.5e-4),
        replay_buffer=ReplayBuffer(
            capacity, gamma=0.99, num_lanes=num_envs, store_next_obs=False,
            fused_dequant_scale=1.0 / 255.0, device=device,
        ),
        gamma=0.99,
        explorer=LinearDecayEpsilonGreedy(1.0, 0.01, final_exploration_frames, n_actions),
        replay_start_size=replay_start_size,
        minibatch_size=minibatch_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        phi=atari_phi,
        compute_dtype=compute_dtype,
        seed=seed,
        device=device,
        draws=draws,
    )


def make_vector_envs(num_envs: int = 8, seed: int = 0) -> Tuple[MultiprocessVectorEnv, MultiprocessVectorEnv]:
    """The training and the evaluation ``MultiprocessVectorEnv``
    (``train_dqn_batch_ale.py:93-99``) of ``synthetic_ale.make_ale_env(seed,
    idx, test)``. The frame ops are built here, before any worker spawns:
    the workers load the library and never build it."""
    runtime.build()
    make = synthetic_ale.make_ale_env
    env = MultiprocessVectorEnv([functools.partial(make, seed, i, False) for i in range(num_envs)])
    try:
        eval_env = MultiprocessVectorEnv([functools.partial(make, seed, i, True) for i in range(num_envs)])
    except BaseException:
        env.close()
        raise
    return env, eval_env


def run_batch(
    outdir: str,
    steps: int = 5 * 10**7,
    eval_interval: int = 10**5,
    eval_n_episodes: int = 10,
    num_envs: int = 8,
    seed: int = 0,
    device=None,
    **agent_kwargs,
):
    """``train_dqn_batch_ale.py``'s ``run_batch``: builds the agent and the
    envs, trains through ``train_agent_batch_with_evaluation``, closes the
    envs. Returns ``(agent, history)``."""
    agent = make_dqn_batch_agent(num_envs=num_envs, seed=seed, device=device, **agent_kwargs)
    env, eval_env = make_vector_envs(num_envs, seed)
    try:
        return train_agent_batch_with_evaluation(
            agent=agent, env=env, eval_env=eval_env, steps=steps, eval_n_steps=None,
            eval_n_episodes=eval_n_episodes, eval_interval=eval_interval, outdir=outdir,
        )
    finally:
        for e in (env, eval_env):
            if not e.closed:
                e.close()


def run_actor_learner(
    outdir: str,
    steps: int = 5 * 10**7,
    eval_interval: int = 10**5,
    eval_n_episodes: int = 10,
    num_envs: int = 8,
    seed: int = 0,
    device=None,
    agent: Optional[DQN] = None,
    global_step_hooks=(),
    learner_step_hooks=(),
    n_updates: Optional[int] = None,
    **agent_kwargs,
) -> DQN:
    """``train_dqn_batch_ale.py``'s ``run_actor_learner``: builds the agent
    (or takes ``agent``), starts the poller and the learner, drives
    ``num_envs`` actor threads through ``train_agent_async``, then stops and
    joins the learner and the poller (which stops the server). A failure of
    any of these threads is raised here after the join. Returns the
    learner agent."""
    if agent is None:
        agent = make_dqn_batch_agent(num_envs=num_envs, seed=seed, device=device, **agent_kwargs)
    runtime.build()  # the frame ops, once, before the actor threads load them
    make_actor, learner, poller, exception_event = agent.setup_actor_learner_training(
        n_actors=num_envs, n_updates=n_updates, step_hooks=learner_step_hooks)
    poller.start()
    learner.start()
    try:
        train_agent_async(
            outdir=outdir, processes=num_envs, make_env=functools.partial(synthetic_ale.make_ale_env, seed),
            steps=steps, eval_interval=eval_interval, eval_n_steps=None, eval_n_episodes=eval_n_episodes,
            make_agent=make_actor, stop_event=learner.stop_event, exception_event=exception_event,
            global_step_hooks=global_step_hooks,
        )
    finally:
        learner.stop()
        learner.join()
        poller.stop()
        poller.join()
        if agent.actor_learner_errors:  # the cause, before what the actors raised after it
            raise agent.actor_learner_errors[0]
    return agent
