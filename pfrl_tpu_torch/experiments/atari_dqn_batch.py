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
spawned workers each, one for training and one for evaluation, over the
example's ``make_ale_env`` (``:76-89``):
``wrap_deepmind(make_atari(env_id))`` (84x84x4 uint8 stacks, hwc; lives
end training episodes and rewards are clipped in training), seeded ``seed +
idx`` (``+ 10**6`` for an evaluation env), and an evaluation env takes a
random action 5% of the time. A factory ``make_env(seed, idx, test)`` may
be passed in its place: ``envs.synthetic_ale.make_ale_env``, over
``SyntheticALE`` (which has no lives, so its training runs with
``episode_life=False``), is the one that runs where ALE is not installed.
:func:`run_batch` drives them through ``train_agent_batch_with_evaluation``
with 10 evaluation episodes, one batch step at a time: observations go up
to the card and actions come down on every step. Sizes are arguments, so
that tests run it small.

:func:`run_actor_learner` is the example's ``--actor-learner`` mode
(``:126-152``) at the same settings: the same agent, its actor-learner half
(``DQN.setup_actor_learner_training(n_actors=8)``: one actor thread per
env, one batched inference server, the poller and the learner threads,
publications every 8 updates) driven by ``train_agent_async``; actor ``i``
builds its training env (seed ``seed + i``) and its evaluation env (seed
``seed + i + 10**6``, ``RandomizeAction(0.05)``) in its own thread, of the
same ``env_id`` or ``make_env``.

:func:`run_multihost` is the example's ``--multihost`` mode (``:153-224``):
the device runner over a ``dp`` mesh of the joined processes, the lanes and
the ring's rows split over them (``parallel/``).
"""

import argparse
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch import runtime
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.agents.dqn import DQN
from pfrl_tpu_torch.envs.multiprocess_vector_env import MultiprocessVectorEnv, make_together
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.train_agent_async import train_agent_async
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi
from pfrl_tpu_torch.wrappers import atari_wrappers

ENV_ID = "BreakoutNoFrameskip-v4"  # the example's --env


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


def _env_factory(env_id: str, make_env: Optional[Callable], seed: int, idx: int, test: bool) -> Callable:
    """A picklable factory of env ``idx``: ``make_env(seed, idx, test)``
    where given, else the example's ``make_ale_env(args, idx, test)``
    (``train_dqn_batch_ale.py:76-89``), ``atari_wrappers.make_atari_deepmind``
    of ``env_id`` seeded ``seed + idx`` (``+ 10**6`` for an evaluation env)
    with 5% random actions in evaluation. Its module imports no torch, so a
    spawned worker that builds it loads none."""
    if make_env is not None:
        return functools.partial(make_env, seed, idx, test)
    return functools.partial(atari_wrappers.make_atari_deepmind, env_id, test, seed + idx + (10**6 if test else 0),
                             randomize_action=0.05)


def make_vector_envs(num_envs: int = 8, seed: int = 0, env_id: str = ENV_ID,
                     make_env: Optional[Callable] = None) -> Tuple[MultiprocessVectorEnv, MultiprocessVectorEnv]:
    """The training and the evaluation ``MultiprocessVectorEnv``
    (``train_dqn_batch_ale.py:93-99``) of the example's env of ``env_id``
    or, where given, of ``make_env(seed, idx,
    test)`` (``synthetic_ale.make_ale_env``), their workers started
    together. The frame ops are built here, before any worker spawns: the
    workers load the library and never build it."""
    runtime.build()
    return make_together(*(functools.partial(MultiprocessVectorEnv, [_env_factory(env_id, make_env, seed, i, test)
                                                                     for i in range(num_envs)])
                           for test in (False, True)))


def run_batch(
    outdir: str,
    steps: int = 5 * 10**7,
    eval_interval: int = 10**5,
    eval_n_episodes: int = 10,
    num_envs: int = 8,
    seed: int = 0,
    device=None,
    load: Optional[str] = None,
    demo: bool = False,
    env_id: str = ENV_ID,
    make_env: Optional[Callable] = None,
    **agent_kwargs,
):
    """``train_dqn_batch_ale.py``'s ``run_batch``: builds the agent and the
    envs, loads ``load`` (``agent.load``: the port's ``train_state.pt``, or
    a JAX shell's ``train_state.msgpack``) where given, then with ``demo``
    evaluates 10 episodes, prints the example's line and returns ``(agent,
    stats)``; else trains through ``train_agent_batch_with_evaluation`` and
    returns ``(agent, history)``. The envs are ``make_vector_envs(num_envs,
    seed, env_id, make_env)``'s, and the agent takes its action count from
    them, as the example's ``build_agent(env.action_space.n, ...)``; it
    closes them."""
    device = resolve_device(device)  # before any worker spawns
    env, eval_env = make_vector_envs(num_envs, seed, env_id=env_id, make_env=make_env)
    try:
        agent = make_dqn_batch_agent(num_envs=num_envs, seed=seed, device=device,
                                     **{"n_actions": env.action_space.n, **agent_kwargs})
        if load:
            agent.load(load)
        if demo:
            stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=10)
            print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} "
                  f"median: {stats['median']} stdev: {stats['stdev']}")
            return agent, stats
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
    env_id: str = ENV_ID,
    make_env: Optional[Callable] = None,
    **agent_kwargs,
) -> DQN:
    """``train_dqn_batch_ale.py``'s ``run_actor_learner``: builds the agent
    (or takes ``agent``), starts the poller and the learner, drives
    ``num_envs`` actor threads through ``train_agent_async``, then stops and
    joins the learner and the poller (which stops the server). Actor ``i``
    builds the example's env of ``env_id`` or ``make_env(seed, i, test)``;
    a built agent takes its action count from a probe env, as the example's.
    A failure of any of these threads is raised here after the join.
    Returns the learner agent."""
    if agent is None:
        device = resolve_device(device)
        probe = _env_factory(env_id, make_env, seed, 0, False)()
        n_actions = probe.action_space.n
        probe.close()
        agent = make_dqn_batch_agent(num_envs=num_envs, seed=seed, device=device,
                                     **{"n_actions": n_actions, **agent_kwargs})
    runtime.build()  # the frame ops, once, before the actor threads load them
    make_actor, learner, poller, exception_event = agent.setup_actor_learner_training(
        n_actors=num_envs, n_updates=n_updates, step_hooks=learner_step_hooks)
    poller.start()
    learner.start()
    try:
        train_agent_async(
            outdir=outdir, processes=num_envs,
            make_env=lambda idx, test: _env_factory(env_id, make_env, seed, idx, test)(),
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


def build_parser() -> argparse.ArgumentParser:
    """``train_dqn_batch_ale.py``'s flags (``:227-252``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default=ENV_ID)
    parser.add_argument("--actor-learner", action="store_true")
    parser.add_argument("--multihost", default=None, metavar="HOST:PORT",
                        help="the coordinator's address; shards the device workload over the joined processes")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=8)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--update-interval", type=int, default=4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--eval-interval", type=int, default=10**5)
    parser.add_argument("--outdir", default="results/dqn_batch_ale")
    add_demo_args(parser)
    return parser


def _agent_kwargs(args) -> dict:
    """``build_agent``'s settings from the flags."""
    return dict(capacity=args.replay_capacity, replay_start_size=args.replay_start_size,
                update_interval=args.update_interval, target_update_interval=args.target_update_interval,
                minibatch_size=args.batch_size, lr=args.lr, compute_dtype=torch.bfloat16 if args.bf16 else None)


def run(argv: Optional[Sequence[str]] = None, device=None, make_env: Optional[Callable] = None):
    """``train_dqn_batch_ale.py``'s ``main``: ``--multihost`` goes to
    :func:`run_multihost`, ``--actor-learner`` to :func:`run_actor_learner`
    (``--load``/``--demo``/``--save-to`` are parsed and not read, as in the
    example), anything else to :func:`run_batch`. ``make_env(seed, idx,
    test)`` replaces the example's ALE env (``synthetic_ale.make_ale_env``
    where ALE is not installed)."""
    args = build_parser().parse_args(argv)
    if args.multihost:
        return run_multihost(argv, device)
    common = dict(outdir=args.outdir, steps=args.steps, eval_interval=args.eval_interval, num_envs=args.num_envs,
                  seed=args.seed, device=device, env_id=args.env, make_env=make_env, **_agent_kwargs(args))
    if args.actor_learner:
        return run_actor_learner(**common)
    return run_batch(load=args.load, demo=args.demo, **common)


def run_multihost(argv: Optional[Sequence[str]] = None, device=None, keep_job: bool = False,
                  chunk: int = 500) -> dict:
    """``train_dqn_batch_ale.py --multihost HOST:PORT --num-processes N
    --process-id I`` (``run_multihost``, ``:153-224``): every process runs
    this same call with its own ``--process-id``. They join one job
    (``parallel.initialize_multihost``: NCCL on the card, Gloo with
    ``device="cpu"``) and one ``dp`` mesh; the device runner trains DQN on
    the Nature Q-network (Adam(``--lr``, eps 1.5e-4), the ``"sum"``
    accumulator, epsilon 1 -> 0.01 over 10^6 transitions, ``atari_phi``)
    over ``--num-envs`` (8) AtariSim lanes, split over the processes, and
    the uniform ring of ``--replay-capacity`` (10^6) slots, dequantized by
    1/255 in the gather, its rows split with the lanes; batch-32 updates
    every 4 transitions from 50,000 on, hard syncs every 10^4. It runs in
    chunks of ``chunk`` scan steps (the example's 500) until ``--steps``
    transitions; only the
    primary process prints. The job is left at the end, or on a failure
    (``keep_job``: kept after a run that ended well, for the caller to
    drive the runner further and then call ``parallel.multihost.shutdown``).
    Returns ``{"runner", "state", "mesh", "chunks"}``, ``chunks`` a list of
    ``(t, global env-steps/s, last loss)``."""
    import time

    from pfrl_tpu_torch.agents.dqn import DQNCore
    from pfrl_tpu_torch.envs.atari_sim import AtariSim
    from pfrl_tpu_torch.experiments.runner import OffPolicyRunner, RunnerConfig
    from pfrl_tpu_torch.parallel.multihost import global_mesh, initialize_multihost, is_primary, shutdown

    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.multihost:
        parser.error("run_multihost needs --multihost HOST:PORT")
    device = initialize_multihost(args.multihost, args.num_processes, args.process_id, device=device)
    try:
        mesh = global_mesh(("dp",))
        n_actions = 6
        core = DQNCore(
            model=NatureQ(n_actions), optimizer=Adam(args.lr, eps=1.5e-4),
            explorer=LinearDecayEpsilonGreedy(1.0, 0.01, 10**6, n_actions), gamma=0.99, batch_accumulator="sum",
            phi=atari_phi, compute_dtype=torch.bfloat16 if args.bf16 else None,
        )
        config = RunnerConfig(num_envs=args.num_envs, replay_start_size=args.replay_start_size,
                              update_interval=args.update_interval,
                              target_update_interval=args.target_update_interval, minibatch_size=args.batch_size)
        buffer = ReplayBuffer(args.replay_capacity, gamma=0.99, num_lanes=args.num_envs, store_next_obs=False,
                              fused_dequant_scale=1.0 / 255.0, device=device)
        runner = OffPolicyRunner(AtariSim(n_actions=n_actions, device=device), core, buffer, config, device=device,
                                 mesh=mesh)
        state = runner.init(args.seed)
        chunks = []
        while state.t < args.steps:
            t0 = time.time()
            state, metrics = runner.run_chunk(state, chunk)
            loss = float(metrics["loss"][-1])
            sps = chunk * args.num_envs / (time.time() - t0)
            chunks.append((state.t, sps, loss))
            if is_primary():
                print(f"step {state.t} | {sps:,.0f} env-steps/s global | loss {loss:.4f}", flush=True)
    except BaseException:
        shutdown()
        raise
    if not keep_job:
        shutdown()
    return {"runner": runner, "state": state, "mesh": mesh, "chunks": chunks}


if __name__ == "__main__":
    run()
