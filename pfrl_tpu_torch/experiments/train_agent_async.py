"""``train_agent_async`` (counterpart of
``pfrl_tpu/experiments/train_agent_async.py``; reference parity:
pfrl/experiments/train_agent_async.py). Two modes:

- **actor-learner** (``stop_event`` given, actors from
  ``DQN.setup_actor_learner_training``): one thread per actor runs the
  reference's serial train loop (``train_agent_async.py:27-145``) over its
  own env, built in that thread, acting through the shared inference
  server; evaluation goes through one :class:`AsyncEvaluator`. An
  exception in any actor thread, its env's or agent's construction
  included, sets both events, and the first is raised again after every
  thread has joined. The learner's and poller's failures set the exception
  event, which stops the actors; the caller raises them
  (``DQN.actor_learner_errors``).
- **shared model** (A3C, ACER): ``processes`` lanes of a ``SerialVectorEnv``
  driven by ``train_agent_batch`` with an ``Evaluator``; returns the agent.

Host code only: it imports no torch.
"""

import logging
import os
import threading
from typing import Callable, Optional

from pfrl_tpu_torch.experiments.evaluator import AsyncEvaluator, Evaluator
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch
from pfrl_tpu_torch.utils.stoppable_thread import Counter


def _actor_train_loop(
    process_idx: int,
    env,
    agent,
    steps: int,
    outdir: str,
    counter: Counter,
    episodes_counter: Counter,
    stop_event: threading.Event,
    exception_event: threading.Event,
    max_episode_len: Optional[int],
    evaluator: Optional[AsyncEvaluator],
    eval_env,
    successful_score: Optional[float],
    logger,
    global_step_hooks,
):
    """The reference's train loop (``train_agent_async.py:27-145``), one per
    actor."""
    global_t = 0

    def save_model():
        if process_idx == 0:
            dirname = os.path.join(outdir, f"{global_t}_except")
            agent.save(dirname)
            logger.info("Saved the current model to %s", dirname)

    try:
        episode_r = 0.0
        local_t = 0
        global_episodes = 0
        obs = env.reset()
        episode_len = 0
        successful = False

        while True:
            a = agent.act(obs)
            obs, r, done, info = env.step(a)
            local_t += 1
            episode_r += r
            episode_len += 1
            reset = episode_len == max_episode_len or info.get("needs_reset", False)
            agent.observe(obs, r, done, reset)
            global_t = counter.increment()

            for hook in global_step_hooks:
                hook(env, agent, global_t)

            if done or reset or global_t >= steps or stop_event.is_set():
                if process_idx == 0:
                    logger.info("outdir:%s global_step:%s local_step:%s R:%s", outdir, global_t, local_t, episode_r)
                if evaluator is not None:
                    eval_score = evaluator.evaluate_if_necessary(t=global_t, episodes=global_episodes,
                                                                 env=eval_env, agent=agent)
                    if eval_score is not None and successful_score is not None and eval_score >= successful_score:
                        stop_event.set()
                        successful = True
                        break
                global_episodes = episodes_counter.increment()
                if global_t >= steps or stop_event.is_set():
                    break
                episode_r = 0.0
                episode_len = 0
                obs = env.reset()

            if process_idx == 0 and exception_event.is_set():
                logger.error("An exception detected, exiting")
                save_model()
                stop_event.set()
                break
    except (Exception, KeyboardInterrupt):
        save_model()
        raise

    if global_t >= steps:
        dirname = os.path.join(outdir, f"{steps}_finish")
        agent.save(dirname)
        logger.info("Saved the final agent to %s", dirname)
    if successful:
        dirname = os.path.join(outdir, "successful")
        agent.save(dirname)
        logger.info("Saved the successful agent to %s", dirname)


def _close(env) -> None:
    close = getattr(env, "close", None)
    if close is not None:
        close()


def _train_actor_learner(outdir, processes, make_env, make_agent, stop_event, exception_event, steps, eval_interval,
                         eval_n_steps, eval_n_episodes, max_episode_len, step_offset, successful_score,
                         evaluation_hooks, save_best_so_far_agent, global_step_hooks, logger):
    counter = Counter()
    episodes_counter = Counter()
    exception_event = exception_event or threading.Event()
    evaluator = None
    if eval_interval is not None:
        evaluator = AsyncEvaluator(
            n_steps=eval_n_steps, n_episodes=eval_n_episodes, eval_interval=eval_interval, outdir=outdir,
            max_episode_len=max_episode_len, step_offset=step_offset, evaluation_hooks=evaluation_hooks,
            save_best_so_far_agent=save_best_so_far_agent, logger=logger,
        )
    errors = []

    def run(i):
        envs = []
        try:
            env = make_env(i, test=False)
            envs.append(env)
            eval_env = make_env(i, test=True)
            envs.append(eval_env)
            agent = make_agent(i)
            _actor_train_loop(
                process_idx=i, env=env, agent=agent, steps=steps, outdir=outdir, counter=counter,
                episodes_counter=episodes_counter, stop_event=stop_event, exception_event=exception_event,
                max_episode_len=max_episode_len, evaluator=evaluator, eval_env=eval_env,
                successful_score=successful_score, logger=logger, global_step_hooks=global_step_hooks,
            )
        except BaseException as e:
            errors.append(e)
            exception_event.set()
            stop_event.set()
        finally:
            for env in envs:
                try:
                    _close(env)
                except Exception as e:  # a failed close fails the run too
                    errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"actor-{i}") for i in range(processes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop_event.set()
    if errors:
        raise errors[0]


def train_agent_async(
    outdir: str,
    processes: int,
    make_env: Callable[[int, bool], object],
    *,
    profile: bool = False,
    steps: int = 8 * 10**7,
    eval_interval: Optional[int] = 10**6,
    eval_n_steps: Optional[int] = None,
    eval_n_episodes: int = 10,
    max_episode_len: Optional[int] = None,
    step_offset: int = 0,
    successful_score: Optional[float] = None,
    agent=None,
    make_agent: Optional[Callable] = None,
    global_step_hooks=(),
    evaluation_hooks=(),
    save_best_so_far_agent: bool = True,
    stop_event: Optional[threading.Event] = None,
    exception_event: Optional[threading.Event] = None,
    logger=None,
):
    """Drives ``processes`` env instances (see the module docstring for the
    two modes). ``make_env(process_idx, test)`` is the reference's factory.
    With ``stop_event`` (the learner's) this runs the actor-learner mode and
    returns None; otherwise it trains the one shared agent synchronously and
    returns it."""
    logger = logger or logging.getLogger(__name__)

    if stop_event is not None:
        assert make_agent is not None, "actor-learner mode needs make_agent from setup_actor_learner_training"
        return _train_actor_learner(
            outdir=outdir, processes=processes, make_env=make_env, make_agent=make_agent, stop_event=stop_event,
            exception_event=exception_event, steps=steps, eval_interval=eval_interval, eval_n_steps=eval_n_steps,
            eval_n_episodes=eval_n_episodes, max_episode_len=max_episode_len, step_offset=step_offset,
            successful_score=successful_score, evaluation_hooks=evaluation_hooks,
            save_best_so_far_agent=save_best_so_far_agent, global_step_hooks=global_step_hooks, logger=logger,
        )

    from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv

    train_env = SerialVectorEnv([make_env(i, False) for i in range(processes)])
    eval_env = SerialVectorEnv([make_env(i, True) for i in range(processes)])
    if agent is None:
        assert make_agent is not None
        agent = make_agent(0)

    if profile:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()

    evaluator = Evaluator(
        agent=agent, env=eval_env, n_steps=eval_n_steps, n_episodes=eval_n_episodes, eval_interval=eval_interval,
        outdir=outdir, max_episode_len=max_episode_len, step_offset=step_offset,
        save_best_so_far_agent=save_best_so_far_agent, logger=logger,
    )
    train_agent_batch(
        agent, train_env, steps, outdir, max_episode_len=max_episode_len, step_offset=step_offset,
        evaluator=evaluator, successful_score=successful_score, step_hooks=global_step_hooks, logger=logger,
    )
    if profile:
        profiler.disable()
        profiler.dump_stats(f"{outdir}/profile.stats")
    return agent
