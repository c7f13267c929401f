"""Serial training driver (counterpart of
``pfrl_tpu/experiments/train_agent.py``; reference contract:
pfrl/experiments/train_agent.py).

Same public API and observable behavior as the reference's
``train_agent_with_evaluation`` (train_agent.py:114): per-step
act/step/observe over one host env, the done-vs-reset truncation
distinction, scheduled evaluation with success-based early stop, periodic
checkpoints, crash saves. The implementation is this repo's own shape —
an episode-nested loop over the shared :class:`TrainRun` services
(train_loop.py) — rather than the reference's flat while-loop. This is
the compatibility path for external envs; the port's device envs train
faster through the runners (experiments/runner.py).
"""

import logging
import os
from typing import Optional

from pfrl_tpu_torch.experiments.train_loop import TrainRun, build_evaluator, save_agent

__all__ = ["train_agent", "train_agent_with_evaluation", "save_agent"]


def train_agent(
    agent,
    env,
    steps: int,
    outdir: str,
    checkpoint_freq=None,
    max_episode_len=None,
    step_offset: int = 0,
    evaluator=None,
    successful_score=None,
    step_hooks=(),
    eval_during_episode: bool = False,
    logger=None,
):
    run = TrainRun(
        agent=agent,
        outdir=outdir,
        logger=logger or logging.getLogger(__name__),
        env=env,
        evaluator=evaluator,
        successful_score=successful_score,
        checkpoint_freq=checkpoint_freq,
        step_hooks=step_hooks,
        t=step_offset,
    )
    episode = 0
    with run.crash_save_on_error():
        while run.t < steps and not run.stop_requested:
            # ---- one episode (or the tail of the step budget) ----
            obs = env.reset()
            ep_return = 0.0
            ep_len = 0
            while True:
                obs, reward, done, info = env.step(agent.act(obs))
                run.t += 1
                ep_len += 1
                ep_return += reward
                truncated = ep_len == max_episode_len or bool(
                    info.get("needs_reset", False)
                )
                # The agent bootstraps through truncation but not through
                # termination (ContinuingTimeLimit semantics,
                # pfrl/wrappers/continuing_time_limit.py:4-41).
                agent.observe(obs, reward, done, truncated)
                run.fire_step_hooks()

                boundary = done or truncated or run.t == steps
                if boundary:
                    run.logger.info(
                        "outdir:%s step:%s episode:%s R:%s",
                        outdir, run.t, episode, ep_return,
                    )
                    run.logger.info("statistics:%s", agent.get_statistics())
                if boundary or eval_during_episode:
                    # eval_during_episode consults the schedule every step,
                    # not only at boundaries (reference train_agent.py:81-90).
                    run.eval_point(episodes=episode + 1)
                stopping = run.stop_requested or run.t == steps
                if not stopping:
                    run.checkpoint_if_due()
                if boundary or stopping:
                    break
            episode += 1
    run.finish()
    return run.history


def train_agent_with_evaluation(
    agent,
    env,
    steps: int,
    eval_n_steps: Optional[int],
    eval_n_episodes: Optional[int],
    eval_interval: int,
    outdir: str,
    checkpoint_freq=None,
    train_max_episode_len=None,
    step_offset: int = 0,
    eval_max_episode_len=None,
    eval_env=None,
    successful_score=None,
    step_hooks=(),
    evaluation_hooks=(),
    save_best_so_far_agent: bool = True,
    use_tensorboard: bool = False,
    eval_during_episode: bool = False,
    logger=None,
):
    """Reference signature (train_agent.py:114-199)."""
    logger = logger or logging.getLogger(__name__)
    os.makedirs(outdir, exist_ok=True)
    evaluator = build_evaluator(
        agent,
        env if eval_env is None else eval_env,
        outdir,
        eval_n_steps=eval_n_steps,
        eval_n_episodes=eval_n_episodes,
        eval_interval=eval_interval,
        eval_max_episode_len=(
            train_max_episode_len
            if eval_max_episode_len is None
            else eval_max_episode_len
        ),
        step_offset=step_offset,
        evaluation_hooks=evaluation_hooks,
        save_best_so_far_agent=save_best_so_far_agent,
        use_tensorboard=use_tensorboard,
        logger=logger,
    )
    history = train_agent(
        agent,
        env,
        steps,
        outdir,
        checkpoint_freq=checkpoint_freq,
        max_episode_len=train_max_episode_len,
        step_offset=step_offset,
        evaluator=evaluator,
        successful_score=successful_score,
        step_hooks=step_hooks,
        eval_during_episode=eval_during_episode,
        logger=logger,
    )
    return agent, history
