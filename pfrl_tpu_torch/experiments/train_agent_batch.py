"""Vector-env training driver (counterpart of
``pfrl_tpu/experiments/train_agent_batch.py``; reference contract:
pfrl/experiments/train_agent_batch.py).

Same public API and observable behavior as the reference's
``train_agent_batch_with_evaluation`` (train_agent_batch.py:157):
batch_act/batch_observe over a VectorEnv, per-lane episode accounting,
masked resets (finished lanes only), log_interval throughput lines. The
implementation shape is this repo's own: per-lane numpy bookkeeping over
the shared :class:`TrainRun` services (train_loop.py).
"""

import collections
import logging
import os
from typing import Optional

import numpy as np

from pfrl_tpu_torch.experiments.train_loop import TrainRun, build_evaluator


def train_agent_batch(
    agent,
    env,
    steps: int,
    outdir: str,
    checkpoint_freq=None,
    log_interval=None,
    max_episode_len=None,
    step_offset: int = 0,
    evaluator=None,
    successful_score=None,
    step_hooks=(),
    return_window_size: int = 100,
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
    n = env.num_envs
    if hasattr(agent, "t"):
        agent.t = step_offset
    lane_return = np.zeros(n, np.float64)
    lane_len = np.zeros(n, np.int64)
    episodes_done = 0
    window = collections.deque(maxlen=return_window_size)

    try:
        with run.crash_save_on_error():
            obss = env.reset()
            while run.t < steps and not run.stop_requested:
                obss, rewards, dones, infos = env.step(agent.batch_act(obss))
                lane_return += rewards
                lane_len += 1
                truncated = np.fromiter(
                    (
                        lane_len[i] == max_episode_len
                        or bool(infos[i].get("needs_reset", False))
                        for i in range(n)
                    ),
                    bool,
                    count=n,
                )
                # Lanes bootstrap through truncation, not termination
                # (same contract as the serial driver).
                agent.batch_observe(obss, rewards, dones, truncated)
                run.t += n

                ended = np.logical_or(dones, truncated)
                window.extend(lane_return[ended])
                episodes_done += int(np.sum(ended))
                run.fire_step_hooks()

                if (
                    log_interval is not None
                    and run.t >= step_offset
                    and run.t % log_interval < n
                ):
                    run.logger.info(
                        "outdir:%s step:%s episode:%s last_R: %s average_R:%s",
                        outdir,
                        run.t,
                        episodes_done,
                        window[-1] if window else np.nan,
                        np.mean(window) if window else np.nan,
                    )
                    run.logger.info("statistics: %s", agent.get_statistics())
                run.eval_point(episodes=episodes_done)
                if run.stop_requested:
                    break
                run.checkpoint_if_due(stride=n)

                # Masked reset: only finished lanes restart
                # (reference train_agent_batch.py:141).
                lane_return[ended] = 0.0
                lane_len[ended] = 0
                obss = env.reset(np.logical_not(ended))
    except (Exception, KeyboardInterrupt):
        env.close()
        raise
    run.finish()
    return run.history


def train_agent_batch_with_evaluation(
    agent,
    env,
    steps: int,
    eval_n_steps: Optional[int],
    eval_n_episodes: Optional[int],
    eval_interval: int,
    outdir: str,
    checkpoint_freq=None,
    max_episode_len=None,
    step_offset: int = 0,
    eval_max_episode_len=None,
    return_window_size: int = 100,
    eval_env=None,
    log_interval=None,
    successful_score=None,
    step_hooks=(),
    evaluation_hooks=(),
    save_best_so_far_agent: bool = True,
    use_tensorboard: bool = False,
    logger=None,
):
    """Reference signature (train_agent_batch.py:157-245)."""
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
            max_episode_len
            if eval_max_episode_len is None
            else eval_max_episode_len
        ),
        step_offset=step_offset,
        evaluation_hooks=evaluation_hooks,
        save_best_so_far_agent=save_best_so_far_agent,
        use_tensorboard=use_tensorboard,
        logger=logger,
    )
    history = train_agent_batch(
        agent,
        env,
        steps,
        outdir,
        checkpoint_freq=checkpoint_freq,
        max_episode_len=max_episode_len,
        step_offset=step_offset,
        evaluator=evaluator,
        successful_score=successful_score,
        return_window_size=return_window_size,
        log_interval=log_interval,
        step_hooks=step_hooks,
        logger=logger,
    )
    return agent, history
