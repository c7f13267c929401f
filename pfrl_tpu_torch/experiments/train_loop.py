"""Shared scaffolding for the host training drivers (counterpart of
``pfrl_tpu/experiments/train_loop.py``).

The reference implements its serial and vector training loops as two
standalone functions with duplicated bookkeeping
(pfrl/experiments/train_agent.py:24-111, train_agent_batch.py:10-154).
Here every cross-cutting service — evaluation scheduling + history rows,
success-based early stop, checkpointing, crash/finish saves, step hooks —
lives in one :class:`TrainRun` object shared by both drivers, so each
driver file owns nothing but its stepping shape (episode-nested serial
loop vs flat vector loop with masked resets).
"""

import contextlib
import logging
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

from pfrl_tpu_torch.experiments.evaluator import Evaluator


def save_agent(agent, t, outdir, logger, suffix=""):
    path = os.path.join(outdir, f"{t}{suffix}")
    agent.save(path)
    logger.info("Saved the agent to %s", path)


@dataclass
class TrainRun:
    """Mutable per-run context threaded through a driver's hot loop.

    ``t`` counts env transitions (the reference's global step). The driver
    advances it and calls the service methods at its own cadence; the run
    records eval history and raises the ``stop_requested`` flag when the
    ``successful_score`` criterion fires
    (reference train_agent.py:83-90).
    """

    agent: Any
    outdir: str
    logger: logging.Logger
    env: Any = None                      # handed to step hooks
    evaluator: Optional[Any] = None
    successful_score: Optional[float] = None
    checkpoint_freq: Optional[int] = None
    step_hooks: Sequence = ()
    t: int = 0
    history: List[dict] = field(default_factory=list)
    stop_requested: bool = False

    @contextlib.contextmanager
    def crash_save_on_error(self):
        """Save a ``<t>_except`` snapshot on any failure, then re-raise
        (reference train_agent.py:103-106)."""
        try:
            yield self
        except (Exception, KeyboardInterrupt):
            save_agent(self.agent, self.t, self.outdir, self.logger, "_except")
            raise

    def fire_step_hooks(self):
        for hook in self.step_hooks:
            hook(self.env, self.agent, self.t)

    def checkpoint_if_due(self, stride: int = 1):
        """Periodic ``<t>_checkpoint`` save; ``stride`` is how much ``t``
        advances per driver iteration (num_envs for vector loops)."""
        if self.checkpoint_freq and self.t % self.checkpoint_freq < stride:
            save_agent(
                self.agent, self.t, self.outdir, self.logger, "_checkpoint"
            )

    def eval_point(self, episodes: int):
        """Consult the evaluator's schedule; record a history row (agent
        statistics + step + score, reference train_agent.py:83-86) and
        request a stop once ``successful_score`` is reached."""
        if self.evaluator is None:
            return
        score = self.evaluator.evaluate_if_necessary(t=self.t, episodes=episodes)
        if score is None:
            return
        row = dict(self.agent.get_statistics())
        row["step"] = self.t
        row["eval_score"] = score
        self.history.append(row)
        if self.successful_score is not None and score >= self.successful_score:
            self.stop_requested = True

    def finish(self):
        save_agent(self.agent, self.t, self.outdir, self.logger, "_finish")


def build_evaluator(
    agent,
    eval_env,
    outdir: str,
    *,
    eval_n_steps: Optional[int],
    eval_n_episodes: Optional[int],
    eval_interval: int,
    eval_max_episode_len: Optional[int],
    step_offset: int,
    evaluation_hooks: Sequence,
    save_best_so_far_agent: bool,
    use_tensorboard: bool,
    logger: logging.Logger,
) -> Evaluator:
    """Evaluator construction shared by the ``*_with_evaluation`` wrappers
    (reference train_agent.py:171-189 / train_agent_batch.py:210-228)."""
    return Evaluator(
        agent=agent,
        env=eval_env,
        n_steps=eval_n_steps,
        n_episodes=eval_n_episodes,
        eval_interval=eval_interval,
        outdir=outdir,
        max_episode_len=eval_max_episode_len,
        step_offset=step_offset,
        evaluation_hooks=evaluation_hooks,
        save_best_so_far_agent=save_best_so_far_agent,
        use_tensorboard=use_tensorboard,
        logger=logger,
    )
