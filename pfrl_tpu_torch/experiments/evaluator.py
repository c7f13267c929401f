"""Evaluation machinery (counterpart of ``pfrl_tpu/experiments/evaluator.py``
up to its ``AsyncEvaluator``, which is not ported; reference parity:
pfrl/experiments/evaluator.py). Host code only: it imports no torch, but
the optional tensorboard writer's.

Serial and vector-env evaluation with the reference's bookkeeping: the
batch evaluator scores the *first n started* episodes to avoid length bias
(evaluator.py:100-251); scores land in a ``scores.txt`` TSV with the same
basic columns (evaluator.py:309-311,375-393); the best-so-far agent is
saved under ``<outdir>/best`` (evaluator.py:509-513).
"""

import logging
import os
import statistics
import time
from typing import Optional

import numpy as np


def run_evaluation_episodes(
    env,
    agent,
    n_steps: Optional[int],
    n_episodes: Optional[int],
    max_episode_len: Optional[int] = None,
    logger=None,
):
    """Serial evaluation (evaluator.py:12-97). Returns list of returns."""
    assert (n_steps is None) != (n_episodes is None)
    logger = logger or logging.getLogger(__name__)
    scores = []
    lengths = []
    with agent.eval_mode():
        terminate = False
        timestep = 0
        while not terminate:
            obs = env.reset()
            done = False
            test_r = 0.0
            episode_len = 0
            info = {}
            while not (
                done
                or episode_len == max_episode_len
                or info.get("needs_reset", False)
            ):
                a = agent.act(obs)
                obs, r, done, info = env.step(a)
                test_r += r
                episode_len += 1
                timestep += 1
            agent.observe(obs, r, done, True)
            scores.append(float(test_r))
            lengths.append(episode_len)
            if n_steps is not None:
                terminate = timestep >= n_steps
            else:
                terminate = len(scores) >= n_episodes
    logger.info("evaluation episode scores: %s", scores)
    return scores, lengths


def batch_run_evaluation_episodes(
    env,
    agent,
    n_steps: Optional[int],
    n_episodes: Optional[int],
    max_episode_len: Optional[int] = None,
    logger=None,
):
    """Vector-env evaluation scoring the first-n started episodes
    (evaluator.py:100-251)."""
    assert (n_steps is None) != (n_episodes is None)
    logger = logger or logging.getLogger(__name__)
    num_envs = env.num_envs
    episode_returns = {}
    episode_lengths = {}
    episode_indices = np.zeros(num_envs, dtype=np.int64)
    episode_idx = 0
    for i in range(num_envs):
        episode_indices[i] = episode_idx
        episode_idx += 1
    episode_r = np.zeros(num_envs, dtype=np.float64)
    episode_len = np.zeros(num_envs, dtype=np.int64)

    obss = env.reset()
    rs = np.zeros(num_envs, dtype=np.float32)

    termination_conditions = False
    timestep = 0
    with agent.eval_mode():
        while True:
            actions = agent.batch_act(obss)
            obss, rs, dones, infos = env.step(actions)
            episode_r += rs
            episode_len += 1
            timestep += 1
            resets = np.logical_or(
                episode_len == max_episode_len,
                [info.get("needs_reset", False) for info in infos],
            )
            end = np.logical_or(resets, dones)

            for i in range(num_envs):
                if end[i]:
                    idx = episode_indices[i]
                    if idx not in episode_returns:
                        episode_returns[idx] = float(episode_r[i])
                        episode_lengths[idx] = int(episode_len[i])
                    episode_indices[i] = episode_idx
                    episode_idx += 1
                    episode_r[i] = 0.0
                    episode_len[i] = 0

            finished = len(episode_returns)
            if n_episodes is not None and finished >= n_episodes:
                termination_conditions = True
            if n_steps is not None and timestep * num_envs >= n_steps:
                termination_conditions = True
            agent.batch_observe(obss, rs, dones, end)
            if termination_conditions:
                break
            if np.any(end):
                obss = env.reset(np.logical_not(end))

    keys = sorted(episode_returns.keys())
    if n_episodes is not None:
        keys = keys[:n_episodes]
    scores = [episode_returns[k] for k in keys]
    lengths = [episode_lengths[k] for k in keys]
    return scores, lengths


def eval_performance(
    env,
    agent,
    n_steps: Optional[int],
    n_episodes: Optional[int],
    max_episode_len: Optional[int] = None,
    logger=None,
):
    """Dispatch serial/batch on the env type (evaluator.py:254-306)."""
    from pfrl_tpu_torch.env import VectorEnv

    if isinstance(env, VectorEnv):
        scores, lengths = batch_run_evaluation_episodes(
            env, agent, n_steps, n_episodes, max_episode_len, logger
        )
    else:
        scores, lengths = run_evaluation_episodes(
            env, agent, n_steps, n_episodes, max_episode_len, logger
        )
    stats = {
        "episodes": len(scores),
        "mean": statistics.mean(scores) if scores else float("nan"),
        "median": statistics.median(scores) if scores else float("nan"),
        "stdev": statistics.stdev(scores) if len(scores) > 1 else 0.0,
        "max": max(scores) if scores else float("nan"),
        "min": min(scores) if scores else float("nan"),
        "length_mean": statistics.mean(lengths) if lengths else float("nan"),
    }
    return stats


_BASIC_COLUMNS = (
    "steps",
    "episodes",
    "elapsed",
    "mean",
    "median",
    "stdev",
    "max",
    "min",
)


class Evaluator:
    """Periodic evaluation + best-model saving (evaluator.py:396-521)."""

    def __init__(
        self,
        agent,
        env,
        n_steps: Optional[int],
        n_episodes: Optional[int],
        eval_interval: int,
        outdir: str,
        max_episode_len: Optional[int] = None,
        step_offset: int = 0,
        evaluation_hooks=(),
        save_best_so_far_agent: bool = True,
        use_tensorboard: bool = False,
        logger=None,
    ):
        assert (n_steps is None) != (n_episodes is None)
        self.agent = agent
        self.env = env
        self.n_steps = n_steps
        self.n_episodes = n_episodes
        self.eval_interval = eval_interval
        self.outdir = outdir
        self.max_episode_len = max_episode_len
        self.step_offset = step_offset
        self.evaluation_hooks = evaluation_hooks
        self.save_best_so_far_agent = save_best_so_far_agent
        self.logger = logger or logging.getLogger(__name__)
        self.max_score = float("-inf")
        self.prev_eval_t = self.step_offset - self.step_offset % self.eval_interval
        self._start_time = time.time()
        self._columns_written = False
        self.tb_writer = None
        if use_tensorboard:
            # Optional dependency (reference: evaluator.py:314-357); any
            # available SummaryWriter flavor works.
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(log_dir=outdir)
            except Exception:
                self.logger.warning(
                    "use_tensorboard requested but no SummaryWriter available"
                )

    def _record_stats(self, t: int, episodes: int, stats: dict) -> None:
        agent_stats = self.agent.get_statistics()
        custom_columns = tuple(name for name, _ in agent_stats)
        path = os.path.join(self.outdir, "scores.txt")
        if not self._columns_written:
            with open(path, "w") as f:
                f.write("\t".join(_BASIC_COLUMNS + custom_columns) + "\n")
            self._columns_written = True
        elapsed = time.time() - self._start_time
        values = (
            t,
            episodes,
            elapsed,
            stats["mean"],
            stats["median"],
            stats["stdev"],
            stats["max"],
            stats["min"],
        ) + tuple(v for _, v in agent_stats)
        with open(path, "a") as f:
            f.write("\t".join(str(v) for v in values) + "\n")

    def evaluate_and_update_max_score(self, t: int, episodes: int) -> float:
        stats = eval_performance(
            self.env,
            self.agent,
            self.n_steps,
            self.n_episodes,
            max_episode_len=self.max_episode_len,
            logger=self.logger,
        )
        mean = stats["mean"]
        self._record_stats(t, episodes, stats)
        if self.tb_writer is not None:
            # record_tb_stats parity (evaluator.py:336-357).
            for key in ("mean", "median", "stdev", "max", "min"):
                self.tb_writer.add_scalar(f"eval/{key}", stats[key], t)
            for name, value in self.agent.get_statistics():
                try:
                    self.tb_writer.add_scalar(f"agent/{name}", float(value), t)
                except (TypeError, ValueError):
                    pass
            self.tb_writer.flush()
        for hook in self.evaluation_hooks:
            hook(
                env=self.env,
                agent=self.agent,
                evaluator=self,
                step=t,
                eval_stats=stats,
                agent_stats=self.agent.get_statistics(),
                env_stats=None,
            )
        self.logger.info(
            "evaluation at step %d: mean %s median %s", t, mean, stats["median"]
        )
        if mean > self.max_score:
            self.max_score = mean
            if self.save_best_so_far_agent:
                self.agent.save(os.path.join(self.outdir, "best"))
        return mean

    def evaluate_if_necessary(self, t: int, episodes: int) -> Optional[float]:
        if t >= self.prev_eval_t + self.eval_interval:
            self.prev_eval_t = t - t % self.eval_interval
            return self.evaluate_and_update_max_score(t, episodes)
        return None
