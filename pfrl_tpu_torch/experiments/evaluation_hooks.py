"""Evaluation hooks (counterpart of
``pfrl_tpu/experiments/evaluation_hooks.py``; reference parity:
pfrl/experiments/evaluation_hooks.py)."""

from typing import Any


class EvaluationHook:
    """Called after each evaluation with the evaluation stats
    (evaluation_hooks.py:8-33)."""

    support_train_agent = True
    support_train_agent_batch = True
    support_train_agent_async = False

    def __call__(
        self, env, agent, evaluator, step: int, eval_stats: dict,
        agent_stats: Any, env_stats: Any,
    ) -> None:
        raise NotImplementedError


class OptunaPrunerHook(EvaluationHook):
    """Report eval scores to an optuna trial; raise TrialPruned when told
    (evaluation_hooks.py:53-117). optuna is imported lazily."""

    def __init__(self, trial):
        self.trial = trial

    def __call__(
        self, env, agent, evaluator, step, eval_stats, agent_stats, env_stats
    ):
        import optuna

        self.trial.report(eval_stats["mean"], step)
        if self.trial.should_prune():
            raise optuna.TrialPruned()
