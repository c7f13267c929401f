"""Training hooks (counterpart of ``pfrl_tpu/experiments/hooks.py``;
reference parity: pfrl/experiments/hooks.py:6-64)."""

from typing import Any, Callable


class StepHook:
    """Called as ``hook(env, agent, step)`` after every training step."""

    def __call__(self, env, agent, step):
        raise NotImplementedError


class LinearInterpolationHook(StepHook):
    """Linearly anneal a value and hand it to a setter (hooks.py:26-64).

    e.g. learning-rate decay over total steps.
    """

    def __init__(
        self,
        total_steps: int,
        start_value: float,
        stop_value: float,
        setter: Callable[[Any, Any, float], None],
    ):
        self.total_steps = total_steps
        self.start_value = start_value
        self.stop_value = stop_value
        self.setter = setter

    def interpolate(self, step: int) -> float:
        if step >= self.total_steps:
            return self.stop_value
        frac = step / self.total_steps
        return self.start_value + frac * (self.stop_value - self.start_value)

    def __call__(self, env, agent, step):
        self.setter(env, agent, self.interpolate(step))
