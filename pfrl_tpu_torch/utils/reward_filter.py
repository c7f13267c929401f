"""Host-side scalar reward filters (counterpart of
``pfrl_tpu/utils/reward_filter.py``; reference parity:
pfrl/utils/reward_filter.py).

Exponential moving averages applied to scalar rewards in host training
loops (average-reward formulations). They hold Python floats, so they live
on the host; reward shaping on the device belongs in the env wrappers
(``pfrl_tpu_torch/envs/wrappers.py``).
"""


class AverageRewardFilter:
    """Subtracts an exponential moving average of the reward.

    Reference: pfrl/utils/reward_filter.py:19-27.
    """

    def __init__(self, tau: float = 1e-3):
        self.tau = tau
        self.average_reward = 0.0

    def __call__(self, reward: float) -> float:
        self.average_reward += self.tau * (reward - self.average_reward)
        return reward - self.average_reward


class NormalizedRewardFilter:
    """Centers and scales the reward by EMA mean / clipped EMA stdev.

    Reference: pfrl/utils/reward_filter.py:1-16. Keeps the reference's
    quirk of clipping the *variance* at ``eps`` from above before the
    square root (it bounds the scale-up of small-variance streams).
    """

    def __init__(self, tau: float = 1e-3, scale: float = 1.0, eps: float = 1e-1):
        self.tau = tau
        self.scale = scale
        self.eps = eps
        self.average_reward = 0.0
        self.average_reward_squared = 0.0

    def __call__(self, reward: float) -> float:
        self.average_reward += self.tau * (reward - self.average_reward)
        self.average_reward_squared += self.tau * (
            reward**2 - self.average_reward_squared
        )
        var = self.average_reward_squared - self.average_reward**2
        stdev = min(var, self.eps) ** 0.5
        return self.scale * (reward - self.average_reward) / stdev
