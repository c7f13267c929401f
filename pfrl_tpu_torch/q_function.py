"""Q-function protocols (counterpart of ``pfrl_tpu/q_function.py``;
reference parity: pfrl/q_function.py:4-28)."""


class StateQFunction:
    """obs -> ActionValue."""

    def __call__(self, x):
        raise NotImplementedError


class StateActionQFunction:
    """(obs, action) -> scalar Q."""

    def __call__(self, x, a):
        raise NotImplementedError
