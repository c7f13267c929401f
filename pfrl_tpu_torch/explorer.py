"""Explorer protocol (counterpart of ``pfrl_tpu/explorer.py``; reference
parity: pfrl/explorer.py:4-17).

An explorer maps ``(draws, t, greedy_actions, action_value)`` to possibly
randomized batched actions; ``t`` is the host step counter and ``draws``
the caller's draw source (:mod:`pfrl_tpu_torch.utils.draws`).
"""


class Explorer:
    def select_action(self, draws, t: int, greedy_actions, action_value=None):
        """Batched action selection."""
        raise NotImplementedError
