"""Greedy, no exploration (counterpart of ``pfrl_tpu/explorers/greedy.py``)."""


class Greedy:
    """Takes the arguments of the epsilon-greedy explorers and draws nothing:
    with noisy layers the exploration is in the action values already."""

    def select_action(self, draws, t: int, greedy_actions, action_value=None):
        return greedy_actions
