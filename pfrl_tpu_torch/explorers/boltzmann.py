"""Boltzmann exploration (counterpart of ``pfrl_tpu/explorers/boltzmann.py``)."""

from pfrl_tpu_torch.utils.draws import categorical


class Boltzmann:
    """Samples from ``softmax(Q / T)`` by the Gumbel-max trick, with one
    uniform per action of every lane (:func:`~pfrl_tpu_torch.utils.draws.categorical`,
    as ``jax.random.categorical`` draws)."""

    def __init__(self, T: float = 1.0):
        self.T = T

    def select_action(self, draws, t: int, greedy_actions, action_value=None):
        if action_value is None:
            raise ValueError("Boltzmann needs the action value")
        return categorical(draws, action_value.q_values / self.T).to(greedy_actions.dtype)
