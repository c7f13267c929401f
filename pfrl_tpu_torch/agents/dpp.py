"""Dynamic Policy Programming (counterpart of ``pfrl_tpu/agents/dpp.py``):
a Boltzmann-softmax backup with inverse temperature ``eta``,
``r + gamma * B(P(s')) + P(s, a) - B(P(s))``."""

import torch

from pfrl_tpu_torch.agents.al import three_forwards
from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.replay.transition import TransitionBatch


def _boltzmann_backup(q: torch.Tensor, eta: float) -> torch.Tensor:
    """``sum_a softmax(eta * q)_a * q_a`` over the last axis."""
    return torch.sum(torch.softmax(eta * q, dim=-1) * q, dim=-1)


class DPPCore(DQNCore):
    def __init__(self, *args, eta: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.eta = eta

    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        y, cur_tgt, next_tgt = three_forwards(self, model, target_model, batch, draws)
        with torch.no_grad():
            t = (
                self.bootstrap(batch, _boltzmann_backup(next_tgt.q_values, self.eta))
                + cur_tgt.evaluate_actions(batch.action)
                - _boltzmann_backup(cur_tgt.q_values, self.eta)
            )
        return y, t


class DPP(DQN):
    """The host shell over :class:`DPPCore` (``dpp.py:46``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = DPPCore
