"""Persistent Advantage Learning and its Double variant (counterpart of
``pfrl_tpu/agents/pal.py``): the AL correction is the smaller of the
action gaps at s and at s'."""

import torch

from pfrl_tpu_torch.agents.al import ALCore, three_forwards
from pfrl_tpu_torch.agents.dqn import DQN
from pfrl_tpu_torch.replay.transition import TransitionBatch


def _gap(av, actions: torch.Tensor) -> torch.Tensor:
    return av.max() - av.evaluate_actions(actions)


class PALCore(ALCore):
    def _next_value(self, model, batch: TransitionBatch, next_tgt, draws) -> torch.Tensor:
        return next_tgt.max()

    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        y, cur_tgt, next_tgt = three_forwards(self, model, target_model, batch, draws)
        with torch.no_grad():
            base = self.bootstrap(batch, self._next_value(model, batch, next_tgt, draws))
            gap = torch.minimum(_gap(cur_tgt, batch.action), _gap(next_tgt, batch.action))
            t = base - self.alpha * gap
        return y, t


class DoublePALCore(PALCore):
    def _next_value(self, model, batch: TransitionBatch, next_tgt, draws) -> torch.Tensor:
        """The target's value of the online network's greedy action at s':
        a fourth forward, online on next_obs, after the three of AL."""
        greedy = self.action_value(model, batch.next_obs, draws).greedy_actions()
        return next_tgt.evaluate_actions(greedy)


class PAL(DQN):
    """The host shell over :class:`PALCore` (``pal.py:52-57``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = PALCore


class DoublePAL(DQN):
    """The host shell over :class:`DoublePALCore` (``pal.py:52-57``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = DoublePALCore
