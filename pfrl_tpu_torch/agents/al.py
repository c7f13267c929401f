"""Advantage Learning (counterpart of ``pfrl_tpu/agents/al.py``): the DQN
target less ``alpha * (max_a Q_tgt(s, a) - Q_tgt(s, a_t))``."""

import torch

from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.replay.transition import TransitionBatch


def three_forwards(core: DQNCore, model, target_model, batch: TransitionBatch, draws):
    """The forwards of AL, PAL and DPP in the JAX cores' order: online on
    obs, target on obs, target on next_obs. Returns ``y`` (the online value
    of the taken action) and the two target action values."""
    y = core.action_value(model, batch.obs, draws).evaluate_actions(batch.action)
    with torch.no_grad():
        cur_tgt = core.action_value(target_model, batch.obs, draws)
        next_tgt = core.action_value(target_model, batch.next_obs, draws)
    return y, cur_tgt, next_tgt


class ALCore(DQNCore):
    def __init__(self, *args, alpha: float = 0.9, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = alpha

    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        y, cur_tgt, next_tgt = three_forwards(self, model, target_model, batch, draws)
        with torch.no_grad():
            advantage = cur_tgt.max() - cur_tgt.evaluate_actions(batch.action)
            t = self.bootstrap(batch, next_tgt.max()) - self.alpha * advantage
        return y, t


class AL(DQN):
    """The host shell over :class:`ALCore` (``al.py:37``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = ALCore
