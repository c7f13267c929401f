"""Double DQN (counterpart of ``pfrl_tpu/agents/double_dqn.py``): the
greedy action from the online network, evaluated by the target network;
:class:`DoubleDQN` is the host shell over it."""

import torch

from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.replay.transition import TransitionBatch


class DoubleDQNCore(DQNCore):
    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        """Three forwards in the JAX core's order: online on obs, online on
        next_obs, target on next_obs."""
        y = self.action_value(model, batch.obs, draws).evaluate_actions(batch.action)
        with torch.no_grad():
            greedy = self.action_value(model, batch.next_obs, draws).greedy_actions()
            next_target = self.action_value(target_model, batch.next_obs, draws)
            t = self.bootstrap(batch, next_target.evaluate_actions(greedy))
        return y, t


class DoubleDQN(DQN):
    default_core = DoubleDQNCore
