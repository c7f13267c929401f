"""Categorical DQN (C51) and its Double variant (counterpart of
``pfrl_tpu/agents/categorical_dqn.py``): a cross-entropy loss over projected
target distributions; the per-sample cross-entropy is the PER error."""

import torch

from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.ops.categorical import categorical_projection
from pfrl_tpu_torch.replay.transition import TransitionBatch


class CategoricalDQNCore(DQNCore):
    def target_distribution(self, model, target_model, batch: TransitionBatch, draws):
        """The target network's distribution of its own greedy action."""
        next_av = self.action_value(target_model, batch.next_obs, draws)
        return next_av.max_as_distribution(), next_av.z_values

    def compute_loss_components(self, model, target_model, batch: TransitionBatch, draws=None):
        """Forwards in the JAX core's order: the target distribution first,
        then online on obs."""
        with torch.no_grad():
            next_dist, z = self.target_distribution(model, target_model, batch, draws)
            # Shifted and shrunk support: r + gamma^k z (terminal: just r).
            Tz = batch.reward[:, None] + (
                1.0 - batch.is_terminal.to(torch.float32)
            )[:, None] * batch.discount[:, None] * z[None, :]
            target_probs = categorical_projection(Tz, next_dist, z)
        av = self.action_value(model, batch.obs, draws)
        pred = av.evaluate_actions_as_distribution(batch.action)
        eltwise = -torch.sum(target_probs * torch.log(pred + 1e-10), dim=1)
        return eltwise, av

    def loss_and_errors(self, model, target_model, batch: TransitionBatch, draws=None):
        eltwise, av = self.compute_loss_components(model, target_model, batch, draws)
        weighted = eltwise * batch.weight
        if self.batch_accumulator == "mean":
            loss = torch.sum(weighted) / eltwise.shape[0]
        else:
            loss = torch.sum(weighted)
        return loss, (eltwise.detach(), av.q_values.detach().mean())


class CategoricalDoubleDQNCore(CategoricalDQNCore):
    def target_distribution(self, model, target_model, batch: TransitionBatch, draws):
        """The target network's distribution of the online network's greedy
        action: online on next_obs, then target on next_obs."""
        greedy = self.action_value(model, batch.next_obs, draws).greedy_actions()
        next_target = self.action_value(target_model, batch.next_obs, draws)
        return next_target.evaluate_actions_as_distribution(greedy), next_target.z_values


class CategoricalDQN(DQN):
    """The host shell over :class:`CategoricalDQNCore` (``categorical_dqn.py:64-69``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = CategoricalDQNCore


class CategoricalDoubleDQN(DQN):
    """The host shell over :class:`CategoricalDoubleDQNCore` (``categorical_dqn.py:64-69``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = CategoricalDoubleDQNCore
