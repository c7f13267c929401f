"""IQN, implicit quantile networks (counterpart of
``pfrl_tpu/agents/iqn.py``): ``IQNCore`` and ``DoubleIQNCore``.

The taus are iid uniform: ``K`` per lane when acting in training, ``N``
and ``N'`` per update, and ``K`` more in ``DoubleIQNCore``'s greedy
selection; evaluation takes the fixed grid ``(arange(K) + 0.5) / K`` and
draws none. The draws come in the order the JAX core uses its split keys:
acting, the taus, then the model's noise (none for an MLP ``psi``), then
the explorer's; an update, ``N`` taus, ``N'`` taus, the online forward's
noise, the target forward's, then the selection's (Double: ``K`` taus, then
the online forward's noise).

Under ``compute_dtype`` the taus are not cast, as in the JAX core: the
cosine branch of the model sees float32 taus, so it and every layer after
the product ``psi(x) * phi(tau)`` compute in float32 by promotion; only
``psi`` computes in ``compute_dtype``.
"""

import torch

from pfrl_tpu_torch.agents.dqn import DQN, DQNCore
from pfrl_tpu_torch.ops.quantile import eltwise_huber_quantile_loss
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils.draws import uniform
from pfrl_tpu_torch.utils.precision import apply_cast


def _taus(draws, batch: int, n: int) -> torch.Tensor:
    return uniform(draws, (batch, n))  # a per-row draw


class IQNCore(DQNCore):
    def __init__(
        self,
        *args,
        quantile_thresholds_N: int = 64,
        quantile_thresholds_N_prime: int = 64,
        quantile_thresholds_K: int = 32,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.N = quantile_thresholds_N
        self.N_prime = quantile_thresholds_N_prime
        self.K = quantile_thresholds_K

    # ------------------------------------------------------------------- act
    def action_value(self, model, obs: torch.Tensor, draws=None, taus=None):
        """``taus`` None: the deterministic grid, float32 as in the JAX core."""
        x = self.phi(obs)
        if taus is None:
            grid = (torch.arange(self.K, dtype=torch.float32, device=x.device) + 0.5) / self.K
            taus = grid.expand(x.shape[0], self.K)
        return apply_cast(model, self.compute_dtype, x, taus, draws, uncast_argnums=(1,))

    @torch.no_grad()
    def select_action(self, state, draws, obs, t: int, training: bool):
        if not training:
            return self.action_value(state.model, obs, draws).greedy_actions()
        taus = _taus(draws, obs.shape[0], self.K)
        av = self.action_value(state.model, obs, draws, taus)
        return self.explorer.select_action(draws, t, av.greedy_actions(), av)

    # ---------------------------------------------------------------- update
    def loss_and_errors(self, model, target_model, batch: TransitionBatch, draws=None):
        """Per example, the sum over N of the mean over N' of the pairwise
        loss; the PER-weighted mean divides by the batch size."""
        B = batch.reward.shape[0]
        taus = _taus(draws, B, self.N)
        taus_prime = _taus(draws, B, self.N_prime)
        av = self.action_value(model, batch.obs, draws, taus)
        y = av.evaluate_actions_as_quantiles(batch.action)  # [B, N]
        with torch.no_grad():
            target_av = self.action_value(target_model, batch.next_obs, draws, taus_prime)
            greedy = self.target_greedy_actions(model, batch, target_av, draws)
            next_quantiles = target_av.evaluate_actions_as_quantiles(greedy)  # [B, N']
            nonterminal = 1.0 - batch.is_terminal.to(torch.float32)
            t = batch.reward[:, None] + batch.discount[:, None] * nonterminal[:, None] * next_quantiles
        per_example = torch.sum(torch.mean(eltwise_huber_quantile_loss(y, t, taus), dim=2), dim=1)
        weighted = per_example * batch.weight
        loss = torch.sum(weighted) / B if self.batch_accumulator == "mean" else torch.sum(weighted)
        return loss, (per_example.detach(), av.q_values.detach().mean())

    def target_greedy_actions(self, model, batch: TransitionBatch, target_av, draws) -> torch.Tensor:
        """Greedy in the target network's mean quantiles."""
        return target_av.greedy_actions()


class DoubleIQNCore(IQNCore):
    def target_greedy_actions(self, model, batch: TransitionBatch, target_av, draws) -> torch.Tensor:
        """Greedy in the online network's mean quantiles at s', on K fresh taus."""
        taus = _taus(draws, batch.reward.shape[0], self.K)
        return self.action_value(model, batch.next_obs, draws, taus).greedy_actions()


class IQN(DQN):
    """The host shell over :class:`IQNCore` (``iqn.py:116-121``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = IQNCore


class DoubleIQN(DQN):
    """The host shell over :class:`DoubleIQNCore` (``iqn.py:116-121``): the port's
    :class:`~pfrl_tpu_torch.agents.dqn.DQN` with this core."""

    default_core = DoubleIQNCore
