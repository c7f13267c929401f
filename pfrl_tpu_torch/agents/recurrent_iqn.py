"""Recurrent IQN (counterpart of ``pfrl_tpu/agents/recurrent_iqn.py``).

The model is ``model(x, taus, carry) -> (QuantileDiscreteActionValue,
carry)`` (:class:`~pfrl_tpu_torch.q_functions.RecurrentImplicitQuantileQFunction`).
An update unrolls the online network over ``obs`` and the target network
over ``next_obs`` from the stored carries, as
:class:`~pfrl_tpu_torch.agents.recurrent_dqn.RecurrentDQNCore` does (no
burn-in, as in the JAX core), with the masked quantile Huber loss.

Draws, in the JAX core's order: acting in training, ``K`` taus per lane
(evaluation takes the grid ``(arange(K) + 0.5) / K`` and draws none), then
the explorer's draws; an update, one tau draw **per unrolled step** (the
JAX core splits ``fold_in(rng, 1)`` into T keys): T draws of ``B * N``
for the online unroll, then T of ``B * N'`` for the target's.
"""

import torch

from pfrl_tpu_torch.agents.dqn import DQNState
from pfrl_tpu_torch.agents.recurrent_dqn import RecurrentDQNCore, time_major
from pfrl_tpu_torch.ops.quantile import eltwise_huber_quantile_loss
from pfrl_tpu_torch.replay.episodic import EpisodeBatch
from pfrl_tpu_torch.utils.draws import uniform
from pfrl_tpu_torch.utils.precision import apply_cast
from pfrl_tpu_torch.utils.recurrent import stack


class RecurrentIQNCore(RecurrentDQNCore):
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

    def _grid(self, batch: int, device) -> torch.Tensor:
        return ((torch.arange(self.K, dtype=torch.float32, device=device) + 0.5) / self.K).expand(batch, self.K)

    def step(self, model, obs: torch.Tensor, carry, taus=None):
        """One step; ``taus`` None: the evaluation grid."""
        x = self.phi(obs)
        if taus is None:
            taus = self._grid(x.shape[0], x.device)
        return apply_cast(model, self.compute_dtype, x, taus, carry, uncast_argnums=(1, 2))

    @torch.no_grad()
    def select_action_recurrent(self, state: DQNState, draws, obs, t: int, training: bool, carry):
        if not training:
            av, new_carry = self.step(state.model, obs, carry)
            return av.greedy_actions(), new_carry
        taus = uniform(draws, (obs.shape[0], self.K))  # a per-row (per-lane) draw
        av, new_carry = self.step(state.model, obs, carry, taus)
        return self.explorer.select_action(draws, t, av.greedy_actions(), av), new_carry

    def unroll_quantiles(self, model, draws, obs_seq: torch.Tensor, batch_size: int, n_taus: int, carry0=None):
        """``obs_seq [B, T, ...]`` -> (quantiles ``[T, B, n_taus, A]``, taus
        ``[T, B, n_taus]``), one tau draw per step."""
        xs = time_major(obs_seq)
        if carry0 is None:
            carry0 = self.initial_carry(batch_size, xs.device)
        # T per-row draws, each ``[B, n_taus]``.
        taus = stack([uniform(draws, (batch_size, n_taus)) for _ in range(xs.shape[0])])
        av, _ = apply_cast(model, self.compute_dtype, self.phi(xs), taus, carry0, uncast_argnums=(1, 2), sequence=True)
        return av.quantiles, taus

    def update_episodic(self, state: DQNState, batch: EpisodeBatch, draws=None):
        tr = batch.transitions
        B, T = batch.mask.shape
        quant, taus = self.unroll_quantiles(state.model, draws, tr.obs, B, self.N, batch.init_carry)
        with torch.no_grad():
            tgt_quant, _ = self.unroll_quantiles(
                state.target_model, draws, tr.next_obs, B, self.N_prime, batch.next_init_carry)
            action = time_major(tr.action).to(torch.int64)  # [T, B]
            greedy = torch.argmax(torch.mean(tgt_quant, dim=2), dim=-1)  # [T, B]
            next_q = torch.gather(tgt_quant, 3, greedy[:, :, None, None].expand(-1, -1, self.N_prime, 1))[..., 0]
            term = time_major(tr.terminated).to(torch.float32)
            target = time_major(tr.reward)[..., None] + self.gamma * (1.0 - term[..., None]) * next_q
        y = torch.gather(quant, 3, action[:, :, None, None].expand(-1, -1, self.N, 1))[..., 0]  # [T, B, N]
        el = eltwise_huber_quantile_loss(
            y.reshape(T * B, self.N), target.reshape(T * B, self.N_prime), taus.reshape(T * B, self.N))
        per = torch.sum(torch.mean(el, dim=2), dim=1).reshape(T, B)
        m = time_major(batch.mask)
        loss = torch.sum(per * m) / self.denominator(batch)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        with torch.no_grad():
            win_err = torch.sum(per * m, dim=0) / torch.clamp_min(torch.sum(m, dim=0), 1.0)
            q_mean = torch.mean(torch.mean(quant, dim=2) * m[..., None])
        return state, {"loss": loss.detach(), "average_q": q_mean, "errors": win_err}
