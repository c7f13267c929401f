"""Recurrent DQN, DRQN (counterpart of ``pfrl_tpu/agents/recurrent_dqn.py``).

The model is recurrent: ``model(x [B, ...], carry) -> (action value,
carry)`` with ``initial_carry(batch_size, device)``
(:mod:`pfrl_tpu_torch.models.recurrent`). The act-time carry is the
runner's ``act_state``. An update replays windows of the episodic buffer
(:class:`~pfrl_tpu_torch.replay.episodic.EpisodeBatch`): the online network
unrolls ``obs`` from the stored carry at the window start
(``init_carry``), the target network ``next_obs`` from the carry after it
(``next_init_carry``); zero carries where the buffer stored none. With
``burn_in`` K, the first K steps of each window are unrolled with the
current weights under no gradient to refresh the stored carries, and the
loss trains on the rest. The loss is the masked Huber (or squared) TD
error, summed over valid steps and divided by their count (``"mean"``) or
by the batch (``"sum"``); ``aux["errors"]`` is one masked mean |TD| per
window, the prioritized episodic buffer's feedback.

In a data-parallel update each rank updates on its share of the windows:
the count of valid steps (or, for ``"sum"``, the batch size) it divides by
is the whole batch's (``EpisodeBatch.whole_mask``), and the ranks'
gradients are summed (``global_denominator``).

An update unrolls each window in one call,
``model(xs [T, B, ...], carry, sequence=True)``, the recurrent modules'
sequence form (:mod:`pfrl_tpu_torch.models.recurrent`).

``compute_dtype`` casts the weights and the observation features, never
the carry: under bf16 the LSTM's hidden side sees the float32 carry and
promotes to float32, while its input side and the layers before it run in
bf16; the Q-values and the carry come back float32, as in the JAX core.
Noisy recurrent models are not ported: the unrolls pass no draw source.
"""

import copy
from typing import Any, Optional

import torch

from pfrl_tpu_torch.agents.dqn import DQNCore, DQNState
from pfrl_tpu_torch.ops.value_loss import huber_loss
from pfrl_tpu_torch.replay.episodic import EpisodeBatch
from pfrl_tpu_torch.utils.precision import apply_cast
from pfrl_tpu_torch.utils.recurrent import mask_recurrent_state_at


def time_major(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, ...] -> [T, B, ...]``."""
    return x.transpose(0, 1)


class RecurrentDQNCore(DQNCore):
    recurrent = True
    #: ``update_episodic``'s ``aux["errors"]`` is one |TD| per window.
    reports_window_errors = True
    #: A rank's share of the masked mean divides by the whole batch's count.
    global_denominator = True

    def __init__(self, *args, burn_in: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        if burn_in < 0:
            raise ValueError("burn_in must be >= 0")
        self.burn_in = burn_in

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> DQNState:
        model = copy.deepcopy(self.model)
        model.reset_parameters(generator)
        model.to(example_obs.device)
        with torch.no_grad():  # shape check
            self.step(model, example_obs, self.initial_carry(example_obs.shape[0], example_obs.device))
        return self.state_from_model(model)

    def initial_carry(self, batch_size: int, device=None):
        return self.model.initial_carry(batch_size, device)

    def init_act_state(self, batch_size: int, device=None):
        return self.initial_carry(batch_size, device)

    def reset_act_state(self, carry, done: torch.Tensor):
        """Zero the carry's rows whose episode just ended."""
        return mask_recurrent_state_at(carry, done)

    # ------------------------------------------------------------------- act
    def step(self, model, obs: torch.Tensor, carry):
        """One step: ``(action value, carry)``, both float32."""
        return apply_cast(model, self.compute_dtype, self.phi(obs), carry, uncast_argnums=(1,))

    @torch.no_grad()
    def select_action_recurrent(self, state: DQNState, draws, obs, t: int, training: bool, carry):
        av, new_carry = self.step(state.model, obs, carry)
        greedy = av.greedy_actions()
        if not training:
            return greedy, new_carry
        return self.explorer.select_action(draws, t, greedy, av), new_carry

    # ---------------------------------------------------------------- update
    def unroll(self, model, obs_seq: torch.Tensor, carry0: Optional[Any], batch_size: int):
        """``obs_seq [B, T, ...]`` -> (action value over ``[T, B]``, final
        carry); ``carry0`` None starts from zeros."""
        xs = time_major(obs_seq)
        if carry0 is None:
            carry0 = self.initial_carry(batch_size, xs.device)
        return apply_cast(model, self.compute_dtype, self.phi(xs), carry0, uncast_argnums=(1,), sequence=True)

    def denominator(self, batch: EpisodeBatch, start: int = 0):
        """What the masked sum of a loss over the windows' steps from
        ``start`` divides by: the count of valid steps (at least 1;
        ``"mean"``) or the number of windows (``"sum"``), the whole
        batch's where ``batch`` is a rank's share."""
        if self.batch_accumulator == "mean":
            return torch.clamp_min(batch.valid_steps(start), 1.0)
        return batch.whole_rows

    def update_episodic(self, state: DQNState, batch: EpisodeBatch, draws=None):
        """One gradient step on a batch of windows, in place."""
        tr = batch.transitions
        B, T = batch.mask.shape
        K = min(self.burn_in, T - 1) if self.burn_in else 0
        on_c, tg_c = batch.init_carry, batch.next_init_carry
        if K:
            with torch.no_grad():
                _, on_c = self.unroll(state.model, tr.obs[:, :K], on_c, B)
                _, tg_c = self.unroll(state.target_model, tr.next_obs[:, :K], tg_c, B)

        def tail(x):
            return time_major(x[:, K:])

        av, _ = self.unroll(state.model, tr.obs[:, K:], on_c, B)
        q = av.evaluate_actions(tail(tr.action))  # [T - K, B]
        with torch.no_grad():
            max_next = self.unroll(state.target_model, tr.next_obs[:, K:], tg_c, B)[0].max()
            term = tail(tr.terminated).to(torch.float32)
            target = tail(tr.reward) + self.gamma * (1.0 - term) * max_next
        diff = q - target
        per = huber_loss(diff) if self.clip_delta else 0.5 * diff * diff
        m = tail(batch.mask)
        loss = torch.sum(per * m) / self.denominator(batch, K)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        with torch.no_grad():
            win_err = torch.sum(torch.abs(diff) * m, dim=0) / torch.clamp_min(torch.sum(m, dim=0), 1.0)
            q_mean = torch.mean(q * m)
        return state, {"loss": loss.detach(), "average_q": q_mean, "errors": win_err}
