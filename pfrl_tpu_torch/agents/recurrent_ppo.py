"""Recurrent PPO with chunked truncated backprop through time (counterpart
of ``pfrl_tpu/agents/recurrent_ppo.py``).

The model is ``model(x, carry) -> ((distribution, value), carry)``. The
on-policy runner threads the carry through collection, stores each step's
carry before acting (``Rollout.carry``) and V(s_{t+1}) with the carry after
it (``Rollout.next_value``), and resets the carry's rows where an episode
ended. The update cuts the ``[T, B]`` rollout into ``T / chunk_len * B``
chunks of ``chunk_len`` steps (``chunk_len`` must divide T), and each
minibatch of chunks is re-unrolled from its stored start carries, the carry
reset after every step that ended an episode, as during collection. Epochs
x shuffled-chunk minibatches, one ``draws.permutation(n)`` per epoch cut to
whole minibatches, as :class:`~pfrl_tpu_torch.agents.ppo.PPOCore`.

``compute_dtype`` casts the weights and the observation features, never
the carry, as :class:`~pfrl_tpu_torch.agents.recurrent_dqn.RecurrentDQNCore`.

Under a mesh (``mesh`` set by ``parallel.data_parallel_core``) each
minibatch's chunks are split over the ranks, as PPO splits its rows: every
chunk is ``chunk_len`` valid steps and every rank holds ``mb / size``
chunks, so the mean of the ranks' mean losses is the whole minibatch's and
the optimizer averages the gradients; no global denominator is needed.
"""

import torch

from pfrl_tpu_torch.agents.ddpg import fresh_module
from pfrl_tpu_torch.agents.ppo import PPOCore, PPOState, Rollout, explained_variance, standardize
from pfrl_tpu_torch.ops.returns import gae_advantages
from pfrl_tpu_torch.parallel.mesh import local_rows
from pfrl_tpu_torch.utils.precision import apply_cast
from pfrl_tpu_torch.utils.recurrent import mask_recurrent_state_at, stack, tree_map


def chunked(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[T, B, ...]`` -> ``[T / k * B, k, ...]``: chunk ``c * B + b`` holds
    lane b's steps ``c * k`` to ``c * k + k - 1``."""
    T, B = x.shape[:2]
    rest = tuple(x.shape[2:])
    return x.reshape((T // k, k, B) + rest).transpose(1, 2).reshape((T // k * B, k) + rest)


def chunk_start_carries(carry, k: int):
    """The stored carries at steps 0, k, 2k, ...: ``[T / k * B, ...]``."""
    return tree_map(lambda x: x[::k].reshape((-1,) + tuple(x.shape[2:])), carry)


class RecurrentPPOCore(PPOCore):
    recurrent = True

    def __init__(self, *args, chunk_len: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.chunk_len = chunk_len

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> PPOState:
        model = fresh_module(self.model, generator, example_obs.device)
        with torch.no_grad():  # shape check
            self.forward_step(model, example_obs, self.initial_carry(example_obs.shape[0], example_obs.device))
        return self.state_from_model(model)

    def initial_carry(self, batch_size: int, device=None):
        return self.model.initial_carry(batch_size, device)

    def init_act_state(self, batch_size: int, device=None):
        return self.initial_carry(batch_size, device)

    def reset_act_state(self, carry, done: torch.Tensor):
        return mask_recurrent_state_at(carry, done)

    # ------------------------------------------------------------------- act
    def forward_step(self, model, obs: torch.Tensor, carry):
        """``(distribution, value [B], carry)``, float32."""
        (dist, value), new_carry = apply_cast(model, self.compute_dtype, self.phi(obs), carry, uncast_argnums=(1,))
        return dist, value[..., 0] if value.dim() > 1 else value, new_carry

    @torch.no_grad()
    def select_action_recurrent(self, state: PPOState, draws, obs, t: int, training: bool, carry):
        dist, _, new_carry = self.forward_step(state.model, obs, carry)
        return (dist.sample(draws) if training else dist.mode()), new_carry

    @torch.no_grad()
    def act_with_aux_recurrent(self, state: PPOState, draws, obs, training: bool, carry):
        dist, value, new_carry = self.forward_step(state.model, obs, carry)
        action = dist.sample(draws) if training else dist.mode()
        return action, {"log_prob": dist.log_prob(action), "value": value}, new_carry

    @torch.no_grad()
    def value_recurrent(self, state: PPOState, obs, carry) -> torch.Tensor:
        """V(obs) from ``carry``: the runner's V(s_{t+1}) on the pre-reset
        next observation with the carry after the step."""
        return self.forward_step(state.model, obs, carry)[1]

    # ---------------------------------------------------------------- update
    def _chunk_loss(self, model, carry0, obs, action, done, old_lp, old_v, adv, v_target):
        """Unroll ``[mb, K]`` chunks from ``carry0``; the losses over every step."""
        carry, steps = carry0, []
        for k in range(obs.shape[1]):
            dist, value, carry = self.forward_step(model, obs[:, k], carry)
            steps.append((dist.log_prob(action[:, k]), dist.entropy(), value))
            carry = self.reset_act_state(carry, done[:, k])
        log_prob, entropy, value = stack(steps, dim=1)
        return self.losses(log_prob, entropy, value, old_lp, old_v, adv, v_target)

    def update(self, state: PPOState, draws, rollout: Rollout):
        T, B = rollout.reward.shape
        K = self.chunk_len
        if T % K:
            raise ValueError(f"chunk_len {K} must divide the rollout length {T}")
        with torch.no_grad():
            advs, v_targets = gae_advantages(
                rollout.reward, rollout.value, rollout.next_value,
                rollout.terminated, rollout.done, self.gamma, self.lambd,
            )
            if self.standardize_advantages:
                advs = standardize(advs)
        data = [chunked(x, K) for x in (
            rollout.obs, rollout.action, rollout.done, rollout.log_prob, rollout.value, advs, v_targets)]
        carry0 = chunk_start_carries(rollout.carry, K)
        n = T // K * B
        n_mb, mb = self.minibatch_shape(n)
        params = list(state.model.parameters())
        metrics = []
        for _ in range(self.epochs):
            for idx in draws.permutation(n)[: n_mb * mb].reshape(n_mb, mb):
                if self.mesh is not None:
                    idx = idx[local_rows(self.mesh, mb)]
                loss, parts = self._chunk_loss(
                    state.model, tree_map(lambda x: x[idx], carry0), *(x[idx] for x in data))
                grads = torch.autograd.grad(loss, params)
                self.optimizer.update(params, grads, state.opt_state)
                metrics.append(torch.stack([loss.detach()] + [p.detach() for p in parts]))
        loss, policy_loss, value_loss, entropy = torch.stack(metrics).mean(0)
        state.n_updates += self.epochs * n_mb
        return state, {
            "loss": loss,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
            "explained_variance": explained_variance(v_targets, rollout.value),
            "errors": torch.zeros(1, device=advs.device),
        }
