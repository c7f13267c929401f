"""Recurrent TRPO over chunked unrolls (counterpart of
``pfrl_tpu/agents/recurrent_trpo.py``).

A recurrent policy ``policy(x, carry) -> (distribution, carry)`` and a
recurrent value function ``vf(x, carry) -> (value, carry)``; the runner's
carry is the pair ``(policy carry, value-function carry)``. The rollout is
cut into chunks as in
:class:`~pfrl_tpu_torch.agents.recurrent_ppo.RecurrentPPOCore`, each
re-unrolled from its stored start carries with the carry reset after every
step that ended an episode.

The policy step is :class:`~pfrl_tpu_torch.agents.trpo.TRPOCore`'s on the
flat parameter vector, every function of it through the chunked unroll:
the surrogate's gradient, the Fisher-vector products as the Hessian-vector
product of the mean KL by double backward through the T-step unroll
(``torch.autograd.grad`` with ``create_graph``; the JAX core takes the
forward-mode ``jvp`` of ``grad``), conjugate gradient, and the line search
over all ``max_backtrack`` candidates. Its ``entropy`` metric is the
entropy at the accepted parameters. The value function is fit by
``vf_epochs`` epochs over shuffled chunks, one ``draws.permutation(n)`` per
epoch. There is no ``compute_dtype``: the recipe refuses one.

Under a mesh it runs whole on every rank over the all-gathered rollout,
as :class:`~pfrl_tpu_torch.agents.trpo.TRPOCore` does.
"""

import torch
from torch.func import functional_call

from pfrl_tpu_torch.agents.ddpg import fresh_module
from pfrl_tpu_torch.agents.ppo import Rollout, standardize
from pfrl_tpu_torch.agents.recurrent_ppo import chunk_start_carries, chunked
from pfrl_tpu_torch.agents.trpo import TRPOCore, TRPOState, _FlatPolicy
from pfrl_tpu_torch.ops.returns import gae_advantages
from pfrl_tpu_torch.utils.conjugate_gradient import conjugate_gradient
from pfrl_tpu_torch.utils.recurrent import mask_recurrent_state_at, stack, tree_map


class _FlatRecurrentPolicy(_FlatPolicy):
    """The policy as a function of its flat parameter vector: the stacked
    distribution ``[N, K]`` of the chunks ``obs [N, K, ...]`` unrolled from
    ``carry0`` with the carry reset after each step in ``done``."""

    def __init__(self, policy, obs, carry0, done):
        super().__init__(policy, obs)
        self.carry0, self.done = carry0, done

    def dist(self, v: torch.Tensor):
        chunks = torch.split(v, self.sizes)
        tensors = {n: c.view_as(p) for n, c, p in zip(self.names, chunks, self.params)}
        carry, dists = self.carry0, []
        for k in range(self.obs.shape[1]):
            d, carry = functional_call(self.policy, tensors, (self.obs[:, k], carry))
            dists.append(d)
            carry = mask_recurrent_state_at(carry, self.done[:, k])
        return stack(dists, dim=1)


class RecurrentTRPOCore(TRPOCore):
    recurrent = True

    def __init__(self, *args, chunk_len: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.chunk_len = chunk_len

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> TRPOState:
        device, B = example_obs.device, example_obs.shape[0]
        policy = fresh_module(self.policy, generator, device)
        vf = fresh_module(self.vf, generator, device)
        with torch.no_grad():  # shape check
            x = self.phi(example_obs)
            policy(x, policy.initial_carry(B, device))
            vf(x, vf.initial_carry(B, device))
        return self.state_from_modules(policy, vf)

    def initial_carry(self, batch_size: int, device=None):
        return (self.policy.initial_carry(batch_size, device), self.vf.initial_carry(batch_size, device))

    def init_act_state(self, batch_size: int, device=None):
        return self.initial_carry(batch_size, device)

    def reset_act_state(self, carry, done: torch.Tensor):
        return mask_recurrent_state_at(carry, done)

    # ------------------------------------------------------------------- act
    def value_step(self, vf, obs: torch.Tensor, carry):
        v, carry = vf(self.phi(obs), carry)
        return (v[..., 0] if v.dim() > 1 else v), carry

    @torch.no_grad()
    def select_action_recurrent(self, state: TRPOState, draws, obs, t: int, training: bool, carry):
        dist, pi_carry = state.policy(self.phi(obs), carry[0])
        _, vf_carry = self.value_step(state.vf, obs, carry[1])  # the value carry keeps in step
        return (dist.sample(draws) if training else dist.mode()), (pi_carry, vf_carry)

    @torch.no_grad()
    def act_with_aux_recurrent(self, state: TRPOState, draws, obs, training: bool, carry):
        dist, pi_carry = state.policy(self.phi(obs), carry[0])
        value, vf_carry = self.value_step(state.vf, obs, carry[1])
        action = dist.sample(draws) if training else dist.mode()
        return action, {"log_prob": dist.log_prob(action), "value": value}, (pi_carry, vf_carry)

    @torch.no_grad()
    def value_recurrent(self, state: TRPOState, obs, carry) -> torch.Tensor:
        """V(s_{t+1}) with the value function's carry after the step."""
        return self.value_step(state.vf, obs, carry[1])[0]

    def _unroll_vf(self, vf, carry0, obs, done) -> torch.Tensor:
        carry, values = carry0, []
        for k in range(obs.shape[1]):
            v, carry = self.value_step(vf, obs[:, k], carry)
            values.append(v)
            carry = mask_recurrent_state_at(carry, done[:, k])
        return torch.stack(values, dim=1)

    # ---------------------------------------------------------------- update
    def update(self, state: TRPOState, draws, rollout: Rollout):
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
        obs, action, done, old_lp, adv, vt = (chunked(x, K) for x in (
            rollout.obs, rollout.action, rollout.done, rollout.log_prob, advs, v_targets))
        pi_carry0, vf_carry0 = chunk_start_carries(rollout.carry, K)
        fp = _FlatRecurrentPolicy(state.policy, self.phi(obs), pi_carry0, done)
        aux = self._recurrent_policy_step(fp, action, old_lp, adv)
        vf_loss = self._vf_fit_chunks(state, draws, vf_carry0, obs, done, vt)
        state.n_updates += 1
        aux.update({"value_loss": vf_loss, "loss": aux["policy_loss"], "errors": torch.zeros(1, device=adv.device)})
        return state, aux

    def _recurrent_policy_step(self, fp: _FlatRecurrentPolicy, actions, old_lp, adv):
        flat0 = fp.vector()
        with torch.no_grad():
            old_dist = fp.dist(flat0)
        x = flat0.clone().requires_grad_(True)
        gain0 = self._gain(fp.dist(x), actions, old_lp, adv)
        (g,) = torch.autograd.grad(gain0, x)
        (kl_grad,) = torch.autograd.grad(torch.mean(old_dist.kl(fp.dist(x))), x, create_graph=True)

        def fvp(v):
            (hv,) = torch.autograd.grad(kl_grad, x, grad_outputs=v, retain_graph=True)
            return hv + self.cg_damping * v

        step_dir = conjugate_gradient(fvp, g, max_iter=self.cg_max_iter)
        shs = torch.dot(step_dir, fvp(step_dir))
        full_step = torch.sqrt(2.0 * self.max_kl / torch.clamp_min(shs, 1e-12)) * step_dir
        accepted, best, kl = self._line_search(fp, old_dist, flat0, full_step, gain0.detach(), actions, old_lp, adv)
        fp.assign(best)
        with torch.no_grad():
            entropy = torch.mean(fp.dist(best).entropy())
        return {
            "policy_loss": -gain0.detach(),
            "kl": kl,
            "step_accepted": accepted.to(torch.float32),
            "entropy": entropy,
        }

    def _vf_fit_chunks(self, state: TRPOState, draws, carry0, obs, done, v_targets) -> torch.Tensor:
        n = v_targets.shape[0]
        mb = min(self.vf_batch_size, n)
        n_mb = max(1, n // mb)
        params = list(state.vf.parameters())
        epoch_losses = []
        for _ in range(self.vf_epochs):
            losses = []
            for idx in draws.permutation(n)[: n_mb * mb].reshape(n_mb, mb):
                v = self._unroll_vf(state.vf, tree_map(lambda c: c[idx], carry0), obs[idx], done[idx])
                loss = torch.mean((v - v_targets[idx]) ** 2)
                grads = torch.autograd.grad(loss, params)
                self.vf_optimizer.update(params, grads, state.vf_opt_state)
                losses.append(loss.detach())
            epoch_losses.append(torch.mean(torch.stack(losses)))
        return torch.mean(torch.stack(epoch_losses))
