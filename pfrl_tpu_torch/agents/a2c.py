"""A2C, synchronous advantage actor-critic (counterpart of
``pfrl_tpu/agents/a2c.py::A2CCore``).

It shares PPO's model protocol and state (:class:`~.ppo.PPOState`) and takes
one full-batch optimizer step per rollout. The value targets are n-step
returns, bootstrapped from V at episode boundaries and at the rollout's end
(``use_gae=False``), or GAE's (``use_gae=True``, with ``tau`` as lambda).
``update`` draws nothing. ``compute_dtype`` as in :mod:`.ppo`.

:class:`A2C` is the host shell (``a2c.py:123-161``) over
:class:`~.ppo.OnPolicyShellAgent`: ``update_interval = update_steps *
num_processes``, and ``pi_loss_coef`` is accepted and dropped, as the JAX
shell drops it.
"""

from typing import Callable, Optional

import torch

from pfrl_tpu_torch.agents.ddpg import _identity
from pfrl_tpu_torch.agents.ppo import OnPolicyShellAgent, PPOCore, PPOState, Rollout, flat
from pfrl_tpu_torch.ops.returns import discounted_returns, gae_advantages
from pfrl_tpu_torch.parallel.mesh import shard_batch


class A2CCore(PPOCore):
    def __init__(
        self,
        model,
        optimizer,
        gamma: float = 0.99,
        use_gae: bool = False,
        tau: float = 0.95,
        entropy_coeff: float = 0.01,
        v_loss_coef: float = 0.5,
        max_grad_norm: Optional[float] = None,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(
            model=model,
            optimizer=optimizer,
            gamma=gamma,
            lambd=tau,
            entropy_coef=entropy_coeff,
            value_func_coef=v_loss_coef,
            max_grad_norm=max_grad_norm,
            phi=phi,
            compute_dtype=compute_dtype,
        )
        self.use_gae = use_gae

    @torch.no_grad()
    def targets(self, model, rollout: Rollout):
        """``(advantages, v_targets)``, ``[T, B]`` each."""
        next_values = self.next_values(model, rollout)
        if self.use_gae:
            return gae_advantages(
                rollout.reward, rollout.value, next_values,
                rollout.terminated, rollout.done, self.gamma, self.lambd,
            )
        v_targets = discounted_returns(
            rollout.reward, rollout.terminated, next_values, self.gamma, done=rollout.done
        )
        return v_targets - rollout.value, v_targets

    def loss(self, model, rollout: Rollout, advs, v_targets):
        dist, values = self.forward(model, flat(rollout.obs))
        pg_loss = -torch.mean(dist.log_prob(flat(rollout.action)) * flat(advs))
        v_loss = torch.mean((values - flat(v_targets)) ** 2)
        entropy = torch.mean(dist.entropy())
        loss = pg_loss + self.value_func_coef * v_loss - self.entropy_coef * entropy
        return loss, (pg_loss, v_loss, entropy)

    def update(self, state: PPOState, draws, rollout: Rollout):
        advs, v_targets = self.targets(state.model, rollout)
        if self.mesh is not None:  # this rank's lanes: the loss is a mean over its share
            rollout, advs, v_targets = shard_batch(self.mesh, (rollout, advs, v_targets), dim=1)
        params = list(state.model.parameters())
        loss, (pg, vl, ent) = self.loss(state.model, rollout, advs, v_targets)
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        return state, {
            "loss": loss.detach(),
            "policy_loss": pg.detach(),
            "value_loss": vl.detach(),
            "entropy": ent.detach(),
            "errors": torch.zeros(1, device=loss.device),
        }


class A2C(OnPolicyShellAgent):
    """The reference's A2C agent (``a2c.py:123-161``). ``update_steps`` is
    the reference's ``t_max``, the rollout's length per env."""

    def __init__(
        self,
        model,
        optimizer,
        gamma: float,
        num_processes: int,
        *,
        gpu=None,
        update_steps: int = 5,
        phi: Callable = _identity,
        pi_loss_coef: float = 1.0,
        v_loss_coef: float = 0.5,
        entropy_coeff: float = 0.01,
        use_gae: bool = False,
        tau: float = 0.95,
        max_grad_norm: Optional[float] = None,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu, pi_loss_coef
        core = A2CCore(
            model=model,
            optimizer=optimizer,
            gamma=gamma,
            use_gae=use_gae,
            tau=tau,
            entropy_coeff=entropy_coeff,
            v_loss_coef=v_loss_coef,
            max_grad_norm=max_grad_norm,
            phi=phi,
            compute_dtype=compute_dtype,
        )
        super().__init__(core, update_interval=update_steps * num_processes, seed=seed, device=device, draws=draws)
