"""Soft Actor-Critic core with a learned temperature (counterpart of
``pfrl_tpu/agents/soft_actor_critic.py::SACCore``).

One update, in place: the twin critics' step towards the soft Bellman
target, which samples the *online* policy on ``next_obs`` and takes the
minimum of the target critics; then the reparameterized actor step through
the *updated* critics together with the temperature's step; then the
Polyak copies of the two critics. Each loss is differentiated with respect
to its own parameters only (the critics' for the critic loss; the policy's
and ``log_temperature`` for the actor and temperature loss, where the
temperature enters the actor term and ``log_pi`` the temperature term
without gradient).

``log_temperature`` is a 0-d tensor with an Adam state of its own (lists of
one). The twin critics are two modules applied one after the other (see
:mod:`.td3`). ``compute_dtype`` as in :mod:`.ddpg`: the temperature and
the log-probabilities stay float32.

Draws, in order: ``select_action`` while training takes the policy's
sample noise, then, only while ``t < burnin_steps``, the burn-in actions,
which replace the sample; ``update`` takes the critic's noise (the sample
at ``next_obs``), then the actor's.

:class:`SoftActorCritic` is the host shell (``soft_actor_critic.py:259-324``)
over :class:`~pfrl_tpu_torch.agents.ddpg.ActorCriticShellAgent`; its
entropy target defaults to ``-|A|``.
"""

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.agents.ddpg import (
    ActorCriticShellAgent,
    CastApplies,
    _identity,
    bootstrap_target,
    fresh_module,
    frozen_copy,
)
from pfrl_tpu_torch.optimizers.adam import Adam
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils.copy_param import soft_copy_param
from pfrl_tpu_torch.utils.precision import check_compute_dtype


@dataclasses.dataclass
class SACState:
    policy: nn.Module
    q_func1: nn.Module
    q_func2: nn.Module
    target_q_func1: nn.Module
    target_q_func2: nn.Module
    policy_opt_state: Any
    q1_opt_state: Any
    q2_opt_state: Any
    log_temperature: torch.Tensor  # 0-d, requires grad
    temperature_opt_state: Any
    n_updates: int = 0


class SACCore(CastApplies):
    """``policy`` maps observations to a distribution with
    ``sample_and_log_prob``; ``entropy_target=None`` keeps the temperature
    fixed at ``initial_temperature``."""

    def __init__(
        self,
        policy: nn.Module,
        q_func1: nn.Module,
        q_func2: nn.Module,
        policy_optimizer,
        q_func1_optimizer,
        q_func2_optimizer,
        gamma: float = 0.99,
        soft_update_tau: float = 5e-3,
        temperature_optimizer=None,
        initial_temperature: float = 1.0,
        entropy_target: Optional[float] = None,
        phi: Callable = _identity,
        burnin_action_func: Optional[Callable] = None,
        burnin_steps: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.policy = policy
        self.q_func1 = q_func1
        self.q_func2 = q_func2
        self.policy_optimizer = policy_optimizer
        self.q_func1_optimizer = q_func1_optimizer
        self.q_func2_optimizer = q_func2_optimizer
        self.gamma = gamma
        self.soft_update_tau = soft_update_tau
        self.temperature_optimizer = temperature_optimizer or Adam(3e-4)
        self.initial_temperature = initial_temperature
        self.entropy_target = entropy_target
        self.learn_temperature = entropy_target is not None
        self.phi = phi
        self.burnin_action_func = burnin_action_func
        self.burnin_steps = burnin_steps
        self.target_update_method = "soft"
        self.explorer = None
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def init(self, generator: torch.Generator, example_obs, example_action) -> SACState:
        """``generator`` (on the CPU) draws the policy's weights, then each
        critic's."""
        device = example_obs.device
        policy = fresh_module(self.policy, generator, device)
        q1 = fresh_module(self.q_func1, generator, device)
        q2 = fresh_module(self.q_func2, generator, device)
        with torch.no_grad():  # shape check
            self.policy_dist(policy, example_obs)
            for q in (q1, q2):
                self.q_value(q, self.phi(example_obs), example_action)
        return self.state_from_modules(policy, q1, q2)

    def state_from_modules(self, policy, q_func1, q_func2) -> SACState:
        device = next(policy.parameters()).device
        log_temp = torch.tensor(
            math.log(self.initial_temperature), dtype=torch.float32, device=device,
            requires_grad=True,
        )
        return SACState(
            policy=policy,
            q_func1=q_func1,
            q_func2=q_func2,
            target_q_func1=frozen_copy(q_func1),
            target_q_func2=frozen_copy(q_func2),
            policy_opt_state=self.policy_optimizer.init(list(policy.parameters())),
            q1_opt_state=self.q_func1_optimizer.init(list(q_func1.parameters())),
            q2_opt_state=self.q_func2_optimizer.init(list(q_func2.parameters())),
            log_temperature=log_temp,
            temperature_opt_state=self.temperature_optimizer.init([log_temp]),
        )

    @torch.no_grad()
    def select_action(self, state: SACState, draws, obs, t: int, training: bool):
        dist = self.policy_dist(state.policy, obs)
        if not training:
            return dist.mode()
        a = dist.sample(draws)
        if self.burnin_action_func is not None and t < self.burnin_steps:
            a = self.burnin_action_func(draws, obs.shape[0])
        return a

    # ---------------------------------------------------------------- update
    def critic_losses(self, state: SACState, batch: TransitionBatch, draws):
        """Soft Bellman targets."""
        with torch.no_grad():
            next_a, next_log_pi = self.policy_dist(state.policy, batch.next_obs).sample_and_log_prob(draws)
            nx = self.phi(batch.next_obs)
            next_q = torch.minimum(
                self.q_value(state.target_q_func1, nx, next_a), self.q_value(state.target_q_func2, nx, next_a)
            )
            entropy_term = torch.exp(state.log_temperature) * next_log_pi
            t = bootstrap_target(batch, next_q - entropy_term)
        return self.twin_critic_loss(state.q_func1, state.q_func2, self.phi(batch.obs), batch.action, t)

    def actor_and_temp_loss(self, state: SACState, batch: TransitionBatch, draws):
        a, log_pi = self.policy_dist(state.policy, batch.obs).sample_and_log_prob(draws)
        x = self.phi(batch.obs)
        q = torch.minimum(self.q_value(state.q_func1, x, a), self.q_value(state.q_func2, x, a))
        temp = torch.exp(state.log_temperature).detach()
        actor_loss = torch.mean(temp * log_pi - q)
        if self.learn_temperature:
            temp_loss = -torch.mean(state.log_temperature * (log_pi + self.entropy_target).detach())
        else:
            temp_loss = torch.zeros_like(actor_loss)
        return actor_loss + temp_loss, (actor_loss, temp_loss, -torch.mean(log_pi))

    def critic_step(self, state: SACState, batch: TransitionBatch, draws):
        """Both critics' loss, gradients and optimizer steps."""
        q1_params = list(state.q_func1.parameters())
        q2_params = list(state.q_func2.parameters())
        c_loss, errors = self.critic_losses(state, batch, draws)
        grads = torch.autograd.grad(c_loss, q1_params + q2_params)
        self.q_func1_optimizer.update(q1_params, grads[: len(q1_params)], state.q1_opt_state)
        self.q_func2_optimizer.update(q2_params, grads[len(q1_params):], state.q2_opt_state)
        return c_loss.detach(), errors

    def actor_step(self, state: SACState, batch: TransitionBatch, draws):
        """The actor's and the temperature's loss, gradients and optimizer
        steps; returns the two losses and the entropy estimate."""
        p_params = list(state.policy.parameters())
        learned = [state.log_temperature] if self.learn_temperature else []
        total, parts = self.actor_and_temp_loss(state, batch, draws)
        grads = torch.autograd.grad(total, p_params + learned)
        self.policy_optimizer.update(p_params, grads[: len(p_params)], state.policy_opt_state)
        if self.learn_temperature:
            self.temperature_optimizer.update(learned, grads[len(p_params):], state.temperature_opt_state)
        return tuple(x.detach() for x in parts)

    def update(self, state: SACState, batch: TransitionBatch, draws):
        c_loss, errors = self.critic_step(state, batch, draws)
        a_loss, t_loss, entropy = self.actor_step(state, batch, draws)
        self.sync_target(state)
        state.n_updates += 1
        return state, {
            "loss": c_loss,
            "actor_loss": a_loss,
            "temperature_loss": t_loss,
            "entropy": entropy,
            "temperature": torch.exp(state.log_temperature.detach()),
            "errors": errors,
        }

    def sync_target(self, state: SACState) -> SACState:
        soft_copy_param(state.target_q_func1, state.q_func1, self.soft_update_tau)
        soft_copy_param(state.target_q_func2, state.q_func2, self.soft_update_tau)
        return state


class SoftActorCritic(ActorCriticShellAgent):
    """The reference's SAC agent (``soft_actor_critic.py:259-324``);
    ``temperature_optimizer_lr`` gives the temperature an Adam of that rate
    (default: the core's Adam(3e-4))."""

    def __init__(
        self,
        policy: nn.Module,
        q_func1: nn.Module,
        q_func2: nn.Module,
        policy_optimizer,
        q_func1_optimizer,
        q_func2_optimizer,
        replay_buffer,
        gamma: float,
        *,
        action_space,
        gpu=None,
        replay_start_size: int = 10000,
        minibatch_size: int = 100,
        update_interval: int = 1,
        phi: Callable = _identity,
        soft_update_tau: float = 5e-3,
        n_times_update: int = 1,
        update_burst: bool = False,
        temperature_optimizer_lr: Optional[float] = None,
        initial_temperature: float = 1.0,
        entropy_target: Optional[float] = None,
        burnin_action_func: Optional[Callable] = None,
        burnin_steps: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu
        if entropy_target is None:
            entropy_target = -float(action_space.shape[0])
        core = SACCore(
            policy=policy,
            q_func1=q_func1,
            q_func2=q_func2,
            policy_optimizer=policy_optimizer,
            q_func1_optimizer=q_func1_optimizer,
            q_func2_optimizer=q_func2_optimizer,
            gamma=gamma,
            soft_update_tau=soft_update_tau,
            temperature_optimizer=Adam(temperature_optimizer_lr) if temperature_optimizer_lr is not None else None,
            initial_temperature=initial_temperature,
            entropy_target=entropy_target,
            phi=phi,
            burnin_action_func=burnin_action_func,
            burnin_steps=burnin_steps,
            compute_dtype=compute_dtype,
        )
        super().__init__(
            core,
            replay_buffer,
            action_space=action_space,
            replay_start_size=replay_start_size,
            minibatch_size=minibatch_size,
            update_interval=update_interval,
            n_times_update=n_times_update,
            update_burst=update_burst,
            seed=seed,
            device=device,
            draws=draws,
        )
