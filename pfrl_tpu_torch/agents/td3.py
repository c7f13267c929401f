"""TD3 core (counterpart of ``pfrl_tpu/agents/td3.py::TD3Core``): twin
critics, delayed policy updates, target-policy smoothing.

The critics' TD step runs every update, with the target taken from the
*target* policy plus smoothing noise through the minimum of the target
critics. The actor's step, through the updated first critic, and the three
Polyak copies run only when ``n_updates`` (read before it is incremented)
is a multiple of ``policy_update_delay``. The JAX core computes that step
every call and selects it in; here ``n_updates`` lives on the host and the
step is skipped, which leaves the policy, its Adam moments and count and
all three targets untouched off-cycle, as there. ``aux`` carries
``actor_loss`` only for an update that stepped the actor.

The twin critics are two modules applied one after the other: stacking
their weights for one batched product, as the JAX core does under XLA,
costs as many eager ops as it saves. ``compute_dtype`` as in :mod:`.ddpg`;
the actor's loss casts the first critic's apply on its own, as the JAX
core's ``actor_loss`` does.

Draws, in order: ``select_action`` as in :mod:`.ddpg`; ``update`` takes one
``draws.normal`` for the smoothing noise.

:class:`TD3` is the host shell (``td3.py:228-287``) over
:class:`~pfrl_tpu_torch.agents.ddpg.ActorCriticShellAgent`: its statistics
report the critic's loss only, as the JAX shell's do, and ``n_updates`` is
the core's host counter.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.agents.ddpg import (
    ActorCriticShellAgent,
    CastApplies,
    _identity,
    bootstrap_target,
    explore_or_burn_in,
    fresh_module,
    frozen_copy,
)
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils import draws as draw_fns
from pfrl_tpu_torch.utils.copy_param import soft_copy_param
from pfrl_tpu_torch.utils.precision import check_compute_dtype


@dataclasses.dataclass
class TD3State:
    policy: nn.Module
    q_func1: nn.Module
    q_func2: nn.Module
    target_policy: nn.Module
    target_q_func1: nn.Module
    target_q_func2: nn.Module
    policy_opt_state: Any
    q1_opt_state: Any
    q2_opt_state: Any
    n_updates: int = 0


def default_target_policy_smoothing_func(draws, batch_action: torch.Tensor) -> torch.Tensor:
    """Gaussian noise of scale 0.2 clipped to +-0.5 on the target actions,
    the sum clipped to +-1."""
    noise = torch.clamp(0.2 * draw_fns.normal(draws, batch_action.shape), -0.5, 0.5)
    return torch.clamp(batch_action + noise, -1.0, 1.0)


class TD3Core(CastApplies):
    def __init__(
        self,
        policy: nn.Module,
        q_func1: nn.Module,
        q_func2: nn.Module,
        policy_optimizer,
        q_func1_optimizer,
        q_func2_optimizer,
        explorer=None,
        gamma: float = 0.99,
        soft_update_tau: float = 5e-3,
        policy_update_delay: int = 2,
        target_policy_smoothing_func: Callable = default_target_policy_smoothing_func,
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
        self.explorer = explorer
        self.gamma = gamma
        self.soft_update_tau = soft_update_tau
        self.policy_update_delay = policy_update_delay
        self.smoothing = target_policy_smoothing_func
        self.phi = phi
        self.burnin_action_func = burnin_action_func
        self.burnin_steps = burnin_steps
        self.target_update_method = "soft"
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def init(self, generator: torch.Generator, example_obs, example_action) -> TD3State:
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

    def state_from_modules(self, policy, q_func1, q_func2) -> TD3State:
        return TD3State(
            policy=policy,
            q_func1=q_func1,
            q_func2=q_func2,
            target_policy=frozen_copy(policy),
            target_q_func1=frozen_copy(q_func1),
            target_q_func2=frozen_copy(q_func2),
            policy_opt_state=self.policy_optimizer.init(list(policy.parameters())),
            q1_opt_state=self.q_func1_optimizer.init(list(q_func1.parameters())),
            q2_opt_state=self.q_func2_optimizer.init(list(q_func2.parameters())),
        )

    @torch.no_grad()
    def select_action(self, state: TD3State, draws, obs, t: int, training: bool):
        greedy = self.policy_dist(state.policy, obs).mode()
        if not training:
            return greedy
        return explore_or_burn_in(self, draws, obs, t, greedy)

    # ---------------------------------------------------------------- update
    def critic_losses(self, state: TD3State, batch: TransitionBatch, draws):
        with torch.no_grad():
            next_a = self.smoothing(draws, self.policy_dist(state.target_policy, batch.next_obs).mode())
            nx = self.phi(batch.next_obs)
            next_q = torch.minimum(
                self.q_value(state.target_q_func1, nx, next_a), self.q_value(state.target_q_func2, nx, next_a)
            )
            t = bootstrap_target(batch, next_q)
        return self.twin_critic_loss(state.q_func1, state.q_func2, self.phi(batch.obs), batch.action, t)

    def actor_loss(self, state: TD3State, batch: TransitionBatch) -> torch.Tensor:
        a = self.policy_dist(state.policy, batch.obs).mode()
        return -torch.mean(self.q_value(state.q_func1, self.phi(batch.obs), a))

    def critic_step(self, state: TD3State, batch: TransitionBatch, draws):
        """Both critics' loss, gradients and optimizer steps."""
        q1_params = list(state.q_func1.parameters())
        q2_params = list(state.q_func2.parameters())
        c_loss, errors = self.critic_losses(state, batch, draws)
        grads = torch.autograd.grad(c_loss, q1_params + q2_params)
        self.q_func1_optimizer.update(q1_params, grads[: len(q1_params)], state.q1_opt_state)
        self.q_func2_optimizer.update(q2_params, grads[len(q1_params):], state.q2_opt_state)
        return c_loss.detach(), errors

    def actor_step(self, state: TD3State, batch: TransitionBatch) -> torch.Tensor:
        p_params = list(state.policy.parameters())
        a_loss = self.actor_loss(state, batch)
        self.policy_optimizer.update(
            p_params, torch.autograd.grad(a_loss, p_params), state.policy_opt_state
        )
        return a_loss.detach()

    def update(self, state: TD3State, batch: TransitionBatch, draws):
        c_loss, errors = self.critic_step(state, batch, draws)
        aux = {"loss": c_loss, "errors": errors}
        if state.n_updates % self.policy_update_delay == 0:
            aux["actor_loss"] = self.actor_step(state, batch)
            self.sync_target(state)
        state.n_updates += 1
        return state, aux

    def sync_target(self, state: TD3State) -> TD3State:
        tau = self.soft_update_tau
        soft_copy_param(state.target_policy, state.policy, tau)
        soft_copy_param(state.target_q_func1, state.q_func1, tau)
        soft_copy_param(state.target_q_func2, state.q_func2, tau)
        return state


class TD3(ActorCriticShellAgent):
    """The reference's TD3 agent (``td3.py:228-287``)."""

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
        explorer,
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
        policy_update_delay: int = 2,
        target_policy_smoothing_func: Callable = default_target_policy_smoothing_func,
        burnin_action_func: Optional[Callable] = None,
        burnin_steps: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu
        core = TD3Core(
            policy=policy,
            q_func1=q_func1,
            q_func2=q_func2,
            policy_optimizer=policy_optimizer,
            q_func1_optimizer=q_func1_optimizer,
            q_func2_optimizer=q_func2_optimizer,
            explorer=explorer,
            gamma=gamma,
            soft_update_tau=soft_update_tau,
            policy_update_delay=policy_update_delay,
            target_policy_smoothing_func=target_policy_smoothing_func,
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
