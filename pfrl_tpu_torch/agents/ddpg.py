"""DDPG core (counterpart of ``pfrl_tpu/agents/ddpg.py::DDPGCore``).

:class:`ActorCriticState` holds the online and target ``nn.Module``s of the
policy and the Q-function and the two optimizers' states; ``update`` and
``sync_target`` change them **in place** (and return the same state).
``n_updates`` lives on the host.

One update is the critic's TD step, then the deterministic policy-gradient
step taken through the *updated* critic, then (soft method) the Polyak
copies. Each loss is differentiated with respect to its own network's
parameters only: the actor's loss leaves no gradient in the critic.

Draws, in order: ``select_action`` while training takes the explorer's
noise, then, only while ``t < burnin_steps`` (a host comparison), the
burn-in actions, which replace the explorer's; ``update`` draws nothing.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs every apply of the policy
and of the critics in that dtype over the float32 parameters
(:class:`CastApplies`): each floating input, the action included, is cast
at the apply boundary and the distribution or value comes back float32.
The targets, losses and optimizers stay float32.

Not ported yet: the host shell ``DDPG`` / ``ActorCriticShellAgent``
(``batch_act`` / ``batch_observe``).
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.ops.value_loss import compute_value_loss
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype


@dataclasses.dataclass
class ActorCriticState:
    policy: nn.Module         # the JAX state's policy_params
    q_func: nn.Module         # ... q_params
    target_policy: nn.Module
    target_q_func: nn.Module
    policy_opt_state: Any
    q_opt_state: Any
    n_updates: int = 0


def _identity(x):
    return x


def fresh_module(template: nn.Module, generator: torch.Generator, device) -> nn.Module:
    """A copy of ``template`` with weights drawn from ``generator``, on ``device``."""
    module = copy.deepcopy(template)
    module.reset_parameters(generator)
    return module.to(device)


def frozen_copy(module: nn.Module) -> nn.Module:
    """A target network: a copy that takes no gradient."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


def bootstrap_target(batch: TransitionBatch, next_q: torch.Tensor) -> torch.Tensor:
    return batch.reward + batch.discount * (1.0 - batch.is_terminal.to(torch.float32)) * next_q


class CastApplies:
    """The networks' applies of the actor-critic cores, under the core's
    ``compute_dtype`` and feature map ``phi``."""

    compute_dtype: Optional[torch.dtype] = None

    def policy_dist(self, policy: nn.Module, obs: torch.Tensor):
        return apply_cast(policy, self.compute_dtype, self.phi(obs))

    def q_value(self, q_func: nn.Module, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """``x`` is the feature map's output already."""
        return apply_cast(q_func, self.compute_dtype, x, action)

    def twin_critic_loss(self, q_func1, q_func2, x, action, t):
        """Sum of the two critics' mean squared TD errors against one
        target; also the first critic's absolute errors. The twins are
        applied one after the other: the JAX core's stacked apply of both
        gives the same numbers."""
        y1, y2 = self.q_value(q_func1, x, action), self.q_value(q_func2, x, action)
        loss = compute_value_loss(y1, t, clip_delta=False) + compute_value_loss(y2, t, clip_delta=False)
        return loss, torch.abs(y1 - t).detach()


def explore_or_burn_in(core, draws, obs: torch.Tensor, t: int, greedy: torch.Tensor) -> torch.Tensor:
    """The training action of the deterministic cores: the explorer's noise
    on the greedy action, replaced by burn-in actions while
    ``t < core.burnin_steps``."""
    a = greedy if core.explorer is None else core.explorer.select_action(draws, t, greedy)
    if core.burnin_action_func is not None and t < core.burnin_steps:
        a = core.burnin_action_func(draws, obs.shape[0])
    return a


class DDPGCore(CastApplies):
    """``policy`` (obs -> distribution) and ``q_func`` ((obs, action) -> Q)
    are templates: ``init`` copies them and draws the copies' weights.
    ``burnin_action_func(draws, batch) -> actions``."""

    def __init__(
        self,
        policy: nn.Module,
        q_func: nn.Module,
        policy_optimizer,
        q_optimizer,
        explorer=None,
        gamma: float = 0.99,
        clip_delta: bool = True,
        target_update_method: str = "soft",
        soft_update_tau: float = 5e-3,
        phi: Callable = _identity,
        burnin_action_func: Optional[Callable] = None,
        burnin_steps: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        if target_update_method not in ("hard", "soft"):
            raise ValueError(f"target_update_method: {target_update_method!r}")
        self.policy = policy
        self.q_func = q_func
        self.policy_optimizer = policy_optimizer
        self.q_optimizer = q_optimizer
        self.explorer = explorer
        self.gamma = gamma
        self.clip_delta = clip_delta
        self.target_update_method = target_update_method
        self.soft_update_tau = soft_update_tau
        self.phi = phi
        self.burnin_action_func = burnin_action_func
        self.burnin_steps = burnin_steps
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs, example_action) -> ActorCriticState:
        """``generator`` (on the CPU) draws the policy's weights, then the
        Q-function's; the examples are batched, on the target device."""
        device = example_obs.device
        policy = fresh_module(self.policy, generator, device)
        q_func = fresh_module(self.q_func, generator, device)
        with torch.no_grad():  # shape check
            self.policy_dist(policy, example_obs)
            self.q_value(q_func, self.phi(example_obs), example_action)
        return self.state_from_modules(policy, q_func)

    def state_from_modules(self, policy: nn.Module, q_func: nn.Module) -> ActorCriticState:
        """A fresh state: targets = copies, zero moments."""
        return ActorCriticState(
            policy=policy,
            q_func=q_func,
            target_policy=frozen_copy(policy),
            target_q_func=frozen_copy(q_func),
            policy_opt_state=self.policy_optimizer.init(list(policy.parameters())),
            q_opt_state=self.q_optimizer.init(list(q_func.parameters())),
        )

    # ------------------------------------------------------------------- act
    @torch.no_grad()
    def select_action(self, state: ActorCriticState, draws, obs, t: int, training: bool):
        greedy = self.policy_dist(state.policy, obs).mode()
        if not training:
            return greedy
        return explore_or_burn_in(self, draws, obs, t, greedy)

    # ---------------------------------------------------------------- update
    def critic_loss(self, state: ActorCriticState, batch: TransitionBatch):
        with torch.no_grad():
            next_a = self.policy_dist(state.target_policy, batch.next_obs).mode()
            next_q = self.q_value(state.target_q_func, self.phi(batch.next_obs), next_a)
            t = bootstrap_target(batch, next_q)
        y = self.q_value(state.q_func, self.phi(batch.obs), batch.action)
        return compute_value_loss(y, t, clip_delta=self.clip_delta), torch.abs(y - t).detach()

    def actor_loss(self, state: ActorCriticState, batch: TransitionBatch) -> torch.Tensor:
        a = self.policy_dist(state.policy, batch.obs).mode()
        return -torch.mean(self.q_value(state.q_func, self.phi(batch.obs), a))

    def critic_step(self, state: ActorCriticState, batch: TransitionBatch):
        """The critic's loss, gradient and optimizer step."""
        q_params = list(state.q_func.parameters())
        c_loss, errors = self.critic_loss(state, batch)
        self.q_optimizer.update(q_params, torch.autograd.grad(c_loss, q_params), state.q_opt_state)
        return c_loss.detach(), errors

    def actor_step(self, state: ActorCriticState, batch: TransitionBatch) -> torch.Tensor:
        """The actor's loss through the current critic, gradient and
        optimizer step."""
        p_params = list(state.policy.parameters())
        a_loss = self.actor_loss(state, batch)
        self.policy_optimizer.update(
            p_params, torch.autograd.grad(a_loss, p_params), state.policy_opt_state
        )
        return a_loss.detach()

    def update(self, state: ActorCriticState, batch: TransitionBatch, draws=None):
        """One critic step and one actor step, in place. Returns
        ``(state, aux)``; nothing in ``aux`` is read on the host."""
        c_loss, errors = self.critic_step(state, batch)
        a_loss = self.actor_step(state, batch)
        state.n_updates += 1
        if self.target_update_method == "soft":
            self.sync_target(state)  # soft targets follow every update
        aux = {
            "loss": c_loss,
            "actor_loss": a_loss,
            "average_q": torch.zeros_like(c_loss),
            "errors": errors,
        }
        return state, aux

    def sync_target(self, state: ActorCriticState) -> ActorCriticState:
        pairs = ((state.target_policy, state.policy), (state.target_q_func, state.q_func))
        for target, source in pairs:
            if self.target_update_method == "hard":
                copy_param(target, source)
            else:
                soft_copy_param(target, source, self.soft_update_tau)
        return state
