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

:class:`ActorCriticShellAgent` is the host shell that DDPG, TD3 and SAC
share (``ddpg.py:182-360``): the reference's ``batch_act``/``batch_observe``
protocol around a core, a replay buffer and a draw source, and
:class:`DDPG` is its DDPG (``ddpg.py:363-417``).
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import check_same_device, resolve_device, use_full_fp32
from pfrl_tpu_torch.agent import AttributeSavingMixin, BatchAgent
from pfrl_tpu_torch.ops.value_loss import compute_value_loss
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch
from pfrl_tpu_torch.utils.batch_states import to_device_like_jax
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype
from pfrl_tpu_torch.utils.stats import RunningStats


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
    def target_next_q(self, state: ActorCriticState, batch: TransitionBatch) -> torch.Tensor:
        """The target critic at the target policy's mode on ``next_obs``."""
        next_a = self.policy_dist(state.target_policy, batch.next_obs).mode()
        return self.q_value(state.target_q_func, self.phi(batch.next_obs), next_a)

    def critic_loss(self, state: ActorCriticState, batch: TransitionBatch):
        with torch.no_grad():
            t = bootstrap_target(batch, self.target_next_q(state, batch))
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


class ActorCriticShellAgent(AttributeSavingMixin, BatchAgent):
    """Host shell of the actor-critic cores (``ddpg.py:182-360``).

    The first act builds the state from the batch's shape (weights from a
    CPU generator seeded with ``seed``; the example action is zeros of
    ``action_space``'s shape, as only its shape matters), unless a state was
    set or loaded before it. ``draws`` is the draw source of the acts and
    the updates (default: a generator on ``device`` seeded with ``seed``).
    ``replay_buffer`` lives on ``device``; the first observe reconfigures it
    to the batch's width.

    Each observe adds one transition per env (``done | reset`` as the
    ring's done, ``done`` as terminated); ``t`` counts them. A
    ``target_update_method == "hard"`` core syncs its targets on each
    crossing of a multiple of ``target_update_interval`` (soft targets
    follow every update inside the core). From ``replay_start_size`` on,
    each crossing of a multiple of ``update_interval`` runs
    ``n_times_update`` updates, each a sample, the core's update and the
    priority feedback; ``update_burst`` runs more than one due update back
    to back and keeps **one** mean loss for them, where the JAX shell runs
    them as one jitted scan. ``float(loss)`` in the statistics waits for
    the card, as in JAX. On the card it runs float32 without TF32.
    """

    saved_attributes = ("train_state",)

    def __init__(
        self,
        core,
        replay_buffer,
        *,
        action_space,
        replay_start_size: int = 10000,
        minibatch_size: int = 100,
        update_interval: int = 1,
        target_update_interval: int = 1,
        n_times_update: int = 1,
        update_burst: bool = False,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        self.core = core
        self.device = check_same_device(agent=resolve_device(device), replay_buffer=replay_buffer.device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.buffer = replay_buffer
        self.core_action_space = action_space
        self.replay_start_size = replay_start_size
        self.minibatch_size = minibatch_size
        self.update_interval = update_interval
        self.target_update_interval = target_update_interval
        self.n_times_update = n_times_update
        self.update_burst = update_burst
        self.seed = seed
        self.draws = draws if draws is not None else Draws(torch.Generator(device=self.device).manual_seed(seed))
        self.t = 0
        self.train_state = None
        self.replay_state = None
        self._last_obs = None
        self._last_action = None
        self._loss_stats = RunningStats(100)

    # ------------------------------------------------------------------- act
    def batch_act(self, batch_obs) -> np.ndarray:
        obs = to_device_like_jax(np.asarray(batch_obs), self.device)
        if self.train_state is None:
            example_action = torch.zeros(
                (obs.shape[0],) + tuple(self.core_action_space.shape), dtype=torch.float32, device=self.device
            )
            self.train_state = self.core.init(torch.Generator().manual_seed(self.seed), obs, example_action)
            self._restore_pending()
        actions = self.core.select_action(self.train_state, self.draws, obs, self.t, self.training)
        if self.training:
            self._last_obs = obs
            self._last_action = actions
        return actions.cpu().numpy()

    # --------------------------------------------------------------- observe
    def batch_observe(self, batch_obs, batch_reward, batch_done, batch_reset) -> None:
        if not self.training:
            return
        done = np.asarray(batch_done, dtype=bool)
        reset = np.asarray(batch_reset, dtype=bool)
        b = done.shape[0]
        dev = self.device
        transition = Transition(
            obs=self._last_obs,
            action=self._last_action,
            reward=torch.from_numpy(np.asarray(batch_reward, dtype=np.float32)).to(dev),
            next_obs=to_device_like_jax(np.asarray(batch_obs), dev) if self.buffer.wants_next_obs else None,
            terminated=torch.from_numpy(done).to(dev),
            done=torch.from_numpy(done | reset).to(dev),
        )
        if self.replay_state is None:
            if getattr(self.buffer, "num_lanes", 1) != b:
                self.buffer = self.buffer.configure_lanes(b)
            self.replay_state = self.buffer.init(Transition(
                obs=transition.obs[0], action=transition.action[0], reward=transition.reward[0],
                next_obs=None if transition.next_obs is None else transition.next_obs[0],
                terminated=transition.terminated[0], done=transition.done[0],
            ))
        self.replay_state = self.buffer.add(self.replay_state, transition)

        prev_t = self.t
        self.t += b
        if (
            self.core.target_update_method == "hard"
            and prev_t // self.target_update_interval != self.t // self.target_update_interval
        ):
            self.core.sync_target(self.train_state)
        if self.t >= self.replay_start_size:
            n_updates = (self.t // self.update_interval - prev_t // self.update_interval) * self.n_times_update
            if self.update_burst and n_updates > 1:
                losses = [self._update_once() for _ in range(n_updates)]
                self._loss_stats.append(torch.stack(losses).mean())
            else:
                for _ in range(n_updates):
                    self._loss_stats.append(self._update_once())

    def _update_once(self) -> torch.Tensor:
        """Sample, update, feed the priorities back; returns the critic's
        loss (the JAX shell's ``fused_update``, op by op)."""
        out = self.buffer.sample(self.replay_state, self.draws, self.minibatch_size)
        batch = out[0] if isinstance(out, tuple) else out
        _, aux = self.core.update(self.train_state, batch, self.draws)
        self.buffer.update_priorities(self.replay_state, batch.indices, aux["errors"])
        return aux["loss"]

    # ----------------------------------------------------------------- stats
    def get_statistics(self):
        return [
            ("average_critic_loss", self._loss_stats.mean()),
            ("n_updates", self.train_state.n_updates if self.train_state is not None else 0),
        ]


class DDPG(ActorCriticShellAgent):
    """The reference's DDPG agent (``ddpg.py:363-417``)."""

    def __init__(
        self,
        policy: nn.Module,
        q_func: nn.Module,
        policy_optimizer,
        q_optimizer,
        replay_buffer,
        gamma: float,
        explorer,
        *,
        action_space,
        gpu=None,
        replay_start_size: int = 10000,
        minibatch_size: int = 100,
        update_interval: int = 1,
        target_update_interval: int = 1,
        phi: Callable = _identity,
        target_update_method: str = "soft",
        soft_update_tau: float = 5e-3,
        n_times_update: int = 1,
        update_burst: bool = False,
        burnin_action_func: Optional[Callable] = None,
        burnin_steps: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu
        core = DDPGCore(
            policy=policy,
            q_func=q_func,
            policy_optimizer=policy_optimizer,
            q_optimizer=q_optimizer,
            explorer=explorer,
            gamma=gamma,
            target_update_method=target_update_method,
            soft_update_tau=soft_update_tau,
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
            target_update_interval=target_update_interval,
            n_times_update=n_times_update,
            update_burst=update_burst,
            seed=seed,
            device=device,
            draws=draws,
        )
