"""PPO, the clipped-surrogate policy optimization core (counterpart of
``pfrl_tpu/agents/ppo.py``: ``PPOState``, ``Rollout``, ``PPOCore``).

The model maps observations to ``(distribution, value)``, the value ``[B, 1]``
or ``[B]``. :class:`PPOState` holds the model and the optimizer's state, and
``update`` changes them **in place** (and returns the same state).

One update: V on every ``next_obs`` of the rollout, GAE over the ``[T, B]``
block (:mod:`pfrl_tpu_torch.ops.returns`), the advantages standardized over
the whole dataset with the population standard deviation (``jnp.std`` is
``ddof=0``; ``torch.std`` defaults to ``correction=1``), then ``epochs``
epochs, each of one ``draws.permutation(n)`` cut to ``n_mb * mb`` ids (the
tail beyond a whole number of minibatches is dropped, as ``perm[: n_mb *
mb]`` drops it) and one optimizer step per minibatch. Every gradient is
``torch.autograd.grad`` of the minibatch loss with respect to exactly the
model's parameters; no ``.grad`` is left behind. The metrics are averaged on
the device over all steps and never read on the host; the explained
variance is taken over the dataset, also with ``correction=0``.

``max_grad_norm`` chains optax's ``clip_by_global_norm`` before the
optimizer (:class:`~pfrl_tpu_torch.optimizers.ClipByGlobalNorm`).

Draws, in order: ``act_with_aux`` / ``select_action`` while training take
the distribution's sample; ``update`` takes one ``permutation(n)`` per epoch.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs the model's forward, and
so its backward, in that dtype over the float32 parameters
(:func:`~pfrl_tpu_torch.utils.precision.apply_cast`): ``(distribution,
value)`` comes back float32, so the log-probability ratios, GAE and the
losses stay float32.

Not ported yet: the host shells ``OnPolicyShellAgent`` and ``PPO``.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.agents.ddpg import _identity, fresh_module
from pfrl_tpu_torch.ops.returns import gae_advantages
from pfrl_tpu_torch.optimizers.clip_by_global_norm import ClipByGlobalNorm
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype


@dataclasses.dataclass
class PPOState:
    model: nn.Module  # the JAX state's params
    opt_state: Any    # whatever the optimizer's ``init`` returns
    n_updates: int = 0


@dataclasses.dataclass
class Rollout:
    """A time-major on-policy rollout, ``[T, B, ...]`` each: ``obs`` the
    agent acted on, ``next_obs`` the true next observation (pre-reset).
    A recurrent core's rollout also has ``carry``, the carry before acting
    at each step, and ``next_value``, V(s_{t+1}) with the carry after it."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor
    carry: Any = None
    next_value: Optional[torch.Tensor] = None


def flat(x: torch.Tensor) -> torch.Tensor:
    """``[T, B, ...]`` -> ``[T * B, ...]``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def standardize(x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / (population std + 1e-8)``, as ``jnp.std``'s ``ddof=0``."""
    return (x - torch.mean(x)) / (torch.std(x, correction=0) + 1e-8)


class PPOCore:
    """``model`` is a template: ``init`` copies it and draws the copy's
    weights (``model.reset_parameters(generator)``)."""

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        gamma: float = 0.99,
        lambd: float = 0.95,
        clip_eps: float = 0.2,
        clip_eps_vf: Optional[float] = None,
        entropy_coef: float = 0.01,
        value_func_coef: float = 1.0,
        epochs: int = 8,
        minibatch_size: int = 64,
        standardize_advantages: bool = True,
        max_grad_norm: Optional[float] = None,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.model = model
        self.optimizer = optimizer if max_grad_norm is None else ClipByGlobalNorm(max_grad_norm, optimizer)
        self.gamma = gamma
        self.lambd = lambd
        self.clip_eps = clip_eps
        self.clip_eps_vf = clip_eps_vf
        self.entropy_coef = entropy_coef
        self.value_func_coef = value_func_coef
        self.epochs = epochs
        self.minibatch_size = minibatch_size
        self.standardize_advantages = standardize_advantages
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> PPOState:
        """``generator`` (on the CPU) draws the weights; ``example_obs`` is a
        batched observation on the target device."""
        model = fresh_module(self.model, generator, example_obs.device)
        with torch.no_grad():  # shape check
            self.forward(model, example_obs)
        return self.state_from_model(model)

    def state_from_model(self, model: nn.Module) -> PPOState:
        return PPOState(model=model, opt_state=self.optimizer.init(list(model.parameters())))

    # ------------------------------------------------------------------- act
    def forward(self, model: nn.Module, obs: torch.Tensor):
        """``(distribution, value [B])``."""
        dist, value = apply_cast(model, self.compute_dtype, self.phi(obs))
        return dist, value[..., 0] if value.dim() > 1 else value

    @torch.no_grad()
    def select_action(self, state: PPOState, draws, obs, t: int, training: bool):
        dist, _ = self.forward(state.model, obs)
        return dist.sample(draws) if training else dist.mode()

    @torch.no_grad()
    def act_with_aux(self, state: PPOState, draws, obs, training: bool = True):
        dist, value = self.forward(state.model, obs)
        action = dist.sample(draws) if training else dist.mode()
        return action, {"log_prob": dist.log_prob(action), "value": value}

    # ---------------------------------------------------------------- update
    def next_values(self, model: nn.Module, rollout: Rollout) -> torch.Tensor:
        """V on every ``next_obs``, ``[T, B]``."""
        return self.forward(model, flat(rollout.next_obs))[1].reshape(rollout.reward.shape)

    @torch.no_grad()
    def _dataset_from_rollout(self, model: nn.Module, rollout: Rollout):
        advs, v_targets = gae_advantages(
            rollout.reward, rollout.value, self.next_values(model, rollout),
            rollout.terminated, rollout.done, self.gamma, self.lambd,
        )
        return tuple(flat(x) for x in (
            rollout.obs, rollout.action, rollout.log_prob, rollout.value, advs, v_targets
        ))

    def _minibatch_loss(self, model, obs, action, old_lp, old_v, adv, v_target):
        dist, value = self.forward(model, obs)
        return self.losses(dist.log_prob(action), dist.entropy(), value, old_lp, old_v, adv, v_target)

    def losses(self, log_prob, entropy, value, old_lp, old_v, adv, v_target):
        """The clipped surrogate, the (clipped) value loss and the entropy
        bonus, each a mean over the minibatch: ``(loss, (policy_loss,
        value_loss, entropy))``."""
        ratio = torch.exp(log_prob - old_lp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - self.clip_eps, 1 + self.clip_eps) * adv
        policy_loss = -torch.mean(torch.minimum(surr1, surr2))
        if self.clip_eps_vf is None:
            value_loss = torch.mean((value - v_target) ** 2)
        else:
            clipped_v = old_v + torch.clamp(value - old_v, -self.clip_eps_vf, self.clip_eps_vf)
            value_loss = torch.mean(torch.maximum((value - v_target) ** 2, (clipped_v - v_target) ** 2))
        entropy = torch.mean(entropy)
        loss = policy_loss + self.value_func_coef * value_loss - self.entropy_coef * entropy
        return loss, (policy_loss, value_loss, entropy)

    def minibatch_shape(self, n: int):
        """``(n_mb, mb)``: whole minibatches in a dataset of ``n``."""
        return max(1, n // self.minibatch_size), (self.minibatch_size if n >= self.minibatch_size else n)

    def update(self, state: PPOState, draws, rollout: Rollout):
        obs, action, old_lp, old_v, adv, v_target = self._dataset_from_rollout(state.model, rollout)
        n = adv.shape[0]
        if self.standardize_advantages:
            adv = standardize(adv)
        n_mb, mb = self.minibatch_shape(n)
        params = list(state.model.parameters())
        metrics = []
        for _ in range(self.epochs):
            ids = draws.permutation(n)[: n_mb * mb].reshape(n_mb, mb)
            for idx in ids:
                loss, parts = self._minibatch_loss(
                    state.model, obs[idx], action[idx], old_lp[idx], old_v[idx], adv[idx], v_target[idx]
                )
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
            "explained_variance": explained_variance(v_target, old_v),
            "errors": torch.zeros(1, device=adv.device),  # the protocol's filler: no priorities on-policy
        }


def explained_variance(v_target: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``1 - Var(v_target - value) / (Var(v_target) + 1e-8)``, population variances."""
    var_y = torch.var(v_target, correction=0)
    return 1.0 - torch.var(v_target - value, correction=0) / (var_y + 1e-8)
