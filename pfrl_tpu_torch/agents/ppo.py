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

:class:`OnPolicyShellAgent` is the host shell that PPO, A2C and TRPO share
(``ppo.py:253-386``): it fills a ``[T, B, ...]`` rollout on the device, one
row per observe, and updates when the block is full; :class:`PPO` is its PPO
(``ppo.py:389-430``).
"""

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import resolve_device, use_full_fp32
from pfrl_tpu_torch.agent import AttributeSavingMixin, BatchAgent
from pfrl_tpu_torch.agents.ddpg import _identity, fresh_module
from pfrl_tpu_torch.ops.returns import gae_advantages
from pfrl_tpu_torch.optimizers.clip_by_global_norm import ClipByGlobalNorm
from pfrl_tpu_torch.parallel.mesh import local_rows
from pfrl_tpu_torch.utils.batch_states import to_device_like_jax
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype
from pfrl_tpu_torch.utils.stats import RunningStats


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
    weights (``model.reset_parameters(generator)``).

    Under a mesh (``mesh`` set by ``parallel.data_parallel_core``) each
    minibatch's rows are split over the ranks: each rank's loss is the
    mean over its share, and the optimizer averages the gradients."""

    #: The on-policy runner may split this core's minibatches over a mesh.
    splits_over_mesh = True
    mesh = None

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
                if self.mesh is not None:
                    idx = idx[local_rows(self.mesh, mb)]
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


class OnPolicyShellAgent(AttributeSavingMixin, BatchAgent):
    """Host shell of the on-policy cores (``ppo.py:253-386``).

    The first act builds the state (weights from a CPU generator seeded with
    ``seed``) unless a state was set or loaded before it; ``draws`` is the
    draw source of the acts and the updates (default: a generator on
    ``device`` seeded with ``seed``). The first observe allocates the
    rollout, ``T = update_interval // B`` rows of ``B`` envs, and raises
    unless ``B`` divides ``update_interval``; each observe writes one row
    (``done | reset`` as done, ``done`` as terminated) and the full block
    goes to ``core.update``. Every training act appends the mean value to
    the statistics and every update its loss and, where the core reports
    it, its entropy: each a ``float`` that waits for the card, as in JAX.
    On the card it runs float32 without TF32.
    """

    saved_attributes = ("train_state",)

    def __init__(self, core, update_interval: int = 2048, seed: int = 0, device=None, draws=None):
        self.core = core
        self.update_interval = update_interval
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.draws = draws if draws is not None else Draws(torch.Generator(device=self.device).manual_seed(seed))
        self.t = 0
        self.train_state = None
        self._rollout: Optional[Rollout] = None
        self._ptr = 0
        self._T = None
        self._last_obs = None
        self._last_action = None
        self._last_aux = None
        self._loss_stats = RunningStats(100)
        self._value_stats = RunningStats(1000)
        self._entropy_stats = RunningStats(1000)

    # ------------------------------------------------------------------- act
    def batch_act(self, batch_obs) -> np.ndarray:
        obs = to_device_like_jax(np.asarray(batch_obs), self.device)
        if self.train_state is None:
            self.train_state = self.core.init(torch.Generator().manual_seed(self.seed), obs)
            self._restore_pending()
        action, aux = self.core.act_with_aux(self.train_state, self.draws, obs, self.training)
        if self.training:
            self._last_obs = obs
            self._last_action = action
            self._last_aux = aux
            self._value_stats.append(torch.mean(aux["value"]))
        return action.cpu().numpy()

    # --------------------------------------------------------------- observe
    def _ensure_rollout(self, b: int) -> None:
        if self._rollout is not None:
            return
        if self.update_interval % b:
            raise ValueError(f"update_interval {self.update_interval} must divide by num_envs {b}")
        self._T = T = self.update_interval // b

        def alloc(x: torch.Tensor) -> torch.Tensor:
            return torch.zeros((T,) + tuple(x.shape), dtype=x.dtype, device=x.device)

        flags = torch.zeros(b, dtype=torch.bool, device=self.device)
        self._rollout = Rollout(
            obs=alloc(self._last_obs),
            action=alloc(self._last_action),
            log_prob=alloc(self._last_aux["log_prob"]),
            value=alloc(self._last_aux["value"]),
            reward=alloc(torch.zeros(b, dtype=torch.float32, device=self.device)),
            terminated=alloc(flags),
            done=alloc(flags),
            next_obs=alloc(self._last_obs),
        )

    def batch_observe(self, batch_obs, batch_reward, batch_done, batch_reset) -> None:
        if not self.training:
            return
        next_obs = to_device_like_jax(np.asarray(batch_obs), self.device)
        b = next_obs.shape[0]
        self._ensure_rollout(b)
        done = np.asarray(batch_done, dtype=bool)
        reset = np.asarray(batch_reset, dtype=bool)
        rollout, row, dev = self._rollout, self._ptr, self.device
        rollout.obs[row] = self._last_obs
        rollout.action[row] = self._last_action
        rollout.log_prob[row] = self._last_aux["log_prob"]
        rollout.value[row] = self._last_aux["value"]
        rollout.reward[row] = torch.from_numpy(np.asarray(batch_reward, dtype=np.float32)).to(dev)
        rollout.terminated[row] = torch.from_numpy(done).to(dev)
        rollout.done[row] = torch.from_numpy(done | reset).to(dev)
        rollout.next_obs[row] = next_obs
        self._ptr += 1
        self.t += b
        if self._ptr == self._T:
            self._update_once()

    def _update_once(self) -> None:
        """One update over the full rollout block."""
        _, aux = self.core.update(self.train_state, self.draws, self._rollout)
        self._ptr = 0
        self._loss_stats.append(aux["loss"])
        if "entropy" in aux:
            self._entropy_stats.append(aux["entropy"])

    # ----------------------------------------------------------------- stats
    def get_statistics(self):
        return [
            ("average_value", self._value_stats.mean()),
            ("average_entropy", self._entropy_stats.mean()),
            ("average_loss", self._loss_stats.mean()),
            ("n_updates", self.train_state.n_updates if self.train_state is not None else 0),
        ]


class PPO(OnPolicyShellAgent):
    """The reference's PPO agent (``ppo.py:389-430``)."""

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        *,
        gpu=None,
        gamma: float = 0.99,
        lambd: float = 0.95,
        phi: Callable = _identity,
        value_func_coef: float = 1.0,
        entropy_coef: float = 0.01,
        update_interval: int = 2048,
        minibatch_size: int = 64,
        epochs: int = 10,
        clip_eps: float = 0.2,
        clip_eps_vf: Optional[float] = None,
        standardize_advantages: bool = True,
        max_grad_norm: Optional[float] = None,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu
        core = PPOCore(
            model=model,
            optimizer=optimizer,
            gamma=gamma,
            lambd=lambd,
            clip_eps=clip_eps,
            clip_eps_vf=clip_eps_vf,
            entropy_coef=entropy_coef,
            value_func_coef=value_func_coef,
            epochs=epochs,
            minibatch_size=minibatch_size,
            standardize_advantages=standardize_advantages,
            max_grad_norm=max_grad_norm,
            phi=phi,
            compute_dtype=compute_dtype,
        )
        super().__init__(core, update_interval=update_interval, seed=seed, device=device, draws=draws)
