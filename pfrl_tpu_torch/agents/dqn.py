"""DQN algorithm core (counterpart of ``pfrl_tpu/agents/dqn.py::DQNCore``).

The JAX core is a set of pure functions over an immutable ``DQNState`` of
parameter trees. Here :class:`DQNState` holds the online and target
``nn.Module``s and the optimizer's state, and ``update`` and ``sync_target``
change them **in place** (and return the same state).

Where the JAX core threads a PRNG key (``rngs={"noise": rng}``), the port
hands the model a draw source (:mod:`pfrl_tpu_torch.utils.draws`): noisy
layers draw from it on every forward, models without noise ignore it.

Ported subclasses: ``double_dqn.DoubleDQNCore``,
``categorical_dqn.CategoricalDQNCore`` and ``CategoricalDoubleDQNCore``,
``al.ALCore``, ``pal.PALCore`` and ``DoublePALCore``, ``dpp.DPPCore``, and
``iqn.IQNCore`` and ``DoubleIQNCore``. The actor-critic cores for
continuous actions are in :mod:`.ddpg`, :mod:`.td3` and
:mod:`.soft_actor_critic`.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs every forward of the
network, and so its backward, in that dtype over the float32 parameters
(:func:`~pfrl_tpu_torch.utils.precision.apply_cast`): the observation
features and the parameters are cast at the apply boundary and the action
value comes back float32, so the targets, losses and the optimizer stay
float32. ``None`` is plain float32.

:class:`DQN` is the host shell (``dqn.py:222-400``): the reference's
``batch_act``/``batch_observe``/``save``/``load`` protocol around a core, a
replay buffer and a draw source, with the reference's ``ReplayUpdater``
gating as host counters. Each act and each update takes its draws from the
shell's draw source (``draws``), where the JAX shell splits a key. The
actor-learner half of the JAX shell (``dqn.py:402-669``) is not ported.
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import check_same_device, resolve_device, use_full_fp32
from pfrl_tpu_torch.agent import AttributeSavingMixin, BatchAgent
from pfrl_tpu_torch.ops.value_loss import compute_weighted_value_loss
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype
from pfrl_tpu_torch.utils.stats import RunningStats


@dataclasses.dataclass
class DQNState:
    model: nn.Module         # the JAX DQNState.params
    target_model: nn.Module  # ... .target_params
    opt_state: Any           # whatever the optimizer's ``init`` returns
    n_updates: int = 0


def _identity(x):
    return x


class DQNCore:
    """``model`` is a template: ``init`` copies it, re-initializes the copy
    from a generator (``model.reset_parameters(generator)``) and moves it to
    the observations' device."""

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        explorer,
        gamma: float = 0.99,
        clip_delta: bool = True,
        batch_accumulator: str = "mean",
        target_update_method: str = "hard",
        soft_update_tau: float = 1e-2,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        if target_update_method not in ("hard", "soft"):
            raise ValueError(f"target_update_method: {target_update_method!r}")
        self.model = model
        self.optimizer = optimizer
        self.explorer = explorer
        self.gamma = gamma
        self.clip_delta = clip_delta
        self.batch_accumulator = batch_accumulator
        self.target_update_method = target_update_method
        self.soft_update_tau = soft_update_tau
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> DQNState:
        """``generator`` (on the CPU) draws the initial weights;
        ``example_obs`` is a batched observation on the target device.
        ``example_action`` is what the runner hands every core; only the
        (state, action) Q-functions of the actor-critic cores need it."""
        model = copy.deepcopy(self.model)
        model.reset_parameters(generator)
        model.to(example_obs.device)
        # Shape check; a noisy model draws noise for it from a source of its
        # own, as the JAX core's init does, never from the run's stream.
        noise = torch.Generator(device=example_obs.device)
        noise.manual_seed(generator.initial_seed())
        with torch.no_grad():
            self.action_value(model, example_obs, Draws(noise))
        return self.state_from_model(model)

    def state_from_model(self, model: nn.Module) -> DQNState:
        """A fresh state around ``model``: target = a copy, zero moments."""
        target = copy.deepcopy(model)
        target.requires_grad_(False)
        return DQNState(
            model=model,
            target_model=target,
            opt_state=self.optimizer.init(list(model.parameters())),
        )

    # ------------------------------------------------------------------- act
    def action_value(self, model: nn.Module, obs: torch.Tensor, draws=None):
        return apply_cast(model, self.compute_dtype, self.phi(obs), draws)

    @torch.no_grad()
    def select_action(self, state: DQNState, draws, obs, t: int, training: bool):
        """The model's noise is drawn first, then the explorer's draws; a
        noisy model draws its noise when evaluating too, as in the JAX core."""
        av = self.action_value(state.model, obs, draws)
        greedy = av.greedy_actions()
        if not training:
            return greedy
        return self.explorer.select_action(draws, t, greedy, av)

    # ---------------------------------------------------------------- update
    @staticmethod
    def bootstrap(batch: TransitionBatch, next_q: torch.Tensor) -> torch.Tensor:
        return batch.reward + batch.discount * (
            1.0 - batch.is_terminal.to(torch.float32)
        ) * next_q

    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        """Forwards in the JAX core's order: online on obs, target on
        next_obs."""
        y = self.action_value(model, batch.obs, draws).evaluate_actions(batch.action)
        with torch.no_grad():
            max_next_q = self.action_value(target_model, batch.next_obs, draws).max()
            t = self.bootstrap(batch, max_next_q)
        return y, t

    def loss_and_errors(self, model, target_model, batch: TransitionBatch, draws=None):
        y, t = self.compute_y_and_t(model, target_model, batch, draws)
        loss = compute_weighted_value_loss(
            y,
            t,
            batch.weight,
            clip_delta=self.clip_delta,
            batch_accumulator=self.batch_accumulator,
        )
        return loss, (torch.abs(y - t).detach(), y.detach().mean())

    def update(self, state: DQNState, batch: TransitionBatch, draws=None):
        """One gradient step, in place. Returns ``(state, aux)``; ``aux``
        carries the per-sample ``errors`` for PER feedback. ``draws`` is the
        noise source of a noisy model."""
        params = list(state.model.parameters())
        loss, (errors, q_mean) = self.loss_and_errors(
            state.model, state.target_model, batch, draws
        )
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        return state, {"loss": loss.detach(), "average_q": q_mean, "errors": errors}

    def sync_target(self, state: DQNState) -> DQNState:
        """Hard copy, or Polyak ``(1 - tau) * target + tau * online``."""
        if self.target_update_method == "hard":
            copy_param(state.target_model, state.model)
        else:
            soft_copy_param(state.target_model, state.model, self.soft_update_tau)
        return state


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _collate_obs(batch_obs):
    """Driver observations as one numpy batch (``dqn.py:60-77``): a list of
    structured observations (tuples, lists or dicts of arrays) stacks leaf
    by leaf, anything else (arrays, ``LazyFrames``) through ``np.asarray``."""
    if isinstance(batch_obs, np.ndarray):
        return batch_obs
    if isinstance(batch_obs, (list, tuple)) and batch_obs and isinstance(batch_obs[0], (tuple, list, dict)):
        first = batch_obs[0]
        if isinstance(first, dict):
            return {k: _collate_obs([o[k] for o in batch_obs]) for k in first}
        return type(first)(_collate_obs([o[i] for o in batch_obs]) for i in range(len(first)))
    return np.asarray(batch_obs)


def to_device(obs, device: torch.device):
    """A numpy batch (or a structure of them) as tensors on ``device``: one
    copy per leaf."""
    return _tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device), obs)


class DQN(AttributeSavingMixin, BatchAgent):
    """Host shell with the reference's agent protocol (``dqn.py:222-400``).

    ``q_function`` is the core's model template: the first act builds the
    state (weights from a CPU generator seeded with ``seed``), unless a
    state was set or loaded before it. ``draws`` is the draw source of the
    acts and the updates (default: a generator on ``device`` seeded with
    ``seed``). ``replay_buffer`` lives on ``device`` (default: the CUDA
    device); the first observe reconfigures it to the batch's width.

    Each observe adds one transition per env; ``t`` counts them. The target
    syncs on each crossing of a multiple of ``target_update_interval``, and
    from ``replay_start_size`` on each crossing of a multiple of
    ``update_interval`` runs ``n_times_update`` updates, each of them a
    sample, an update and the priority feedback. ``float(loss)`` in the
    statistics waits for the card after every update, as in JAX. On the
    card it runs float32 without TF32 (``use_full_fp32``), as the runners do.
    """

    saved_attributes = ("train_state",)
    default_core = DQNCore

    def __init__(
        self,
        q_function: nn.Module,
        optimizer,
        replay_buffer,
        gamma: float,
        explorer,
        *,
        replay_start_size: int = 50000,
        minibatch_size: int = 32,
        update_interval: int = 1,
        target_update_interval: int = 10000,
        clip_delta: bool = True,
        phi: Callable = _identity,
        target_update_method: str = "hard",
        soft_update_tau: float = 1e-2,
        n_times_update: int = 1,
        batch_accumulator: str = "mean",
        seed: int = 0,
        core_cls: Optional[type] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        draws=None,
    ):
        core_cls = core_cls or type(self).default_core
        self.core = core_cls(
            model=q_function,
            optimizer=optimizer,
            explorer=explorer,
            gamma=gamma,
            clip_delta=clip_delta,
            batch_accumulator=batch_accumulator,
            target_update_method=target_update_method,
            soft_update_tau=soft_update_tau,
            phi=phi,
            compute_dtype=compute_dtype,
        )
        self.device = check_same_device(agent=resolve_device(device), replay_buffer=replay_buffer.device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.buffer = replay_buffer
        self.gamma = gamma
        self.replay_start_size = replay_start_size
        self.minibatch_size = minibatch_size
        self.update_interval = update_interval
        self.target_update_interval = target_update_interval
        self.n_times_update = n_times_update
        self.seed = seed
        self.draws = draws if draws is not None else Draws(torch.Generator(device=self.device).manual_seed(seed))

        self.t = 0  # env transitions observed
        self._optim_t = 0  # optimizer steps
        self.train_state: Optional[DQNState] = None
        self.replay_state = None
        self._last_obs = None
        self._last_action = None
        self._loss_stats = RunningStats(100)
        self._q_stats = RunningStats(1000)

    def _ensure_init(self, obs) -> None:
        if self.train_state is None:
            self.train_state = self.core.init(torch.Generator().manual_seed(self.seed), obs)
            self._restore_pending()

    # ------------------------------------------------------------------- act
    def batch_act(self, batch_obs) -> np.ndarray:
        obs = to_device(_collate_obs(batch_obs), self.device)
        self._ensure_init(obs)
        actions = self.core.select_action(self.train_state, self.draws, obs, self.t, self.training)
        if self.training:
            self._last_obs = obs  # already on the device for the observe
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
            # Read from the successor slot when the ring stores no next_obs.
            next_obs=to_device(_collate_obs(batch_obs), dev) if self.buffer.wants_next_obs else None,
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
        # The target syncs on each crossing of a multiple (dqn.py:520-521).
        if prev_t // self.target_update_interval != self.t // self.target_update_interval:
            self.core.sync_target(self.train_state)
        # ReplayUpdater gating (pfrl/replay_buffer.py:290-356).
        if self.t >= self.replay_start_size:
            n_triggers = self.t // self.update_interval - prev_t // self.update_interval
            for _ in range(n_triggers * self.n_times_update):
                self._update_once()

    def _update_once(self) -> None:
        """Sample, update, feed the priorities back (the JAX shell's fused
        update, op by op)."""
        out = self.buffer.sample(self.replay_state, self.draws, self.minibatch_size)
        batch = out[0] if isinstance(out, tuple) else out
        _, aux = self.core.update(self.train_state, batch, self.draws)
        self.buffer.update_priorities(self.replay_state, batch.indices, aux["errors"])
        self._optim_t += 1
        self._loss_stats.append(aux["loss"])
        self._q_stats.append(aux["average_q"])

    # ----------------------------------------------------------------- stats
    def get_statistics(self):
        return [
            ("average_q", self._q_stats.mean()),
            ("average_loss", self._loss_stats.mean()),
            ("n_updates", self.optim_t),
        ]

    @property
    def cumulative_steps(self) -> int:
        """Env transitions observed (``dqn.py:631``)."""
        return self.t

    @property
    def optim_t(self) -> int:
        """Optimizer steps so far."""
        return self._optim_t
