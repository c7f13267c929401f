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
shell's draw source (``draws``), where the JAX shell splits a key.

Its actor-learner half (``dqn.py:402-669``,
:meth:`DQN.setup_actor_learner_training`): actor threads act through one
:class:`~pfrl_tpu_torch.parallel.inference_server.BatchedInferenceServer`
and queue their transitions, a poller thread adds them to the ring one
whole row at a time, and a learner thread updates flat out. Three things
differ from the JAX shell, each for the port's in-place state:

- the actors act from a **copy** of the online network. ``update`` changes
  the network in place, op by op, where JAX swaps a pointer to an immutable
  state; so the learner copies the online weights into the acting network
  under a lock after every ``actor_update_interval`` updates (a
  publication), and after every update before the first publication (when
  the JAX actors read the live state). An act launches its forward under
  the same lock, and everything runs on one CUDA stream, so an act sees
  whole weights from before a publication or from after it (ROADMAP C51);
- the server draws from a source of its own, used by the server thread
  only, where JAX seeds each act with ``PRNGKey(seed)`` from the server's
  batch count; the learner draws from the shell's ``draws``;
- a poller's, learner's or server's failure is kept in
  ``actor_learner_errors`` beside the exception event, so that a run can
  raise it after the join.
"""

import collections
import contextlib
import copy
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import check_same_device, resolve_device, use_full_fp32
from pfrl_tpu_torch.agent import AttributeSavingMixin, BatchAgent
from pfrl_tpu_torch.ops.value_loss import compute_weighted_value_loss
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch
from pfrl_tpu_torch.utils.batch_states import batch_states, first_leaf, map_structure, to_device_like_jax
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
        device = first_leaf(example_obs).device
        model.to(device)
        # Shape check; a noisy model draws noise for it from a source of its
        # own, as the JAX core's init does, never from the run's stream.
        noise = torch.Generator(device=device)
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


def _collate_obs(batch_obs):
    """Driver observations as one numpy batch (``dqn.py:60-77``): a numpy
    batch as it is, else :func:`batch_states` (structured observations leaf
    by leaf; arrays and ``LazyFrames`` stacked)."""
    if isinstance(batch_obs, np.ndarray):
        return batch_obs
    return batch_states(batch_obs)


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
        obs = to_device_like_jax(_collate_obs(batch_obs), self.device)
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
            next_obs=to_device_like_jax(_collate_obs(batch_obs), dev) if self.buffer.wants_next_obs else None,
            terminated=torch.from_numpy(done).to(dev),
            done=torch.from_numpy(done | reset).to(dev),
        )
        if self.replay_state is None:
            self._init_ring(transition, b)
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

    def _init_ring(self, transition: Transition, lanes: int) -> None:
        """The ring, configured to ``lanes`` lanes, from the first row of the
        first transition batch."""
        if getattr(self.buffer, "num_lanes", 1) != lanes:
            self.buffer = self.buffer.configure_lanes(lanes)
        self.replay_state = self.buffer.init(Transition(
            obs=map_structure(lambda x: x[0], transition.obs), action=transition.action[0],
            reward=transition.reward[0],
            next_obs=None if transition.next_obs is None else map_structure(lambda x: x[0], transition.next_obs),
            terminated=transition.terminated[0], done=transition.done[0],
        ))

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

    def save(self, dirname: str) -> None:
        # During actor-learner training an actor saves from its own thread:
        # the learner changes the state in place only under the ring's lock.
        with getattr(self, "_replay_lock", None) or contextlib.nullcontext():
            super().save(dirname)

    @property
    def cumulative_steps(self) -> int:
        """Env transitions observed, or received from the actors
        (``dqn.py:631``)."""
        counter = getattr(self, "_cumulative_steps_counter", None)
        return counter.value if counter is not None else self.t

    @property
    def optim_t(self) -> int:
        """Optimizer steps so far."""
        return self._optim_t

    # ======================================================== actor-learner
    def _can_start_replay(self) -> bool:
        """Enough transitions inserted to sample safely (``dqn.py:402-406``)."""
        margin = (self.buffer.num_steps + 1) * self.buffer.num_lanes
        return self._replay_inserted >= max(self.replay_start_size, margin, self.minibatch_size)

    def _publish(self) -> None:
        """The online weights into the actors' copy, under the acting lock."""
        with self._acting_lock:
            copy_param(self._acting.model, self.train_state.model)

    def _make_acting_copy(self) -> None:
        model = copy.deepcopy(self.train_state.model)
        model.requires_grad_(False)
        self._acting = DQNState(model=model, target_model=None, opt_state=None)

    def _actor_act_fn(self, seed: int, obs_batch, t: int, training: bool):
        """The server's batched act (``dqn.py:408-426``): the state built at
        the first call, then one forward of the acting copy at the server's
        ``t``, drawing from the server's own source. ``seed`` (the JAX
        server's key) is not needed."""
        obs = to_device_like_jax(obs_batch, self.device)
        with self._init_lock:
            if self.train_state is None:
                self._ensure_init(obs)
            if self._acting is None:
                self._make_acting_copy()
        with self._acting_lock:  # the launches only; the actions come down outside
            return self.core.select_action(self._acting, self._actor_draws, obs, t, training)

    def _rows_to_transition(self, rows) -> Transition:
        """One transition per actor as one ring row: single-lane actors'
        rows stacked, vector actors' ``[k, ...]`` rows concatenated, each
        field uploaded once. ``next_obs`` is not uploaded for a ring that
        reads it from the successor slot."""
        join = np.stack if self._lanes_per_actor == 1 else np.concatenate
        dev = self.device

        def field(key, dtype=None):
            return torch.from_numpy(join([np.asarray(r[key], dtype) for r in rows])).to(dev)

        def obs(key):
            return to_device_like_jax(_join_rows([r[key] for r in rows], join), dev)

        return Transition(
            obs=obs("obs"),
            action=field("action"),
            reward=field("reward", np.float32),
            next_obs=obs("next_obs") if self.buffer.wants_next_obs else None,
            terminated=field("terminated", bool),
            done=field("done", bool),
        )

    def _poller_loop(self, transition_queue, stop_event, exception_event, logger):
        """Drains the actors' transitions into the ring (``dqn.py:428-508``).
        The ring interleaves lanes (a lane per actor lane), so transitions
        wait in per-actor FIFOs and go in one whole row at a time, one
        transition per actor: each lane keeps its order for the n-step
        fold. The first add configures the ring to ``n_actors * K`` lanes.
        Stopping it stops the server."""
        n, k = self._n_actors, self._lanes_per_actor
        staging = [collections.deque() for _ in range(n)]
        try:
            while not stop_event.is_set() and not exception_event.is_set():
                try:
                    actor_id, data = transition_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                staging[actor_id].append(data)
                self._cumulative_steps_counter.increment(k)
                while True:  # everything already in flight
                    try:
                        actor_id, data = transition_queue.get_nowait()
                    except queue.Empty:
                        break
                    staging[actor_id].append(data)
                    self._cumulative_steps_counter.increment(k)
                while all(staging):
                    t0 = time.perf_counter()
                    transition = self._rows_to_transition([staging[i].popleft() for i in range(n)])
                    with self._replay_lock:
                        if self.replay_state is None:
                            self._init_ring(transition, n * k)
                        self.replay_state = self.buffer.add(self.replay_state, transition)
                        self._replay_inserted += n * k
                    self.add_spans.append((t0, time.perf_counter()))
        except Exception as e:
            logger.exception("Poller loop failed. Exiting")
            self.actor_learner_errors.append(e)
            exception_event.set()
        finally:
            self._inference.stop()

    def _learner_loop(self, stop_event, exception_event, n_updates, actor_update_interval, step_hooks,
                      optimizer_step_hooks, logger):
        """Updates decoupled from acting (``dqn.py:510-557``): an update
        under the ring's lock, a publication every ``actor_update_interval``
        updates (before the first, a refresh after every update), ``t =
        optim_t * update_interval`` for the hooks, a hard sync when ``t`` is
        a multiple of ``target_update_interval``; it stops itself after
        ``n_updates``."""
        try:
            update_counter = 0
            published = False
            while not stop_event.is_set():
                if (self.train_state is None or self.replay_state is None or self._acting is None
                        or not self._can_start_replay()):
                    time.sleep(5e-3)  # not a tight poll: the actors need the GIL
                    continue
                if n_updates is not None and self._optim_t >= n_updates:
                    stop_event.set()
                    break
                t0 = time.perf_counter()
                with self._replay_lock:
                    self._update_once()
                self.update_spans.append((t0, time.perf_counter()))
                update_counter += 1
                if update_counter % actor_update_interval == 0:
                    self.update_counter.increment()
                    self._publish()
                    published = True
                elif not published:
                    self._publish()  # the JAX actors read the live state until then
                effective_timestep = self._optim_t * self.update_interval
                self.t = effective_timestep
                for hook in optimizer_step_hooks:
                    hook(None, self, self._optim_t)
                for hook in step_hooks:
                    hook(None, self, effective_timestep)
                if effective_timestep % self.target_update_interval == 0:
                    with self._replay_lock:
                        self.core.sync_target(self.train_state)
        except Exception as e:
            logger.exception("Learner loop failed. Exiting")
            self.actor_learner_errors.append(e)
            exception_event.set()

    def setup_actor_learner_training(
        self,
        n_actors: int,
        update_counter=None,
        n_updates: Optional[int] = None,
        actor_update_interval: int = 8,
        lanes_per_actor: int = 1,
        inference_slots: Optional[int] = None,
        step_hooks=(),
        optimizer_step_hooks=(),
        logger=None,
        actor_draws=None,
    ):
        """Returns ``(make_actor, learner, poller, exception_event)``
        (``dqn.py:559-667``): start ``poller`` and ``learner``, drive the
        actors of ``make_actor(i)`` (``experiments.train_agent_async(...,
        make_agent=make_actor, stop_event=learner.stop_event)``), then stop
        and join the learner, then the poller, which stops the server.

        With ``lanes_per_actor`` K > 1 each actor is a
        :class:`~.state_q_function_actor.VectorStateQFunctionActor` of K
        lanes, and the ring gets ``n_actors * K``. ``inference_slots`` is
        the server's batch width (default: every lane). ``actor_draws`` is
        the server's draw source (default: a generator on the device
        seeded with ``seed + 1``)."""
        from pfrl_tpu_torch.agents.state_q_function_actor import StateQFunctionActor, VectorStateQFunctionActor
        from pfrl_tpu_torch.parallel.inference_server import BatchedInferenceServer
        from pfrl_tpu_torch.utils.stoppable_thread import Counter, StoppableThread

        logger = logger or logging.getLogger(__name__)
        self._n_actors = n_actors
        self._lanes_per_actor = lanes_per_actor
        self.update_counter = update_counter if update_counter is not None else Counter()
        self._cumulative_steps_counter = Counter()
        self._replay_inserted = 0
        self._optim_t = 0
        self._replay_lock = threading.Lock()
        self._init_lock = threading.Lock()
        self._acting_lock = threading.Lock()
        self._actor_draws = actor_draws if actor_draws is not None else Draws(
            torch.Generator(device=self.device).manual_seed(self.seed + 1))
        self._acting = None
        if self.train_state is not None:
            self._make_acting_copy()
        self.actor_learner_errors = []
        # Host timings, ``(start, end)`` on ``time.perf_counter``'s clock.
        self.add_spans, self.update_spans = [], []

        self._inference = BatchedInferenceServer(
            act_fn=self._actor_act_fn,
            n_slots=inference_slots or n_actors * lanes_per_actor,
            t_fn=lambda: self._cumulative_steps_counter.value,
        )
        self._inference.start()
        transition_queue: "queue.Queue" = queue.Queue()
        exception_event = threading.Event()

        def make_actor(i: int) -> StateQFunctionActor:
            if lanes_per_actor > 1:
                return VectorStateQFunctionActor(self._inference, transition_queue, i, lanes_per_actor,
                                                 learner_agent=self, logger=logger)
            return StateQFunctionActor(self._inference, transition_queue, i, learner_agent=self, logger=logger)

        poller_stop = threading.Event()
        poller = StoppableThread(stop_event=poller_stop, target=self._poller_loop, name="poller", kwargs=dict(
            transition_queue=transition_queue, stop_event=poller_stop, exception_event=exception_event,
            logger=logger))
        learner_stop = threading.Event()
        learner = StoppableThread(stop_event=learner_stop, target=self._learner_loop, name="learner", kwargs=dict(
            stop_event=learner_stop, exception_event=exception_event, n_updates=n_updates,
            actor_update_interval=actor_update_interval, step_hooks=list(step_hooks),
            optimizer_step_hooks=list(optimizer_step_hooks), logger=logger))
        return make_actor, learner, poller, exception_event


def _join_rows(parts, join):
    """``join`` (``np.stack`` or ``np.concatenate``) over the leaves of
    observations of one structure."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join_rows([p[k] for p in parts], join) for k in first}
    if isinstance(first, tuple):
        return tuple(_join_rows([p[i] for p in parts], join) for i in range(len(first)))
    return join([np.asarray(p) for p in parts])
