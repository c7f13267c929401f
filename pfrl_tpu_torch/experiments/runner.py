"""Off-policy training loop (counterpart of ``pfrl_tpu/experiments/runner.py``).

The JAX runner compiles ``act -> env.step -> replay.add -> gated updates ->
target sync`` into one program iterated with ``lax.scan``. Here a scan step
is :meth:`OffPolicyRunner._one_step` and ``run_chunk`` is a Python loop over
it. The step counter ``t`` lives on the host (it gates updates and target
syncs, so the host needs it anyway); everything else stays on the device and
no step waits for the device.

:class:`RunnerState` is updated **in place**, the replay ring above all.

Ported: the single-device branches, for discrete and continuous actions
(the example action that sizes the ring comes from the env's action
space). Buffers with priority feedback (``iid_samples`` false) take the
sequential sample -> update -> feedback loop; uniform buffers take the
presample branch, one id draw per scan step and a row gather per update;
episodic buffers (``sample_episodes``) take the window loop, sample ->
``core.update_episodic`` -> per-window priority feedback where the buffer
has ``update_episode_priorities`` and the core ``reports_window_errors``.
A recurrent core (``select_action_recurrent``) acts from the carry in
``act_state``; the carries before and after the step go into the
transition's ``extras`` (where the buffer ``stores_carries``), taken
before the carry's rows of ended episodes are reset. A core that acts
with extras (``select_action_with_extras``, ACER's behaviour
distribution) stores them with each transition; ``init`` sizes the
buffer's extras from one call of it. A core without ``sync_target`` (ACER)
is never synced. :class:`EvalLoop` is the counterpart of ``JaxEvalLoop``.

**Spans** (``utils/profiling.py``; recorded only under
``profiling.recording()``): ``init``; per scan step ``step`` around
``act``, ``env``, ``add``, ``returns``, each update's ``sample`` (``draw``
and ``gather`` inside a prioritized buffer's; the uniform ring's one id
draw per scan step, then each update's ``gather``), ``update`` and
``feedback`` (counters ``updates`` and ``feedbacks``), and ``sync``.

**A mesh** (``mesh=``, :func:`pfrl_tpu_torch.parallel.mesh.make_mesh`: one rank
per process) changes the layout, not the result, as in the JAX package,
for every core and buffer. Each rank steps, acts for and stores only its
lanes (:func:`~pfrl_tpu_torch.parallel.mesh.local_rows` of ``num_envs``),
holds those lanes' act-time carry (reset per local lane) and keeps those
lanes' rows of whichever buffer it holds, a ring's slots or an episodic
buffer's rows with their stored carries or ACER's extras
(``parallel/lane_sharding.py``): the buffer's bytes divide by the ranks.
Every draw is global: every rank draws each draw whole from an equally
seeded source, takes its lanes' part of the per-lane ones and its rows'
part of an update's per-row ones, and uses a noisy layer's per-parameter
noise whole. The replicated state (weights, optimizer state, cursor, PER's
trees and beta, an episodic buffer's tables, the returns ring) is
replicated exactly: the sampled ids or rows are global, the batch is
all-gathered from its rows' owners, each rank differentiates its ``B /
size`` share and the gradients are all-reduced before the identical
optimizer step (``parallel/data_parallel.py``: the mean, or the sum for a
``"sum"`` core and for a masked loss over the whole batch's count of valid
steps); per-row or per-window errors are all-gathered before the
priorities are updated, so the prefix-sample kernel runs on every rank
over the replicated tree. The finished lanes' rewards and flags are
all-gathered every step, so the returns ring and the metrics are the whole
run's. Over one rank the run equals the run without a mesh to the bit.
"""

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from pfrl_tpu_torch._device import check_same_device, resolve_device, use_full_fp32
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.parallel.data_parallel import data_parallel_core, data_parallel_update, summed_metrics
from pfrl_tpu_torch.parallel.lane_sharding import LaneDraws, LaneShardedBuffer, LaneShardedEpisodicBuffer
from pfrl_tpu_torch.parallel.mesh import all_gather_rows, local_rows, replicate
from pfrl_tpu_torch.replay.transition import Transition
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.profiling import count, span
from pfrl_tpu_torch.utils.recurrent import tree_map


@dataclasses.dataclass
class RunnerConfig:
    """Cadences in env *transitions*: with L lanes each scan step advances
    t by L, and ``L * n_times_update / update_interval`` gradient steps run
    per scan step once ``t >= replay_start_size``."""

    num_envs: int = 128
    replay_start_size: int = 1000
    update_interval: int = 1
    n_times_update: int = 1
    target_update_interval: int = 1000
    minibatch_size: int = 32

    @property
    def updates_per_step(self) -> int:
        per = self.num_envs * self.n_times_update / self.update_interval
        if per != int(per) or per < 1:
            raise ValueError(
                f"num_envs*n_times_update ({self.num_envs}*{self.n_times_update}) "
                f"must be a multiple of update_interval ({self.update_interval})"
            )
        return int(per)


@dataclasses.dataclass
class RunnerState:
    env_states: Any
    obs: torch.Tensor
    train_state: Any
    replay_state: Any
    draws: Any                     # the JAX state's rng
    t: int                         # env transitions so far
    episode_return: torch.Tensor   # [L] running returns
    recent_returns: torch.Tensor   # [window] ring of completed returns
    recent_count: torch.Tensor     # int32 0-d
    act_state: Any = ()            # a recurrent core's carry


class OffPolicyRunner:
    """DQN-family and actor-critic off-policy training on one device.

    Draws per scan step, in order: the core's act noise (and its burn-in
    actions while they last), the env's resets, the ids of all of the
    step's minibatches (uniform ring) or each update's sample (prioritized,
    episodic), then each update's own noise (and taus)."""

    def __init__(
        self,
        env,
        core,
        buffer,
        config: RunnerConfig,
        return_window: int = 256,
        device=None,
        mesh=None,
    ):
        self.device = check_same_device(
            runner=resolve_device(device), env=env.device, buffer=buffer.device
        )
        if buffer.num_lanes != config.num_envs:
            raise ValueError("buffer num_lanes must equal runner num_envs")
        config.updates_per_step  # validates the cadence
        self.config = config
        self.return_window = return_window
        self.recurrent = hasattr(core, "select_action_recurrent")
        self.store_carries = self.recurrent and getattr(buffer, "stores_carries", False)
        self.acts_with_extras = not self.recurrent and hasattr(core, "select_action_with_extras")
        self.mesh = mesh
        lanes = config.num_envs
        self._dp_update = None
        if mesh is not None:
            mine = local_rows(mesh, config.num_envs)  # raises unless the lanes divide evenly
            lanes = mine.stop - mine.start
            if config.minibatch_size % mesh.size:
                raise ValueError(f"minibatch {config.minibatch_size} does not divide over {mesh.size} ranks")
            episodic = hasattr(buffer, "sample_episodes")
            buffer = (LaneShardedEpisodicBuffer if episodic else LaneShardedBuffer)(buffer, mesh)
            core = data_parallel_core(core, mesh)
            update = core.update_episodic if episodic else core.update
            self._dp_update = data_parallel_update(mesh, update, summed_metrics(core))
        self.env = VectorTorchEnv(env, lanes)
        self.core = core
        self.buffer = buffer
        if self.device.type == "cuda":
            use_full_fp32()

    # ----------------------------------------------------------------- init
    def init(self, seed: int, draws=None) -> RunnerState:
        """``draws`` replaces the default source, one ``torch.Generator`` on
        the device seeded with ``seed``. The weights are drawn from a CPU
        generator seeded with ``seed``."""
        with span("init"):
            if draws is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                draws = Draws(gen)
            env_states, obs = self.env.reset(self._lane_draws(draws))
            example_action = self._example_action()
            L = self.config.num_envs
            train_state = self.core.init(
                torch.Generator().manual_seed(seed), obs, torch.stack([example_action] * self.env.num_envs)
            )
            if self.mesh is not None:
                replicate(self.mesh, train_state)
            zeros = lambda dtype: torch.zeros((), dtype=dtype, device=self.device)  # noqa: E731
            act_state = self.core.init_act_state(self.env.num_envs, self.device) if self.recurrent else ()
            extras = None
            if self.store_carries:
                one = tree_map(lambda x: x[0], act_state)
                extras = {"carry": one, "next_carry": one}
            elif self.acts_with_extras:
                # The shapes of one call, from a draw source of its own: the
                # JAX runner takes them by ``eval_shape``, which draws nothing.
                own = Draws(torch.Generator(device=self.device).manual_seed(seed))
                _, ex = self.core.select_action_with_extras(train_state, own, obs, 0, True)
                extras = {k: torch.zeros_like(v[0]) for k, v in ex.items()}
            example = Transition(
                obs=obs[0],
                action=example_action,
                reward=zeros(torch.float32),
                next_obs=obs[0],
                terminated=zeros(torch.bool),
                done=zeros(torch.bool),
                extras=extras,
            )
            return RunnerState(
                env_states=env_states,
                obs=obs,
                train_state=train_state,
                replay_state=self.buffer.init(example),
                draws=draws,
                t=0,
                episode_return=torch.zeros(L, dtype=torch.float32, device=self.device),
                recent_returns=torch.zeros(self.return_window, dtype=torch.float32, device=self.device),
                recent_count=zeros(torch.int32),
                act_state=act_state,
            )

    def _lane_draws(self, draws):
        """The source of the act's and the env's draws: this rank's lanes'
        part of each under a mesh."""
        return draws if self.mesh is None else LaneDraws(draws, self.mesh)

    def _global_lanes(self, *xs):
        """Every lane's values of this rank's ``xs`` (all-gathered under a
        mesh)."""
        return xs if self.mesh is None else all_gather_rows(self.mesh, xs)

    def _update(self, train, batch, draws):
        """The core's update (``update_episodic`` over an episodic buffer),
        or under a mesh its data-parallel update."""
        if self._dp_update is not None:
            return self._dp_update(train, batch, draws)
        if hasattr(self.buffer, "sample_episodes"):
            return self.core.update_episodic(train, batch, draws)
        return self.core.update(train, batch, draws)

    def _example_action(self) -> torch.Tensor:
        """int32 0-d for a discrete action space, else float32 of its shape."""
        space = self.env.action_space
        if hasattr(space, "n"):
            return torch.zeros((), dtype=torch.int32, device=self.device)
        return torch.zeros(space.shape, dtype=torch.float32, device=self.device)

    # ----------------------------------------------------------------- step
    def _one_step(self, state: RunnerState) -> Dict[str, torch.Tensor]:
        cfg = self.config
        L = cfg.num_envs
        with span("step"):
            extras = None
            draws = self._lane_draws(state.draws)
            with span("act"):
                if self.recurrent:
                    actions, act_state = self.core.select_action_recurrent(
                        state.train_state, draws, state.obs, state.t, True, state.act_state)
                elif self.acts_with_extras:
                    actions, extras = self.core.select_action_with_extras(
                        state.train_state, draws, state.obs, state.t, True)
                else:
                    actions = self.core.select_action(state.train_state, draws, state.obs, state.t, True)
            with span("env"):
                env_states, vec = self.env.step(draws, state.env_states, actions)
            ts = vec.ts
            if self.recurrent:
                if self.store_carries:
                    # Before the reset at the episode boundary: the carry before
                    # the step seeds a window's online unroll, the one after it
                    # the target's.
                    extras = {"carry": state.act_state, "next_carry": act_state}
                state.act_state = self.core.reset_act_state(act_state, ts.done)
            with span("add"):
                self.buffer.add(
                    state.replay_state,
                    Transition(
                        obs=state.obs,
                        action=actions,
                        reward=ts.reward,
                        next_obs=ts.obs,
                        terminated=ts.terminated,
                        done=ts.done,
                        extras=extras,
                    ),
                )
            t_prev, t = state.t, state.t + L
            with span("returns"):
                reward, done = self._global_lanes(ts.reward, ts.done)
                n_finished = record_returns(state, reward, done, self.return_window)

            loss = self._maybe_update(state, t)

            # Target sync on interval crossing (in env transitions), for a core
            # that has a target.
            crossed = t // cfg.target_update_interval != t_prev // cfg.target_update_interval
            if crossed and hasattr(self.core, "sync_target"):
                with span("sync"):
                    self.core.sync_target(state.train_state)

            state.env_states = env_states
            state.obs = vec.obs
            state.t = t
            return {"reward_mean": torch.mean(reward), "loss": loss, "done_count": n_finished}

    def _maybe_update(self, state: RunnerState, t: int) -> torch.Tensor:
        """``updates_per_step`` gradient steps once ``t >= replay_start_size``;
        returns the last loss. The counters ``updates`` and ``feedbacks``
        count the gradient steps and priority feedbacks, whatever spans
        hold them."""
        cfg = self.config
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if t < cfg.replay_start_size:
            return loss
        draws, train, replay = state.draws, state.train_state, state.replay_state
        if hasattr(self.buffer, "sample_episodes"):
            feedback = hasattr(self.buffer, "update_episode_priorities") and getattr(
                self.core, "reports_window_errors", False)
            for _ in range(cfg.updates_per_step):
                with span("sample"):
                    batch = self.buffer.sample_episodes(replay, draws, cfg.minibatch_size)
                with span("update"):
                    _, aux = self._update(train, batch, draws)
                count("updates")
                if feedback:
                    with span("feedback"):
                        self.buffer.update_episode_priorities(replay, batch.rows, aux["errors"])
                    count("feedbacks")
            return aux["loss"]
        if self.buffer.iid_samples:
            # The ids of every minibatch of this scan step in one draw; each
            # update gathers only its own rows. Ids first, then each update's
            # noise, as the JAX runner splits its key.
            with span("sample"):
                all_ids = self.buffer.sample_indices(
                    replay, draws, cfg.updates_per_step * cfg.minibatch_size
                ).reshape(cfg.updates_per_step, cfg.minibatch_size)
            for ids in all_ids:
                with span("gather"):
                    batch = self.buffer.gather(replay, ids)
                with span("update"):
                    _, aux = self._update(train, batch, draws)
                count("updates")
            return aux["loss"]
        for _ in range(cfg.updates_per_step):
            with span("sample"):
                batch, _ = self.buffer.sample(replay, draws, cfg.minibatch_size)
            with span("update"):
                _, aux = self._update(train, batch, draws)
            count("updates")
            with span("feedback"):
                self.buffer.update_priorities(replay, batch.indices, aux["errors"])
            count("feedbacks")
        return aux["loss"]

    # ---------------------------------------------------------------- chunks
    def run_chunk(self, state: RunnerState, num_steps: int) -> Tuple[RunnerState, Dict[str, torch.Tensor]]:
        """Run ``num_steps`` scan steps (``num_steps * L`` transitions);
        metrics come back stacked, ``[num_steps]`` each, on the device."""
        steps = [self._one_step(state) for _ in range(num_steps)]
        metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        return state, metrics

    def recent_return_mean(self, state: RunnerState) -> float:
        return recent_return_mean(state, self.return_window)


def record_returns(state, reward: torch.Tensor, done: torch.Tensor, window: int) -> torch.Tensor:
    """Adds ``reward`` to each lane's running return and moves the returns of
    the lanes that finished, in lane order, into the ring of the last
    ``window`` finished episodes; unfinished lanes write into a spare last
    slot that is dropped. Updates ``state``'s ``episode_return``,
    ``recent_returns`` and ``recent_count`` (both runners' states have them)
    and returns the number of lanes that finished, int32 0-d, on the device."""
    lanes = reward.shape[0]
    ep_ret = state.episode_return + reward
    n_finished = torch.sum(done, dtype=torch.int32)
    lane_order = torch.argsort((~done).to(torch.int8), stable=True)
    pos = (state.recent_count + torch.arange(lanes, dtype=torch.int32, device=reward.device)) % window
    write_pos = torch.where(done[lane_order], pos, window)
    ring = torch.cat([state.recent_returns, state.recent_returns.new_zeros(1)])
    ring[write_pos] = ep_ret[lane_order]
    state.episode_return = torch.where(done, 0.0, ep_ret)
    state.recent_returns = ring[:window]
    state.recent_count = state.recent_count + n_finished
    return n_finished


def recent_return_mean(state, window: int) -> float:
    """Mean of the finished returns in the ring (NaN before the first); reads
    the device."""
    n = min(int(state.recent_count), window)
    if n == 0:
        return float("nan")
    return float(state.recent_returns[:n].mean())


class EvalLoop:
    """Evaluation over ``num_episodes`` lanes (counterpart of ``JaxEvalLoop``).

    Acts without the explorer (``training=False``) for ``max_steps`` steps
    and scores the first finished episode of each lane; a lane that never
    finished gives its partial return. A noisy model still draws noise. A
    recurrent core acts from a carry that starts at zero and whose rows are
    reset where an episode ends. A core that acts with extras acts through
    ``select_action`` here, as ``JaxEvalLoop`` does (ACER: the policy's
    mode).

    Under a mesh (``mesh=``) each rank evaluates its lanes' episodes, from
    its lanes' part of every per-lane draw, on the replicated weights, and
    the returns are all-gathered: every rank gets the returns the loop
    without a mesh gives.
    """

    def __init__(self, env, core, num_episodes: int, max_steps: int, device=None, mesh=None):
        self.device = check_same_device(runner=resolve_device(device), env=env.device)
        lanes = num_episodes
        if mesh is not None:
            mine = local_rows(mesh, num_episodes)  # raises unless the episodes divide evenly
            lanes = mine.stop - mine.start
        self.env = VectorTorchEnv(env, lanes)
        self.mesh = mesh
        self.core = core
        self.max_steps = max_steps
        if self.device.type == "cuda":
            use_full_fp32()

    @torch.no_grad()
    def evaluate(self, train_state, draws) -> np.ndarray:
        """float32 ``[num_episodes]`` returns, on the host. Each step draws
        the act noise first, then the env's resets."""
        L = self.env.num_envs
        if self.mesh is not None:
            draws = LaneDraws(draws, self.mesh)
        env_states, obs = self.env.reset(draws)
        ep_ret = torch.zeros(L, dtype=torch.float32, device=self.device)
        final_ret = torch.zeros_like(ep_ret)
        finished = torch.zeros(L, dtype=torch.bool, device=self.device)
        recurrent = hasattr(self.core, "select_action_recurrent")
        carry = self.core.init_act_state(L, self.device) if recurrent else ()
        for _ in range(self.max_steps):
            if recurrent:
                actions, carry = self.core.select_action_recurrent(train_state, draws, obs, 0, False, carry)
            else:
                actions = self.core.select_action(train_state, draws, obs, 0, False)
            env_states, vec = self.env.step(draws, env_states, actions)
            if recurrent:
                carry = self.core.reset_act_state(carry, vec.ts.done)
            ep_ret = ep_ret + vec.ts.reward * (~finished)
            newly = vec.ts.done & ~finished
            final_ret = torch.where(newly, ep_ret, final_ret)
            finished = finished | vec.ts.done
            obs = vec.obs
        returns = torch.where(finished, final_ret, ep_ret)
        if self.mesh is not None:
            returns = all_gather_rows(self.mesh, returns)
        return returns.cpu().numpy()
