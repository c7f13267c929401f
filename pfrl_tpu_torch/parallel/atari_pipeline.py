"""Device-resident Atari actor-learner pipeline, process actors over shared
memory (counterpart of ``pfrl_tpu/parallel/atari_pipeline.py``; reference:
pfrl/agents/dqn.py:604-788 and pfrl/agents/state_q_function_actor.py:15-133).

The design is the JAX package's:

- **Actors are spawned processes** (:mod:`.env_worker`), so env stepping
  and the C++ frame ops never contend with the learner and the servers
  for the GIL. Data rides ``multiprocessing.shared_memory``; pipes carry
  only slot tokens (credit-based flow control over an R-slot ring). The
  actors import no torch and never touch the card.
- **Only the newest 84x84 uint8 plane crosses to the card per
  transition.** Frame stacking happens on the device: a per-lane rolling
  stack is updated inside the act stage.
- **The act stage is the replay writer**: it advances the stack, picks the
  actions and stages the plane and action into the plane ring. The
  committer writes only rewards and flags (a few bytes per lane) once the
  env step is done. Sample-time gathers rebuild 4-stacks from the
  lane-strided predecessor rows, masked at episode boundaries with
  repeat-oldest semantics (host FrameStack after a reset).
- **The learner runs bursts** of ``burst`` updates, paced at
  ``acted // update_interval``, and reads its loss once per burst.

Where the port differs, and why. The JAX package's state is immutable: an
act dispatch sees one whole ``train_state`` (the one before a burst or the
one after it) and a burst reads one snapshot of the ring while acting
stages rows ahead of the cursor. The port updates in place, so it keeps
those semantics by construction:

- **The acting copy.** ``DQNCore.update`` changes the online network in
  place, op by op, from the learner thread; an act issued between two of
  those ops would read torn weights. The servers act from a copy of the
  online network that the learner publishes under ``_state_lock`` at the
  end of each burst: an act sees the weights after one whole burst,
  never a part of one.
- **The burst's ids come from one snapshot.** If acting runs ahead during a
  long burst, staged rows wrap onto rows that the burst still samples (the
  window's margin is 2L rows). So a burst draws all ``n`` batches' ids from
  one read of ``commit_cursor`` and issues all their gathers under the lock
  at its start (64 x 32 x 8 planes x 7,056 B = 115.6 MB at full width);
  what acting and committing write afterwards lands after the gathers, in
  stream order on the card and in program order on the CPU.
- **Host syncs.** On one CUDA stream a server thread's ``actions.cpu()``
  waits for everything queued before it, a burst's updates included (in
  JAX the same holds for acts issued after a burst, which depend on its
  result). :meth:`timings` keeps the act round trips apart by whether a
  burst was in flight when the request came. The Python loop of a burst's
  updates holds the GIL against the server threads: that is measured, not
  fixed, here (a CUDA graph of the burst is the lever).
- **Draws.** The device functions take a draw source
  (:mod:`pfrl_tpu_torch.utils.draws`) in place of ``fold_in`` keys: one
  generator per server thread and one for the learner, seeded from
  ``seed``. A burst draws its ids first, then its updates' noise.

The four device functions are methods over explicit tensors, as the JAX
tests reach its jitted ones: :meth:`act_stage`, :meth:`commit`,
:meth:`sample` (:meth:`sample_ids` then :meth:`gather`) and
:meth:`learner_burst`.

**Checkpoints.** :meth:`save` writes ``train_state.pt`` while no burst is
in flight and under the state lock. :meth:`load` restores a
``train_state.pt`` (or a JAX ``train_state.msgpack``, converted) into the
live train state and **re-publishes the acting copy** in the same locked
section: without that the servers would go on acting from the old weights
until the next burst. A pipeline loaded before :meth:`start` keeps the
loaded state.
"""

import copy
import dataclasses
import logging
import os
import queue
import statistics
import threading
import time
from multiprocessing import connection as mp_connection
from multiprocessing import get_context
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from pfrl_tpu_torch import runtime
from pfrl_tpu_torch._device import resolve_device, use_full_fp32
from pfrl_tpu_torch.parallel.env_worker import _env_worker, _WorkerChannel
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils.copy_param import copy_param
from pfrl_tpu_torch.utils.draws import Draws


@dataclasses.dataclass
class PlaneRing:
    """Lane-interleaved replay ring of single frame planes on the device.

    Row ``r`` is lane ``r % L`` at vector step ``r // L``; the temporal
    successor of row ``r`` is ``r + L`` (the layout of ``replay/uniform.py``).
    ``commit_cursor`` counts fully committed rows, on the host (the
    committer advances it, the learner reads it, both under the lock);
    planes and actions ahead of it are staged by acts in flight.
    """

    planes: torch.Tensor      # [cap, H*W] uint8
    action: torch.Tensor      # [cap] int32
    reward: torch.Tensor      # [cap] float32
    terminated: torch.Tensor  # [cap] bool
    done: torch.Tensor        # [cap] bool
    commit_cursor: int = 0    # monotonic

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in
                   (self.planes, self.action, self.reward, self.terminated, self.done))


def _seeded_draws(seed: int, device: torch.device) -> Draws:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Draws(gen)


class AtariActorLearnerPipeline:
    """SEED-style actor-learner pipeline for host Atari-class envs.

    Args:
        core: a DQN-family core (``select_action`` / ``update`` /
            ``sync_target``, :mod:`pfrl_tpu_torch.agents.dqn`) whose ``phi``
            takes ``[B, 84, 84, 4]`` uint8.
        env_factory: spawn-picklable ``f(seed) -> env`` giving
            ``[84, 84, 1]`` uint8 planes (``envs/synthetic_ale.make_warped``:
            MaxAndSkip + WarpFrame without FrameStack; stacking runs on the
            device).
        n_workers, lanes_per_worker: actor processes x env lanes each.
        capacity: ring rows (single planes), rounded down to whole rows of
            ``L = n_workers * lanes_per_worker``.
        burst: updates per burst.
        device: where the ring, the stack and the networks live (default:
            the CUDA device; raises without one unless ``device="cpu"``).
    """

    def __init__(
        self,
        core,
        env_factory: Callable,
        n_workers: int = 2,
        lanes_per_worker: int = 64,
        capacity: int = 200_000,
        minibatch_size: int = 32,
        update_interval: int = 4,
        target_update_interval: int = 10_000,
        replay_start_size: int = 2_000,
        burst: int = 64,
        slot_ring: int = 4,
        frame_hw: Tuple[int, int] = (84, 84),
        frame_stack: int = 4,
        gamma: float = 0.99,
        seed: int = 0,
        logger=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.core = core
        self.env_factory = env_factory
        self.n_workers = n_workers
        self.K = lanes_per_worker
        self.L = n_workers * lanes_per_worker
        self.capacity = (capacity // self.L) * self.L
        self.minibatch_size = minibatch_size
        self.update_interval = update_interval
        self.target_update_interval = target_update_interval
        self.replay_start_size = max(replay_start_size, (slot_ring + frame_stack + 2) * self.L)
        self.burst = burst
        self.R = slot_ring
        self.hw = tuple(frame_hw)
        self.stack_k = frame_stack
        self.gamma = gamma
        self.seed = seed
        self.logger = logger or logging.getLogger(__name__)

        self.acted_steps = 0  # committed env transitions
        self.optim_t = 0      # optimizer steps done
        self.target_syncs = 0
        self._loss = float("nan")
        self._avg_q = float("nan")
        self.exception_event = threading.Event()
        self._stop = threading.Event()
        self._state_lock = threading.Lock()  # guards the ring, the stack and the acting copy
        self._learner_lock = threading.Lock()  # held over a burst's updates and its publication
        self._trans_q: "queue.Queue" = queue.Queue()
        self._req_qs = {}
        self._threads: List[threading.Thread] = []
        self._workers = []
        self._channels: List[_WorkerChannel] = []
        self._burst_since: Optional[float] = None  # perf_counter at the start of the burst in flight
        self._round_trips: List[Tuple[float, bool]] = []  # (seconds, a burst was in flight at the request)
        self._bursts: List[Tuple[float, float]] = []      # (gathers issued, whole burst) seconds
        self._commits: List[float] = []                   # seconds to copy a row's flags over and commit them
        self._spawned_at: Optional[float] = None
        self._first_request = {}
        self.train_state = None
        self._acting = None
        if self.device.type == "cuda":
            use_full_fp32()

    # ------------------------------------------------------------ device fns
    def act_stage(self, acting, stack, ring: PlaneRing, planes, prev_done, lane_off: int, row_base: int, t: int,
                  draws) -> torch.Tensor:
        """``planes [K, H*W]`` uint8, ``prev_done [K]`` bool: rolls lanes
        ``lane_off .. lane_off + K`` of ``stack`` (a reset lane's stack is
        its plane four times), picks their actions from ``acting`` (a core
        state) and stages planes and actions at ring rows ``row_base ..
        row_base + K`` (mod capacity). Updates ``stack`` and ``ring`` in
        place; returns the actions."""
        K, (H, W), k = planes.shape[0], self.hw, self.stack_k
        img = planes.reshape(K, H, W, 1)
        sub = stack[lane_off: lane_off + K]
        shifted = torch.cat([sub[..., 1:], img], dim=-1)
        new_sub = torch.where(prev_done[:, None, None, None], img.expand(K, H, W, k), shifted)
        sub.copy_(new_sub)
        actions = self.core.select_action(acting, draws, new_sub, t, True)
        # The capacity is whole rows of L and a worker's lanes lie inside
        # one row, so the K staged rows never wrap: a slice.
        r0 = row_base % self.capacity
        ring.planes[r0: r0 + K] = planes
        ring.action[r0: r0 + K] = actions.to(torch.int32)
        return actions

    def commit(self, ring: PlaneRing, rew, term, done) -> None:
        """Commits one full row of L transitions: flags, then the cursor."""
        r0 = ring.commit_cursor % self.capacity
        L = rew.shape[0]
        ring.reward[r0: r0 + L] = rew
        ring.terminated[r0: r0 + L] = term
        ring.done[r0: r0 + L] = done
        ring.commit_cursor += L

    def sample_ids(self, cursor: int, draws, n: int) -> torch.Tensor:
        """int32 ``[n]`` row ids, uniform over the window
        ``[max((k-1) L, cursor - cap + (R+k+1) L), cursor - L)``: every id
        has its k-1 predecessors and its successor committed, and none lies
        in the rows that acts in flight may be overwriting."""
        L, k = self.L, self.stack_k
        lo = max((k - 1) * L, cursor - self.capacity + (self.R + k + 1) * L)
        hi = cursor - L  # the successor plane must be written (staged is enough)
        return lo + draws.randint(max(hi - lo, 1), n)

    def gather(self, ring: PlaneRing, ids: torch.Tensor) -> TransitionBatch:
        """The transitions at ``ids``, their 4-stacks rebuilt from
        lane-strided rows with repeat-oldest masking at episode boundaries."""
        L, cap, k, (H, W) = self.L, self.capacity, self.stack_k, self.hw
        mb = ids.shape[0]
        idx = ids.to(torch.int64)
        # How far back can each sample reach without crossing an episode
        # boundary? m in [0, k-1].
        offsets = torch.arange(1, k, dtype=torch.int64, device=idx.device)
        back = idx[:, None] - offsets[None, :] * L
        blocked = torch.cumsum(ring.done[back % cap].to(torch.int32), dim=1) > 0  # [B, k-1]
        m = torch.sum(~blocked, dim=1)
        j = torch.arange(k - 1, -1, -1, dtype=torch.int64, device=idx.device)

        def stack_at(rows_newest, mm):
            # channel c holds offset j = k-1-c steps back, clamped to mm
            eff = torch.minimum(j[None, :], mm[:, None])
            pl = ring.planes[(rows_newest[:, None] - eff * L) % cap]  # [B, k, HW]
            return pl.reshape(mb, k, H, W).permute(0, 2, 3, 1)          # [B, H, W, k]

        slot = idx % cap
        done = ring.done[slot]
        obs = stack_at(idx, m)
        # next_obs: one step forward; a boundary at the id itself resets.
        m_next = torch.where(done, 0, torch.clamp_max(m + 1, k - 1))
        next_obs = stack_at(idx + L, m_next)
        # NOTE deviation, ported as the JAX package has it: a truncation
        # (done & ~terminated) is treated as terminal here. The worker resets
        # right after a truncated episode, so the successor plane in the
        # ring is the NEXT episode's reset frame: bootstrapping through it
        # would target an unrelated state's value. Killing the bootstrap is
        # the classic Atari-DQN behaviour (the reference's ALE path has no
        # ContinuingTimeLimit either); envs where truncation bootstrap
        # fidelity matters belong on the runners, which store true next
        # observations.
        return TransitionBatch(
            obs=obs,
            action=ring.action[slot],
            reward=ring.reward[slot],
            next_obs=next_obs,
            discount=torch.full((mb,), self.gamma, dtype=torch.float32, device=idx.device),
            is_terminal=done,
            weight=torch.ones(mb, dtype=torch.float32, device=idx.device),
            indices=ids,
        )

    def sample(self, ring: PlaneRing, draws) -> TransitionBatch:
        return self.gather(ring, self.sample_ids(ring.commit_cursor, draws, self.minibatch_size))

    def burst_batches(self, ring: PlaneRing, draws, n: int) -> List[TransitionBatch]:
        """A burst's ``n`` batches, their ids drawn in one draw from one read
        of the cursor and all their gathers issued now (the learner calls it
        under the lock)."""
        ids = self.sample_ids(ring.commit_cursor, draws, n * self.minibatch_size)
        return [self.gather(ring, row) for row in ids.reshape(n, self.minibatch_size)]

    def burst_updates(self, train_state, batches: List[TransitionBatch], draws) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """One update per batch, in place, with a target sync on each
        crossing of ``(u * UI) // TUI`` (u: updates before the step; the
        cadence of dqn.py:307-314). Returns the mean loss and the mean
        average Q (tensors) and the number of syncs."""
        UI, TUI = self.update_interval, self.target_update_interval
        loss = q = torch.zeros((), dtype=torch.float32, device=self.device)
        syncs = 0
        for batch in batches:
            u = train_state.n_updates
            _, aux = self.core.update(train_state, batch, draws)
            if ((u + 1) * UI) // TUI != (u * UI) // TUI:
                self.core.sync_target(train_state)
                syncs += 1
            loss = loss + aux["loss"]
            q = q + aux["average_q"]
        n = len(batches)
        return loss / n, q / n, syncs

    def learner_burst(self, train_state, ring: PlaneRing, draws, n: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """:meth:`burst_batches` then :meth:`burst_updates`."""
        return self.burst_updates(train_state, self.burst_batches(ring, draws, n), draws)

    def _example_stack(self) -> torch.Tensor:
        H, W = self.hw
        return torch.zeros((self.L, H, W, self.stack_k), dtype=torch.uint8, device=self.device)

    def _init_device_state(self, seed: int) -> None:
        """The train state (weights from a CPU generator seeded with
        ``seed``) and its acting copy, unless a state was set or loaded
        already; the stack and the ring."""
        H, W = self.hw
        example = self._example_stack()
        if self.train_state is None:
            self.set_train_state(self.core.init(torch.Generator().manual_seed(seed), example))
        self.stack = torch.zeros_like(example)
        zeros = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=self.device)  # noqa: E731
        self.ring = PlaneRing(
            planes=zeros(self.capacity, H * W, dtype=torch.uint8),
            action=zeros(self.capacity, dtype=torch.int32),
            reward=zeros(self.capacity, dtype=torch.float32),
            terminated=zeros(self.capacity, dtype=torch.bool),
            done=zeros(self.capacity, dtype=torch.bool),
        )
        self._server_draws = {w: _seeded_draws(seed * 1_000 + 1 + w, self.device) for w in range(self.n_workers)}
        self._learner_draws = _seeded_draws(seed * 1_000, self.device)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        ctx = get_context("spawn")
        runtime.build()  # before any actor spawns: they load it, never build it
        self._init_device_state(self.seed)
        self._spawned_at = time.perf_counter()
        for w in range(self.n_workers):
            ch = _WorkerChannel(ctx, w, self.K, self.R, self.hw)
            proc = ctx.Process(
                target=_env_worker,
                args=(ch.child_conn, ch.shm.name, self.K, self.R, self.hw, self.env_factory,
                      self.seed * 10_000 + w * self.K),
                daemon=True,
            )
            proc.start()
            ch.child_conn.close()
            self._channels.append(ch)
            self._workers.append(proc)
        for ch in self._channels:
            self._req_qs[ch.worker_id] = queue.Queue()
        threads = [
            ("io", self._io_loop, ()),
            ("committer", self._committer_loop, ()),
            ("learner", self._learner_loop, ()),
        ] + [
            # One act server per worker: the act stage is issued under the
            # lock, the readback of the actions outside it.
            (f"server{ch.worker_id}", self._server_loop, (ch,))
            for ch in self._channels
        ]
        for name, fn, args in threads:
            t = threading.Thread(target=fn, args=args, name=f"pipeline-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for ch in self._channels:
            try:
                ch.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for t in self._threads:
            t.join(timeout=10)
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for ch in self._channels:
            ch.close()

    # ----------------------------------------------------------------- loops
    def _guard(fn):
        def wrapped(self, *a, **kw):
            try:
                fn(self, *a, **kw)
            except Exception:
                self.logger.exception("%s failed", fn.__name__)
                self.exception_event.set()
                self._stop.set()
        return wrapped

    @_guard
    def _io_loop(self):
        """Single reader for all worker pipes; fans tokens out to queues."""
        conns = {ch.conn: ch for ch in self._channels}
        while not self._stop.is_set():
            for conn in mp_connection.wait(list(conns), timeout=0.1):
                ch = conns[conn]
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    if not self._stop.is_set():
                        raise
                    return
                if msg[0] == "req":
                    now = time.perf_counter()
                    self._first_request.setdefault(ch.worker_id, now)
                    self._req_qs[ch.worker_id].put((msg[1], now, self._burst_since is not None))
                elif msg[0] == "trans":
                    self._trans_q.put((ch, msg[1]))

    @_guard
    def _server_loop(self, ch):
        """Act-stage service for one worker: the act stage under the lock,
        the actions' readback outside it."""
        req_q = self._req_qs[ch.worker_id]
        draws = self._server_draws[ch.worker_id]
        lane_off = ch.worker_id * self.K
        while not self._stop.is_set():
            try:
                slot, requested, in_burst = req_q.get(timeout=0.1)
            except queue.Empty:
                continue
            v = ch.views
            planes = torch.from_numpy(np.array(v["planes"][slot])).to(self.device)
            prev_done = torch.from_numpy(v["prev_done"][slot].astype(bool)).to(self.device)
            row_base = ch.step * self.L + lane_off
            with self._state_lock:
                actions = self.act_stage(self._acting, self.stack, self.ring, planes, prev_done, lane_off, row_base,
                                         self.acted_steps, draws)
            v["act"][slot] = actions.cpu().numpy()
            self._round_trips.append((time.perf_counter() - requested, in_burst))
            ch.step += 1
            ch.send(("act", slot))

    @_guard
    def _committer_loop(self):
        """Drains full rows (one slot from every worker) into the ring."""
        staging = {ch.worker_id: [] for ch in self._channels}
        while not self._stop.is_set():
            try:
                ch, slot = self._trans_q.get(timeout=0.1)
            except queue.Empty:
                continue
            staging[ch.worker_id].append((ch, slot))
            while all(staging.values()):
                row = [staging[w].pop(0) for w in sorted(staging)]
                rew = np.concatenate([c.views["rew"][s] for c, s in row])
                term = np.concatenate([c.views["term"][s].astype(bool) for c, s in row])
                done = np.concatenate([c.views["done"][s].astype(bool) for c, s in row])
                t0 = time.perf_counter()
                tensors = [torch.from_numpy(x).to(self.device) for x in (rew, term, done)]
                with self._state_lock:
                    self.commit(self.ring, *tensors)
                self._commits.append(time.perf_counter() - t0)
                self.acted_steps += self.L
                for c, s in row:
                    c.send(("free", s))

    @_guard
    def _learner_loop(self):
        """Paced bursts: keeps ``optim_t`` near ``acted // update_interval``,
        never ahead of it."""
        draws = self._learner_draws
        while not self._stop.is_set():
            if self.acted_steps < self.replay_start_size:
                time.sleep(0.01)
                continue
            if self.acted_steps // self.update_interval - self.optim_t < self.burst:
                time.sleep(0.002)
                continue
            self._run_burst(draws)

    def _run_burst(self, draws) -> None:
        """One burst as the learner runs it beside the servers: the batches'
        ids and gathers under the lock, the updates outside it, then the
        weights published to the acting copy under the lock."""
        n = self.burst
        t0 = self._burst_since = time.perf_counter()
        with self._state_lock:
            batches = self.burst_batches(self.ring, draws, n)
        gathers_issued = time.perf_counter() - t0
        with self._learner_lock:
            loss, q, syncs = self.burst_updates(self.train_state, batches, draws)
            self.publish()
        # One sync per burst, not per update.
        self._loss, self._avg_q = float(loss), float(q)
        self._bursts.append((gathers_issued, time.perf_counter() - t0))
        self._burst_since = None
        self.target_syncs += syncs
        self.optim_t += n

    def publish(self) -> None:
        """Copies the online network into the acting copy, under the lock:
        acts see the weights after a whole burst, never a part of one."""
        with self._state_lock:
            copy_param(self._acting.model, self.train_state.model)

    def set_train_state(self, train_state) -> None:
        """Installs ``train_state`` (a converted checkpoint, say) and
        publishes it to the acting copy."""
        acting = copy.deepcopy(train_state.model)
        acting.requires_grad_(False)
        with self._state_lock:
            self.train_state = train_state
            self._acting = dataclasses.replace(train_state, model=acting)

    # ------------------------------------------------------------ checkpoint
    def save(self, dirname: str) -> str:
        """Writes the train state to ``<dirname>/train_state.pt`` between
        bursts, under the state lock; returns the path."""
        from pfrl_tpu_torch.replay.persistent import save_state

        path = os.path.join(dirname, "train_state.pt")
        with self._learner_lock, self._state_lock:
            save_state(self.train_state, path)
        return path

    def load(self, dirname: str) -> None:
        """Restores the train state saved in ``dirname`` (a
        ``train_state.pt``, or a JAX ``train_state.msgpack`` converted for
        the pipeline's core) and re-publishes the acting copy, between
        bursts and under the state lock. A pipeline with no state yet builds
        one as the template."""
        from pfrl_tpu_torch.agent import restore_saved, to_saved
        from pfrl_tpu_torch.experiments.demo_cli import resolve_train_state_path

        path = resolve_train_state_path(dirname)
        if path.endswith(".msgpack"):
            from pfrl_tpu_torch import convert

            saved = to_saved(convert.load_flax_checkpoint(self.core, path, device=self.device))
        else:
            saved = torch.load(path, map_location="cpu", weights_only=True)
        if self.train_state is None:
            self.set_train_state(self.core.init(torch.Generator().manual_seed(self.seed), self._example_stack()))
        with self._learner_lock, self._state_lock:
            self.train_state = restore_saved(self.train_state, saved, path)
            copy_param(self._acting.model, self.train_state.model)

    # ------------------------------------------------------------------ misc
    def get_statistics(self):
        return [
            ("average_q", self._avg_q),
            ("average_loss", self._loss),
            ("n_updates", self.optim_t),
        ]

    def timings(self) -> dict:
        """Host-clock readings of the run so far: act round trips (a
        request's arrival to its actions in shared memory, in ms; median
        and p90, apart by whether a burst was in flight at the request),
        commits (a row's flags to the device and committed, lock wait
        included), bursts (ms to issue the gathers, ms for the whole burst
        up to its loss on the host), target syncs and the workers' start-up
        (spawn to the last worker's first request, s)."""
        def summary(xs):
            xs = sorted(xs)
            if not xs:
                return {"n": 0}
            return {"n": len(xs), "median_ms": statistics.median(xs) * 1e3,
                    "p90_ms": xs[min(len(xs) - 1, int(0.9 * len(xs)))] * 1e3}

        trips = list(self._round_trips)
        bursts = list(self._bursts)
        started = (max(self._first_request.values()) - self._spawned_at
                   if len(self._first_request) == self.n_workers else None)
        return {
            "act_round_trip": summary([s for s, _ in trips]),
            "act_round_trip_idle_learner": summary([s for s, b in trips if not b]),
            "act_round_trip_during_burst": summary([s for s, b in trips if b]),
            "commit": summary(list(self._commits)),
            "burst_gathers": summary([g for g, _ in bursts]),
            "burst_updates": summary([b - g for g, b in bursts]),
            "burst": summary([b for _, b in bursts]),
            "target_syncs": self.target_syncs,
            "worker_startup_s": started,
        }

    @torch.no_grad()
    def greedy_actions(self, obs_stacks) -> np.ndarray:
        """Greedy actions for ``[B, H, W, k]`` uint8 frame stacks from the
        last published weights (the eval-mode act path; host eval envs run
        their own FrameStack, as the reference evaluates actors,
        evaluator.py:66-97)."""
        obs = torch.from_numpy(np.asarray(obs_stacks, np.uint8)).to(self.device)
        draws = _seeded_draws(0, self.device)
        with self._state_lock:
            actions = self.core.select_action(self._acting, draws, obs, 0, False)
        return actions.cpu().numpy()
