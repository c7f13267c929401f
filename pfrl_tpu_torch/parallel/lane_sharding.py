"""The runners' lanes split over a :class:`~.mesh.Mesh`: draw sources that
hand each rank its share of every draw, a replay ring whose rows each rank
keeps for its own lanes, and the episodic buffers' counterpart.

The JAX runner under a mesh places the lane-major arrays (env states,
observations, the act-time carry, the storage of whichever buffer it
holds) sharded over the data axis and every other array (weights,
optimizer state, cursor, priority trees, an episodic buffer's tables, the
key) replicated, and XLA computes the same numbers as on one device. The
port does by hand what keeps that contract:

- **Draws are global, and each names its kind.** Every rank holds an
  equally seeded draw source and draws every draw whole, so the sources
  stay in lockstep and equal the single-process run's. A per-row draw
  (``utils.draws.per_row``: IQN's taus, SAC's and TD3's noise, ACER's
  ``[n_sdn, B, T, d]`` normal whose rows lie on axis 1, a distribution's
  sample) keeps this rank's rows *on the rows' axis*; a per-parameter draw
  (``utils.draws.per_parameter``: a noisy layer's ``eps_in`` and
  ``eps_out``) is used whole. :class:`RowDraws` is the source of a
  data-parallel update: a flat draw that names no kind raises there.
  :class:`LaneDraws` serves the act and the env, where a flat draw of
  ``n`` numbers for this rank's lanes is per lane (every env's resets and
  every explorer's draws are lane-major): it draws ``n * size`` and keeps
  this rank's ``n``. Draws that are not per lane (the sampled ids and
  rows, PER's targets, the minibatch permutation) come from the shared
  source itself.
- **The ring's rows are sharded; its bookkeeping is replicated.**
  :class:`LaneShardedBuffer` keeps a plain ring of this rank's
  ``lanes / size`` lanes and ``capacity / size`` slots; the cursor, the
  sampleable range, the ids and PER's trees and beta are the whole ring's,
  on every rank. A gather maps each global id to its owner's local slot,
  gathers on every rank, all-gathers and keeps each row from its owner:
  every rank sees the whole batch, as the single-process ring gives it.
- **The episodic buffers likewise.** :class:`LaneShardedEpisodicBuffer`:
  lane ``l`` writes its own block of ``E / num_lanes`` rows, so this
  rank's lanes' blocks are ``E / size`` consecutive rows, with their
  stored carries; the row lengths, seals, each lane's row, the count of
  rows started and the prioritized buffer's tree are the whole buffer's,
  advanced on every rank from every lane's ``done``. The sampled rows,
  their offsets and PER's mixture are drawn on every rank from the shared
  source; each window is read from its owner's rows and all-gathered.
"""

import dataclasses
import math

import torch

from pfrl_tpu_torch.parallel.mesh import Mesh, all_gather, all_gather_rows, local_rows, map_tensors
from pfrl_tpu_torch.replay.episodic import take_rows
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayState
from pfrl_tpu_torch.replay.uniform import ReplayBuffer, ReplayState


class RowDraws:
    """This rank's share of every draw of ``draws`` that names its kind
    (see the module's note): the source of a data-parallel update."""

    def __init__(self, draws, mesh: Mesh):
        self.draws, self.mesh = draws, mesh
        self.device = getattr(draws, "device", None)

    def rows(self, kind: str, shape, row_axis: int = 0) -> torch.Tensor:
        """A per-row draw: the whole draw of ``shape`` with ``shape[row_axis]``
        rows on every rank, of which this rank keeps its own on that axis."""
        whole = list(shape)
        n = whole[row_axis]
        whole[row_axis] = n * self.mesh.size
        x = getattr(self.draws, kind)(math.prod(whole)).reshape(whole)
        return x.narrow(row_axis, self.mesh.rank * n, n).contiguous()

    def whole(self, kind: str, n: int) -> torch.Tensor:
        """A per-parameter draw, the same on every rank."""
        return getattr(self.draws, kind)(n)

    def _flat(self, name: str):
        raise TypeError(f"a flat draw ({name}) in a data-parallel update names no kind: draw it with "
                        "utils.draws.per_row or per_parameter")

    def uniform(self, n: int) -> torch.Tensor:
        self._flat("uniform")

    def normal(self, n: int) -> torch.Tensor:
        self._flat("normal")

    def randint(self, high: int, n: int) -> torch.Tensor:
        self._flat("randint")

    def randint_below(self, high, n: int) -> torch.Tensor:
        self._flat("randint_below")

    def permutation(self, n: int) -> torch.Tensor:
        self._flat("permutation")


class LaneDraws(RowDraws):
    """The act's and the env's source: this rank's lanes' part of every
    flat draw (per lane), and the kinds of :class:`RowDraws`."""

    def _part(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x[self.mesh.rank * n:(self.mesh.rank + 1) * n]

    def uniform(self, n: int) -> torch.Tensor:
        return self._part(self.draws.uniform(n * self.mesh.size), n)

    def normal(self, n: int) -> torch.Tensor:
        return self._part(self.draws.normal(n * self.mesh.size), n)

    def randint(self, high: int, n: int) -> torch.Tensor:
        return self._part(self.draws.randint(high, n * self.mesh.size), n)

    def randint_below(self, high, n: int) -> torch.Tensor:
        return self._part(self.draws.randint_below(high, n * self.mesh.size), n)

    def permutation(self, n: int) -> torch.Tensor:
        raise NotImplementedError("a permutation is not a per-lane draw")


@dataclasses.dataclass
class ShardedRingState:
    """``local``: this rank's rows (a plain ring's state, its own cursor);
    the whole ring's ``cursor`` and ``size`` are computed from it."""

    local: ReplayState
    world: int
    capacity: int  # the whole ring's

    @property
    def cursor(self) -> torch.Tensor:
        return self.local.cursor * self.world

    @property
    def size(self) -> torch.Tensor:
        return torch.clamp_max(self.cursor, self.capacity)

    @property
    def storage(self):
        return self.local.storage

    @property
    def item_shapes(self):
        return self.local.item_shapes


class LaneShardedBuffer:
    """``buffer`` (a uniform or prioritized ring over all lanes) with its
    rows split over ``mesh`` by lane. ``add`` takes this rank's lanes;
    ``sample_indices``, ``sample``, ``gather`` and ``update_priorities``
    take and give the whole ring's ids and the whole batch."""

    def __init__(self, buffer, mesh: Mesh):
        if buffer.num_lanes % mesh.size:
            raise ValueError(f"{buffer.num_lanes} lanes do not divide over {mesh.size} ranks")
        self.buffer, self.mesh = buffer, mesh
        self.prioritized = isinstance(buffer, ReplayBuffer) and hasattr(buffer, "draw")
        self.local_lanes = buffer.num_lanes // mesh.size
        self.ring = ReplayBuffer(
            buffer.capacity // mesh.size, num_steps=buffer.num_steps, gamma=buffer.gamma,
            num_lanes=self.local_lanes, store_next_obs=buffer.store_next_obs,
            fused_dequant_scale=buffer.fused_dequant_scale, device=buffer.device,
        )
        self.num_lanes, self.capacity = buffer.num_lanes, buffer.capacity
        self.iid_samples, self.device = buffer.iid_samples, buffer.device

    def init(self, example):
        base = ShardedRingState(self.ring.init(example), self.mesh.size, self.capacity)
        return PrioritizedReplayState(base=base, **self.buffer.init_trees()) if self.prioritized else base

    def _base(self, state) -> ShardedRingState:
        return state.base if self.prioritized else state

    def add(self, state, batch):
        """This rank's lanes' transitions, in place; PER's trees admit
        every lane's slot."""
        base = self._base(state)
        cursor = base.cursor
        self.ring.add(base.local, batch)
        if self.prioritized:
            self.buffer.admit(state, cursor, self.num_lanes)
        return state

    def sample_indices(self, state, draws, batch_size: int) -> torch.Tensor:
        return self.buffer.sample_indices(state, draws, batch_size)

    def gather(self, state, ids: torch.Tensor):
        """The whole batch of the global monotonic ``ids``, on every rank."""
        base = state if isinstance(state, ShardedRingState) else self._base(state)
        lane = ids % self.num_lanes
        owner = (lane // self.local_lanes).long()
        local_ids = (ids // self.num_lanes) * self.local_lanes + lane % self.local_lanes
        rows = torch.arange(ids.shape[0], device=ids.device)
        batch = self.ring.gather(base.local, local_ids)
        whole = map_tensors(lambda x: all_gather(self.mesh, x)[owner, rows], batch)
        whole.indices = ids
        return whole

    def sample(self, state, draws, batch_size: int):
        """``(batch, state)`` as the buffer samples: uniform ids, or PER's
        draw on the replicated trees (the prefix-sample kernel on every
        rank) with its weights and slots."""
        if not self.prioritized:
            return self.gather(state, self.sample_indices(state, draws, batch_size)), state
        ids, slots, weights = self.buffer.draw(state, draws, batch_size)
        batch = self.gather(state.base, ids)
        batch.weight = weights
        batch.indices = slots
        return batch, state

    def update_priorities(self, state, slots, errors):
        """The whole batch's feedback into the replicated trees."""
        return self.buffer.update_priorities(state, slots, errors)


class LaneShardedEpisodicBuffer:
    """``buffer`` (an :class:`~pfrl_tpu_torch.replay.episodic.EpisodicReplayBuffer`
    or its prioritized subclass over all lanes) with its storage rows split
    over ``mesh`` by lane (see the module's note). ``add`` takes this
    rank's lanes; ``sample_episodes`` and ``update_episode_priorities``
    take and give the whole batch."""

    def __init__(self, buffer, mesh: Mesh):
        if buffer.num_lanes % mesh.size:
            raise ValueError(f"{buffer.num_lanes} lanes do not divide over {mesh.size} ranks")
        if buffer.max_episodes % buffer.num_lanes:
            raise ValueError(f"{buffer.max_episodes} rows do not split into equal blocks for "
                             f"{buffer.num_lanes} lanes")
        self.buffer, self.mesh = buffer, mesh
        self.lanes = local_rows(mesh, buffer.num_lanes)
        self.storage_rows = buffer.max_episodes // mesh.size
        self.offset = mesh.rank * self.storage_rows
        for name in ("num_lanes", "max_episodes", "max_episode_len", "subseq_len", "gamma", "stores_carries",
                     "device"):
            setattr(self, name, getattr(buffer, name))
        if hasattr(buffer, "update_episode_priorities"):
            self.update_episode_priorities = buffer.update_episode_priorities

    def init(self, example):
        return self.buffer.init(example, storage_rows=self.storage_rows)

    def add(self, state, batch):
        """This rank's lanes' step into their rows, in place; every lane's
        bookkeeping from the all-gathered ``done``."""
        rows = state.lane_row
        pos = state.ep_len[rows]
        self.buffer.write(state.storage, rows[self.lanes] - self.offset, pos[self.lanes], batch)
        return self.buffer.advance(state, all_gather_rows(self.mesh, batch.done))

    def take(self, s: torch.Tensor, idx: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
        """The windows ``s[idx, t_idx]`` of the whole buffer: each rank reads
        the rows it owns (others' rows clamped into its own), all-gathers,
        and keeps each window from its row's owner."""
        owner = (idx // self.storage_rows).long()
        local = torch.clamp(idx - self.offset, 0, self.storage_rows - 1)
        gathered = all_gather(self.mesh, take_rows(s, local, t_idx))
        return gathered[owner, torch.arange(idx.shape[0], device=idx.device)]

    def sample_episodes(self, state, draws, n_episodes: int, max_len=None):
        """The buffer's draw on the replicated tables, windows from their
        owners: the whole batch on every rank."""
        idx = self.buffer.draw_rows(state, draws, n_episodes)
        return self.buffer.gather_windows(state, draws.uniform(n_episodes), idx,
                                          self.buffer._window_len(max_len), take=self.take)
