"""The runners' lanes split over a :class:`~.mesh.Mesh`: a draw source that
hands each rank its lanes' part of every per-lane draw, and a replay ring
whose rows each rank keeps for its own lanes.

The JAX runner under a mesh places the lane-major arrays (env states,
observations, the ring's storage) sharded over the data axis and every
other array (weights, optimizer state, cursor, priority trees, the key)
replicated, and XLA computes the same numbers as on one device. The port
does by hand what keeps that contract:

- **Draws are global.** Every rank holds an equally seeded draw source and
  draws every draw whole, so the sources stay in lockstep and equal the
  single-process run's. :class:`LaneDraws` serves the act and the env: a
  draw of ``n`` numbers for this rank's lanes draws ``n * size`` and keeps
  this rank's ``n``, which is its lanes' part where the draw is lane-major
  (every env's resets and every explorer's and distribution's samples
  are). Draws that are not per lane (the sampled ids, PER's targets, the
  minibatch permutation) come from the shared source itself.
- **The ring's rows are sharded; its bookkeeping is replicated.**
  :class:`LaneShardedBuffer` keeps a plain ring of this rank's
  ``lanes / size`` lanes and ``capacity / size`` slots; the cursor, the
  sampleable range, the ids and PER's trees and beta are the whole ring's,
  on every rank. A gather maps each global id to its owner's local slot,
  gathers on every rank, all-gathers and keeps each row from its owner:
  every rank sees the whole batch, as the single-process ring gives it.
"""

import dataclasses

import torch

from pfrl_tpu_torch.parallel.mesh import Mesh, all_gather, map_tensors
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayState
from pfrl_tpu_torch.replay.uniform import ReplayBuffer, ReplayState


class LaneDraws:
    """This rank's part of every draw of ``draws`` (see the module's note)."""

    def __init__(self, draws, mesh: Mesh):
        self.draws, self.mesh = draws, mesh
        self.device = getattr(draws, "device", None)

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
        if hasattr(buffer, "sample_episodes"):
            raise NotImplementedError("the episodic buffers under a mesh are not ported")
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
