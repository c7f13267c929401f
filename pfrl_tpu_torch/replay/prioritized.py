"""Proportional prioritized replay (counterpart of
``pfrl_tpu/replay/prioritized.py``).

The ring, the sum and min trees, ``max_priority`` and ``beta`` are all
updated **in place**; ``add``/``sample``/``update_priorities`` return the
same state object. Sampling finds each target's leaf with
:func:`pfrl_tpu_torch.ops.prefix_sample.prefix_sample`: the hand-written
kernel for a ring on the card, its plain version for a ring on the CPU.

With n-step > 1 or ``store_next_obs=False``, the newest
``(n - 1 + extra) * num_lanes`` slots are held out of the tree (priority 0,
min +inf) until their window completes, then enter at max priority.
"""

import dataclasses
from typing import Optional

import torch

from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
from pfrl_tpu_torch.replay import sum_tree
from pfrl_tpu_torch.replay.transition import Transition
from pfrl_tpu_torch.replay.uniform import ReplayBuffer, ReplayState
from pfrl_tpu_torch.utils.batch_states import first_leaf
from pfrl_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PrioritizedReplayState:
    base: ReplayState
    tree: torch.Tensor          # sum tree over slot priorities
    min_tree: torch.Tensor      # min tree (for normalize_by_max="memory")
    max_priority: torch.Tensor  # f32 0-d
    beta: torch.Tensor          # f32 0-d

    @property
    def size(self):
        return self.base.size

    @property
    def cursor(self):
        return self.base.cursor


class PrioritizedReplayBuffer(ReplayBuffer):
    #: Each sample depends on the priorities the last update fed back.
    iid_samples = False

    def __init__(
        self,
        capacity: int,
        alpha: float = 0.6,
        beta0: float = 0.4,
        betasteps: Optional[float] = 2e5,
        eps: float = 0.01,
        normalize_by_max="batch",
        error_min: Optional[float] = 0.0,
        error_max: Optional[float] = 1.0,
        num_steps: int = 1,
        gamma: float = 0.99,
        num_lanes: int = 1,
        store_next_obs: bool = True,
        fused_dequant_scale: Optional[float] = None,
        device=None,
    ):
        super().__init__(
            capacity,
            num_steps=num_steps,
            gamma=gamma,
            num_lanes=num_lanes,
            store_next_obs=store_next_obs,
            fused_dequant_scale=fused_dequant_scale,
            device=device,
        )
        if normalize_by_max is True:
            normalize_by_max = "batch"
        if normalize_by_max not in (False, "batch", "memory"):
            raise ValueError(f"normalize_by_max: {normalize_by_max!r}")
        self.alpha = alpha
        self.beta0 = beta0
        self.beta_add = 0.0 if betasteps is None else (1.0 - beta0) / betasteps
        self.eps = eps
        self.normalize_by_max = normalize_by_max
        self.error_min = error_min
        self.error_max = error_max
        self.tree_capacity = sum_tree.tree_capacity(self.capacity)

    def _config(self) -> dict:
        return dict(
            super()._config(), alpha=self.alpha, beta0=self.beta0,
            betasteps=None if self.beta_add == 0 else (1.0 - self.beta0) / self.beta_add,
            eps=self.eps, normalize_by_max=self.normalize_by_max,
            error_min=self.error_min, error_max=self.error_max,
        )

    # ------------------------------------------------------------------ init
    def init(self, example: Transition) -> PrioritizedReplayState:
        return PrioritizedReplayState(base=super().init(example), **self.init_trees())

    def init_trees(self) -> dict:
        """The replicated part of the state: the trees, ``max_priority`` and
        ``beta``."""
        dev = self.device
        return dict(
            tree=sum_tree.init_tree(self.tree_capacity, dev),
            min_tree=sum_tree.init_min_tree(self.tree_capacity, dev),
            max_priority=torch.ones((), dtype=torch.float32, device=dev),
            beta=torch.full((), self.beta0, dtype=torch.float32, device=dev),
        )

    # ------------------------------------------------------------------- add
    def add(self, state: PrioritizedReplayState, batch: Transition) -> PrioritizedReplayState:
        lanes = first_leaf(batch.obs).shape[0]
        cursor = state.base.cursor.clone()  # super().add bumps it in place
        super().add(state.base, batch)
        return self.admit(state, cursor, lanes)

    def admit(self, state: PrioritizedReplayState, cursor: torch.Tensor, lanes: int) -> PrioritizedReplayState:
        """The trees' side of an add of ``lanes`` rows at ``cursor`` (the
        cursor before the add), in place."""
        lane = torch.arange(lanes, dtype=torch.int32, device=self.device)
        written = (cursor + lane) % self.capacity

        hold = (self.num_steps - 1 + (0 if self.store_next_obs else 1)) * self.num_lanes
        tree, min_tree = state.tree, state.min_tree
        if hold == 0:
            prio = torch.ones(lanes, dtype=torch.float32, device=self.device) * state.max_priority
            sum_tree.update(tree, written, prio)
            sum_tree.update_min(min_tree, written, prio)
            return state
        # Newly written slots enter held out (incomplete n-step window).
        sum_tree.update(tree, written, torch.zeros(lanes, dtype=torch.float32, device=self.device))
        sum_tree.update_min(
            min_tree, written, torch.full((lanes,), torch.inf, dtype=torch.float32, device=self.device)
        )
        # Slots ageing out of the hold window become sampleable.
        aging_ids = cursor - hold + lane
        aging = aging_ids % self.capacity
        mature = aging_ids >= 0
        prio = torch.where(mature, state.max_priority, 0.0)
        sum_tree.update(tree, aging, torch.where(mature, prio, sum_tree.get(tree, aging)))
        sum_tree.update_min(
            min_tree, aging, torch.where(mature, prio, sum_tree.get(min_tree, aging))
        )
        return state

    # ----------------------------------------------------------------- sample
    def _find_slots(self, tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Prefix-sum target -> leaf slot, clamped to the last leaf.

        On the card this always launches the prefix-sample kernel; on the
        CPU ``prefix_sample`` takes its plain version.
        """
        cap = self.tree_capacity
        idx = prefix_sample(tree[cap:], targets)
        return torch.clamp_max(idx, cap - 1)

    def sample(self, state: PrioritizedReplayState, draws, batch_size: int):
        """Returns ``(batch, state)``; beta anneals per call, in place."""
        with span("draw"):
            ids, slots, weights = self.draw(state, draws, batch_size)
        with span("gather"):
            batch = self.gather(state.base, ids)
        batch.weight = weights
        batch.indices = slots
        return batch, state

    def draw(self, state: PrioritizedReplayState, draws, batch_size: int):
        """The trees' side of a sample: ``(ids, slots, weights)``, the
        monotonic ids to gather, the slots to feed back and the importance
        weights; beta anneals, in place."""
        total = sum_tree.total(state.tree)
        targets = sum_tree.stratified_targets(total, draws.uniform(batch_size))
        slots = self._find_slots(state.tree, targets)
        priorities = sum_tree.get(state.tree, slots)
        probs = priorities / total

        if self.normalize_by_max == "batch":
            min_prob = torch.min(probs)
            weights = (probs / min_prob) ** -state.beta
        elif self.normalize_by_max == "memory":
            min_prob = sum_tree.min_value(state.min_tree) / total
            weights = (probs / min_prob) ** -state.beta
        else:
            weights = (state.size.to(torch.float32) * probs) ** -state.beta

        # Slot -> monotonic id (for gather's window arithmetic):
        # the slot itself if in the live [lo, cursor) window, else + wraps.
        cursor = state.cursor
        lo = torch.clamp_min(cursor - self.capacity, 0)
        gen = (cursor - 1 - slots) // self.capacity  # how many wraps back
        ids = torch.maximum(slots + gen * self.capacity, lo)
        state.beta = torch.clamp_max(state.beta + self.beta_add, 1.0)
        return ids, slots, weights

    # ------------------------------------------------------------- priorities
    def priority_from_errors(self, errors: torch.Tensor) -> torch.Tensor:
        e = errors
        if self.error_min is not None:
            e = torch.clamp_min(e, self.error_min)
        if self.error_max is not None:
            e = torch.clamp_max(e, self.error_max)
        return (e + self.eps) ** self.alpha

    def update_priorities(
        self, state: PrioritizedReplayState, slots: torch.Tensor, errors: torch.Tensor
    ) -> PrioritizedReplayState:
        """Priority feedback, in place. ``slots`` should be unique: with a
        duplicate, which priority lands is unspecified."""
        prio = self.priority_from_errors(errors)
        sum_tree.update(state.tree, slots, prio)
        sum_tree.update_min(state.min_tree, slots, prio)
        state.max_priority = torch.maximum(state.max_priority, torch.max(prio))
        return state
