"""Per-row prioritized episodic replay (counterpart of
``pfrl_tpu/replay/prioritized_episodic.py``): the episodic buffer plus a
dense sum tree over its rows.

``add`` gives a row the running max priority when its episode ends
(``done``) and zero to the row a lane moves on to. A row sealed because it
filled keeps priority 0, so only the uniform share of the mixture can draw
it: that is the JAX package's behaviour, kept as it is.
``sample_episodes`` draws, in the JAX package's order, the stratified
targets (``uniform(n)``, a tree descent in plain tensor ops, not the
prefix-sample kernel), the uniform rows (``uniform(n * E)``), the mixture
(``uniform(n)``, uniform below ``uniform_ratio``) and the window offsets
(``uniform(n)``). Feedback is one error per sampled window:
``(|err| + eps) ** alpha``.
"""

import dataclasses

import torch

from pfrl_tpu_torch.replay import sum_tree
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer, EpisodicReplayState
from pfrl_tpu_torch.replay.transition import Transition


@dataclasses.dataclass
class PrioritizedEpisodicReplayState(EpisodicReplayState):
    tree: torch.Tensor = None          # [2 * capacity] sum tree over rows
    max_priority: torch.Tensor = None  # float32 0-d


class PrioritizedEpisodicReplayBuffer(EpisodicReplayBuffer):
    def __init__(
        self,
        max_episodes: int,
        max_episode_len: int,
        num_lanes: int = 1,
        uniform_ratio: float = 0.1,
        alpha: float = 1.0,
        eps: float = 1e-3,
        subseq_len=None,
        store_carries: bool = True,
        device=None,
    ):
        super().__init__(max_episodes, max_episode_len, num_lanes, subseq_len=subseq_len,
                         store_carries=store_carries, device=device)
        self.uniform_ratio = uniform_ratio
        self.alpha = alpha
        self.eps = eps
        self.tree_capacity = sum_tree.tree_capacity(max_episodes)

    def configure_lanes(self, num_lanes: int) -> "PrioritizedEpisodicReplayBuffer":
        return PrioritizedEpisodicReplayBuffer(
            self.max_episodes, self.max_episode_len, num_lanes, uniform_ratio=self.uniform_ratio, alpha=self.alpha,
            eps=self.eps, subseq_len=self.subseq_len, store_carries=self.stores_carries, device=self.device)

    def init(self, example: Transition, storage_rows=None) -> PrioritizedEpisodicReplayState:
        base = super().init(example, storage_rows)
        return PrioritizedEpisodicReplayState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(EpisodicReplayState)},
            tree=sum_tree.init_tree(self.tree_capacity, self.device),
            max_priority=torch.ones((), dtype=torch.float32, device=self.device),
        )

    def advance(self, state: PrioritizedEpisodicReplayState, done: torch.Tensor) -> PrioritizedEpisodicReplayState:
        rows = state.lane_row
        super().advance(state, done)
        tree = state.tree
        sum_tree.update(tree, rows, torch.where(done, state.max_priority, sum_tree.get(tree, rows)))
        next_rows = state.lane_row
        sum_tree.update(tree, next_rows, torch.where(next_rows != rows, 0.0, sum_tree.get(tree, next_rows)))
        return state

    def draw_rows(self, state: PrioritizedEpisodicReplayState, draws, n: int) -> torch.Tensor:
        """The mixture: the stratified tree draw, or uniform over the sealed
        rows below ``uniform_ratio``."""
        prioritized = sum_tree.stratified_sample(state.tree, draws, n)
        uniform = self._sealed_rows(draws, n, state.finished.to(torch.float32))
        use_uniform = draws.uniform(n) < self.uniform_ratio
        return torch.where(use_uniform, uniform, prioritized)

    def update_episode_priorities(self, state: PrioritizedEpisodicReplayState, rows, errors):
        prio = (torch.abs(errors) + self.eps) ** self.alpha
        sum_tree.update(state.tree, rows, prio)
        state.max_priority = torch.maximum(state.max_priority, torch.max(prio))
        return state
