"""Episodic device replay with random-offset windows (counterpart of
``pfrl_tpu/replay/episodic.py``).

Storage is one ``[E, L, ...]`` tensor per leaf: ``E = max_episodes`` rows
of ``L = max_episode_len`` steps, with each row's length and whether it is
sealed. Each of the ``num_lanes`` lanes writes into a private ring of
``E // num_lanes`` consecutive rows. A row is sealed (becomes sampleable)
when its episode ends **or** when it fills; the episode then goes on in the
lane's next row, whose length and seal are reset. The runner stores each
step's recurrent carries in ``extras`` (``"carry"`` before the step,
``"next_carry"`` after it) so that a window warm-starts mid-episode, or
ACER's behaviour distribution (``"mu_logits"``, or ``"mu_mean"`` and
``"mu_std"``).

As in :mod:`~pfrl_tpu_torch.replay.uniform`, the state is written **in
place** (``storage[rows, pos] = x``): at the DRQN-Atari size the storage is
gigabytes and must never be copied per step. The JAX package's
``split_storage`` / ``merge_storage`` exist to keep XLA from copying it;
here nothing is copied, and they are not needed.

Cursors and rows are int32. Draws: :meth:`EpisodicReplayBuffer.
sample_episodes` draws the rows by ``jax.random.categorical`` over
``log(finished + 1e-20)`` (Gumbel-max on one ``uniform`` of ``[n, E]``),
then one ``uniform(n)`` for the window offsets, ``int32(u * (max_off +
1))`` computed in float32 and clamped to ``max_off``.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch
from pfrl_tpu_torch.utils.draws import categorical
from pfrl_tpu_torch.utils.recurrent import tree_map

_LEAVES = ("obs", "action", "reward", "next_obs", "terminated", "done")


def take_rows(s: torch.Tensor, idx: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
    """``s[idx, t_idx]``: windows ``[B, T, ...]`` of rows ``idx [B]`` at
    steps ``t_idx [B, T]``."""
    return s[idx[:, None], t_idx]


@dataclasses.dataclass
class EpisodicReplayState:
    storage: Dict[str, Any]   # leaf -> [E, L, ...]; "extras" -> {name: carry of [E, L, ...]}
    ep_len: torch.Tensor      # [E] int32 steps written per row
    finished: torch.Tensor    # [E] bool: row sealed (episode done or row full)
    lane_row: torch.Tensor    # [num_lanes] int32 row each lane writes
    n_started: torch.Tensor   # int32 0-d: rows started

    @property
    def n_finished(self) -> torch.Tensor:
        return torch.sum(self.finished, dtype=torch.int32)


@dataclasses.dataclass
class EpisodeBatch:
    """Windows ``[B, T, ...]`` with a validity mask; ``rows``/``offsets``
    locate each window (row and start step)."""

    transitions: Transition
    mask: torch.Tensor     # [B, T] float32, 1 where valid
    lengths: torch.Tensor  # [B] int32
    rows: torch.Tensor     # [B] int32
    offsets: torch.Tensor  # [B] int32
    #: The whole batch's mask where this batch is one rank's share of it
    #: (a data-parallel update sets it); None where this is the whole batch.
    whole_mask: Optional[torch.Tensor] = None

    def valid_steps(self, start: int = 0) -> torch.Tensor:
        """The whole batch's count of valid steps from step ``start`` of its
        windows: what a masked mean over the batch divides by."""
        mask = self.mask if self.whole_mask is None else self.whole_mask
        return torch.sum(mask[:, start:])

    @property
    def whole_rows(self) -> int:
        """The whole batch's number of windows."""
        return (self.mask if self.whole_mask is None else self.whole_mask).shape[0]

    def _first(self, name: str) -> Optional[Any]:
        ex = self.transitions.extras or {}
        return tree_map(lambda x: x[:, 0], ex[name]) if name in ex else None

    @property
    def init_carry(self) -> Optional[Any]:
        """The carry the actor held before ``obs[:, 0]`` (None: no carries stored)."""
        return self._first("carry")

    @property
    def next_init_carry(self) -> Optional[Any]:
        """The carry after ``obs[:, 0]``: the target's warm start over ``next_obs``."""
        return self._first("next_carry")


class EpisodicReplayBuffer:
    """``subseq_len``: the default window of :meth:`sample_episodes` (None:
    whole rows). ``store_carries`` False stores no carries; windows then
    start from zero carries."""

    def __init__(
        self,
        max_episodes: int,
        max_episode_len: int,
        num_lanes: int = 1,
        subseq_len: Optional[int] = None,
        gamma: float = 0.99,
        store_carries: bool = True,
        device=None,
    ):
        if max_episodes <= 2 * num_lanes:
            raise ValueError("need headroom: max_episodes > 2 * num_lanes")
        self.max_episodes = max_episodes
        self.max_episode_len = max_episode_len
        self.num_lanes = num_lanes
        self.subseq_len = subseq_len
        self.gamma = gamma
        self.stores_carries = store_carries
        self.device = resolve_device(device)

    @property
    def wants_next_obs(self) -> bool:
        """The buffer protocol's flag (``ReplayBuffer.wants_next_obs``): a
        row keeps whole trajectories, ``next_obs`` included."""
        return True

    def configure_lanes(self, num_lanes: int) -> "EpisodicReplayBuffer":
        """A copy for ``num_lanes`` lanes (a host shell learns its vector
        env's width at its first step)."""
        return EpisodicReplayBuffer(self.max_episodes, self.max_episode_len, num_lanes, subseq_len=self.subseq_len,
                                    gamma=self.gamma, store_carries=self.stores_carries, device=self.device)

    # ------------------------------------------------------------------ init
    def init(self, example: Transition, storage_rows: Optional[int] = None) -> EpisodicReplayState:
        """Allocate storage from one example transition (no batch dim).
        ``storage_rows`` (default ``max_episodes``) is the storage's number
        of rows: a rank of a mesh keeps only its lanes' rows
        (``parallel.lane_sharding``); the bookkeeping is the whole buffer's."""
        E, L, dev = self.max_episodes, self.max_episode_len, self.device
        R = E if storage_rows is None else storage_rows

        def alloc(x):
            return torch.zeros((R, L) + tuple(x.shape), dtype=x.dtype, device=dev)

        storage = {name: alloc(getattr(example, name)) for name in _LEAVES}
        storage["extras"] = {k: tree_map(alloc, v) for k, v in (example.extras or {}).items()}
        return EpisodicReplayState(
            storage=storage,
            ep_len=torch.zeros(E, dtype=torch.int32, device=dev),
            finished=torch.zeros(E, dtype=torch.bool, device=dev),
            lane_row=torch.arange(self.num_lanes, dtype=torch.int32, device=dev) * (E // self.num_lanes),
            n_started=torch.tensor(self.num_lanes, dtype=torch.int32, device=dev),
        )

    # ------------------------------------------------------------------- add
    def add(self, state: EpisodicReplayState, batch: Transition) -> EpisodicReplayState:
        """Append one step per lane, in place; seal and rotate a lane's row
        on episode end or when the row fills."""
        rows = state.lane_row
        self.write(state.storage, rows, state.ep_len[rows], batch)
        return self.advance(state, batch.done)

    def write(self, storage: Dict[str, Any], rows: torch.Tensor, pos: torch.Tensor, batch: Transition) -> None:
        """Writes each lane's step of ``batch`` at its storage row ``rows``
        and step ``pos``, in place."""
        safe_pos = torch.clamp_max(pos, self.max_episode_len - 1)  # rows rotate on fill

        def write(s, x):
            s[rows, safe_pos] = x.to(s.dtype)  # a sampled action may come as int64

        for name in _LEAVES:
            write(storage[name], getattr(batch, name))
        for name, carry in (batch.extras or {}).items():
            if name in storage["extras"]:
                tree_map(write, storage["extras"][name], carry)

    def advance(self, state: EpisodicReplayState, done: torch.Tensor) -> EpisodicReplayState:
        """The bookkeeping of one step of every lane (``done`` ``[num_lanes]``),
        in place: lengths, seals, each lane's next row."""
        rows = state.lane_row
        new_pos = state.ep_len[rows] + 1
        state.ep_len[rows] = new_pos
        seal = done | (new_pos >= self.max_episode_len)
        state.finished[rows] = state.finished[rows] | seal
        rpl = self.max_episodes // self.num_lanes
        base = torch.arange(self.num_lanes, dtype=torch.int32, device=rows.device) * rpl
        next_rows = torch.where(seal, base + (rows - base + 1) % rpl, rows)
        # The incoming rows start empty and unsealed.
        state.ep_len[next_rows] = torch.where(seal, 0, state.ep_len[next_rows])
        state.finished[next_rows] = torch.where(seal, False, state.finished[next_rows])
        state.lane_row = next_rows
        state.n_started = state.n_started + torch.sum(seal, dtype=torch.int32)
        return state

    # ---------------------------------------------------------------- sample
    def _window_len(self, max_len: Optional[int]) -> int:
        return max_len or self.subseq_len or self.max_episode_len

    def _sealed_rows(self, draws, n: int, weights: torch.Tensor) -> torch.Tensor:
        """int32 ``[n]`` rows by ``categorical(log(weights + 1e-20))``."""
        logits = torch.log(weights + 1e-20).expand(n, -1)
        return categorical(draws, logits).to(torch.int32)

    def draw_rows(self, state: EpisodicReplayState, draws, n: int) -> torch.Tensor:
        """int32 ``[n]`` sampled rows: uniform over the sealed rows."""
        return self._sealed_rows(draws, n, state.finished.to(torch.float32))

    def gather_windows(self, state: EpisodicReplayState, u: torch.Tensor, idx: torch.Tensor, T: int,
                       take: Optional[Callable] = None) -> EpisodeBatch:
        """Windows of ``T`` steps from rows ``idx`` at offsets drawn from
        ``u`` ``[B]`` uniformly over ``[0, max(0, len - T)]``; a shorter row
        is returned whole from offset 0, its tail masked. ``take(s, idx,
        t_idx)`` reads a storage leaf (default: :func:`take_rows`)."""
        full_len = state.ep_len[idx]
        max_off = torch.clamp_min(full_len - T, 0)
        off = torch.minimum((u * (max_off + 1).to(torch.float32)).to(torch.int32), max_off)
        steps = torch.arange(T, dtype=torch.int32, device=idx.device)
        t_idx = torch.clamp_max(off[:, None] + steps[None, :], self.max_episode_len - 1)
        read = take or take_rows

        def take(s):
            return read(s, idx, t_idx)

        st = state.storage
        transitions = Transition(
            **{name: take(st[name]) for name in _LEAVES},
            extras={k: tree_map(take, v) for k, v in st["extras"].items()},
        )
        lengths = torch.minimum(full_len - off, torch.full_like(full_len, T))
        mask = (steps[None, :] < lengths[:, None]).to(torch.float32)
        return EpisodeBatch(transitions=transitions, mask=mask, lengths=lengths, rows=idx, offsets=off)

    def sample_episodes(self, state: EpisodicReplayState, draws, n_episodes: int,
                        max_len: Optional[int] = None) -> EpisodeBatch:
        """Uniform over sealed rows, then a random-offset window of
        ``max_len`` (default ``subseq_len``, else whole rows) from each."""
        idx = self.draw_rows(state, draws, n_episodes)
        return self.gather_windows(state, draws.uniform(n_episodes), idx, self._window_len(max_len))

    def sample(self, state: EpisodicReplayState, draws, n: int) -> TransitionBatch:
        """``n`` single transitions, uniform over the stored steps of sealed
        rows (rows weighted by length), with 1-step discounts."""
        ep_len = state.ep_len
        rows = self._sealed_rows(draws, n, state.finished.to(torch.float32) * ep_len.to(torch.float32))
        row_len = ep_len[rows]
        u = draws.uniform(n)
        t = torch.minimum((u * row_len.to(torch.float32)).to(torch.int32), torch.clamp_min(row_len - 1, 0))
        st = state.storage
        tr = {name: st[name][rows, t] for name in _LEAVES}
        return TransitionBatch(
            obs=tr["obs"],
            action=tr["action"],
            reward=tr["reward"],
            next_obs=tr["next_obs"],
            discount=torch.full((n,), self.gamma, dtype=torch.float32, device=rows.device),
            is_terminal=tr["terminated"],
            weight=torch.ones(n, dtype=torch.float32, device=rows.device),
            indices=rows * self.max_episode_len + t,
            extras={k: tree_map(lambda s: s[rows, t], v) for k, v in st["extras"].items()},
        )
