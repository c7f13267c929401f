"""Device-resident replay ring (counterpart of ``pfrl_tpu/replay/uniform.py``).

A preallocated ring of device tensors with a monotonic int32 write cursor.
Env lanes are interleaved (the temporal successor of slot ``i`` is
``i + num_lanes``); n-step returns are folded at sample time, masked at
episode boundaries.

Unlike the JAX package, whose state is immutable, :class:`ReplayState` is
updated **in place**: the ring is gigabytes at Atari sizes and must never
be copied per step. ``add`` writes rows into the existing storage and bumps
the cursor tensor; it returns the same state object.

An observation (``obs``, and ``next_obs`` where it is stored) may be a
tensor or a structure of them (a tuple, list or dict, as the grasping
example's ``(image, elapsed_steps)``): each leaf is stored as one tensor of
its own dtype, ``[capacity, padded width]`` or ``[capacity]`` for a 0-d
item, as the JAX ring stores each leaf of its pytree, and the gather
reshapes each back.

The row gather stays plain tensor indexing, as in the JAX package, where
it is an XLA gather outside any Pallas kernel.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch
from pfrl_tpu_torch.utils.batch_states import first_leaf, map_structure


def _padded_width(d: int) -> int:
    """Flat item width as stored: leaves of 128 elements or more are padded
    to a multiple of 128, the JAX ring's layout; the pad stays zero."""
    if d < 128:
        return d
    return ((d + 127) // 128) * 128


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@dataclasses.dataclass
class ReplayState:
    storage: Dict[str, Any]  # field -> [capacity] or [capacity, padded width], or a structure of them
    cursor: torch.Tensor     # int32 0-d: items written so far
    item_shapes: Dict[str, Any]  # field -> item shape, or a structure of them

    #: A snapshot loads only into a ring of the same item shapes
    #: (:func:`~pfrl_tpu_torch.agent.restore_saved`): two shapes can pad to
    #: one stored width.
    strict_fields = ("item_shapes",)

    @property
    def size(self) -> torch.Tensor:
        capacity = first_leaf(self.storage).shape[0]
        return torch.clamp_max(self.cursor, capacity)


class ReplayBuffer:
    """Static config + init/add/gather over a :class:`ReplayState`.

    Args:
        capacity: max stored transitions (rounded down to a multiple of lanes).
        num_steps: n of n-step returns.
        gamma: discount of the n-step fold.
        num_lanes: env lanes per ``add``; the ring stride.
        store_next_obs: False reads the bootstrap observation from the
            temporally next ring slot instead of a stored copy.
        fused_dequant_scale: when set, uint8 observations come out of the
            gather as ``float32 * scale``.
        device: where the ring lives (default: the CUDA device).
    """

    def __init__(
        self,
        capacity: int,
        num_steps: int = 1,
        gamma: float = 0.99,
        num_lanes: int = 1,
        store_next_obs: bool = True,
        fused_dequant_scale: Optional[float] = None,
        device=None,
    ):
        if capacity < num_lanes * (num_steps + (0 if store_next_obs else 1)):
            raise ValueError("capacity too small for num_lanes * n-step window")
        self.num_lanes = num_lanes
        self.capacity = (capacity // num_lanes) * num_lanes
        self.num_steps = num_steps
        self.gamma = gamma
        self.store_next_obs = store_next_obs
        self.fused_dequant_scale = fused_dequant_scale
        self.device = resolve_device(device)

    #: Samples are iid draws with no cross-sample state (no priority
    #: feedback): the runner draws the ids of all of a scan step's
    #: minibatches at once. PrioritizedReplayBuffer overrides this to False.
    iid_samples = True

    @property
    def wants_next_obs(self) -> bool:
        """Whether ``add`` reads the ``next_obs`` leaf. False: the bootstrap
        observation comes from the successor ring slot, so a host caller
        may skip collating and uploading it."""
        return self.store_next_obs

    def _config(self) -> dict:
        return dict(
            capacity=self.capacity, num_steps=self.num_steps, gamma=self.gamma,
            num_lanes=self.num_lanes, store_next_obs=self.store_next_obs,
            fused_dequant_scale=self.fused_dequant_scale, device=self.device,
        )

    def configure_lanes(self, num_lanes: int) -> "ReplayBuffer":
        """A copy for another env-batch width (the ring stride); the host
        shell calls it once it learns the vector env's size. The capacity
        is the one this buffer rounded to, as in the JAX package."""
        return type(self)(**{**self._config(), "num_lanes": num_lanes})

    def _leaves(self, t: Transition) -> Dict[str, torch.Tensor]:
        leaves = {
            "obs": t.obs, "action": t.action, "reward": t.reward,
            "terminated": t.terminated, "done": t.done,
        }
        if self.store_next_obs:
            leaves["next_obs"] = t.next_obs
        return leaves

    # ------------------------------------------------------------------ init
    def init(self, example: Transition) -> ReplayState:
        """Allocate storage from one example transition (no batch dim)."""
        def alloc(x):
            shape = (self.capacity, _padded_width(x.numel())) if x.dim() >= 1 else (self.capacity,)
            return torch.zeros(shape, dtype=x.dtype, device=self.device)

        fields = self._leaves(example)
        storage = {name: map_structure(alloc, x) for name, x in fields.items()}
        shapes = {name: map_structure(lambda x: tuple(x.shape), x) for name, x in fields.items()}
        return ReplayState(
            storage=storage,
            cursor=torch.zeros((), dtype=torch.int32, device=self.device),
            item_shapes=shapes,
        )

    # ------------------------------------------------------------------- add
    def add(self, state: ReplayState, batch: Transition) -> ReplayState:
        """Insert one transition per lane, in place."""
        lanes = first_leaf(batch.obs).shape[0]
        idx = (state.cursor + torch.arange(lanes, dtype=torch.int32, device=self.device)) % self.capacity

        def write(x, s):
            if s.dim() == 2:
                x = x.reshape(lanes, -1)
                s[idx, : x.shape[1]] = x  # the 128-lane pad stays zero
            else:
                s[idx] = x

        for name, x in self._leaves(batch).items():
            map_structure(write, x, state.storage[name])
        state.cursor += lanes
        return state

    # ---------------------------------------------------------------- sample
    def _sampleable_range(self, state: ReplayState):
        """Monotonic id range [lo, hi) of n-step-window-complete items.

        Without stored next_obs, one extra stride is held out so the
        bootstrap slot (window end + 1) is always written.
        """
        extra = 0 if self.store_next_obs else 1
        lo = torch.clamp_min(state.cursor - self.capacity, 0)
        hi = state.cursor - (self.num_steps - 1 + extra) * self.num_lanes
        return lo, hi

    def sample_indices(self, state: ReplayState, draws, batch_size: int) -> torch.Tensor:
        """``batch_size`` monotonic int32 ids, uniform over the sampleable
        range; the range stays on the device."""
        lo, hi = self._sampleable_range(state)
        return lo + draws.randint_below(torch.clamp_min(hi - lo, 1), batch_size)

    def _take(self, x, ids, shape: Tuple[int, ...], dequant: bool = False):
        """Rows ``x[ids]`` trimmed to the true item width and reshaped;
        uint8 leaves optionally dequantized to ``float32 * scale``."""
        if x.dim() == 2:
            out = x[ids, : _numel(shape)]
        else:
            out = x[ids]
        out = out.reshape(ids.shape[0], *shape)
        if dequant and self.fused_dequant_scale and x.dtype == torch.uint8:
            out = out.to(torch.float32) * self.fused_dequant_scale
        return out

    def gather(self, state: ReplayState, ids: torch.Tensor) -> TransitionBatch:
        """Materialize an n-step-folded batch from monotonic int32 ids."""
        n, stride = self.num_steps, self.num_lanes
        steps = torch.arange(n, dtype=ids.dtype, device=ids.device)
        win = (ids[:, None] + steps[None, :] * stride) % self.capacity  # [B, n]
        first = win[:, 0]

        st = state.storage
        rewards = st["reward"][win]
        terminated = st["terminated"][win]
        dones = st["done"][win]

        # Steps strictly after an episode boundary are invalid.
        before = torch.cat(
            [torch.zeros_like(dones[:, :1]), dones[:, : n - 1]], dim=1
        ).to(torch.int32)
        valid = torch.cumsum(before, dim=1) == 0  # [:, 0] always True
        discounts = torch.pow(
            self.gamma, torch.arange(n, dtype=torch.float32, device=ids.device)
        )
        folded_reward = torch.sum(rewards * valid.to(rewards.dtype) * discounts, dim=1)
        k = torch.sum(valid, dim=1)  # steps actually folded
        discount = torch.pow(self.gamma, k.to(torch.float32))
        is_terminal = torch.any(terminated & valid, dim=1)
        # The bootstrap obs is next_obs of the last folded step.
        last = win[torch.arange(win.shape[0], device=ids.device), k - 1]

        shapes = state.item_shapes

        def take_obs(name, ids):
            return map_structure(lambda x, shape: self._take(x, ids, shape, dequant=True), st[name], shapes[name])

        obs = take_obs("obs", first)
        if self.store_next_obs:
            next_obs = take_obs("next_obs", last)
        else:
            next_obs = take_obs("obs", (last + stride) % self.capacity)
        return TransitionBatch(
            obs=obs,
            action=self._take(st["action"], first, shapes["action"]),
            reward=folded_reward,
            next_obs=next_obs,
            discount=discount,
            is_terminal=is_terminal,
            weight=torch.ones_like(folded_reward),
            indices=ids,
        )

    def sample(self, state: ReplayState, draws, batch_size: int) -> TransitionBatch:
        return self.gather(state, self.sample_indices(state, draws, batch_size))

    def update_priorities(self, state: ReplayState, ids, errors) -> ReplayState:
        """Priority feedback is a no-op for the uniform buffer."""
        return state
