"""Running observation normalization (counterpart of
``pfrl_tpu/models/empirical_normalization.py``).

The statistics are an explicit :class:`NormalizerState` of tensors, and
``update`` / ``normalize`` / ``inverse`` are pure functions of it, as in the
JAX package: no buffer of a module moves. ``update`` is Chan's parallel
merge with biased (``ddof = 0``) variances, in the JAX package's order of
operations; with ``until``, a state whose count has reached ``until``
before the batch is returned unchanged.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from pfrl_tpu_torch._device import resolve_device


@dataclasses.dataclass
class NormalizerState:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # 0-d float32: the number of samples absorbed


class EmpiricalNormalization:
    """Normalize by the empirical mean and standard deviation of everything
    seen so far. ``until`` caps how many samples update the statistics;
    ``clip_threshold`` clips the normalized outputs."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        eps: float = 1e-2,
        until: Optional[int] = None,
        clip_threshold: Optional[float] = 5.0,
    ):
        self.shape = tuple(shape)
        self.eps = eps
        self.until = until
        self.clip_threshold = clip_threshold

    def init(self, device=None) -> NormalizerState:
        device = resolve_device(device)
        return NormalizerState(
            mean=torch.zeros(self.shape, dtype=torch.float32, device=device),
            var=torch.ones(self.shape, dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.float32, device=device),
        )

    def update(self, state: NormalizerState, batch: torch.Tensor) -> NormalizerState:
        """Absorb a batch ``[B, *shape]``; returns a new state."""
        b = torch.tensor(float(batch.shape[0]), dtype=torch.float32, device=batch.device)
        batch_mean = torch.mean(batch, dim=0)
        centered = batch - batch_mean
        batch_var = torch.mean(centered * centered, dim=0)
        count = state.count + b
        delta = batch_mean - state.mean
        new_mean = state.mean + (b / count) * delta
        m_a = state.var * state.count
        m_b = batch_var * b
        m2 = m_a + m_b + delta * delta * state.count * b / count
        new = NormalizerState(mean=new_mean, var=m2 / count, count=count)
        if self.until is not None:
            frozen = state.count >= self.until
            new = NormalizerState(**{
                f.name: torch.where(frozen, getattr(state, f.name), getattr(new, f.name))
                for f in dataclasses.fields(NormalizerState)
            })
        return new

    def normalize(self, state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
        out = (x - state.mean) / (torch.sqrt(state.var) + self.eps)
        if self.clip_threshold is not None:
            out = torch.clamp(out, -self.clip_threshold, self.clip_threshold)
        return out

    def __call__(self, state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(state, x)

    def inverse(self, state: NormalizerState, y: torch.Tensor) -> torch.Tensor:
        return y * (torch.sqrt(state.var) + self.eps) + state.mean
