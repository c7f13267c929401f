"""Transitions (counterpart of ``pfrl_tpu/replay/transition.py``).

Every field is one tensor with a leading batch dimension; the JAX package's
pytree observations are not needed on the ported path and are left out.
``extras`` is a dict of carries (tensors or nested tuples of tensors with
the same leading dimension): the episodic buffer stores the recurrent
carries there (``"carry"``, ``"next_carry"``), or ACER's behaviour
distribution; other buffers ignore it.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Transition:
    """One env step per lane."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: Optional[torch.Tensor]
    terminated: torch.Tensor  # true episode end: no bootstrap
    done: torch.Tensor        # terminated | truncated: episode boundary
    extras: Optional[dict] = None


@dataclasses.dataclass
class TransitionBatch:
    """An n-step-folded sample: ``discount`` is gamma**k for the k steps
    folded, ``is_terminal`` kills the bootstrap, ``weight`` is the PER
    importance weight, ``indices`` route priority feedback."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    discount: torch.Tensor
    is_terminal: torch.Tensor
    weight: torch.Tensor
    indices: torch.Tensor
    extras: Optional[dict] = None
