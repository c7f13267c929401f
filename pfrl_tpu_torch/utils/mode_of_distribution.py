"""Deterministic action extraction (counterpart of
``pfrl_tpu/utils/mode_of_distribution.py``; reference parity:
pfrl/utils/mode_of_distribution.py:5-19)."""

from typing import Any


def mode_of_distribution(distrib: Any):
    """The mode of a distribution of :mod:`pfrl_tpu_torch.distributions`:
    every one exposes ``.mode()`` (the reference dispatched on the type of
    a ``torch.distributions`` object, which had no mode before torch 1.12)."""
    return distrib.mode()
