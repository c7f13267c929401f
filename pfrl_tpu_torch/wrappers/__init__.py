"""Host env wrappers (counterpart of ``pfrl_tpu/wrappers``): numpy in, numpy
out. The Atari preprocessing stack and ``make_atari`` are
:mod:`.atari_wrappers`; ``ContinuingTimeLimit``, ``Monitor`` and ``Render``,
``VectorFrameStack`` and the small wrappers of :mod:`.misc` are exported
here, as the JAX package exports them. None imports torch."""

from pfrl_tpu_torch.wrappers import atari_wrappers  # noqa: F401
from pfrl_tpu_torch.wrappers.continuing_time_limit import ContinuingTimeLimit  # noqa: F401
from pfrl_tpu_torch.wrappers.misc import (  # noqa: F401
    CastObservation,
    CastObservationToFloat32,
    NormalizeActionSpace,
    RandomizeAction,
    ScaleReward,
)
from pfrl_tpu_torch.wrappers.monitor import Monitor, Render  # noqa: F401
from pfrl_tpu_torch.wrappers.vector_frame_stack import LazyFrames, VectorFrameStack  # noqa: F401

__all__ = [
    "atari_wrappers",
    "ContinuingTimeLimit",
    "CastObservation",
    "CastObservationToFloat32",
    "NormalizeActionSpace",
    "RandomizeAction",
    "ScaleReward",
    "Monitor",
    "Render",
    "LazyFrames",
    "VectorFrameStack",
]
