"""Host env wrappers (counterpart of ``pfrl_tpu/wrappers``): numpy in, numpy
out. The Atari preprocessing stack is :mod:`.atari_wrappers`; the small
wrappers of :mod:`.misc` are exported here. None imports torch."""

from pfrl_tpu_torch.wrappers.misc import (  # noqa: F401
    CastObservation,
    CastObservationToFloat32,
    NormalizeActionSpace,
    RandomizeAction,
    ScaleReward,
)
